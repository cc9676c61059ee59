// K5: streaming brute-force nearest neighbour (k = 1).
//
// Replaces the TPU kernel knn_bruteforce_pallas
// (open3d_slam_private_tpu/kernels/knn_pallas.py:78, body _knn_kernel :44).
// Contract, for each query q_i of query [Q, 3] against ref [M, 3], every
// step rounded once to float32 as XLA's CPU dot and sum of squares round:
//   qsq_i  = fma(q2, q2, fma(q1, q1, q0 * q0)), rsq_j the same
//   cross  = fma(q2, r2, fma(q1, r1, q0 * r0))
//   d2_ij  = (qsq_i - 2 * cross) + rsq_j, with no clamp (it may be negative)
//   out[i] = (min_j d2_ij, the lowest j attaining it); (inf, 0) when M = 0
// Padded reference rows sit at 1e9 (d2 ~ 1e18) and never beat a real point.
// The steps are written with intrinsics (__fmul_rn, __fmaf_rn, __fadd_rn):
// nvcc would otherwise contract a*b+c where the contract does not, and one
// contraction more or less changes bits. qsq - 2*cross is one
// __fmaf_rn(-2, cross, qsq): 2*cross is exact, so that is the contract's
// rounding, subnormal products included. No tensor cores: TF32 would flip
// near-tied winners, and no wgmma product rounds as this FMA chain does.
//
// What bounds it on an H100: FP32 issue. A pair costs 5 FP32 instructions
// (FMUL, three FFMA, FADD) and one FMNMX; 8 FLOP a pair over 67 TFLOP/s is
// the stated bound, and 6 instructions a pair over 132 SMs x 128 lanes is
// ~66% of it at best. Design:
// - knn_brute_pack writes the reference once as float4 (x, y, z, rsq), the
//   tail padded to a whole tile with (0, 0, 0, inf), which never wins.
// - The main kernel keeps kQpt queries a thread in registers and streams
//   tiles of kTile packed points through shared memory, double-buffered with
//   cp.async (the next tile loads while this one is scanned). Every lane of
//   a warp reads the same point (one broadcast LDS.128 feeds 6*kQpt
//   instructions).
// - Argmin in two steps: the scan keeps only the running minimum (fminf)
//   and, per chunk of kChunk points, the first chunk where it strictly
//   dropped; at the end each query re-scans that one chunk in index order
//   for the first point at the minimum, with the same instructions. That is
//   the lowest index at the minimum, as the Pallas kernel's per-tile argmin
//   and strict '<' across tiles give.
// - Split-M: where query tiles alone cannot fill the card, blockIdx.y cuts
//   the reference tiles into `splits` contiguous ranges; each writes a
//   partial (min, first index) per query and knn_brute_merge takes the
//   smallest, the lowest split among equals. No float atomics: the result
//   does not depend on timing. The split count comes from Q, M, the SM
//   count and the kernel's occupancy (knn_brute_plan), fixed for a shape.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// Queries a thread. 16 would halve the shared-memory loads a pair but takes
// 128 registers (4 blocks an SM) against 92 (5 blocks), and measured
// 0.6-2.4% slower on an H100 (tools/torch_knn_brute_variants.py).
constexpr int kQpt = 8;
constexpr int kTile = 128;   // packed points a shared-memory stage holds (2 KB)
constexpr int kChunk = 64;   // points per running-minimum chunk
constexpr int kMaxSplits = 64;

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
}

__device__ __forceinline__ float pair_d2(float q0, float q1, float q2, float qsq, float4 r) {
  const float cross = __fmaf_rn(q2, r.z, __fmaf_rn(q1, r.y, __fmul_rn(q0, r.x)));
  return __fadd_rn(__fmaf_rn(-2.f, cross, qsq), r.w);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void knn_brute_pack(const float* __restrict__ ref, int m, int m_pad,
                               float4* __restrict__ packed) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m_pad) return;
  if (j < m) {
    const float x = ref[3 * static_cast<size_t>(j)];
    const float y = ref[3 * static_cast<size_t>(j) + 1];
    const float z = ref[3 * static_cast<size_t>(j) + 2];
    packed[j] = make_float4(x, y, z, sq_norm(x, y, z));
  } else {
    packed[j] = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  }
}

static_assert(kTile % kThreads == 0 && kTile % kChunk == 0, "whole tiles and chunks");

__device__ __forceinline__ void stage_tile(float4* dst, const float4* src) {
#pragma unroll
  for (int j = 0; j < kTile / kThreads; ++j)
    cp_async16(dst + j * kThreads + threadIdx.x, src + j * kThreads + threadIdx.x);
  cp_async_commit();
}

// Grid (query tiles, splits). Split s scans tiles [tiles*s/splits,
// tiles*(s+1)/splits) and writes out_d2/out_ids[s * nq + i].
// Four blocks an SM at least: ptxas may then spend registers interleaving
// the kQpt chains of a point (92 a thread; without the hint 72-80 and
// 2-13% slower on an H100, tools/torch_knn_brute_variants.py).
__global__ void __launch_bounds__(kThreads, 4)
knn_brute_kernel(const float* __restrict__ query, const float4* __restrict__ packed, int nq,
                 int tiles, float* __restrict__ out_d2, int32_t* __restrict__ out_ids) {
  __shared__ __align__(16) float4 stage[2][kTile];
  const int splits = gridDim.y, s = blockIdx.y;
  const int t_begin = static_cast<int>(static_cast<int64_t>(tiles) * s / splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(tiles) * (s + 1) / splits);
  const int base = blockIdx.x * (kThreads * kQpt) + threadIdx.x;
  float q0[kQpt], q1[kQpt], q2[kQpt], qsq[kQpt], best[kQpt];
  int chunk[kQpt];
#pragma unroll
  for (int k = 0; k < kQpt; ++k) {
    const int i = base + k * kThreads;
    const bool in = i < nq;
    q0[k] = in ? query[3 * static_cast<size_t>(i)] : 0.f;
    q1[k] = in ? query[3 * static_cast<size_t>(i) + 1] : 0.f;
    q2[k] = in ? query[3 * static_cast<size_t>(i) + 2] : 0.f;
    qsq[k] = sq_norm(q0[k], q1[k], q2[k]);
    best[k] = CUDART_INF_F;
    chunk[k] = -1;
  }
  if (t_begin < t_end) stage_tile(stage[0], packed + static_cast<size_t>(t_begin) * kTile);
  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      stage_tile(stage[buf ^ 1], packed + static_cast<size_t>(t + 1) * kTile);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t is in shared memory for every thread
    const float4* tile = stage[buf];
    for (int c = 0; c < kTile / kChunk; ++c) {
      float before[kQpt];
#pragma unroll
      for (int k = 0; k < kQpt; ++k) before[k] = best[k];
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        // pair_d2 for every query, one step at a time across the queries:
        // kQpt independent chains in flight, not one chain of 6 dependent
        // instructions after another.
        const float4 r = tile[c * kChunk + j];
        float d[kQpt];
#pragma unroll
        for (int k = 0; k < kQpt; ++k) d[k] = __fmul_rn(q0[k], r.x);
#pragma unroll
        for (int k = 0; k < kQpt; ++k) d[k] = __fmaf_rn(q1[k], r.y, d[k]);
#pragma unroll
        for (int k = 0; k < kQpt; ++k) d[k] = __fmaf_rn(q2[k], r.z, d[k]);
#pragma unroll
        for (int k = 0; k < kQpt; ++k) d[k] = __fmaf_rn(-2.f, d[k], qsq[k]);
#pragma unroll
        for (int k = 0; k < kQpt; ++k) d[k] = __fadd_rn(d[k], r.w);
#pragma unroll
        for (int k = 0; k < kQpt; ++k) best[k] = fminf(best[k], d[k]);
      }
      const int here = t * (kTile / kChunk) + c;
#pragma unroll
      for (int k = 0; k < kQpt; ++k) chunk[k] = best[k] < before[k] ? here : chunk[k];
    }
    __syncthreads();  // every thread is done with buf before it is refilled
  }
#pragma unroll
  for (int k = 0; k < kQpt; ++k) {
    const int i = base + k * kThreads;
    if (i >= nq) continue;
    int id = 0;
    if (chunk[k] >= 0) {  // the first point of the chunk at the minimum
      const float4* p = packed + static_cast<size_t>(chunk[k]) * kChunk;
      int j = 0;
      while (j < kChunk - 1 && pair_d2(q0[k], q1[k], q2[k], qsq[k], p[j]) != best[k]) ++j;
      id = chunk[k] * kChunk + j;
    }
    const size_t o = static_cast<size_t>(s) * nq + i;
    out_d2[o] = best[k];
    out_ids[o] = id;
  }
}

// The smallest partial of each query, the lowest split among equals (a
// strict '<' in split order); (inf, 0) where every split saw no finite d2.
__global__ void knn_brute_merge(const float* __restrict__ part_d2,
                                const int32_t* __restrict__ part_ids, int nq, int splits,
                                float* __restrict__ out_d2, int32_t* __restrict__ out_ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float d = CUDART_INF_F;
  int id = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t o = static_cast<size_t>(s) * nq + i;
    const float v = part_d2[o];
    if (v < d) {
      d = v;
      id = part_ids[o];
    }
  }
  out_d2[i] = d;
  out_ids[i] = id;
}

// Splits of the reference: with `slots` blocks resident on the card at
// once, time ~ waves x tiles a split. The smallest split count within 2% of
// the least such time (fewer partials to write and merge).
int choose_splits(int qtiles, int tiles, int slots) {
  const int most = tiles < kMaxSplits ? tiles : kMaxSplits;
  if (most <= 1 || slots <= 0) return 1;
  int64_t cost[kMaxSplits + 1];
  int64_t least = INT64_MAX;
  for (int s = 1; s <= most; ++s) {
    const int64_t blocks = static_cast<int64_t>(qtiles) * s;
    cost[s] = ((blocks + slots - 1) / slots) * ((tiles + s - 1) / s);
    if (cost[s] < least) least = cost[s];
  }
  for (int s = 1; s <= most; ++s)
    if (cost[s] * 50 <= least * 51) return s;
  return 1;
}

}  // namespace

// plan[0] = queries a thread, plan[1] = splits, plan[2] = packed reference
// rows (M rounded up to a whole tile). Returns a CUDA error code (0 on
// success).
extern "C" int knn_brute_plan(int Q, int M, int32_t* plan) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, knn_brute_kernel, kThreads, 0);
  const int tiles = (M + kTile - 1) / kTile;
  const int qtiles = (Q + kThreads * kQpt - 1) / (kThreads * kQpt);
  plan[0] = kQpt;
  plan[1] = choose_splits(qtiles, tiles, sms * occ);
  plan[2] = tiles * kTile;
  return static_cast<int>(cudaGetLastError());
}

// query: [Q, 3] float32; ref: [M, 3] float32; splits and packed ([m_pad]
// float4 scratch): from knn_brute_plan; part_d2/part_ids: [splits, Q]
// scratch (unused when splits == 1); d2: [Q] float32; ids: [Q] int32.
// Launches on `stream`, returns cudaGetLastError() after the launches (0 on
// success).
extern "C" int knn_brute_launch(const float* query, const float* ref, int Q, int M, int splits,
                                float* packed, float* part_d2, int32_t* part_ids, float* d2,
                                int32_t* ids, void* stream) {
  if (Q == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (M + kTile - 1) / kTile, m_pad = tiles * kTile;
  float4* pk = reinterpret_cast<float4*>(packed);
  if (m_pad > 0) knn_brute_pack<<<(m_pad + 255) / 256, 256, 0, st>>>(ref, M, m_pad, pk);
  const dim3 grid((Q + kThreads * kQpt - 1) / (kThreads * kQpt), splits);
  knn_brute_kernel<<<grid, kThreads, 0, st>>>(query, pk, Q, tiles, splits > 1 ? part_d2 : d2,
                                              splits > 1 ? part_ids : ids);
  if (splits > 1)
    knn_brute_merge<<<(Q + 255) / 256, 256, 0, st>>>(part_d2, part_ids, Q, splits, d2, ids);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* knn_brute_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
