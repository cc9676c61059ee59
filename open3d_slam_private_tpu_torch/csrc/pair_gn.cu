// K1: fused pair-cached Gauss-Newton linearisation (knn = 1).
//
// Replaces the TPU kernel pair_gn_step_folded
// (open3d_slam_private_tpu/kernels/pair_gn_pallas.py:261, body
// _kernel_folded at :194). Contract, for each problem b and point i:
//   s  = T_b * p_i                      (reading point moved by the pose)
//   d2 = |s - q_i|^2                    (q_i: the round's cached pair)
//   ok = valid_i && d2 <= max_d2
//   w  = ok && d2 <= tau_b              (round-frozen trimming threshold)
//   r  = (s - q_i) . n_i,  J = [s x n_i, n_i]
// out[b] = A = sum w J^T J as a full symmetric 6x6 (36 floats, row-major),
//          b = -sum w J r (6), sum w, sum w r^2, count ok       (45 floats)
//
// What bounds it on an H100: memory, and at the SLAM step's sizes the
// launch. Each point streams 37 bytes (reading, pair and normal xyz, one
// valid byte) for ~100 flops: 0.6 MB at 1 x 16,384 (0.18 us at 3.35 TB/s,
// far below the ~2 us launch floor), 19.4 MB at 8 x 65,536 (5.8 us).
// Design:
// - One launch per call. A grid of (blocks, problem); each block reduces its
//   tiles to one partial row, then the last block of a problem to finish
//   (a per-problem arrival counter: partial row, __threadfence, atomicAdd)
//   adds the partial rows in block order and writes the output. A last-block
//   reduction over a thread block cluster was the other choice: a cluster
//   holds at most 8 (16 with a non-portable opt-in) blocks, which would cap
//   the blocks of a problem, while the counter costs one atomic a block.
//   The counters and the partial rows live in a workspace the wrapper
//   allocates once per device; the last block resets its counter to 0, so
//   calls must not overlap: they are issued on one stream, in order.
// - Sums in a fixed order for a given shape (each thread's points, a
//   butterfly warp reduction, warps in order, blocks in order), no float
//   atomics: a rerun gives bit-identical sums.
// - Loads through shared memory: a block stages each tile's contiguous
//   [tile, 3] slices of reading, pair and normal and the tile's valid bytes
//   with 16-byte cp.async copies (a ring of two stages, 38 KB: the next
//   tile loads while this one is summed; four stages measured no faster),
//   so every warp load is 512 contiguous bytes; a thread then reads its
//   points from shared memory (stride 3 words: no bank conflicts).
// - Work per thread: a tile is 512 points, 2 a thread; the wrapper gives a
//   block enough tiles that the grid is ~2 blocks an SM (8 points a thread
//   at 8 x 65,536), so the 30-value warp reduction (31 shuffles as a
//   butterfly) is amortised; at 1 x 16,384 a block takes one tile (32
//   blocks), the grid's latency is one tile load and two reductions.
// - The transform and d2 are rounded step by step (__fmul_rn/__fadd_rn, no
//   FMA contraction) so the weight of every point equals the plain PyTorch
//   version's and the weight and count sums match it exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;                // points a tile
constexpr int kAcc = 30;                  // 21 upper-triangle A, 6 b, sum w, sum w r^2, n ok
constexpr int kOut = 45;                  // full A, b, sum w, sum w r^2, n ok
constexpr int kXyzBytes = kTile * 12 + 32;  // a tile's [tile, 3] floats + alignment slack
constexpr int kValidBytes = kTile + 32;
constexpr int kStageBytes = 3 * kXyzBytes + kValidBytes;  // reading, pair, normal, valid
constexpr int kStages = 2;  // tiles in flight a block (dynamic shared memory, 38 KB)
constexpr int kRowsAtOnce = 128;  // partial rows the last block fetches at once (16 KB)

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ const char* align_down16(const char* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1));
}

// Copy bytes [lo, hi) of one input into dst, dst[0] holding the byte at
// align_down16(lo): 16-byte cp.async for every aligned quad that lies inside
// the input (end = its last byte + 1), single bytes past the last one.
__device__ __forceinline__ void stage(char* dst, const char* lo, const char* hi, const char* end) {
  const char* qa = align_down16(lo);
  const char* hi16 = align_down16(hi + 15);
  const char* end16 = align_down16(end);
  const char* qend = hi16 < end16 ? hi16 : end16;
  for (const char* q = qa + 16 * threadIdx.x; q < qend; q += 16 * kThreads) cp_async16(dst + (q - qa), q);
  for (const char* p = (qend > lo ? qend : lo) + threadIdx.x; p < hi; p += kThreads) dst[p - qa] = *p;
}

// Warp sum of 32 values: a butterfly that halves the values each lane holds
// at every step (16 + 8 + 4 + 2 + 1 shuffles); lane l ends with the sum of
// value l. Each sum is formed by one lane in a fixed order.
template <int kN>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & kN) != 0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float send = upper ? v[j] : v[j + kN];
    const float keep = upper ? v[j + kN] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kN);
  }
}

__global__ void __launch_bounds__(kThreads)
pair_gn_fused(const float* __restrict__ reading, const float* __restrict__ pair_xyz,
              const float* __restrict__ pair_nrm, const uint8_t* __restrict__ valid,
              const float* __restrict__ T, const float* __restrict__ tau, float max_d2, int B,
              int n, int tiles_per_block, float* __restrict__ partial, int* __restrict__ counter,
              float* __restrict__ out) {
  extern __shared__ __align__(16) char s_tiles[];  // kStages x kStageBytes
  __shared__ float red[kWarps][32];
  __shared__ float row[32];
  __shared__ bool last;

  const int b = blockIdx.y;
  const float* t = T + 16 * b;
  const float t00 = t[0], t01 = t[1], t02 = t[2], t03 = t[3];
  const float t10 = t[4], t11 = t[5], t12 = t[6], t13 = t[7];
  const float t20 = t[8], t21 = t[9], t22 = t[10], t23 = t[11];
  const float tau_b = tau[b];

  const char* rd = reinterpret_cast<const char*>(reading);
  const char* pq = reinterpret_cast<const char*>(pair_xyz);
  const char* pn = reinterpret_cast<const char*>(pair_nrm);
  const char* vd = reinterpret_cast<const char*>(valid);
  const size_t total = static_cast<size_t>(B) * n;
  const size_t base = static_cast<size_t>(b) * n;
  const int tiles = (n + kTile - 1) / kTile;
  const int tile0 = blockIdx.x * tiles_per_block;
  const int tile1 = min(tile0 + tiles_per_block, tiles);

  auto load = [&](int tile) {
    if (tile < tile1) {
      char* st = s_tiles + ((tile - tile0) % kStages) * kStageBytes;
      const size_t g0 = base + static_cast<size_t>(tile) * kTile;
      const size_t g1 = base + min(static_cast<size_t>(tile + 1) * kTile, static_cast<size_t>(n));
      stage(st, rd + 12 * g0, rd + 12 * g1, rd + 12 * total);
      stage(st + kXyzBytes, pq + 12 * g0, pq + 12 * g1, pq + 12 * total);
      stage(st + 2 * kXyzBytes, pn + 12 * g0, pn + 12 * g1, pn + 12 * total);
      stage(st + 3 * kXyzBytes, vd + g0, vd + g1, vd + total);
    }
    cp_async_commit();  // an empty group keeps the count of groups per tile
  };

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;

#pragma unroll
  for (int k = 0; k < kStages; ++k) load(tile0 + k);
  for (int tile = tile0; tile < tile1; ++tile) {
    const char* st = s_tiles + ((tile - tile0) % kStages) * kStageBytes;
    cp_async_wait_stages();
    __syncthreads();
    const size_t g0 = base + static_cast<size_t>(tile) * kTile;
    const int count = min(kTile, n - tile * kTile);
    // Where the tile's first point sits in each staged buffer.
    const char* sr = st + (rd + 12 * g0 - align_down16(rd + 12 * g0));
    const char* sq = st + kXyzBytes + (pq + 12 * g0 - align_down16(pq + 12 * g0));
    const char* sn = st + 2 * kXyzBytes + (pn + 12 * g0 - align_down16(pn + 12 * g0));
    const char* sv = st + 3 * kXyzBytes + (vd + g0 - align_down16(vd + g0));
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const float* p = reinterpret_cast<const float*>(sr + 12 * i);
      const float* q = reinterpret_cast<const float*>(sq + 12 * i);
      const float x = p[0], y = p[1], z = p[2];
      const float sx = add(add(add(mul(t00, x), mul(t01, y)), mul(t02, z)), t03);
      const float sy = add(add(add(mul(t10, x), mul(t11, y)), mul(t12, z)), t13);
      const float sz = add(add(add(mul(t20, x), mul(t21, y)), mul(t22, z)), t23);
      const float dx = __fsub_rn(sx, q[0]);
      const float dy = __fsub_rn(sy, q[1]);
      const float dz = __fsub_rn(sz, q[2]);
      const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
      const bool ok = sv[i] != 0 && d2 <= max_d2;
      if (!ok) continue;
      acc[29] += 1.f;
      if (!(d2 <= tau_b)) continue;
      const float* nn = reinterpret_cast<const float*>(sn + 12 * i);
      const float nx = nn[0], ny = nn[1], nz = nn[2];
      const float r = dx * nx + dy * ny + dz * nz;
      const float c[6] = {sy * nz - sz * ny, sz * nx - sx * nz, sx * ny - sy * nx, nx, ny, nz};
      int s = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int e = a; e < 6; ++e) acc[s++] += c[a] * c[e];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] -= c[a] * r;
      acc[27] += 1.f;
      acc[28] += r * r;
    }
    __syncthreads();
    load(tile + kStages);
  }

  // Block partial row: warp butterflies, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
  red[warp][lane] = acc[0];
  __syncthreads();
  float* mine = partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * 32;
  if (threadIdx.x < kAcc) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    mine[threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter + b, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!last) return;

  // The problem's last block: the partial rows, 128 at a time, are fetched
  // into the (now idle) tile buffer with every load in flight at once, then
  // added in block order.
  __threadfence();
  float* parts = reinterpret_cast<float*>(s_tiles);
  const float* rows_b = partial + static_cast<size_t>(b) * gridDim.x * 32;
  float v = 0.f;
  for (int k0 = 0; k0 < static_cast<int>(gridDim.x); k0 += kRowsAtOnce) {
    const int words = min(kRowsAtOnce, static_cast<int>(gridDim.x) - k0) * 32;
    float fetched[kRowsAtOnce * 32 / kThreads];
#pragma unroll
    for (int u = 0; u < kRowsAtOnce * 32 / kThreads; ++u) {
      const int e = threadIdx.x + u * kThreads;
      fetched[u] = e < words ? __ldcg(rows_b + k0 * 32 + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kRowsAtOnce * 32 / kThreads; ++u) parts[threadIdx.x + u * kThreads] = fetched[u];
    __syncthreads();
    if (threadIdx.x < kAcc)
      for (int k = 0; k < words / 32; ++k) v += parts[k * 32 + threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x < kAcc) row[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x < kOut) {
    const int j = threadIdx.x;
    int src;
    if (j < 36) {
      const int lo = min(j / 6, j % 6), hi = max(j / 6, j % 6);
      src = lo * (11 - lo) / 2 + hi;  // upper-triangle index of (lo, hi)
    } else {
      src = 21 + (j - 36);
    }
    out[static_cast<size_t>(b) * kOut + j] = row[src];
  }
  if (threadIdx.x == 0) counter[b] = 0;
}

}  // namespace

// reading, pair_xyz, pair_nrm: [B, N, 3] float32; valid: [B, N] uint8 or
// bool; T: [B, 4, 4] float32 (row-major); tau: [B] float32; partial: a
// [B * nblocks * 32] float32 workspace; counter: [B] int32, zero before the
// call and zero after it; out: [B, 45]. Launches on `stream`, returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pair_gn_launch(const float* reading, const float* pair_xyz,
                              const float* pair_nrm, const uint8_t* valid, const float* T,
                              const float* tau, float max_d2, int B, int N, int nblocks,
                              int tiles_per_block, float* partial, int* counter, float* out,
                              void* stream) {
  if (B == 0) return 0;
  // The ring a block can fill; one stage also holds 128 partial rows.
  const int smem = min(kStages, tiles_per_block) * kStageBytes;
  pair_gn_fused<<<dim3(nblocks, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      reading, pair_xyz, pair_nrm, valid, T, tau, max_d2, B, N, tiles_per_block, partial, counter,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pair_gn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
