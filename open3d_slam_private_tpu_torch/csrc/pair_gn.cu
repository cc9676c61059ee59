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
// latency of one launch. Each point streams 37 bytes (reading, pair and
// normal xyz, one valid byte) for ~100 flops: 0.6 MB at 1 x 16,384 (0.18 us
// at 3.35 TB/s, below the ~0.8 us a launch costs inside a CUDA graph), 19.4
// MB at 8 x 65,536 (5.8 us). At 1 x 16,384 the time is a chain of dependent
// steps (launch, loads, sums, reductions), so the design removes every one
// it can.
// Design (the plan from N alone, kernels/pair_gn.py k1_plan; the order
// modelled bit for bit by tests/pair_gn_model.py):
// - A problem's points are cut into tiles of one point a thread of a block
//   (256 up to 16,384 points, 512 beyond) and its tiles into G chunks of at
//   most 4 tiles, one block a chunk. Thread t adds point t of each of its
//   block's tiles, in tile order, in registers; it issues the loads of all
//   its points (three floats of each xyz, the valid byte) before it adds
//   any, so a block's loads are in flight at once. (Staging the tiles
//   through shared memory with cp.async measured slower at 1 x 16,384.)
// - Then a halving warp butterfly (lane l ends with sum l of the 30), the
//   block's warps in order, and the chunks in order.
// - N <= 16,384 (at most 16 chunks): the G blocks of a problem are one
//   thread block cluster (more than 8 with the non-portable size opted in:
//   1 x 16,384 is 16 blocks of 4 tiles of 256, 1 x 4,096 16 blocks of 1).
//   Small blocks spread a problem's sums and butterflies over 16 SMs. Each
//   rank stores its row into rank 0's shared memory (distributed shared
//   memory), one cluster barrier, and rank 0 adds the rows in rank order
//   and writes the output: one launch, no global scratch, no fence, no
//   atomic.
// - N > 16,384: 512-thread blocks; the chunks' rows go to a [B, G, 32]
//   scratch that the wrapper allocates for the call, and a second kernel
//   adds them in chunk order (at 8 x 65,536: 256 blocks of 4 tiles, ~2 an
//   SM).
// - Nothing outlives a call: a CUDA graph that holds a call holds only its
//   own inputs, output and scratch.
// - Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
//   FMA contraction): the weight and count of every point equal the plain
//   version's, the weight and count sums are exact, and the numpy model
//   gives the kernel's bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Threads a block, one a point of a tile: 256 on the cluster route, 512
// beyond.
template <bool kCluster> struct Block { static constexpr int kThreads = kCluster ? 256 : 512; };
constexpr int kMaxTiles = 4;    // tiles a block
constexpr int kMaxCluster = 16;  // blocks a cluster (non-portable past 8)
constexpr int kAcc = 30;        // 21 upper-triangle A, 6 b, sum w, sum w r^2, n ok
constexpr int kOut = 45;        // full A, b, sum w, sum w r^2, n ok

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Warp sum of 32 values: a butterfly that halves the values each lane holds
// at every step (16 + 8 + 4 + 2 + 1 shuffles); lane l ends with the sum of
// value l over the 32 lanes, formed as lanes 16 apart, then 8, 4, 2, 1.
template <int kN>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & kN) != 0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float send = upper ? v[j] : v[j + kN];
    const float keep = upper ? v[j + kN] : v[j];
    v[j] = add(keep, __shfl_xor_sync(0xffffffffu, send, kN));
  }
}

// Output slot k of the 45 -> accumulator index.
__device__ __forceinline__ int out_source(int k) {
  if (k < 36) {
    const int lo = min(k / 6, k % 6), hi = max(k / 6, k % 6);
    return lo * (11 - lo) / 2 + hi;  // upper-triangle index of (lo, hi)
  }
  return 21 + (k - 36);
}

// Grid (G chunks, B problems); with kCluster the G blocks of a problem are
// one cluster, else each writes its row to partial [B, G, 32].
template <bool kCluster>
__global__ void __launch_bounds__(Block<kCluster>::kThreads)
pair_gn_fused(const float* __restrict__ reading, const float* __restrict__ pair_xyz,
              const float* __restrict__ pair_nrm, const uint8_t* __restrict__ valid,
              const float* __restrict__ T, const float* __restrict__ tau, float max_d2, int n,
              int tiles_per_block, float* __restrict__ partial, float* __restrict__ out) {
  constexpr int kTile = Block<kCluster>::kThreads, kWarps = kTile / 32;
  __shared__ float red[kWarps][32];
  __shared__ float rows[kMaxCluster][32];  // the ranks' rows, in rank 0's memory
  __shared__ float row[32];

  // Cluster route: rank 0's shared memory takes the other ranks' rows, so
  // every rank must have started before any stores there; this barrier
  // phase's wait sits just before the stores.
  if constexpr (kCluster) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int b = blockIdx.y, g = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * n;
  const int tiles = (n + kTile - 1) / kTile;
  const int tile0 = g * tiles_per_block;
  const int count_tiles = min(tiles_per_block, tiles - tile0);

  // This thread's points, all loads first.
  float px[kMaxTiles], py[kMaxTiles], pz[kMaxTiles], qx[kMaxTiles], qy[kMaxTiles], qz[kMaxTiles];
  float nx[kMaxTiles], ny[kMaxTiles], nz[kMaxTiles];
  bool on[kMaxTiles];
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    const int i = (tile0 + k) * kTile + threadIdx.x;
    const bool here = k < count_tiles && i < n;
    const size_t e = base + (here ? i : 0);
    px[k] = here ? __ldg(reading + 3 * e) : 0.f;
    py[k] = here ? __ldg(reading + 3 * e + 1) : 0.f;
    pz[k] = here ? __ldg(reading + 3 * e + 2) : 0.f;
    qx[k] = here ? __ldg(pair_xyz + 3 * e) : 0.f;
    qy[k] = here ? __ldg(pair_xyz + 3 * e + 1) : 0.f;
    qz[k] = here ? __ldg(pair_xyz + 3 * e + 2) : 0.f;
    nx[k] = here ? __ldg(pair_nrm + 3 * e) : 0.f;
    ny[k] = here ? __ldg(pair_nrm + 3 * e + 1) : 0.f;
    nz[k] = here ? __ldg(pair_nrm + 3 * e + 2) : 0.f;
    on[k] = here && __ldg(valid + e) != 0;
  }
  const float* t = T + 16 * b;
  const float t00 = t[0], t01 = t[1], t02 = t[2], t03 = t[3];
  const float t10 = t[4], t11 = t[5], t12 = t[6], t13 = t[7];
  const float t20 = t[8], t21 = t[9], t22 = t[10], t23 = t[11];
  const float tau_b = tau[b];

  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxTiles; ++k) {
    if (k >= count_tiles) break;
    const float x = px[k], y = py[k], z = pz[k];
    const float sx = add(add(add(mul(t00, x), mul(t01, y)), mul(t02, z)), t03);
    const float sy = add(add(add(mul(t10, x), mul(t11, y)), mul(t12, z)), t13);
    const float sz = add(add(add(mul(t20, x), mul(t21, y)), mul(t22, z)), t23);
    const float dx = sub(sx, qx[k]), dy = sub(sy, qy[k]), dz = sub(sz, qz[k]);
    const float d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
    if (!(on[k] && d2 <= max_d2)) continue;
    acc[29] = add(acc[29], 1.f);
    if (!(d2 <= tau_b)) continue;
    const float r = add(add(mul(dx, nx[k]), mul(dy, ny[k])), mul(dz, nz[k]));
    const float c[6] = {sub(mul(sy, nz[k]), mul(sz, ny[k])), sub(mul(sz, nx[k]), mul(sx, nz[k])),
                        sub(mul(sx, ny[k]), mul(sy, nx[k])), nx[k], ny[k], nz[k]};
    int s = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int e = a; e < 6; ++e, ++s) acc[s] = add(acc[s], mul(c[a], c[e]));
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) acc[21 + a] = sub(acc[21 + a], mul(c[a], r));
    acc[27] = add(acc[27], 1.f);
    acc[28] = add(acc[28], mul(r, r));
  }

  // The block's row: warp butterflies, then the warps in order.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
  red[warp][lane] = acc[0];
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < kAcc) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v = add(v, red[w][threadIdx.x]);
  }
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    if (threadIdx.x < kAcc) cluster.map_shared_rank(&rows[0][0], 0)[g * 32 + threadIdx.x] = v;
    cluster.sync();
    if (g != 0) return;
    if (threadIdx.x < kAcc) {
      float total = 0.f;
      for (int r = 0; r < static_cast<int>(gridDim.x); ++r) total = add(total, rows[r][threadIdx.x]);
      row[threadIdx.x] = total;
    }
    __syncthreads();
    if (threadIdx.x < kOut) out[static_cast<size_t>(b) * kOut + threadIdx.x] = row[out_source(threadIdx.x)];
  } else {
    if (threadIdx.x < kAcc) partial[(static_cast<size_t>(b) * gridDim.x + g) * 32 + threadIdx.x] = v;
  }
}

// Beyond one cluster: problem blockIdx.x; thread j adds sum j of the G
// chunks' rows in chunk order (8 rows' loads at a time), then the block
// writes the 45 outputs.
__global__ void __launch_bounds__(64)
pair_gn_final(const float* __restrict__ partial, int G, float* __restrict__ out) {
  __shared__ float row[32];
  const int b = blockIdx.x, j = threadIdx.x;
  if (j < kAcc) {
    const float* p = partial + static_cast<size_t>(b) * G * 32 + j;
    float total = 0.f;
    for (int c0 = 0; c0 < G; c0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = c0 + u < G ? p[static_cast<size_t>(c0 + u) * 32] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + u < G) total = add(total, v[u]);
    }
    row[j] = total;
  }
  __syncthreads();
  if (j < kOut) out[static_cast<size_t>(b) * kOut + j] = row[out_source(j)];
}

// A launch on `s`, with a thread block cluster of `cluster` blocks along x
// when it is not 0.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kernel)(Params...), dim3 grid, int threads, int cluster, cudaStream_t s,
                   Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (cluster) {
    if (cluster > 8) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace

// reading, pair_xyz, pair_nrm: [B, N, 3] float32; valid: [B, N] uint8 or
// bool; T: [B, 4, 4] float32 (row-major); tau: [B] float32; out: [B, 45].
// G chunks of tiles_per_block tiles of 256 points (cluster != 0) or 512
// (kernels/pair_gn.py k1_plan);
// cluster != 0: one launch, G <= 16 blocks a cluster, partial unused; else
// partial is [B * G * 32] float32 scratch and a second kernel adds the
// chunks. Launches on `stream`, returns cudaGetLastError() after the
// launches (0 on success; 1 for a bad plan).
extern "C" int pair_gn_launch(const float* reading, const float* pair_xyz,
                              const float* pair_nrm, const uint8_t* valid, const float* T,
                              const float* tau, float max_d2, int B, int N, int G,
                              int tiles_per_block, int cluster, float* partial, float* out,
                              void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tile = cluster ? Block<true>::kThreads : Block<false>::kThreads;
  const int tiles = (N + tile - 1) / tile;
  if (G < 1 || tiles_per_block < 1 || tiles_per_block > kMaxTiles || B > 65535 ||
      static_cast<long long>(G) * tiles_per_block < tiles || (cluster && G > kMaxCluster) ||
      (!cluster && partial == nullptr))
    return 1;
  cudaError_t err;
  if (cluster) {
    err = launch(pair_gn_fused<true>, dim3(G, B), Block<true>::kThreads, G, s, reading, pair_xyz, pair_nrm, valid, T,
                 tau, max_d2, N, tiles_per_block, partial, out);
  } else {
    err = launch(pair_gn_fused<false>, dim3(G, B), Block<false>::kThreads, 0, s, reading, pair_xyz, pair_nrm, valid, T,
                 tau, max_d2, N, tiles_per_block, partial, out);
    if (err == cudaSuccess) err = launch(pair_gn_final, dim3(B), 64, 0, s, static_cast<const float*>(partial), G, out);
  }
  return static_cast<int>(err);
}

extern "C" const char* pair_gn_error_string(int code) {
  if (code == 1) return "pair_gn: bad plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
