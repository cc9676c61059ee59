// normal_eq: point-to-plane normal equations summed in an order fixed by the
// problem's own size.
//
// No TPU kernel stands behind it: the JAX package forms these sums in XLA
// (open3d_slam_private_tpu/models/minimizers.py:65-88,
// point_to_plane_normal_equations_bc). The port's plain version is the
// float32 einsum of models/minimizers.py; on the card cuBLAS picks that
// einsum's algorithm and its split of the reduction from the whole shape,
// batch included, so a problem's A and b moved with the batch it ran in.
// Contract, for each problem b over its N x K pairs (point i, slot k):
//   p = src[b, i], q = ref_xyz[b, i, k], n = ref_normals[b, i, k],
//   w = weights[b, i, k]
//   J = [p x n, n]   r = (p - q) . n
// out[b] = A = sum w J J^T as a full symmetric 6x6 (36 floats, row-major),
//          b = -sum w J r (6)                                    (42 floats)
//
// What bounds it on an H100: memory for the wide shapes, the latency of one
// launch for the SLAM step's. Each pair reads its 12-byte match, its 12-byte
// normal and its 4-byte weight, each point its 12 bytes: ~124 MB at the
// knn = 8 detection shape (8 x 65,536 x 8; 81 MB counting only the weighted
// pairs' match and normal), 67-84 MB at the relocalisation burst's 4,096 x
// 512 x 1, 0.1-0.5 MB at the SLAM step's 1 x 4,096 x 1 and 1 x 16,384 x 1.
// The 27 float64 sums take 27 fused multiply-adds a pair, ~8 us at 8 x
// 65,536 x 8 over 132 SMs, under the ~24-37 us of its bytes.
// Design (the plan from P = N K alone, kernels/normal_eq.py ne_plan; the
// order modelled bit for bit by tests/normal_eq_model.py):
// - Pair lanes: lane l of a warp or block adds the pairs l, l + lanes, ...
//   of its range in order, from 0. Its loads for 8 pairs (4 on the
//   two-pass route; weight, point, match, normal: the K lanes of a point
//   read it once, as one broadcast; K a template parameter for 1 and 8, a
//   division otherwise) issue before any of them is added; the 27 sums (21
//   upper-triangle A, 6 b) stay in its registers, with each pair's factors,
//   so the pair loop has no barrier. 27 float64 sums fit one thread's
//   registers, so one lane owns them all. On the two-pass route a batch's
//   weights load first and the match and normal only of a pair of nonzero
//   weight (at the knn = 8 detection shape 42% of the pairs have none,
//   whole points often, whose 24-byte slots then cost no sector); where one
//   launch's latency counts, all loads go at once.
// - Then a halving warp butterfly (lane l ends with sum l of each 32).
// - P <= 512 (the burst's 512-point problems): one warp a problem, 4 a
//   block; lane j writes sum j. One launch.
// - 512 < P <= 16,384: G = min(16, ceil(P / 256)) chunks of ceil(P / G)
//   pairs, one block of 128 lanes each (small blocks spread a problem's
//   sums and butterflies over up to 16 SMs), its 4 warps in order; the G
//   blocks of a problem are one thread block cluster (past 8 the
//   non-portable size; 1 x 16,384 x 1 is 16 blocks of 1,024 pairs, 1 x
//   4,096 x 1 16 of 256), each rank stores its row in rank 0's shared
//   memory and rank 0 adds them in rank order. One launch, no scratch.
// - P > 16,384: chunks of 8,192 pairs, one block of 256 lanes each (32
//   pairs a lane), its 8 warps in order;
//   the chunks' rows go to float64 scratch the wrapper allocates for the
//   call, and a second kernel, one warp a sum, adds them (lane l adds
//   chunks l, l + 32, ... in order, 8 chunks' loads at a time, then a
//   butterfly).
// - No atomics, and no choice that looks at B: a problem's bits are the
//   same in any batch.
// - Partials are float64: each product of two float32 values is exact in
//   float64, so the only roundings are the float64 additions and the final
//   cast to float32 (the result is within an ulp or two of the exact sum,
//   where the float32 einsum carries the error of its own order).
// - A pair of weight 0 is skipped (its term is 0 for finite inputs, as the
//   chain's unmatched slots are).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // a block's pair lanes on the two-pass route
constexpr int kClusterLanes = 128;  // and on the cluster route
constexpr int kWarps = kThreads / 32;
constexpr int kWarpProblems = 4;  // problems a block on the warp route
constexpr int kWarpRoute = 512;   // pairs a problem, at most, on the warp route
constexpr int kMaxCluster = 16;
constexpr int kWarpPerProblem = 0, kCluster = 1, kTwoPass = 2;  // routes
// Pairs a lane loads before it adds them: 8 where one launch's latency
// counts (a lane's pairs in one round trip), 4 on the two-pass route (two
// blocks an SM, so one block's loads overlap the other's sums).
template <int kRoute> struct Batch { static constexpr int kPairs = kRoute == kTwoPass ? 4 : 8; };
constexpr int kAcc = 27;      // 21 upper-triangle A, 6 b
constexpr int kRow = 32;      // a row of sums, padded
constexpr int kOut = 42;      // full A, b
constexpr int kFinalThreads = 32 * kAcc;  // one warp a sum

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// Warp sum of 32 values: a butterfly that halves the values each lane holds
// at every step (16 + 8 + 4 + 2 + 1 shuffles); lane l ends with the sum of
// value l over the 32 lanes, formed as lanes 16 apart, then 8, 4, 2, 1.
template <int kN>
__device__ __forceinline__ void butterfly(double (&v)[kRow], int lane) {
  const bool upper = (lane & kN) != 0;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const double send = upper ? v[j] : v[j + kN];
    const double keep = upper ? v[j + kN] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kN);
  }
}

__device__ __forceinline__ void warp_sums(double (&acc)[kRow], int lane) {
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
}

// Output slot k of the 42 -> sum index.
__device__ __forceinline__ int out_source(int k) {
  if (k < 36) {
    const int lo = min(k / 6, k % 6), hi = max(k / 6, k % 6);
    return lo * (11 - lo) / 2 + hi;  // upper-triangle index of (lo, hi)
  }
  return 21 + (k - 36);
}

struct Inputs {
  const float* src;      // [B, N, 3]
  const float* ref_xyz;  // [B, N, K, 3]
  const float* ref_nrm;  // [B, N, K, 3]
  const float* weights;  // [B, N, K]
  int n_pairs, k;        // N K, K
};

// Slot u of a batch: the point at p and the match and normal of pair pe,
// or zeros where `here` is false.
template <int kBatch>
__device__ __forceinline__ void load_pair(const Inputs& in, const float* p, size_t pe, bool here, int u,
                                          float (&px)[kBatch], float (&py)[kBatch], float (&pz)[kBatch],
                                          float (&qx)[kBatch], float (&qy)[kBatch], float (&qz)[kBatch],
                                          float (&nx)[kBatch], float (&ny)[kBatch], float (&nz)[kBatch]) {
  px[u] = here ? __ldg(p) : 0.f;
  py[u] = here ? __ldg(p + 1) : 0.f;
  pz[u] = here ? __ldg(p + 2) : 0.f;
  qx[u] = here ? __ldg(in.ref_xyz + 3 * pe) : 0.f;
  qy[u] = here ? __ldg(in.ref_xyz + 3 * pe + 1) : 0.f;
  qz[u] = here ? __ldg(in.ref_xyz + 3 * pe + 2) : 0.f;
  nx[u] = here ? __ldg(in.ref_nrm + 3 * pe) : 0.f;
  ny[u] = here ? __ldg(in.ref_nrm + 3 * pe + 1) : 0.f;
  nz[u] = here ? __ldg(in.ref_nrm + 3 * pe + 2) : 0.f;
}

// Lane `lane` of `lanes` adds pairs [first, end) of problem b: pairs
// first + lane, + lanes, ... in order, kBatch at a time (all loads first;
// with kSkip the weights first, then the rest of the pairs of weight != 0).
template <int K, int kBatch, bool kSkip>
__device__ __forceinline__ void add_pairs(const Inputs& in, int b, int first, int end, int lane,
                                          int lanes, double (&acc)[kRow]) {
  const int k = K ? K : in.k;
  const size_t pair0 = static_cast<size_t>(b) * in.n_pairs;
  const size_t point0 = static_cast<size_t>(b) * (in.n_pairs / k);
  for (int e0 = first + lane; e0 < end; e0 += kBatch * lanes) {
    float w[kBatch], px[kBatch], py[kBatch], pz[kBatch], qx[kBatch], qy[kBatch], qz[kBatch],
        nx[kBatch], ny[kBatch], nz[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * lanes;
      const bool here = e < end;
      w[u] = here ? __ldg(in.weights + pair0 + (here ? e : 0)) : 0.f;
      if constexpr (!kSkip)
        load_pair(in, in.src + 3 * (point0 + (here ? e / k : 0)), pair0 + (here ? e : 0), here, u, px, py, pz,
                  qx, qy, qz, nx, ny, nz);
    }
    if constexpr (kSkip) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * lanes;
        const bool here = w[u] != 0.f;  // 0 past `end`
        load_pair(in, in.src + 3 * (point0 + (here ? e / k : 0)), pair0 + (here ? e : 0), here, u, px, py, pz,
                  qx, qy, qz, nx, ny, nz);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (w[u] == 0.f) continue;  // also the pairs past `end`
      const float dx = sub(px[u], qx[u]), dy = sub(py[u], qy[u]), dz = sub(pz[u], qz[u]);
      const float r = add(add(mul(dx, nx[u]), mul(dy, ny[u])), mul(dz, nz[u]));
      const float c[6] = {sub(mul(py[u], nz[u]), mul(pz[u], ny[u])),
                          sub(mul(pz[u], nx[u]), mul(px[u], nz[u])),
                          sub(mul(px[u], ny[u]), mul(py[u], nx[u])), nx[u], ny[u], nz[u]};
      int s = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const double cw = static_cast<double>(mul(c[a], w[u]));
#pragma unroll
        for (int q = a; q < 6; ++q, ++s) acc[s] = __fma_rn(cw, static_cast<double>(c[q]), acc[s]);
        acc[21 + a] = __fma_rn(-cw, static_cast<double>(r), acc[21 + a]);
      }
    }
  }
}

// kWarpPerProblem: block x holds problems 4x .. 4x + 3, one a warp.
// kCluster: grid (G chunks, B problems), the G blocks of a problem one
// cluster. kTwoPass: grid (G chunks, B problems), rows to `partial`.
template <int K, int kRoute>
__global__ void __launch_bounds__(kRoute == kWarpPerProblem ? 32 * kWarpProblems
                                  : kRoute == kCluster              ? kClusterLanes
                                                                    : kThreads,
                                  kRoute == kTwoPass ? 2 : 1)
normal_eq_partial(const Inputs in, int B, int chunk, double* __restrict__ partial,
                  float* __restrict__ out) {
  __shared__ double red[kWarps][kRow];
  __shared__ double rows[kMaxCluster][kRow];  // the ranks' rows, in rank 0's memory
  __shared__ float row[kWarps][kRow];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (kRoute == kCluster) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  double acc[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) acc[j] = 0.0;

  if constexpr (kRoute == kWarpPerProblem) {
    const int b = blockIdx.x * kWarpProblems + warp;
    if (b >= B) return;
    add_pairs<K, Batch<kRoute>::kPairs, false>(in, b, 0, in.n_pairs, lane, 32, acc);
    warp_sums(acc, lane);
    row[warp][lane] = static_cast<float>(acc[0]);
    __syncwarp();
    for (int k = lane; k < kOut; k += 32) out[static_cast<size_t>(b) * kOut + k] = row[warp][out_source(k)];
    return;
  } else {
    constexpr int kLanes = kRoute == kCluster ? kClusterLanes : kThreads;
    const int b = blockIdx.y, g = blockIdx.x;
    const int first = g * chunk, end = min(in.n_pairs, first + chunk);
    add_pairs<K, Batch<kRoute>::kPairs, kRoute == kTwoPass>(in, b, first, end, threadIdx.x, kLanes, acc);
    warp_sums(acc, lane);
    red[warp][lane] = acc[0];
    __syncthreads();
    double v = 0.0;
    if (threadIdx.x < kAcc) {
#pragma unroll
      for (int w = 0; w < kLanes / 32; ++w) v += red[w][threadIdx.x];
    }
    if constexpr (kRoute == kCluster) {
      cg::cluster_group cluster = cg::this_cluster();
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      if (threadIdx.x < kAcc) cluster.map_shared_rank(&rows[0][0], 0)[g * kRow + threadIdx.x] = v;
      cluster.sync();
      if (g != 0) return;
      if (threadIdx.x < kAcc) {
        double total = 0.0;
        for (int r = 0; r < static_cast<int>(gridDim.x); ++r) total += rows[r][threadIdx.x];
        row[0][threadIdx.x] = static_cast<float>(total);
      }
      __syncthreads();
      if (threadIdx.x < kOut) out[static_cast<size_t>(b) * kOut + threadIdx.x] = row[0][out_source(threadIdx.x)];
    } else {
      if (threadIdx.x < kAcc) partial[(static_cast<size_t>(b) * gridDim.x + g) * kRow + threadIdx.x] = v;
    }
  }
}

// Two-pass route: one block a problem, one warp a sum: lane l adds the
// chunk rows l, l + 32, ... of sum j in chunk order (8 rows' loads at a
// time), a butterfly adds the 32 lanes, then the block writes the full
// symmetric A and b.
__global__ void __launch_bounds__(kFinalThreads)
normal_eq_final(const double* __restrict__ partial, int nchunks, float* __restrict__ out) {
  __shared__ float row[kRow];
  const int b = blockIdx.x, lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  if (j < kAcc) {
    const double* p = partial + static_cast<size_t>(b) * nchunks * kRow + j;
    double v = 0.0;
    for (int c0 = lane; c0 < nchunks; c0 += 32 * 8) {
      double t[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) t[u] = c0 + 32 * u < nchunks ? p[static_cast<size_t>(c0 + 32 * u) * kRow] : 0.0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (c0 + 32 * u < nchunks) v += t[u];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) row[j] = static_cast<float>(v);
  }
  __syncthreads();
  if (threadIdx.x < kOut) out[static_cast<size_t>(b) * kOut + threadIdx.x] = row[out_source(threadIdx.x)];
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

template <int K, int kRoute>
cudaError_t launch_partial(const Inputs& in, int B, int G, int chunk, double* partial, float* out,
                           cudaStream_t s) {
  if (kRoute == kWarpPerProblem)
    return launch(normal_eq_partial<K, kRoute>, dim3((B + kWarpProblems - 1) / kWarpProblems),
                  32 * kWarpProblems, 0, s, in, B, chunk, partial, out);
  if (kRoute == kCluster)
    return launch(normal_eq_partial<K, kRoute>, dim3(G, B), kClusterLanes, G, s, in, B, chunk, partial, out);
  return launch(normal_eq_partial<K, kRoute>, dim3(G, B), kThreads, 0, s, in, B, chunk, partial, out);
}

template <int kRoute>
cudaError_t launch_route(const Inputs& in, int B, int G, int chunk, double* partial, float* out,
                         cudaStream_t s) {
  if (in.k == 1) return launch_partial<1, kRoute>(in, B, G, chunk, partial, out, s);
  if (in.k == 8) return launch_partial<8, kRoute>(in, B, G, chunk, partial, out, s);
  return launch_partial<0, kRoute>(in, B, G, chunk, partial, out, s);
}

}  // namespace

// src: [B, N, 3] float32; ref_xyz, ref_nrm: [B, N, K, 3] float32; weights:
// [B, N, K] float32; out: [B, 42] float32. route 0 (one warp a problem, N K
// <= 512), 1 (G <= 16 blocks of `chunk` pairs a problem, one cluster) or 2
// (G blocks of `chunk` pairs, rows through `partial`, [B * G * 32] float64
// scratch, and a second kernel), from kernels/normal_eq.py ne_plan.
// Launches on `stream`, returns cudaGetLastError() after the launches (0 on
// success; 1 for a bad plan).
extern "C" int normal_eq_launch(const float* src, const float* ref_xyz, const float* ref_nrm,
                                const float* weights, int B, int N, int K, int route, int G,
                                int chunk, double* partial, float* out, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = N * K;
  if (K < 1 || B > 65535 || G < 1 || chunk < 1 || static_cast<long long>(G) * chunk < P ||
      (route == kWarpPerProblem && P > kWarpRoute) || (route == kCluster && G > kMaxCluster) ||
      (route == kTwoPass && partial == nullptr) || route < 0 || route > kTwoPass)
    return 1;
  const Inputs in{src, ref_xyz, ref_nrm, weights, P, K};
  cudaError_t err;
  if (route == kWarpPerProblem) {
    err = launch_route<kWarpPerProblem>(in, B, G, chunk, partial, out, s);
  } else if (route == kCluster) {
    err = launch_route<kCluster>(in, B, G, chunk, partial, out, s);
  } else {
    err = launch_route<kTwoPass>(in, B, G, chunk, partial, out, s);
    if (err == cudaSuccess)
      err = launch(normal_eq_final, dim3(B), kFinalThreads, 0, s, static_cast<const double*>(partial), G, out);
  }
  return static_cast<int>(err);
}

extern "C" const char* normal_eq_error_string(int code) {
  if (code == 1) return "normal_eq: bad plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
