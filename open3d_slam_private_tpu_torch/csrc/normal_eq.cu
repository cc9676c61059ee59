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
// What bounds it on an H100: memory. Each pair reads its 12-byte match, its
// 12-byte normal and its 4-byte weight once, each point its 12 bytes once:
// ~124 MB at the knn = 8 detection shape (8 x 65,536 x 8), ~37 us at
// 3.35 TB/s; ~100 operations a pair are far below the FP32 rate.
// Design:
// - The order is fixed by N * K alone: block (c, b) sums the pairs
//   [1024 c, 1024 (c + 1)) of problem b, four a thread at a fixed stride;
//   the 27 sums (21 upper-triangle A, 6 b) are reduced by a warp butterfly
//   and then the warps in order into one partial row; a second kernel, one
//   block a problem and one warp a sum, adds the partial rows in a fixed
//   order (lane l takes rows l, l + 32, ..., then a warp butterfly). No
//   atomics, and no choice that looks at B: a problem's bits are the same
//   in any batch.
// - Partials are float64: each product of two float32 values is exact in
//   float64, so the only roundings are the float64 additions and the final
//   cast to float32 (the result is within an ulp or two of the exact sum,
//   where the float32 einsum carries the error of its own order).
// - A pair of weight 0 is skipped (its term is 0 for finite inputs, as the
//   chain's unmatched slots are).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;  // pairs a block
constexpr int kAcc = 27;                       // 21 upper-triangle A, 6 b
constexpr int kRow = 32;                       // a partial row, padded
constexpr int kOut = 42;                       // full A, b
constexpr int kFinalThreads = 32 * kAcc;       // one warp a slot

// Warp sum of 32 values: a butterfly that halves the values each lane holds
// at every step (16 + 8 + 4 + 2 + 1 shuffles); lane l ends with the sum of
// value l. Each sum is formed by one lane in a fixed order.
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

__global__ void __launch_bounds__(kThreads)
normal_eq_partial(const float* __restrict__ src, const float* __restrict__ ref_xyz,
                  const float* __restrict__ ref_nrm, const float* __restrict__ weights,
                  int n_pairs, int k, double* __restrict__ partial) {
  __shared__ double red[kWarps][kRow];
  const int b = blockIdx.y;
  const size_t pair0 = static_cast<size_t>(b) * n_pairs;
  const size_t point0 = static_cast<size_t>(b) * (n_pairs / k);

  double acc[kRow];
#pragma unroll
  for (int j = 0; j < kRow; ++j) acc[j] = 0.0;

#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int e = blockIdx.x * kChunk + u * kThreads + threadIdx.x;
    if (e >= n_pairs) break;
    const size_t pe = pair0 + e;
    const float w = weights[pe];
    if (w == 0.f) continue;
    const float* p = src + 3 * (point0 + e / k);
    const float px = p[0], py = p[1], pz = p[2];
    const float nx = ref_nrm[3 * pe], ny = ref_nrm[3 * pe + 1], nz = ref_nrm[3 * pe + 2];
    const float dx = __fsub_rn(px, ref_xyz[3 * pe]);
    const float dy = __fsub_rn(py, ref_xyz[3 * pe + 1]);
    const float dz = __fsub_rn(pz, ref_xyz[3 * pe + 2]);
    const float r = __fadd_rn(__fadd_rn(__fmul_rn(dx, nx), __fmul_rn(dy, ny)), __fmul_rn(dz, nz));
    const float c[6] = {__fsub_rn(__fmul_rn(py, nz), __fmul_rn(pz, ny)),
                        __fsub_rn(__fmul_rn(pz, nx), __fmul_rn(px, nz)),
                        __fsub_rn(__fmul_rn(px, ny), __fmul_rn(py, nx)), nx, ny, nz};
    int s = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const double cw = static_cast<double>(__fmul_rn(c[a], w));
#pragma unroll
      for (int q = a; q < 6; ++q) acc[s++] += cw * static_cast<double>(c[q]);
      acc[21 + a] -= cw * static_cast<double>(r);
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  butterfly<16>(acc, lane);
  butterfly<8>(acc, lane);
  butterfly<4>(acc, lane);
  butterfly<2>(acc, lane);
  butterfly<1>(acc, lane);
  red[warp][lane] = acc[0];
  __syncthreads();
  if (threadIdx.x < kAcc) {
    double v = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][threadIdx.x];
    partial[(static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kRow + threadIdx.x] = v;
  }
}

// One block a problem, one warp a slot: lane l adds the chunk partials
// l, l + 32, ... of slot j in chunk order, a butterfly adds the 32 lanes,
// then the block writes the full symmetric A and b. The order is fixed by
// the chunk count.
__global__ void __launch_bounds__(kFinalThreads)
normal_eq_final(const double* __restrict__ partial, int nchunks, float* __restrict__ out) {
  __shared__ float row[kRow];
  const int b = blockIdx.x, lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  if (j < kAcc) {
    const double* p = partial + static_cast<size_t>(b) * nchunks * kRow + j;
    double v = 0.0;
    for (int c = lane; c < nchunks; c += 32) v += p[static_cast<size_t>(c) * kRow];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) row[j] = static_cast<float>(v);
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    const int k = threadIdx.x;
    int from;
    if (k < 36) {
      const int lo = min(k / 6, k % 6), hi = max(k / 6, k % 6);
      from = lo * (11 - lo) / 2 + hi;  // upper-triangle index of (lo, hi)
    } else {
      from = 21 + (k - 36);
    }
    out[static_cast<size_t>(b) * kOut + k] = row[from];
  }
}

}  // namespace

// src: [B, N, 3] float32; ref_xyz, ref_nrm: [B, N, K, 3] float32; weights:
// [B, N, K] float32; partial: [B * nchunks * 32] float64 scratch with
// nchunks = ceil(N * K / 1024); out: [B, 42] float32. Launches on `stream`,
// returns cudaGetLastError() after the launches (0 on success).
extern "C" int normal_eq_launch(const float* src, const float* ref_xyz, const float* ref_nrm,
                                const float* weights, int B, int N, int K, double* partial,
                                float* out, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pairs = N * K;
  const int nchunks = (n_pairs + kChunk - 1) / kChunk;
  if (nchunks > 0) {
    normal_eq_partial<<<dim3(nchunks, B), kThreads, 0, s>>>(src, ref_xyz, ref_nrm, weights,
                                                           n_pairs, K, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  normal_eq_final<<<B, kFinalThreads, 0, s>>>(partial, nchunks, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* normal_eq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
