// moments: sums over each problem's pairs in an order fixed by the problem's
// own size, in float64 partials.
//
// No TPU kernel stands behind it: the JAX package forms these sums with XLA
// einsums (open3d_slam_private_tpu/models/minimizers.py:179-205,
// point_to_plane_moments; :255-297, gicp_moments) and elementwise sums
// (models/localizability.py:159-160,175, the X-ICP analysis). On the card the
// port's einsums would let cuBLAS pick the algorithm and the split of the
// reduction from the whole shape, batch included; here a problem's sums
// never look at B. Two entries, float32 in, float32 [B, S] out:
//
//   Structured (moments_partial + moments_final), for each problem b over
//   its P pairs. Each of its sums is an entry of sum_pairs a(p) b(p)^T:
//   kP2pl (S = 131): inputs p0, q, n [B, P, 3], w [B, P]; s = n . q,
//     a = [1, p0, p0 p0^T] (13), b = [w n n^T, w s n, w s^2, w] (14):
//     N2[f,g,c,h] = sum w p0_f p0_g n_c n_h   (81)   N1[f,c,h] = sum w p0_f n_c n_h (27)
//     N0[c,h] = sum w n_c n_h (9)   Q1[f,c] = sum w s p0_f n_c (9)
//     Q0[c] = sum w s n_c (3)   Q2 = sum w s^2   n0 = sum w
//   kGicp (S = 147): adds the rotated reading normals ns [B, P, 3]; with
//     M = w (2 I - k (n n^T + ns ns^T))^-1 (k = 1 - epsilon, the closed-form
//     adjugate inverse) and Mq = M q,
//     a = [1, p0, p0 p0^T, |p0|^2] (14), b = [M, Mq, w, w q, w |q|^2] (17):
//     S0 = sum M (9)   S1[d] = sum p0_d M (27)   S2[d,e] = sum p0_d p0_e M (81)
//     Y0 = sum Mq (3)   Y1[d,a] = sum p0_d Mq_a (9)   n0 = sum w
//     n1 = sum w p0 (3)   nq = sum w q (3)   npp = sum w |p0|^2   nqq = sum w |q|^2
//     C[a,b] = sum w q_a p0_b (9)
//   Raw (moments_raw, + moments_raw_final beyond one launch's reach): groups
//     of terms [B, P, S_g], passed by pointer; out[b, col_g + j] = sum over
//     pairs of term j of group g (the X-ICP analysis's contribution sums and
//     constrained re-solves, GICP's per-iteration normal equations).
//
// What bounds it on an H100: memory for the structured inputs (40 B a pair
// for kP2pl, 52 B for kGicp), and float64 issue close behind (131-147
// fused multiply-adds a pair plus its factors). The raw entry on the SLAM
// step reads 49-197 KB a group: a launch's latency bounds it.
//
// Design, structured:
// - Block (c, b) sums the pairs [4096 c, 4096 (c + 1)) of problem b. Its
//   warps form two groups of four; a group owns
//   a fixed set of sums (rectangles of a-rows x b-columns, rect_of), and its
//   128 lanes take pairs: lane l reads pairs l, l + 128, ... and forms their
//   factors a, b in registers (the inputs of the next 1-2 pairs load while
//   it adds), then adds a_r * b_c into each of its sums with one float64
//   fused multiply-add. No shared memory and no barrier in the pair loop.
// - Then a halving warp butterfly (lane l ends with sum l of each 32) and the
//   group's four warps in order give the chunk's partial row; a second
//   kernel, one warp a sum, adds the chunk partials: lane l adds chunks l,
//   l + 32, ... in order, then a butterfly adds the 32 lanes. No atomics, no
//   choice that looks at B.
// Design, raw (the order fixed by P alone, and a column's bits by P alone:
// not by S, its group or its position; tests/moments_model.py models it):
// - P <= 16,384: G = min(8, ceil(P / 512)) chunks of CH = ceil(P / G) pairs
//   (kernels/moments.py raw_plan), one block each, the G blocks of a
//   (problem, window) one thread block cluster: one launch. P > 16,384: G =
//   ceil(P / 2048), the chunks' totals through float64 scratch and a second
//   kernel.
// - In a chunk, 256 pair lanes: lane l adds the pairs l, l + 256, ... of
//   the chunk in order, starting from 0. Lanes 32h .. 32h + 31 are added as
//   an xor butterfly would (16, 8, 4, 2, 1 apart), the 8 groups h in order,
//   then the chunks in order, and the total is rounded once to float32.
// - A block takes a window of W <= 16 columns of one group (W a power of
//   two): thread t holds the slots t + 256 m (m < W) of the flat [256 pairs
//   x W] tile, i.e. column t % W of lanes (t + 256 m) / W, so a warp reads
//   consecutive words; it loads 4 tiles (2 for W > 4) before it adds them.
//   The slots pass through shared memory (column-major, padded) once, after
//   the pair loop, where one thread a 32-lane group forms its tree; the
//   chunks' totals meet in rank 0's shared memory (the cluster's
//   distributed shared memory), read in rank order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kP2pl = 0, kGicp = 1;
constexpr int kMaxSums = 160;  // a partial row
constexpr int kFinalWarps = 8;

// ---------------------------------------------------------------------------
// Structured entries.
// ---------------------------------------------------------------------------

constexpr int kPairChunk = 4096;  // pairs a block
constexpr int kGroups = 2;  // sum groups a block
constexpr int kGroupWarps = 4;
constexpr int kGroupLanes = 32 * kGroupWarps;  // pair lanes of a sum group
constexpr int kRedRow = 96;                    // a warp's sums, padded to 32s

template <int Kind> struct Spec;
// kPrefetch: pairs whose inputs load ahead of the one a lane adds (GICP's
// registers leave room for one).
template <> struct Spec<kP2pl> { static constexpr int kIn = 10, kSums = 131, kPrefetch = 2; };
template <> struct Spec<kGicp> { static constexpr int kIn = 13, kSums = 147, kPrefetch = 1; };

struct Rect { int r0, r1, c0, c1; };

// Sum group `group`'s k-th rectangle of a-rows [r0, r1) x b-columns [c0, c1),
// in accumulator order (row-major); empty past the last.
__host__ __device__ constexpr Rect rect_of(int kind, int group, int k) {
  if (kind == kP2pl) {
    if (group == 0) return k == 0 ? Rect{0, 13, 0, 5} : Rect{0, 0, 0, 0};
    switch (k) {
      case 0: return Rect{0, 13, 5, 9};   // w n n^T, entries 5..8
      case 1: return Rect{0, 4, 9, 12};   // w s n
      case 2: return Rect{0, 1, 12, 14};  // w s^2, w
      default: return Rect{0, 0, 0, 0};
    }
  }
  if (group == 0) return k == 0 ? Rect{0, 13, 0, 6} : Rect{0, 0, 0, 0};  // M 0..5
  switch (k) {
    case 0: return Rect{0, 13, 6, 9};     // M 6..8
    case 1: return Rect{0, 4, 9, 13};     // Mq, w
    case 2: return Rect{13, 14, 12, 13};  // w |p0|^2
    case 3: return Rect{0, 4, 13, 16};    // w q
    case 4: return Rect{0, 1, 16, 17};    // w |q|^2
    default: return Rect{0, 0, 0, 0};
  }
}

__host__ __device__ constexpr int group_sums(int kind, int group) {
  int n = 0;
  for (int k = 0;; ++k) {
    const Rect R = rect_of(kind, group, k);
    if (R.r1 <= R.r0) return n;
    n += (R.r1 - R.r0) * (R.c1 - R.c0);
  }
}

static_assert(group_sums(kP2pl, 0) + group_sums(kP2pl, 1) == 131, "point-to-plane sums");
static_assert(group_sums(kGicp, 0) + group_sums(kGicp, 1) == 147, "GICP sums");

// The output slot (minimizers.P2PL_LAYOUT / GICP_LAYOUT order) of a-row r x
// b-column c.
__device__ int sum_index(int kind, int r, int c) {
  if (kind == kP2pl) {
    if (c < 9) return r >= 4 ? 9 * (r - 4) + c : r >= 1 ? 81 + 9 * (r - 1) + c : 108 + c;
    if (c < 12) return r >= 1 ? 117 + 3 * (r - 1) + (c - 9) : 126 + (c - 9);
    return c == 12 ? 129 : 130;
  }
  if (c < 9) return r == 0 ? c : r < 4 ? 9 + 9 * (r - 1) + c : 36 + 9 * (r - 4) + c;
  if (c < 12) return r == 0 ? 117 + (c - 9) : 120 + 3 * (r - 1) + (c - 9);
  if (c == 12) return r == 0 ? 129 : r < 4 ? 130 + (r - 1) : 136;
  if (c < 16) return r == 0 ? 133 + (c - 13) : 138 + 3 * (c - 13) + (r - 1);
  return 137;
}

__device__ int group_slot(int kind, int group, int i) {
  for (int k = 0;; ++k) {
    const Rect R = rect_of(kind, group, k);
    const int w = R.c1 - R.c0, n = (R.r1 - R.r0) * w;
    if (i < n) return sum_index(kind, R.r0 + i / w, R.c0 + i % w);
    i -= n;
  }
}

template <int Kind, int Group, int K, int Base, int N>
__device__ __forceinline__ void accumulate(const double (&a)[14], const double (&bf)[17],
                                           double (&acc)[N]) {
  constexpr Rect R = rect_of(Kind, Group, K);
  if constexpr (R.r1 > R.r0) {
#pragma unroll
    for (int r = R.r0; r < R.r1; ++r)
#pragma unroll
      for (int c = R.c0; c < R.c1; ++c) {
        double& s = acc[Base + (r - R.r0) * (R.c1 - R.c0) + (c - R.c0)];
        s = fma(a[r], bf[c], s);
      }
    accumulate<Kind, Group, K + 1, Base + (R.r1 - R.r0) * (R.c1 - R.c0)>(a, bf, acc);
  }
}

// One pair's inputs: p0 (0..2), q (3..5), n (6..8), w (9), ns (10..12).
template <int Kind>
__device__ __forceinline__ void load_pair(const float* __restrict__ p0, const float* __restrict__ q,
                                          const float* __restrict__ n, const float* __restrict__ ns,
                                          const float* __restrict__ w, size_t e,
                                          float (&x)[Spec<Kind>::kIn]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = __ldg(p0 + 3 * e + i);
    x[3 + i] = __ldg(q + 3 * e + i);
    x[6 + i] = __ldg(n + 3 * e + i);
    if constexpr (Kind == kGicp) x[10 + i] = __ldg(ns + 3 * e + i);
  }
  x[9] = __ldg(w + e);
}

// The factors a (rows) and b (columns) of one pair, in float64.
template <int Kind>
__device__ __forceinline__ void factors(const float (&x)[Spec<Kind>::kIn], double k, double (&a)[14],
                                        double (&bf)[17]) {
  const double p[3] = {x[0], x[1], x[2]};
  const double q[3] = {x[3], x[4], x[5]};
  const double nn[3] = {x[6], x[7], x[8]};
  const double w = x[9];
  a[0] = 1.0;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    a[1 + f] = p[f];
#pragma unroll
    for (int g = 0; g < 3; ++g) a[4 + 3 * f + g] = p[f] * p[g];
  }
  a[13] = p[0] * p[0] + p[1] * p[1] + p[2] * p[2];
  if constexpr (Kind == kP2pl) {
    const double s = nn[0] * q[0] + nn[1] * q[1] + nn[2] * q[2];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double wn = w * nn[c];
#pragma unroll
      for (int h = 0; h < 3; ++h) bf[3 * c + h] = wn * nn[h];
      bf[9 + c] = w * s * nn[c];
    }
    bf[12] = w * s * s;
    bf[13] = w;
    bf[14] = bf[15] = bf[16] = 0.0;
  } else {
    const double ns[3] = {x[10], x[11], x[12]};
    double S[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) S[i][j] = (i == j ? 2.0 : 0.0) - k * (nn[i] * nn[j] + ns[i] * ns[j]);
    // Adjugate over determinant, as the plain version's _inv3x3.
    const double A_ = S[1][1] * S[2][2] - S[1][2] * S[2][1];
    const double B_ = -(S[1][0] * S[2][2] - S[1][2] * S[2][0]);
    const double C_ = S[1][0] * S[2][1] - S[1][1] * S[2][0];
    const double det = S[0][0] * A_ + S[0][1] * B_ + S[0][2] * C_;
    // 1 / det by the hardware's approximation and two Newton steps (a
    // float64 division expands to a slow path several times as long).
    const double den = fabs(det) > 1e-20 ? det : 1.0;
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(den));
    double e = fma(-den, r, 1.0);
    r = fma(r, e, r);
    e = fma(-den, r, 1.0);
    r = fma(r, e, r);
    const double inv = w * r;
    const double M[9] = {
        A_ * inv,
        -(S[0][1] * S[2][2] - S[0][2] * S[2][1]) * inv,
        (S[0][1] * S[1][2] - S[0][2] * S[1][1]) * inv,
        B_ * inv,
        (S[0][0] * S[2][2] - S[0][2] * S[2][0]) * inv,
        -(S[0][0] * S[1][2] - S[0][2] * S[1][0]) * inv,
        C_ * inv,
        -(S[0][0] * S[2][1] - S[0][1] * S[2][0]) * inv,
        (S[0][0] * S[1][1] - S[0][1] * S[1][0]) * inv,
    };
#pragma unroll
    for (int i = 0; i < 9; ++i) bf[i] = M[i];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      bf[9 + d] = M[3 * d] * q[0] + M[3 * d + 1] * q[1] + M[3 * d + 2] * q[2];
      bf[13 + d] = w * q[d];
    }
    bf[12] = w;
    bf[16] = w * (q[0] * q[0] + q[1] * q[1] + q[2] * q[2]);
  }
}

// Warp sum of N values a lane: per 32 values, a butterfly that halves the
// values each lane holds at every step (16 + 8 + 4 + 2 + 1 shuffles); lane l
// ends with the sum of value 32 i + l, stored to dst.
template <int kHalf>
__device__ __forceinline__ void halve(double (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const double send = upper ? v[j] : v[j + kHalf];
    const double keep = upper ? v[j + kHalf] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
}

template <int N>
__device__ __forceinline__ void warp_sums(const double (&acc)[N], int lane, double* dst) {
#pragma unroll
  for (int base = 0; base < N; base += 32) {
    double v[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = base + j < N ? acc[base + j] : 0.0;
    halve<16>(v, lane);
    halve<8>(v, lane);
    halve<4>(v, lane);
    halve<2>(v, lane);
    halve<1>(v, lane);
    if (base + lane < N) dst[base + lane] = v[0];
  }
}

template <int Kind, int Group>
__device__ __forceinline__ void group_pairs(const float* __restrict__ p0, const float* __restrict__ q,
                                            const float* __restrict__ n, const float* __restrict__ ns,
                                            const float* __restrict__ w, size_t pair0, int first,
                                            int end, int lane_g, double k, double* red_row) {
  constexpr int kN = group_sums(Kind, Group), kPrefetch = Spec<Kind>::kPrefetch;
  double acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) acc[i] = 0.0;
  // buf[d]: the inputs of the pair d steps ahead.
  float buf[kPrefetch + 1][Spec<Kind>::kIn];
  const int e0 = first + lane_g;
#pragma unroll
  for (int d = 0; d < kPrefetch; ++d)
    if (e0 + d * kGroupLanes < end) load_pair<Kind>(p0, q, n, ns, w, pair0 + e0 + d * kGroupLanes, buf[d]);
  for (int e = e0; e < end; e += kGroupLanes) {
    const int ahead = e + kPrefetch * kGroupLanes;
    if (ahead < end) load_pair<Kind>(p0, q, n, ns, w, pair0 + ahead, buf[kPrefetch]);
    double a[14], bf[17];
    factors<Kind>(buf[0], k, a, bf);
    accumulate<Kind, Group, 0, 0>(a, bf, acc);
#pragma unroll
    for (int d = 0; d < kPrefetch; ++d)
#pragma unroll
      for (int i = 0; i < Spec<Kind>::kIn; ++i) buf[d][i] = buf[d + 1][i];
  }
  warp_sums<kN>(acc, threadIdx.x & 31, red_row);
}

template <int Kind>
__global__ void __launch_bounds__(kGroupLanes * kGroups, 1)
moments_partial(const float* __restrict__ p0, const float* __restrict__ q,
                const float* __restrict__ n, const float* __restrict__ ns,
                const float* __restrict__ w, int P, double k, double* __restrict__ partial) {
  constexpr int kWarps = kGroupWarps * kGroups;
  __shared__ double red[kWarps * kRedRow];
  const int b = blockIdx.y, warp = threadIdx.x >> 5;
  const int group = threadIdx.x / kGroupLanes, lane_g = threadIdx.x % kGroupLanes;
  const size_t pair0 = static_cast<size_t>(b) * P;
  const int first = blockIdx.x * kPairChunk, end = min(P, first + kPairChunk);
  double* row = red + warp * kRedRow;
  if (group == 0)
    group_pairs<Kind, 0>(p0, q, n, ns, w, pair0, first, end, lane_g, k, row);
  else
    group_pairs<Kind, 1>(p0, q, n, ns, w, pair0, first, end, lane_g, k, row);
  __syncthreads();
  // The chunk's partial row: each sum over its group's warps in order.
  double* out = partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kMaxSums;
  for (int t = threadIdx.x; t < Spec<Kind>::kSums; t += blockDim.x) {
    int g = 0, i = t;
    while (i >= group_sums(Kind, g)) i -= group_sums(Kind, g++);
    const double* r = red + g * kGroupWarps * kRedRow + i;
    double v = r[0];
#pragma unroll
    for (int j = 1; j < kGroupWarps; ++j) v += r[j * kRedRow];
    out[group_slot(Kind, g, i)] = v;
  }
}

// Sum j of problem blockIdx.x, by warp j - 8 blockIdx.y of block
// (blockIdx.x, blockIdx.y): lane l adds the chunk partials l, l + 32, ...
// in order, then a butterfly adds the 32 lanes.
__global__ void __launch_bounds__(32 * kFinalWarps)
moments_final(const double* __restrict__ partial, int nchunks, int S, float* __restrict__ out) {
  const int b = blockIdx.x, lane = threadIdx.x & 31, j = blockIdx.y * kFinalWarps + (threadIdx.x >> 5);
  if (j >= S) return;
  const double* p = partial + static_cast<size_t>(b) * nchunks * kMaxSums + j;
  double v = 0.0;
  for (int c = lane; c < nchunks; c += 32) v += p[static_cast<size_t>(c) * kMaxSums];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) out[static_cast<size_t>(b) * S + j] = static_cast<float>(v);
}

// ---------------------------------------------------------------------------
// Raw entry.
// ---------------------------------------------------------------------------

constexpr int kRawLanes = 256;  // pair lanes of a chunk
constexpr int kRawGroups = kRawLanes / 32;  // butterflies of 32 lanes a chunk
constexpr int kRawWidth = 16;  // columns a window, at most
// A column's lanes in shared memory, one pad after every 32 (odd stride).
constexpr int kRedStride = kRawLanes + kRawGroups + 1;
constexpr int kMaxWindows = 32;
constexpr int kClusterChunks = 8;  // chunks a problem on the one-launch route, at most

// kTiles: 256-pair tiles a thread loads before it adds them.
template <int kWidth> struct RawShape;
template <> struct RawShape<4> { static constexpr int kTiles = 4; };
template <> struct RawShape<kRawWidth> { static constexpr int kTiles = 2; };

struct RawWindow {
  const float* terms;  // the group's [B, P, S]
  int S, j0, end, lw;  // its columns, the window's first and end, log2 of its width
  int col;             // the output column of the window's first
};
struct RawWindows {
  RawWindow w[kMaxWindows];
};

// Cluster route: chunk x, window y, problem z, a cluster of the G chunks;
// two-pass route: window x, chunk y, problem z (the windows of a chunk
// side by side: they read the same rows).
template <bool kCluster, int kWidth>
__global__ void __launch_bounds__(kRawLanes)
moments_raw(const __grid_constant__ RawWindows ws, int P, int G, int CH, int Stot,
            double* __restrict__ partial, float* __restrict__ out) {
  constexpr int kTiles = RawShape<kWidth>::kTiles;
  __shared__ double red[kWidth * kRedStride];
  __shared__ double gtot[kWidth * kRawGroups];
  __shared__ double ctot[kWidth];
  const int wi = kCluster ? blockIdx.y : blockIdx.x, g = kCluster ? blockIdx.x : blockIdx.y;
  const RawWindow& win = ws.w[wi];
  const int S = win.S, j0 = win.j0, jend = win.end, lw = win.lw, col = win.col;
  const int b = blockIdx.z, t = threadIdx.x;
  const int W = 1 << lw, c = t & (W - 1);
  const bool col_ok = j0 + c < jend;
  const int first = g * CH, end = min(P, first + CH);
  // Slot m: lane (t + 256 m) / W of column c; its pairs lie S * 256 apart.
  const float* __restrict__ src = win.terms + static_cast<size_t>(b) * P * S + static_cast<size_t>(first) * S + j0 + c;
  int lane[kWidth];
#pragma unroll
  for (int m = 0; m < kWidth; ++m) lane[m] = (t + kRawLanes * m) >> lw;
  double acc[kWidth];
#pragma unroll
  for (int m = 0; m < kWidth; ++m) acc[m] = 0.0;
  for (int pair = 0; first + pair < end; pair += kTiles * kRawLanes) {
    float v[kTiles][kWidth];
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int m = 0; m < kWidth; ++m) {
        const int p = pair + i * kRawLanes + lane[m];
        v[i][m] = (m < W && col_ok && first + p < end) ? __ldg(src + p * S) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < kTiles; ++i)
#pragma unroll
      for (int m = 0; m < kWidth; ++m)
        if (m < W && col_ok && first + pair + i * kRawLanes + lane[m] < end) acc[m] += static_cast<double>(v[i][m]);
  }
#pragma unroll
  for (int m = 0; m < kWidth; ++m)
    if (m < W) red[c * kRedStride + lane[m] + (lane[m] >> 5)] = acc[m];
  __syncthreads();
  // Lane tree: thread (column cc, group h) adds lanes x < off and x + off
  // of lanes 32h .. 32h + 31, off = 16, 8, 4, 2, 1 (an xor butterfly's
  // order); then the chunk's 8 groups in order.
  if (t < W * kRawGroups) {
    const int h = t % kRawGroups, cc = t / kRawGroups;
    const double* r = red + cc * kRedStride + 33 * h;
    double v[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) v[x] = r[x] + r[x + 16];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
#pragma unroll
      for (int x = 0; x < off; ++x) v[x] += v[x + off];
    gtot[cc * kRawGroups + h] = v[0];
  }
  __syncthreads();
  double ct = 0.0;
  if (t < W) {
    ct = gtot[t * kRawGroups];
#pragma unroll
    for (int h = 1; h < kRawGroups; ++h) ct += gtot[t * kRawGroups + h];
  }
  if constexpr (kCluster) {
    // The chunks' totals in chunk (rank) order, read by rank 0 from the
    // other ranks' shared memory; the second sync keeps every rank's memory
    // alive until rank 0 has read it.
    cg::cluster_group cluster = cg::this_cluster();
    if (t < W) ctot[t] = ct;
    cluster.sync();
    if (g == 0 && t < W && j0 + t < jend) {
      double part[kClusterChunks];
#pragma unroll
      for (int r = 1; r < kClusterChunks; ++r) part[r] = r < G ? cluster.map_shared_rank(ctot, r)[t] : 0.0;
      double total = ct;
#pragma unroll
      for (int r = 1; r < kClusterChunks; ++r)
        if (r < G) total += part[r];
      out[static_cast<size_t>(b) * Stot + col + t] = static_cast<float>(total);
    }
    cluster.sync();
  } else {
    if (t < W) partial[((static_cast<size_t>(b) * gridDim.x + wi) * G + g) * kRawWidth + t] = ct;
  }
}

// Beyond one launch: window blockIdx.x of problem blockIdx.y, thread t adds
// column t's chunk totals in chunk order.
__global__ void __launch_bounds__(32)
moments_raw_final(const __grid_constant__ RawWindows ws, int G, int Stot,
                  const double* __restrict__ partial, float* __restrict__ out) {
  const RawWindow& win = ws.w[blockIdx.x];
  const int b = blockIdx.y, t = threadIdx.x;
  if (t < (1 << win.lw) && win.j0 + t < win.end) {
    const double* p = partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * G * kRawWidth + t;
    double total = p[0];
    for (int g = 1; g < G; ++g) total += p[static_cast<size_t>(g) * kRawWidth];
    out[static_cast<size_t>(b) * Stot + win.col + t] = static_cast<float>(total);
  }
}

template <bool kCluster, int kWidth>
cudaError_t launch_raw(const RawWindows& ws, int nw, int B, int P, int G, int CH, int Stot,
                       double* partial, float* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = kCluster ? dim3(G, nw, B) : dim3(nw, G, B);
  cfg.blockDim = dim3(kRawLanes);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (kCluster) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  return cudaLaunchKernelEx(&cfg, moments_raw<kCluster, kWidth>, ws, P, G, CH, Stot, partial, out);
}

}  // namespace

// Structured entry. kind: 0 point-to-plane (p0, q, n, w), 1 GICP (p0, q, n,
// ns, w; k = 1 - epsilon). p0, q, n, ns: [B, P, 3] float32; w: [B, P]
// float32; ns may be null for kind 0. partial: [B * nchunks * 160] float64
// scratch with nchunks = ceil(P / 4096); out: [B, S] float32. Launches on
// `stream`, returns cudaGetLastError() after the launches (0 on success; 1
// for a bad kind or S).
extern "C" int moments_launch(int kind, const float* p0, const float* q, const float* n,
                              const float* ns, const float* w, int B, int P, int S, double k,
                              double* partial, float* out, void* stream) {
  if (B == 0) return 0;
  const int want = kind == kP2pl ? Spec<kP2pl>::kSums : kind == kGicp ? Spec<kGicp>::kSums : -1;
  if (S != want || B > 65535) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (P + kPairChunk - 1) / kPairChunk;
  if (nchunks > 0) {
    const dim3 grid(nchunks, B);
    if (kind == kP2pl)
      moments_partial<kP2pl><<<grid, kGroupLanes * kGroups, 0, s>>>(p0, q, n, ns, w, P, k, partial);
    else
      moments_partial<kGicp><<<grid, kGroupLanes * kGroups, 0, s>>>(p0, q, n, ns, w, P, k, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    moments_final<<<dim3(B, (S + kFinalWarps - 1) / kFinalWarps), 32 * kFinalWarps, 0, s>>>(partial, nchunks, S, out);
  } else {
    cudaMemsetAsync(out, 0, static_cast<size_t>(B) * S * sizeof(float), s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Raw entry: `n` column ranges [j_begin[i], j_end[i]) of terms[i], each a
// group [B, P, S[i]] (float32, contiguous); range i's sums go to out[:,
// col[i] : col[i] + j_end[i] - j_begin[i]] of out [B, Stot] float32. G
// chunks of CH pairs (kernels/moments.py raw_plan); cluster != 0: one
// launch, G <= 8 blocks a cluster; else partial is [B * windows * G * 16]
// float64 scratch (a window: 16 columns of a range, or its rest) and a
// second kernel adds the chunks. Returns cudaGetLastError() (0 on success;
// 1 for a bad plan, 2 for more than 32 windows).
extern "C" int moments_raw_launch(int n, const float* const* terms, const int* S,
                                  const int* j_begin, const int* j_end, const int* col, int B,
                                  int P, int G, int CH, int cluster, int Stot, double* partial,
                                  float* out, void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 0) {
    cudaMemsetAsync(out, 0, static_cast<size_t>(B) * Stot * sizeof(float), s);
    return static_cast<int>(cudaGetLastError());
  }
  if (G < 1 || CH < 1 || (cluster ? G > kClusterChunks : G > 65535) || B > 65535 ||
      static_cast<long long>(G) * CH < P)
    return 1;
  for (int i = 0; i < n; ++i)
    if (static_cast<long long>(CH + 4 * kRawLanes) * S[i] >= (1ll << 31)) return 1;
  RawWindows ws = {};
  int nw = 0, width = 1;
  for (int i = 0; i < n; ++i) {
    for (int j0 = j_begin[i]; j0 < j_end[i]; j0 += kRawWidth) {
      if (nw == kMaxWindows) return 2;
      int lw = 0;
      while ((1 << lw) < min(kRawWidth, j_end[i] - j0)) ++lw;
      ws.w[nw++] = RawWindow{terms[i], S[i], j0, j_end[i], lw, col[i] + j0 - j_begin[i]};
      width = max(width, 1 << lw);
    }
  }
  cudaError_t err;
  if (cluster)
    err = width <= 4 ? launch_raw<true, 4>(ws, nw, B, P, G, CH, Stot, partial, out, s)
                     : launch_raw<true, kRawWidth>(ws, nw, B, P, G, CH, Stot, partial, out, s);
  else
    err = width <= 4 ? launch_raw<false, 4>(ws, nw, B, P, G, CH, Stot, partial, out, s)
                     : launch_raw<false, kRawWidth>(ws, nw, B, P, G, CH, Stot, partial, out, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!cluster) moments_raw_final<<<dim3(nw, B), 32, 0, s>>>(ws, G, Stot, partial, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moments_error_string(int code) {
  if (code == 1) return "moments: bad kind, number of sums or plan";
  if (code == 2) return "moments: more than 32 windows in one launch";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
