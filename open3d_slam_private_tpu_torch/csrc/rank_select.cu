// K4: rank + select the knn = 1 winner of rows gathered beforehand.
//
// Replaces the TPU kernel rank_select_rows
// (open3d_slam_private_tpu/kernels/select_pallas.py:117, body _kernel :63,
// matrices _build_mats :53). Contract, for each query i with its gathered
// cell-list row rows[i] = cap candidates of 8 words (x, y, z, id bits, nx,
// ny, nz, 0):
//   d2_c   = |row_c.xyz - q_i|^2 for every slot (padded slots carry
//            xyz = 1e9, so their d2 ~3e18 loses to any real candidate and
//            an empty row's minimum stays finite), inf for a masked query
//   winner = the first slot c at the minimum d2
//   out[i] = [x, y, z, id bits, nx, ny, nz] of the winner, the minimum d2,
//            the occupancy (slots whose x < 1e8), 7 zeros          (16 words)
// It differs from K2 in three ways: padded slots are excluded by their
// coordinates, not by id; occupancy counts x < 1e8; an empty row's d2 is
// finite where K2 gives inf.
//
// The TPU kernel ranks with segment-sum matmuls on the MXU ([cap*8, cap]
// distance sums, a pick-mask expand and a channel sum); on Hopper the warp
// reads the row directly.
// What bounds it on an H100: memory. Each query reads its whole row,
// cap x 32 B (1.5 KiB at cap 48), streamed once in order, and writes 64 B:
// 805 MB for the 524,288 queries of a B = 8 x 65,536 round, ~0.25 ms at full
// bandwidth.
// Design: one warp per query over its contiguous row, through the rank
// routine of rank_select.cuh: coalesced 32-byte candidates, a shuffle
// argmin over (d2, slot) that keeps the lowest slot, ids read as integer
// bits and the winner's payload copied as raw words. The chain's select leg
// reads its rows in place instead (the table entry, gather_select.cu with
// K4's contract); this kernel serves rows wider than that entry takes and
// the Pallas kernel's own [N, cap * 8] contract.

#include <cuda_runtime.h>
#include <stdint.h>

#include "rank_select.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rank_select_kernel(const uint32_t* __restrict__ rows, const float* __restrict__ query,
                   const uint8_t* __restrict__ mask, int n, int cap,
                   uint32_t* __restrict__ out) {
  const int i = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps exit together
  const uint32_t* r = rows + static_cast<size_t>(i) * cap * 8;
  float best;
  int best_c, occ;
  rank_select::rank_row(r, cap, lane, query[3 * i], query[3 * i + 1], query[3 * i + 2],
                               mask[i] != 0, best, best_c, occ);
  rank_select::write_selected(out + static_cast<size_t>(i) * rank_select::kOut, r, lane, best,
                              best_c, occ);
}

}  // namespace

// rows: [N, cap * 8] float32 words (16-byte aligned); query: [N, 3] float32;
// mask: [N] uint8; out: [N, 16] float32 words. Launches on `stream`, returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int rank_select_launch(const void* rows, const float* query, const uint8_t* mask,
                                  int N, int cap, void* out, void* stream) {
  if (N == 0) return 0;
  const int blocks = (N + kThreads / 32 - 1) / (kThreads / 32);
  rank_select_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), query, mask, N, cap, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rank_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
