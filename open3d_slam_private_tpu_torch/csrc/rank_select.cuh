// The per-row rank + first-minimum select of K4's rows entry
// (rank_select.cu). K4's table entry and K2 rank from shared memory instead
// (gather_select.cu) and do not include this header.
//
// A row is cap candidates of 8 32-bit words: x, y, z, id bits, nx, ny, nz, 0.
// One warp ranks one row: lane l takes slots l, l+32, ..., reading each
// candidate's first 16 bytes as one uint4 (a warp reads 1 KiB of the row per
// step, coalesced); a shuffle argmin over (d2, slot) keeps the lowest slot
// among equal distances. d2 is rounded step by step (__fmul_rn/__fadd_rn) as
// (dx*dx + dy*dy) + dz*dz, the plain PyTorch versions' order, so ties fall
// the same way. Ids are read as integer bits and the winner's payload is
// copied as raw words: ids below 2^23 are denormal floats and must never pass
// through float arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace rank_select {

constexpr int kOut = 16;  // x, y, z, id bits, nx, ny, nz, d2, occupancy, 7 zeros

// Rank the row r against query (qx, qy, qz) with validity qm, K4's contract:
// every slot competes, padded ones through their 1e9 coordinates (d2
// ~3e18), and occupancy counts slots whose x < 1e8. A masked query sees
// d2 = inf everywhere. The result is the same in every lane: best d2, its
// lowest slot, the occupancy.
__device__ __forceinline__ void rank_row(const uint32_t* __restrict__ r, int cap, int lane,
                                         float qx, float qy, float qz, bool qm, float& best,
                                         int& best_c, int& occ) {
  best = CUDART_INF_F;
  best_c = 0x7fffffff;
  occ = 0;
  for (int c = lane; c < cap; c += 32) {
    const uint4 a = *reinterpret_cast<const uint4*>(r + 8 * c);  // x, y, z, id
    occ += __uint_as_float(a.x) < 1e8f ? 1 : 0;
    const float dx = __fsub_rn(__uint_as_float(a.x), qx);
    const float dy = __fsub_rn(__uint_as_float(a.y), qy);
    const float dz = __fsub_rn(__uint_as_float(a.z), qz);
    float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
    if (!qm) d2 = CUDART_INF_F;
    if (best_c == 0x7fffffff || d2 < best) {  // a lane's first slot always counts
      best = d2;
      best_c = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, best, off);
    const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    if (od < best || (od == best && oc < best_c)) {
      best = od;
      best_c = oc;
    }
    occ += __shfl_xor_sync(0xffffffffu, occ, off);
  }
}

// Lanes 0..15 write the [16]-word output row o of the winner of row r.
__device__ __forceinline__ void write_selected(uint32_t* __restrict__ o,
                                               const uint32_t* __restrict__ r, int lane,
                                               float best, int best_c, int occ) {
  if (lane < kOut) {
    uint32_t v = 0u;
    if (lane < 7) v = r[8 * best_c + lane];
    else if (lane == 7) v = __float_as_uint(best);
    else if (lane == 8) v = __float_as_uint(static_cast<float>(occ));
    o[lane] = v;
  }
}

}  // namespace rank_select
