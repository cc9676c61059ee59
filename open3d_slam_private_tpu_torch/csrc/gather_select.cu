// K2: fused cell-list row gather + rank + select (knn = 1), and K4's
// contract on the same machinery (the table entry of rank_select).
//
// Replaces the TPU kernel gather_select
// (open3d_slam_private_tpu/kernels/gather_select_pallas.py:207, through
// _gather_select_tiled :135, body _kernel :94 and _rank_block :56). Contract,
// for each query i with row index h_i into the cell list table [T, cap, 8]
// (payload x, y, z, id bits, nx, ny, nz, 0):
//   d2_c   = |row_c.xyz - q_i|^2, set to inf where id_c < 0 or the query is
//            masked out
//   winner = the first slot c at the minimum d2
//   out[i] = [x, y, z, id bits, nx, ny, nz] of the winner, the minimum d2,
//            the row's occupancy (slots with id >= 0), 7 zeros   (16 words)
//   An h_i outside [0, T) gives the INVALID row (id -1, d2 inf, zeros).
// With by_coords set, the rank kernel takes the contract of K4, the TPU
// kernel rank_select_rows (open3d_slam_private_tpu/kernels/select_pallas.py:117),
// on the row table[h_i] read in place instead of gathered beforehand: every
// slot competes (padded slots carry xyz = 1e9, so they lose to any real
// candidate and an empty row's d2 stays finite), a masked query sees inf
// everywhere, occupancy counts the slots whose x < 1e8. The count, rowsum,
// scan and scatter passes are the same for both contracts.
//
// It reads the table in its own [T, cap, 8] layout; the TPU kernel's
// [T, 8, 128] tiles were a DMA-alignment device and would cost 256 MiB of
// padding at T = 2^16.
// What bounds it on an H100: memory. The work needs, of each row the
// queries touch, its slots' xyz (and ids, in K2's contract) read once, each
// query's xyz, mask and row index and its winner's remaining payload read
// once and its 64-byte output written: about 60 MB for the 524,288 queries
// of a B = 8 x 65,536 round, which touch only 15,148 rows (~35 queries a
// row). A warp per query that re-reads its row moves 805 MB through L2
// instead, and K4's rows gathered beforehand move those 805 MB through
// device memory twice (written by the gather, read by the kernel).
// Design: group the queries by row, then rank each row's queries from one
// staged copy of the row. Its pace is then set by random accesses: the
// grouping's 4-byte atomics and writes, and each grouped query's xyz, mask
// and 64-byte output at the query's own index (whole 32-byte sectors each),
// not by the ranking's arithmetic.
// - count:   a histogram of h over the T rows (atomics), whose returned
//            value is each query's place within its row; an out-of-range h
//            writes its INVALID row here and takes no further part.
// - rowsum:  per block of 1024 rows, the queries and the work items (one per
//            32 queries of a row) it holds.
// - scan:    per block of 1024 rows, the exclusive scans of both (the block
//            adds the totals of the blocks before it): each row's first
//            position in the grouped order, and one record (row, first
//            position, count) per work item (32 queries of a row); the counts are reset to zero
//            for the next call. Every access is coalesced.
// - scatter: each query writes its index at its row's offset plus its
//            place: the order of queries within a row varies from run to
//            run, but every output is written at the query's own index, so
//            results are bit-identical.
// - rank:    a grid of warps walks the work items with a grid stride, so
//            a hot row spreads over several warps. A warp stages the row in shared
//            memory with 16-byte loads (once a work item) and reads its
//            queries' indices in grouped order; each lane ranks one query
//            over the staged candidates (all lanes read the same candidate
//            at once: a shared-memory broadcast), d2 rounded step by step as
//            (dx*dx + dy*dy) + dz*dz, ids read as integer bits; it writes its
//            16 words at the query's index, the winner's payload copied as
//            raw words (ids below 2^23 are denormal floats and must never
//            pass through float arithmetic). The contract is the kernel's
//            template parameter: it changes only how a slot is staged.
// No library sort or scan. The row counts (zero between calls) and the
// scratch are buffers the wrapper allocates once per device; calls are
// issued on one stream, in order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;  // rows a rowsum / scan block
constexpr int kQ = 32;              // queries a work item: one per lane of a rank warp
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kOut = 16;

// The scratch, carved by gather_select_launch: the work items [ceil(N / 32)
// + T] (16-byte records first), the rowsum blocks' totals, then the row
// offsets [T + 1], the item count, the grouped query indices [N] and each
// query's place in its row [N].
struct Work {
  int* count;          // [T], zero between calls
  int4* items;         // (row, first position, queries, 0)
  int2* block_tot;     // [ceil(T / 1024)] (queries, items)
  int* offset;         // [T + 1]
  int* n_items;        // [1]
  int* order;          // [N]
  int* slot;           // [N]
};

__device__ __forceinline__ void write_invalid(uint32_t* __restrict__ o) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  o4[0] = make_uint4(0u, 0u, 0u, 0xffffffffu);  // id INVALID_ID
  o4[1] = make_uint4(0u, 0u, 0u, __float_as_uint(CUDART_INF_F));
  o4[2] = zero;
  o4[3] = zero;
}

__global__ void __launch_bounds__(kThreads)
gather_select_count(const int32_t* __restrict__ h, int n, int table_size, Work w,
                    uint32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int row = h[i];
  if (row < 0 || row >= table_size) {
    write_invalid(out + static_cast<size_t>(i) * kOut);
    return;
  }
  w.slot[i] = atomicAdd(w.count + row, 1);  // the query's place within its row
}

// Block-wide inclusive scan of one int2 a thread (x: queries, y: items);
// the block total lands in warp_tot[31].
__device__ __forceinline__ int2 block_scan(int2 v, int2* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ox = __shfl_up_sync(0xffffffffu, v.x, off);
    const int oy = __shfl_up_sync(0xffffffffu, v.y, off);
    if (lane >= off) {
      v.x += ox;
      v.y += oy;
    }
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int2 t = warp_tot[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ox = __shfl_up_sync(0xffffffffu, t.x, off);
      const int oy = __shfl_up_sync(0xffffffffu, t.y, off);
      if (lane >= off) {
        t.x += ox;
        t.y += oy;
      }
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) {
    v.x += warp_tot[warp - 1].x;
    v.y += warp_tot[warp - 1].y;
  }
  return v;
}

__device__ __forceinline__ int items_of(int c) { return (c + kQ - 1) / kQ; }

__global__ void __launch_bounds__(kScanThreads)
gather_select_rowsum(int table_size, Work w) {
  __shared__ int2 warp_tot[32];
  const int r = blockIdx.x * kScanThreads + threadIdx.x;
  const int c = r < table_size ? w.count[r] : 0;
  const int2 inc = block_scan(make_int2(c, items_of(c)), warp_tot);
  if (threadIdx.x == kScanThreads - 1) w.block_tot[blockIdx.x] = inc;
}

__global__ void __launch_bounds__(kScanThreads)
gather_select_scan(int table_size, Work w) {
  __shared__ int2 warp_tot[32];
  __shared__ int2 base;
  if (threadIdx.x < 32) {  // the totals of the blocks before this one
    int2 b = make_int2(0, 0);
    for (int k = threadIdx.x; k < static_cast<int>(blockIdx.x); k += 32) {
      const int2 t = w.block_tot[k];
      b.x += t.x;
      b.y += t.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      b.x += __shfl_xor_sync(0xffffffffu, b.x, off);
      b.y += __shfl_xor_sync(0xffffffffu, b.y, off);
    }
    if (threadIdx.x == 0) base = b;
  }
  const int r = blockIdx.x * kScanThreads + threadIdx.x;
  const int c = r < table_size ? w.count[r] : 0;
  const int items = items_of(c);
  const int2 inc = block_scan(make_int2(c, items), warp_tot);  // syncs: `base` is set
  const int first = base.x + inc.x - c, item0 = base.y + inc.y - items;
  if (r < table_size) {
    w.offset[r] = first;
    w.count[r] = 0;
    for (int k = 0; k < items; ++k)
      w.items[item0 + k] = make_int4(r, first + k * kQ, min(kQ, c - k * kQ), 0);
  }
  if (r == table_size - 1) {
    w.offset[table_size] = first + c;
    *w.n_items = item0 + items;
  }
}

__global__ void __launch_bounds__(kThreads)
gather_select_scatter(const int32_t* __restrict__ h, int n, int table_size, Work w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int row = h[i];
  if (row < 0 || row >= table_size) return;
  w.order[w.offset[row] + w.slot[i]] = i;
}

// One warp a work item: the warp stages the row (the raw payload for the
// winner's copy, and each slot's xyz for ranking), counts the occupancy with
// one ballot per 32 slots, and each lane ranks one query. K2's contract
// (kByCoords false) stages +inf for an empty slot, so its d2 is inf, and
// counts the slots with id >= 0; K4's (kByCoords true) stages every slot's
// own xyz and counts the slots whose x < 1e8.
template <bool kByCoords>
__global__ void __launch_bounds__(kThreads)
gather_select_rank(const uint4* __restrict__ table, const float* __restrict__ query,
                   const uint8_t* __restrict__ mask, int cap, Work w, uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];  // per warp: cap x 2 uint4 payload, cap float4 xyz
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* s_row = smem + static_cast<size_t>(warp) * cap * 3;
  float4* s_xyz = reinterpret_cast<float4*>(s_row + 2 * cap);
  const int n_items = *w.n_items;
  const int stride = gridDim.x * kWarpsPerBlock;
  int item = blockIdx.x * kWarpsPerBlock + warp;
  int4 it = item < n_items ? w.items[item] : make_int4(0, 0, 0, 0);
  for (; item < n_items; item += stride) {
    const bool mine = lane < it.z;  // it: row, first position, queries
    float qx = 0.f, qy = 0.f, qz = 0.f;
    bool qm = false;
    int i = 0;
    if (mine) {
      i = w.order[it.y + lane];
      qx = query[3 * i];
      qy = query[3 * i + 1];
      qz = query[3 * i + 2];
      qm = mask[i] != 0;
    }
    const uint4* src = table + static_cast<size_t>(it.x) * cap * 2;
    int occ = 0;
    for (int c0 = 0; c0 < cap; c0 += 32) {
      const int c = c0 + lane;
      bool occupied = false;
      if (c < cap) {
        const uint4 a = src[2 * c], b = src[2 * c + 1];
        s_row[2 * c] = a;
        s_row[2 * c + 1] = b;
        const float4 xyz = make_float4(__uint_as_float(a.x), __uint_as_float(a.y),
                                       __uint_as_float(a.z), 0.f);
        if (kByCoords) {
          occupied = xyz.x < 1e8f;
          s_xyz[c] = xyz;
        } else {
          occupied = static_cast<int32_t>(a.w) >= 0;
          s_xyz[c] = occupied ? xyz : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, 0.f);
        }
      }
      occ += __popc(__ballot_sync(0xffffffffu, occupied));
    }
    const int next = item + stride;
    const int4 it_next = next < n_items ? w.items[next] : make_int4(0, 0, 0, 0);
    __syncwarp();
    if (mine) {
      float best = CUDART_INF_F;
      int best_c = 0;
      if (qm) {  // a masked query sees inf in every slot
#pragma unroll 4
        for (int c = 0; c < cap; ++c) {
          const float4 a = s_xyz[c];
          const float dx = __fsub_rn(a.x, qx);
          const float dy = __fsub_rn(a.y, qy);
          const float dz = __fsub_rn(a.z, qz);
          const float d2 =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (c == 0 || d2 < best) {  // the first slot at the minimum
            best = d2;
            best_c = c;
          }
        }
      }
      const uint4 p = s_row[2 * best_c], pn = s_row[2 * best_c + 1];
      uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * kOut);
      o[0] = p;
      o[1] = make_uint4(pn.x, pn.y, pn.z, __float_as_uint(best));
      o[2] = make_uint4(__float_as_uint(static_cast<float>(occ)), 0u, 0u, 0u);
      o[3] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();  // the row is read before the next one is staged
    it = it_next;
  }
}

// The rank kernel's staging: per warp, a row's raw payload and its xyz.
size_t rank_smem(int cap) { return static_cast<size_t>(cap) * 48 * kWarpsPerBlock; }

template <bool kByCoords>
cudaError_t launch_rank(int blocks, cudaStream_t s, const uint4* table, const float* query,
                        const uint8_t* mask, int cap, Work w, uint32_t* out) {
  const size_t smem = rank_smem(cap);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_select_rank<kByCoords>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gather_select_rank<kByCoords><<<blocks, kThreads, smem, s>>>(table, query, mask, cap, w, out);
  return cudaGetLastError();
}

}  // namespace

// table: [T, cap, 8] float32 words (16-byte aligned); h: [N] int32; query:
// [N, 3] float32; mask: [N] uint8 or bool; count: [T] int32, zero before
// the call and zero after it; scratch: 16-byte aligned, 2 N + 4 (ceil(N /
// 32) + T) + T + 2 ceil(T / 1024) + 3 int32 words; out: [N, 16] float32
// words (16-byte aligned); rank_blocks: the rank kernel's grid; by_coords:
// 0 for K2's contract, 1 for K4's. Launches five kernels on `stream`,
// returns cudaGetLastError() after each (0 on success). Rows whose staging
// does not fit in a block's shared memory (cap above 605 on an H100) are
// refused with cudaErrorInvalidValue before any kernel runs.
extern "C" int gather_select_launch(const void* table, const int32_t* h, const float* query,
                                    const uint8_t* mask, int N, int T, int cap, int* count,
                                    int* scratch, int rank_blocks, int by_coords, void* out,
                                    void* stream) {
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rank_smem(cap) > static_cast<size_t>(smem_max)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (T + kScanThreads - 1) / kScanThreads;
  Work w;
  w.count = count;
  w.items = reinterpret_cast<int4*>(scratch);
  w.block_tot = reinterpret_cast<int2*>(w.items + (N + kQ - 1) / kQ + T);
  w.offset = reinterpret_cast<int*>(w.block_tot + row_blocks);
  w.n_items = w.offset + T + 1;
  w.order = w.n_items + 1;
  w.slot = w.order + N;
  uint32_t* o = static_cast<uint32_t*>(out);
  const int blocks = (N + kThreads - 1) / kThreads;
  gather_select_count<<<blocks, kThreads, 0, s>>>(h, N, T, w, o);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_select_rowsum<<<row_blocks, kScanThreads, 0, s>>>(T, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_select_scan<<<row_blocks, kScanThreads, 0, s>>>(T, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_select_scatter<<<blocks, kThreads, 0, s>>>(h, N, T, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const uint4* t = static_cast<const uint4*>(table);
  err = by_coords ? launch_rank<true>(rank_blocks, s, t, query, mask, cap, w, o)
                  : launch_rank<false>(rank_blocks, s, t, query, mask, cap, w, o);
  return static_cast<int>(err);
}

extern "C" const char* gather_select_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
