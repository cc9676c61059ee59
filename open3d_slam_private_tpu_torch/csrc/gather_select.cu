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
// everywhere, occupancy counts the slots whose x < 1e8. The grouping passes
// are the same for both contracts.
//
// It reads the table in its own [T, cap, 8] layout; the TPU kernel's
// [T, 8, 128] tiles were a DMA-alignment device and would cost 256 MiB of
// padding at T = 2^16.
// What bounds it on an H100: memory, and random accesses. The work needs,
// of each row the queries touch, its slots' xyz and ids read once, each
// query's xyz, mask and row index and its winner's remaining payload read
// once and its 64-byte output written: about 60 MB for the 524,288 queries
// of a B = 8 x 65,536 round (18 us at 3.35 TB/s), which touch only 15,148
// rows (~35 queries a row; a run of 256 consecutive queries touches ~248
// rows, so only a global grouping finds the sharing). Reading each touched
// row whole (32-byte sectors) sets a floor of ~19.6 us. A warp per query
// that re-reads its row moves 805 MB through L2 instead.
// Design: group the queries by row, carrying each query's coordinates into
// the grouped order, then rank each row's queries from one staged copy. One
// memset and four kernels on one stream, no host read; the plan (scratch
// layout, rank grid, shared memory) is kernels/gather_select.py k2_plan,
// checked against make_plan below; tests/gather_select_model.py models the
// passes in numpy.
// - memset:  the row counts, the scan's look-back words and its ticket;
//            nothing has to be zero on entry, and the scratch is the call's
//            own (inside a CUDA graph capture, from the graph's pool).
// - count:   a histogram of h over the T rows (reductions: atomics whose
//            value nobody waits for); an out-of-range h writes its INVALID
//            row here and takes no further part.
// - scan:    one pass with decoupled look-back over blocks of 1024 rows
//            (blocks take tickets in launch order; warp 0 reads up to 32
//            predecessors' 64-bit words, flag | items | queries, at once):
//            each row's first position in the grouped order, and one work
//            item (row, first position, queries) per 32 queries of a row.
// - scatter: each query, read where it lies (coalesced), takes the next
//            position of its row (an atomic on the row's cursor, which
//            starts at the row's first position) and writes one 16-byte
//            record (x, y, z, i | mask << 31) there. The order within a row
//            varies from run to run; every output is written at the query's
//            own index and ranked over the same slots, so results are
//            bit-identical.
// - rank:    persistent warps walk the work items with a grid stride, so a
//            hot row (hundreds of queries) spreads over warps. A warp stages
//            the item's row (cap x 32 contiguous bytes) and its records
//            (16 bytes each, contiguous, just written, in L2) with the bulk
//            copy engine (cp.async.bulk, completion on an mbarrier), double
//            buffered: the next item's copies are in flight while the lanes
//            rank the current one. Each query gets the most lanes that fit
//            (32 / the next power of two of the item's queries): each lane
//            ranks every lpq-th slot from the staged row, d2 rounded step by
//            step as (dx*dx + dy*dy) + dz*dz, ids read as integer bits, and
//            the query's lanes take the least (d2, slot). The winner's
//            payload is copied as raw words (ids below 2^23 are denormal
//            floats and must never pass through float arithmetic); the 16
//            words of each query go through the stage so that four lanes
//            write a query's 64 bytes at its index (whole sectors). The
//            contract is the kernel's template parameter.
// Measured on the headline round (PERF.md, section 6): the rank's time is
// set by its 64-byte outputs at random query indices (33.5 MB; ~14 us of
// its ~34) and by staging 27,053 items' rows and records (~50 MB through
// L2, ~20 us alone), the count's and scatter's by random atomics and
// 16-byte writes. Plain 16-byte cp.async staging measured the same as the
// bulk copy; a separate pass that wrote the outputs in query order measured
// slower (it reads each winner again).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // count / scatter / rank blocks
constexpr int kScanThreads = 1024;  // rows a scan block
constexpr int kQ = 32;              // queries a work item: one per lane of a rank warp
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 16;
constexpr int kRecordBytes = 16;
constexpr int kSms = 132;             // an H100 SXM's SMs: the rank grid's unit
constexpr int kSmSmem = 233472;       // shared memory of an H100 SM
constexpr int kBlockReserved = 1024;  // kept by the runtime for each block
constexpr long long kMaxN = (1ll << 31) - 1;
constexpr int kMaxT = 1 << 30;
constexpr uint64_t kFlagMask = 3ull << 62, kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr int kBadPlan = -1, kTooWide = -2, kOutOfRange = -3;
// A wait that cannot end (a copy that never lands, a scan block that never
// publishes) traps after 2^28 polls instead of holding the card.
constexpr unsigned kMaxPolls = 1u << 28;

// The scratch (int32 word offsets) and the rank grid: kernels/gather_select.py
// k2_plan computes the same.
struct Plan {
  long long items, state, ticket, count, offset, n_items, words, zero_words;
  int row_blocks, warp_smem, block_smem, rank_blocks;
};

// A rank stage: a row and 32 records, and at least the 2 KB of 32 output
// rows that go through it.
__host__ __device__ constexpr int stage_of(int cap) {
  return cap * 32 + kQ * kRecordBytes > 2048 ? cap * 32 + kQ * kRecordBytes : 2048;
}

Plan make_plan(long long N, int T, int cap) {
  Plan p;
  p.row_blocks = (T + kScanThreads - 1) / kScanThreads;
  const long long max_items = (N + kQ - 1) / kQ + (N < T ? N : T);
  p.items = 4 * N;  // the records [N] x 16 bytes come first
  p.state = p.items + 4 * max_items;
  p.ticket = p.state + 2 * p.row_blocks;
  p.count = p.ticket + 1;
  p.offset = p.count + T;
  p.n_items = p.offset + T;
  p.words = p.n_items + 1;
  p.zero_words = p.offset - p.state;
  p.warp_smem = 16 + 2 * stage_of(cap);
  p.block_smem = kWarps * p.warp_smem;
  int per_sm = kSmSmem / (p.block_smem + kBlockReserved);
  per_sm = per_sm < 1 ? 1 : (per_sm > 8 ? 8 : per_sm);
  p.rank_blocks = kSms * per_sm;
  return p;
}

struct Work {
  uint4* records;     // [N] (x, y, z, i | mask << 31) in grouped order
  int4* items;        // (row, first position, queries, 0)
  uint64_t* state;    // [row_blocks] look-back words, zeroed by the memset
  int* ticket;        // zeroed by the memset
  int* count;         // [T], zeroed by the memset
  int* offset;        // [T] each row's first position, then the scatter's cursor
  int* n_items;       // [1]
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
  atomicAdd(w.count + row, 1);  // no return: a reduction
}

// Block-wide inclusive scan of one int2 a thread (x: queries, y: items);
// warp_tot[31] ends as the block total.
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

// A look-back word: flag (2 bits) | items (31) | queries (31). The value
// travels with its flag in one 64-bit access, so relaxed order suffices.
__device__ __forceinline__ uint64_t pack_state(int2 v, uint64_t flag) {
  return flag | (static_cast<uint64_t>(static_cast<uint32_t>(v.y)) << 31) |
         static_cast<uint32_t>(v.x);
}

__device__ __forceinline__ int2 unpack_state(uint64_t s) {
  return make_int2(static_cast<int>(s & 0x7fffffffu), static_cast<int>((s >> 31) & 0x7fffffffu));
}

__device__ __forceinline__ uint64_t load_state(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_state(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The exclusive prefix (queries, items) of the blocks before block b: warp
// 0 reads the words of blocks b - 1 - lane, 32 at a time, until the nearest
// inclusive one; it sums that one and the aggregates after it.
__device__ __forceinline__ int2 look_back(const uint64_t* state, int b, int lane) {
  int2 excl = make_int2(0, 0);
  for (int end = b; end > 0; end -= 32) {
    const int k = end - 1 - lane;
    uint64_t s;
    unsigned incl, upto;
    for (unsigned polls = 0;; ++polls) {
      if (polls == kMaxPolls) __trap();
      s = k >= 0 ? load_state(state + k) : kInclusive;
      const uint64_t flag = s & kFlagMask;
      const unsigned ready = __ballot_sync(0xffffffffu, flag != 0);
      incl = __ballot_sync(0xffffffffu, flag == kInclusive);
      upto = incl ? (incl & (0u - incl)) * 2u - 1u : 0xffffffffu;  // lanes up to the first inclusive
      if ((ready & upto) == upto) break;
    }
    int2 v = ((upto >> lane) & 1u) ? unpack_state(s) : make_int2(0, 0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
    }
    excl.x += v.x;
    excl.y += v.y;
    if (incl) break;
  }
  return excl;
}

__global__ void __launch_bounds__(kScanThreads)
gather_select_scan(int table_size, Work w) {
  __shared__ int2 warp_tot[32];
  __shared__ int2 base;
  __shared__ int ticket;
  if (threadIdx.x == 0) ticket = atomicAdd(w.ticket, 1);  // blocks before it have started
  __syncthreads();
  const int b = ticket;
  const int r = b * kScanThreads + threadIdx.x;
  const int c = r < table_size ? w.count[r] : 0;
  const int items = items_of(c);
  const int2 inc = block_scan(make_int2(c, items), warp_tot);
  if (threadIdx.x < 32) {
    const int2 agg = warp_tot[31];
    if (threadIdx.x == 0) store_state(w.state + b, pack_state(agg, b == 0 ? kInclusive : kAggregate));
    const int2 excl = look_back(w.state, b, threadIdx.x);
    if (threadIdx.x == 0) {
      if (b > 0) store_state(w.state + b, pack_state(make_int2(excl.x + agg.x, excl.y + agg.y), kInclusive));
      base = excl;
    }
  }
  __syncthreads();
  const int first = base.x + inc.x - c, item0 = base.y + inc.y - items;
  if (r < table_size) {
    w.offset[r] = first;
    for (int k = 0; k < items; ++k)
      w.items[item0 + k] = make_int4(r, first + k * kQ, min(kQ, c - k * kQ), 0);
  }
  if (r == table_size - 1) *w.n_items = item0 + items;
}

__global__ void __launch_bounds__(kThreads)
gather_select_scatter(const int32_t* __restrict__ h, const float* __restrict__ query,
                      const uint8_t* __restrict__ mask, int n, int table_size, Work w) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int row = h[i];
  if (row < 0 || row >= table_size) return;
  const uint4 rec = make_uint4(__float_as_uint(query[3 * i]), __float_as_uint(query[3 * i + 1]),
                               __float_as_uint(query[3 * i + 2]),
                               static_cast<uint32_t>(i) | (mask[i] != 0 ? 0x80000000u : 0u));
  w.records[atomicAdd(w.offset + row, 1)] = rec;  // the row's next free position
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Lane 0: the row and the records of work item `it` into a stage, both
// completing on the stage's mbarrier.
__device__ __forceinline__ void stage_item(const uint4* table, const uint4* records, int cap, int4 it,
                                           unsigned char* stage, uint32_t bar) {
  const uint32_t row_bytes = static_cast<uint32_t>(cap) * 32u;
  const uint32_t rec_bytes = static_cast<uint32_t>(it.z) * kRecordBytes;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the lanes' reads of this stage first
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(row_bytes + rec_bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(stage)),
      "l"(table + static_cast<size_t>(it.x) * cap * 2), "r"(row_bytes), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(stage + row_bytes)),
      "l"(records + it.y), "r"(rec_bytes), "r"(bar)
      : "memory");
}

// One work item from its stage. The warp counts the occupancy (a ballot a
// 32 slots). Each query of the item gets lpq lanes, the most that fit (32
// for one query, 1 for 17-32): lane sub of a query's group ranks slots sub,
// sub + lpq, ...; the group then takes the least (d2, slot), the first slot
// at the minimum. K2's contract (kByCoords false) lets no empty slot (id <
// 0) win and counts the slots with id >= 0 (an all-empty row or a masked
// query keeps slot 0 at d2 = inf); K4's (kByCoords true) ranks every slot
// by its own xyz and counts the slots whose x < 1e8. The results go through
// the stage, which every lane has read by then, so that four lanes write
// each query's 64 bytes at its index (whole 32-byte sectors).
template <bool kByCoords>
__device__ __forceinline__ void rank_item(unsigned char* stage, int cap, int queries, int lane,
                                          uint32_t* __restrict__ out) {
  const uint4* s_row = reinterpret_cast<const uint4*>(stage);  // slot c: words 2c (x, y, z, id), 2c + 1
  const uint4* s_rec = reinterpret_cast<const uint4*>(stage + static_cast<size_t>(cap) * 32);
  int occ = 0;
  for (int c0 = 0; c0 < cap; c0 += 32) {
    const int c = c0 + lane;
    bool occupied = false;
    if (c < cap) {
      const uint4 a = s_row[2 * c];
      occupied = kByCoords ? __uint_as_float(a.x) < 1e8f : static_cast<int32_t>(a.w) >= 0;
    }
    occ += __popc(__ballot_sync(0xffffffffu, occupied));
  }
  const int shift = __clz(queries - 1) - 27;  // log2(lpq) for 1 <= queries <= 32
  const int lpq = 1 << shift, q = lane >> shift, sub = lane & (lpq - 1);
  const uint4 rec = s_rec[q < queries ? q : 0];
  float best = CUDART_INF_F;
  int best_c = sub < cap ? sub : 0x7fffffff;
  if (q < queries && (rec.w >> 31) && sub < cap) {  // a masked query sees inf in every slot
    const float qx = __uint_as_float(rec.x), qy = __uint_as_float(rec.y), qz = __uint_as_float(rec.z);
#pragma unroll 4
    for (int c = sub; c < cap; c += lpq) {
      const uint4 a = s_row[2 * c];
      const float dx = __fsub_rn(__uint_as_float(a.x), qx);
      const float dy = __fsub_rn(__uint_as_float(a.y), qy);
      const float dz = __fsub_rn(__uint_as_float(a.z), qz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
      if ((kByCoords || static_cast<int32_t>(a.w) >= 0) && d2 < best) {
        best = d2;
        best_c = c;
      }
    }
  }
  for (int off = lpq >> 1; off > 0; off >>= 1) {  // the least (d2, slot) of the group
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oc = __shfl_xor_sync(0xffffffffu, best_c, off);
    if (ob < best || (ob == best && oc < best_c)) {
      best = ob;
      best_c = oc;
    }
  }
  const uint4 p = s_row[2 * best_c], pn = s_row[2 * best_c + 1];
  __syncwarp();  // every lane has read the stage
  uint4* s_out = reinterpret_cast<uint4*>(stage);
  if (q < queries && sub == 0) {  // query q's row, its 16-byte chunks swizzled
    const int sw = (q >> 1) & 3;
    s_out[4 * q + (0 ^ sw)] = p;
    s_out[4 * q + (1 ^ sw)] = make_uint4(pn.x, pn.y, pn.z, __float_as_uint(best));
    s_out[4 * q + (2 ^ sw)] = make_uint4(__float_as_uint(static_cast<float>(occ)), 0u, 0u, 0u);
  }
  __syncwarp();
  const int k = lane & 3;
  for (int r = 0; r < (queries + 7) / 8; ++r) {
    const int qq = 8 * r + (lane >> 2);
    const uint32_t i = __shfl_sync(0xffffffffu, rec.w, qq << shift) & 0x7fffffffu;
    if (qq < queries) {
      const uint4 v = k == 3 ? make_uint4(0u, 0u, 0u, 0u) : s_out[4 * qq + (k ^ ((qq >> 1) & 3))];
      reinterpret_cast<uint4*>(out + static_cast<size_t>(i) * kOut)[k] = v;
    }
  }
}

// Persistent warps over the work items, each with two stages (its shared
// memory: two mbarriers, then two stages of a row and 32 records).
template <bool kByCoords>
__global__ void __launch_bounds__(kThreads)
gather_select_rank(const uint4* __restrict__ table, int cap, Work w, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int stage_bytes = stage_of(cap);
  unsigned char* mine = smem + static_cast<size_t>(warp) * (16 + 2 * stage_bytes);
  const uint32_t bar = smem_u32(mine);  // stage s completes on bar + 8 s
  unsigned char* stage = mine + 16;
  const int n_items = *w.n_items;
  const int stride = gridDim.x * kWarps;
  int item = blockIdx.x * kWarps + warp;
  if (item >= n_items) return;
  if (lane == 0) {
    bar_init(bar);
    bar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  int4 it = w.items[item];
  if (lane == 0) stage_item(table, w.records, cap, it, stage, bar);
  int next = item + stride;
  int4 it_next = next < n_items ? w.items[next] : make_int4(0, 0, 0, 0);
  uint32_t parity = 0;  // bit s: the phase parity stage s waits for
  for (int s = 0;; s ^= 1) {
    if (next < n_items && lane == 0)
      stage_item(table, w.records, cap, it_next, stage + (s ^ 1) * stage_bytes, bar + 8 * (s ^ 1));
    const int after = next + stride;
    const int4 it_after = after < n_items ? w.items[after] : make_int4(0, 0, 0, 0);
    bar_wait(bar + 8 * s, (parity >> s) & 1u);
    parity ^= 1u << s;
    rank_item<kByCoords>(stage + s * stage_bytes, cap, it.z, lane, out);
    __syncwarp();  // the stage is read before it is filled again
    if (next >= n_items) break;
    it = it_next;
    it_next = it_after;
    next = after;
  }
}

template <bool kByCoords>
cudaError_t launch_rank(const Plan& p, cudaStream_t s, const uint4* table, int cap, Work w, uint32_t* out) {
  static int opted = 48 * 1024;  // the dynamic shared memory this instantiation may take
  if (p.block_smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        gather_select_rank<kByCoords>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.block_smem);
    if (err != cudaSuccess) return err;
    opted = p.block_smem;
  }
  gather_select_rank<kByCoords><<<p.rank_blocks, kThreads, p.block_smem, s>>>(table, cap, w, out);
  return cudaGetLastError();
}

}  // namespace

// table: [T, cap, 8] float32 words (16-byte aligned); h: [N] int32; query:
// [N, 3] float32; mask: [N] uint8 or bool; scratch: scratch_words int32
// words (16-byte aligned), nothing zero on entry; out: [N, 16] float32
// words (16-byte aligned); scratch_words, rank_blocks and block_smem: the
// plan of kernels/gather_select.py k2_plan, refused (-1) unless equal to
// make_plan's; by_coords: 0 for K2's contract, 1 for K4's. Refused before
// any pass: N outside [0, 2^31), T outside [1, 2^30] or cap < 1 (-3); rows
// whose rank block does not fit in a block's shared memory (-2; cap above
// 437 on an H100). Issues a memset and four kernels on `stream`, returns
// the first CUDA error (0 on success).
extern "C" int gather_select_launch(const void* table, const int32_t* h, const float* query,
                                    const uint8_t* mask, long long N, int T, int cap, int* scratch,
                                    long long scratch_words, int rank_blocks, int block_smem,
                                    int by_coords, void* out, void* stream) {
  if (N < 0 || N > kMaxN || T < 1 || T > kMaxT || cap < 1) return kOutOfRange;
  int device = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan p = make_plan(N, T, cap);
  if (p.block_smem > smem_max) return kTooWide;
  if (scratch_words != p.words || rank_blocks != p.rank_blocks || block_smem != p.block_smem)
    return kBadPlan;
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Work w;
  w.records = reinterpret_cast<uint4*>(scratch);
  w.items = reinterpret_cast<int4*>(scratch + p.items);
  w.state = reinterpret_cast<uint64_t*>(scratch + p.state);
  w.ticket = scratch + p.ticket;
  w.count = scratch + p.count;
  w.offset = scratch + p.offset;
  w.n_items = scratch + p.n_items;
  err = cudaMemsetAsync(w.state, 0, static_cast<size_t>(p.zero_words) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = static_cast<int>(N);
  const int blocks = (n + kThreads - 1) / kThreads;
  uint32_t* o = static_cast<uint32_t*>(out);
  gather_select_count<<<blocks, kThreads, 0, s>>>(h, n, T, w, o);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_select_scan<<<p.row_blocks, kScanThreads, 0, s>>>(T, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  gather_select_scatter<<<blocks, kThreads, 0, s>>>(h, query, mask, n, T, w);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const uint4* t = static_cast<const uint4*>(table);
  err = by_coords ? launch_rank<true>(p, s, t, cap, w, o) : launch_rank<false>(p, s, t, cap, w, o);
  return static_cast<int>(err);
}

extern "C" const char* gather_select_error_string(int code) {
  if (code == kBadPlan) return "gather_select: the plan differs from the launcher's";
  if (code == kTooWide) return "gather_select: rows wider than the rank block's shared memory stages";
  if (code == kOutOfRange) return "gather_select: N, T or cap out of range";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
