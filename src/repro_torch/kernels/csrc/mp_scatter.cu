// The scatter of a materialised edge stream on Hopper (sm_90a): masked
// scatter-sum, and the single-pass multi-statistic sweep.
//
// Replaces the TPU kernels repro/kernels/mp_scatter.py::mp_scatter (body
// _mp_scatter_kernel) and ::mp_scatter_multi (body _mp_scatter_multi_kernel).
// For every destination row i, over the unmasked edges e with rcv_e == i in
// stream order, with m_e the f32 message row (E, D):
//
//   sum_i   = sum m_e         sumsq_i = sum m_e^2 (squared in f32)
//   count_i = #edges  (N, 1)
//   max_i   = max m_e (-inf when empty)   min_i = min m_e (+inf when empty)
//
// mp_scatter_launch computes sum alone; mp_scatter_multi_launch any subset,
// a null output pointer switching its statistic off. Empty destinations
// keep the accumulators' neutrals: 0, -inf and +inf (mp_pipeline's keyed
// extrema use the finite -+1e30 instead; this contract is the reference's).
// Receivers outside [0, n) are never owned and add nothing.
//
// Messages are float32 or bfloat16 (the MoE dispatch's tokens). Either is
// widened on load and accumulated in float32. mp_scatter_launch returns
// the messages' dtype, as the reference (which accumulates in f32 and casts
// with astype, round to nearest even): bfloat16 sums are rounded here with
// __float2bfloat16_rn, not written as f32 for a cast to finish. The multi
// sweep's outputs are always the raw f32 accumulators.
//
// The Pallas kernels route each edge tile through a one-hot matrix on the
// TPU's matrix unit (_route_matrix) and take max / min by an (edge_tile,
// bank, D) mask-select. Both are devices of the TPU and are not carried
// over; this kernel computes what mp_scatter_ref / mp_scatter_multi_ref
// compute.
//
// What bounds it on an H100. Each input read once and each output written
// once: the mask, the owned edges' receivers (4 bytes) and message rows,
// the outputs. The MoE dispatch (olmoe-1b-7b, 8,192 bf16 rows of D = 2048
// into 10,240 slots) moves ~74 MB: ~22 us at 3.35 TB/s, and HBM runs at
// that rate only with ~25 KB of loads in flight per SM (Little's law at
// ~1 us). The GNN buckets (hep: N = 64, E = 1024, ~800 owned; GIN's D = 100
// sum is ~0.35 MB, ~0.10 us) are bound by the launch and the bucketing. A
// long row is bound by its fold: every column's sum is one chain of
// dependent adds in stream order (a 5,000-edge hub: ~5,000 x 4 cycles).
//
// Design: one launch a call, in one of two forms; the wrapper picks the
// form (kernels/mp_scatter.py::launch_form), both bitwise equal:
//   * Block form (an ordinary launch; E <= kLocalEdges): block (x, y) owns
//     the rows [x * rows, (x + 1) * rows) and the y-th chunk of kBlockChunk
//     bytes of each message row. It buckets its rows' edges in shared
//     memory with edge_buckets.cuh::bucket_edges_stable, which places them
//     in stream order (no sort), then folds every one of its rows, one
//     after another, through long_rows.cuh's ring: all 8 warps copy the
//     chunks of the rows' edges by cp.async, up to 48 KB ahead, and the
//     threads that own the chunk's 4-byte words fold them in stream order.
//     So a row of any length is folded by a block, its loads issued by all
//     of the block's warps.
//   * Grid form (cooperative: cudaLaunchCooperativeKernel, every block the
//     card holds at once, from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
//     a launch the card refuses is returned, with no fallback). Phases 0-3
//     from edge_buckets.cuh::bucket_edges: count, scan and place every
//     owned edge by row in the wrapper's int32 scratch, four grid barriers;
//     atomics count and place, none adds a message; phase 2 lists the rows
//     longer than kShort<S> with their segments (row, start, length), no
//     barrier added. Phase 4 folds the short rows: a work item is (row,
//     slice of D); a block takes `rows` rows a step and its 8 warps share
//     the items, lane k of a warp reading the segment head of its k-th
//     item (one round trip for up to 32 items); a warp sorts the segment in
//     registers (edge_buckets.cuh::fold_sorted: up to 128 edges in the
//     one-slice kernels, 32 in the wide ones), loads 16 bytes a lane (8
//     bf16 or 4 f32) for S slices of 32 lanes, issues the loads of U edges
//     before folding any, and folds into register accumulators. Phase 5
//     folds the long rows: the grid's blocks take (long row, chunk) units,
//     chunks of kBlockChunk bytes, or of kSplitChunk from kSplitLen edges
//     on (a hub's columns over 4x the blocks); each sorts the row's segment
//     alone by a bitmap of its edge indices (long_rows.cuh::sorted_segment)
//     and folds its chunk through the ring as the block form does. No row
//     longer than kShort<S> is folded by one warp, and no row's order comes
//     from a sweep of the edge stream.
//   * Both forms fold with __fadd_rn, __fmul_rn, fmaxf and fminf from the
//     neutrals, and every (row, column) is folded by one thread over the
//     row's owned edges in stream order: the outputs are bitwise a float32
//     stream-order fold, for any `rows`, grid, form and run.
//   * Where a row start is not 16-byte aligned (D not a multiple of the
//     16-byte lane group, or a pointer off 16 bytes) the grid form's warps
//     load and store element by element, and the ring copies 4 bytes a
//     lane (or elements, for bfloat16 rows off 4 bytes).
//   * Each statistic is written once: bf16 sums by __float2bfloat16_rn, f32
//     otherwise; count by the first owner of the row's first chunk.
//   * f32 throughout, no fast math; the launchers allocate nothing and do
//     not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "edge_buckets.cuh"
#include "long_rows.cuh"

namespace {

using buckets::kThreads;
using buckets::kWarps;
// block form: up to kLocalEdges edges (one stable tile) and kLocalRows rows
// a block; its bucketing lists (2 * kLocalEdges ints) live in the ring's
// shared memory, free until the ring's first copy
constexpr int kLocalEdges = 4096;
constexpr int kLocalRows = 1024;
// the ring of both forms: 4 slots of 16 KB. A block form's block folds
// chunks of kBlockChunk bytes of its rows; a long row folds in chunks of
// kBlockChunk too, or of kSplitChunk (its columns over 4x the blocks) from
// kSplitLen edges on, where one block's share of the copies would take
// longer than the row's fold
constexpr int kStage = 16384;
constexpr int kSlots = 4;
constexpr int kRing = long_rows::kRingBytes<kStage, kSlots>;
constexpr int kBlockChunk = 512;
constexpr int kSplitChunk = 128;
constexpr int kSplitLen = 1024;
static_assert(2 * kLocalEdges * 4 <= kRing,
              "the bucketing lists live in the ring");
// registers a lane for sorting a short row's segment in the grid form: the
// one-slice (GNN-width) kernels sort up to 128 edges, the wide ones up to
// 32 (the larger sort slowed the MoE dispatch, whose rows hold one edge);
// a longer row is phase 5's
template <int S>
constexpr int kSortRegs = S == 1 ? 4 : 1;
template <int S>
constexpr int kShort = 32 * kSortRegs<S>;

struct Args {
  const void* msg;       // (e, d) float or __nv_bfloat16
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  void* sum;             // (n, d) float, or __nv_bfloat16 when sum_bf16;
                         // each output null when not asked
  float* sumsq;          // (n, d)
  float* count;          // (n, 1)
  float* mx;             // (n, d)
  float* mn;             // (n, d)
  // the grid form's int32 scratch: counts (n), row_start (n + 1), order
  // (e), the long rows' counts (2: split, whole) and (row, start, length)
  // triples (3 ((e >> 5) + 1): the split rows from the front, the others
  // from the back)
  int* counts;
  int* row_start;
  int* order;
  int* long_count;
  int* long_rows;
  int n, e, d;
  int rows;              // block form: rows a block; grid form: rows a
                         // block takes per step of phase 4
  int sum_bf16;          // write sum as bfloat16 (round to nearest even)
  int vec;               // rows start 16-byte aligned: 16-byte loads/stores
  int copy;              // long_rows::Copy of the ring
};

// word k of a 16-byte load (k a compile-time constant after unrolling)
__device__ __forceinline__ uint32_t word(const uint4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// element k of a 16-byte group of In, widened to f32
template <typename In>
__device__ __forceinline__ float element(const uint4& v, int k) {
  if constexpr (sizeof(In) == 4) {
    return __uint_as_float(word(v, k));
  } else {   // bfloat16: the upper 16 bits of an f32
    const uint32_t w = word(v, k >> 1);
    return __uint_as_float((k & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// The 16-byte group of row `id` from column `col`, zero past d: one 16-byte
// load when rows are 16-byte aligned (vec), else element by element.
template <typename In, bool kVec>
__device__ __forceinline__ uint4 load_group(const In* msg, int id, int col,
                                            int d) {
  const In* src = msg + (static_cast<size_t>(id) * d + col);
  if constexpr (kVec) {
    return col < d ? __ldg(reinterpret_cast<const uint4*>(src))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(In) == 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (col + k < d) w[k] = __ldg(reinterpret_cast<const unsigned*>(src) + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (col + k < d) {
        const uint32_t h =
            __ldg(reinterpret_cast<const unsigned short*>(src) + k);
        w[k >> 1] |= h << (16 * (k & 1));
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The S groups of U rows (ids[u] for u < cnt, ids[0] again past it, so that
// every load is issued before the first fold, with no branch between).
template <typename In, int S, int U, bool kVec>
__device__ __forceinline__ void load_batch(const In* msg, const int (&ids)[U],
                                           int cnt, const int (&col)[S],
                                           int d, uint4 (&raw)[U][S]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int id = u < cnt ? ids[u] : ids[0];
#pragma unroll
    for (int s = 0; s < S; ++s) raw[u][s] = load_group<In, kVec>(msg, id, col[s], d);
  }
}

// V f32 values to out[off, off + V), columns past d skipped
template <int V>
__device__ __forceinline__ void store_f32(float* out, size_t off, int col,
                                          int d, bool vec, const float* a) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      reinterpret_cast<float4*>(out + off)[q] =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (col + k < d) out[off + k] = a[k];
  }
}

// 8 values as bfloat16 (round to nearest even) to out[off, off + 8)
__device__ __forceinline__ void store_bf16(__nv_bfloat16* out, size_t off,
                                           int col, int d, bool vec,
                                           const float* a) {
  if (vec) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * q]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(a[2 * q + 1]));
      w[q] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(out + off) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (col + k < d) out[off + k] = __float2bfloat16_rn(a[k]);
  }
}

// The grid form's phase 4 for one (row, slice) of a short row (len <=
// kShort<S>): lane `lane` owns columns col0 + (s * 32 + lane) * V + [0, V)
// for s < S; (start, len, first) is the row's segment_head. kMulti keeps
// all four wide statistics (each written only when asked); otherwise the
// sum alone.
template <typename In, int S, int U, bool kMulti>
__device__ __forceinline__ void accumulate_row(const Args& p,
                                               const buckets::Buckets& b,
                                               int row, int col0, int start,
                                               int len, int first) {
  constexpr int V = 16 / sizeof(In);
  const In* msg = static_cast<const In*>(p.msg);
  const int lane = threadIdx.x & 31;
  const bool vec = p.vec != 0;
  int col[S];
  float sum[S][V], sq[S][V], mx[S][V], mn[S][V];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    col[s] = col0 + (s * 32 + lane) * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum[s][k] = 0.f;
      if constexpr (kMulti) {
        sq[s][k] = 0.f;
        mx[s][k] = -INFINITY;
        mn[s][k] = INFINITY;
      }
    }
  }

  buckets::fold_in_stream_order<U, kSortRegs<S>>(
      b, start, len, first, [&](const int (&ids)[U], int cnt) {
        uint4 raw[U][S];
        if (vec) {
          load_batch<In, S, U, true>(msg, ids, cnt, col, p.d, raw);
        } else {
          load_batch<In, S, U, false>(msg, ids, cnt, col, p.d, raw);
        }
        // a load past cnt folds each statistic's neutral: s + 0 is s for
        // every sum here (a sum from +0 is never -0), fmaxf(m, -inf) is m
        // and fminf(m, +inf) is m
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool take = u < cnt;
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const float x = element<In>(raw[u][s], k);
              sum[s][k] = __fadd_rn(sum[s][k], take ? x : 0.f);
              if constexpr (kMulti) {
                sq[s][k] = __fadd_rn(sq[s][k], take ? __fmul_rn(x, x) : 0.f);
                mx[s][k] = fmaxf(mx[s][k], take ? x : -INFINITY);
                mn[s][k] = fminf(mn[s][k], take ? x : INFINITY);
              }
            }
          }
        }
      });

#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (col[s] >= p.d) continue;
    const size_t off = static_cast<size_t>(row) * p.d + col[s];
    if (p.sum) {
      if constexpr (sizeof(In) == 2 && !kMulti) {
        if (p.sum_bf16) {
          store_bf16(static_cast<__nv_bfloat16*>(p.sum), off, col[s], p.d,
                     vec, sum[s]);
        } else {
          store_f32<V>(static_cast<float*>(p.sum), off, col[s], p.d, vec,
                       sum[s]);
        }
      } else {
        store_f32<V>(static_cast<float*>(p.sum), off, col[s], p.d, vec,
                     sum[s]);
      }
    }
    if constexpr (kMulti) {
      if (p.sumsq) store_f32<V>(p.sumsq, off, col[s], p.d, vec, sq[s]);
      if (p.mx) store_f32<V>(p.mx, off, col[s], p.d, vec, mx[s]);
      if (p.mn) store_f32<V>(p.mn, off, col[s], p.d, vec, mn[s]);
    }
  }
  if constexpr (kMulti) {
    if (p.count && col0 == 0 && lane == 0) {
      p.count[row] = static_cast<float>(len);
    }
  }
}


// --- the ring's fold (block form, and the grid form's long rows)

// One owner's accumulators: the V columns of its 4-byte word.
template <typename In, bool kMulti>
struct Acc {
  static constexpr int V = 4 / sizeof(In);
  float sum[V], sq[V], mx[V], mn[V];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sum[k] = 0.f;
      sq[k] = 0.f;
      mx[k] = -INFINITY;
      mn[k] = INFINITY;
    }
  }

  __device__ __forceinline__ void add(uint32_t w) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float x = V == 1 ? __uint_as_float(w)
                             : __uint_as_float(k ? (w & 0xffff0000u)
                                                 : (w << 16));
      sum[k] = __fadd_rn(sum[k], x);
      if constexpr (kMulti) {
        sq[k] = __fadd_rn(sq[k], __fmul_rn(x, x));
        mx[k] = fmaxf(mx[k], x);
        mn[k] = fminf(mn[k], x);
      }
    }
  }

  // row's columns col + [0, V) (those below d); count (len) by the owner of
  // the row's first word
  __device__ __forceinline__ void write(const Args& p, int row, int col,
                                        int len, bool first) const {
    const size_t off = static_cast<size_t>(row) * p.d + col;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (col + k >= p.d) break;
      if (p.sum) {
        if (sizeof(In) == 2 && !kMulti && p.sum_bf16) {
          static_cast<__nv_bfloat16*>(p.sum)[off + k] =
              __float2bfloat16_rn(sum[k]);
        } else {
          static_cast<float*>(p.sum)[off + k] = sum[k];
        }
      }
      if constexpr (kMulti) {
        if (p.sumsq) p.sumsq[off + k] = sq[k];
        if (p.mx) p.mx[off + k] = mx[k];
        if (p.mn) p.mn[off + k] = mn[k];
      }
    }
    if constexpr (kMulti) {
      if (p.count && first) p.count[row] = static_cast<float>(len);
    }
  }
};

// chunk `k` of kBytes of a row of In
template <typename In, int kBytes>
__device__ __forceinline__ long_rows::Chunk chunk_of(const Args& p, int k) {
  constexpr int kCols = kBytes / sizeof(In);
  const int cw = min(kCols, p.d - k * kCols);
  return {static_cast<const uint8_t*>(p.msg), p.d,
          static_cast<int>(sizeof(In)), k * kCols, cw, p.copy,
          long_rows::slot_of(cw * static_cast<int>(sizeof(In)))};
}

// The block form after its buckets: the block's rows [row0, row0 +
// rows_here), segments order[row_start[q], row_start[q + 1]) in stream
// order (shared memory), folded one after another through the ring, chunk
// k; empty rows get the neutrals.
template <typename In, bool kMulti>
__device__ __forceinline__ void fold_block_rows(const Args& p, uint8_t* ring,
                                                const int* row_start,
                                                const int* order, int row0,
                                                int rows_here, int k) {
  constexpr int V = Acc<In, kMulti>::V;
  const long_rows::Chunk c = chunk_of<In, kBlockChunk>(p, k);
  const int c0 = c.c0;
  const int w = threadIdx.x;
  const bool owns = w * V < c.cw;
  Acc<In, kMulti> a;
  a.reset();
  int q = 0;
  int end = row_start[1];
  const auto flush = [&]() {
    a.write(p, row0 + q, c0 + w * V, row_start[q + 1] - row_start[q],
            c0 == 0 && w == 0);
    a.reset();
    if (++q < rows_here) end = row_start[q + 1];
  };
  long_rows::stream<kStage, kSlots>(
      c, order, row_start[rows_here], ring,
      [&](int j0, int cnt, const uint8_t* stage) {
        if (!owns) return;
        // the stage's entries row by row: a row ending here is written
        // (empty ones too) before the next row's first entry is folded
        for (int k = 0; k < cnt;) {
          while (j0 + k == end) flush();
          const int stop = min(cnt, end - j0);
          long_rows::fold_range(stage, c.slot, k, stop, w,
                                [&](uint32_t v) { a.add(v); });
          k = stop;
        }
      });
  if (owns) {
    while (q < rows_here) flush();
  }
}

// The grid form's phase 5 for one (long row, chunk k of kBytes): the
// segment order[start, start + len) sorted by the block, folded through
// the ring (smem: ring, the sort's memory). Not inlined: phase 4's
// registers do not carry its state.
template <typename In, bool kMulti, int kBytes>
__device__ __noinline__ void fold_long_row(const Args& p, uint8_t* smem,
                                           int row, int k, int start,
                                           int len) {
  constexpr int V = Acc<In, kMulti>::V;
  const long_rows::Chunk c = chunk_of<In, kBytes>(p, k);
  const int c0 = c.c0;
  const int w = threadIdx.x;
  const bool owns = w * V < c.cw;
  Acc<In, kMulti> a;
  a.reset();
  long_rows::sorted_segment(
      p.order + start, len, p.e, smem + kRing,
      [&](const int* ids, int cnt) {
        long_rows::stream<kStage, kSlots>(
            c, ids, cnt, smem,
            [&](int, int cnt_here, const uint8_t* stage) {
              if (owns) {
                long_rows::fold_range(stage, c.slot, 0, cnt_here, w,
                                      [&](uint32_t v) { a.add(v); });
              }
            });
      });
  if (owns) a.write(p, row, c0 + w * V, len, c0 == 0 && w == 0);
}

// bucket_edges_stable's caller streams: none
struct NoExtra {
  __device__ __forceinline__ void load(int, int) {}
  __device__ __forceinline__ void store(int, int, int, int) {}
};

// kGrid: the grid form (S slices of 32 lanes a warp item, U edges in
// flight); else the block form (S, U unused: 0).
template <typename In, int S, int U, bool kMulti, bool kGrid>
__global__ void __launch_bounds__(kThreads, kGrid ? 2 : 1)
    mp_scatter_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const buckets::Edges g = {p.rcv, p.mask, p.n, p.e};
  if constexpr (!kGrid) {
    // ring | counts (rows) | row_start (rows + 1) | order (e); the
    // bucketing's lists in the ring, dead before its first copy
    int* list_e = reinterpret_cast<int*>(smem);
    int* counts = reinterpret_cast<int*>(smem + kRing);
    int* row_start = counts + p.rows;
    int* order = row_start + p.rows + 1;
    const int row0 = blockIdx.x * p.rows;
    const int rows_here = min(p.rows, p.n - row0);
    const buckets::Buckets b = {counts, row_start, order, row0,
                                row0 + rows_here};
    NoExtra x;
    // at most 1,024 edges (the serving buckets): 4 edges a thread
    if (p.e <= kThreads * 4) {
      buckets::bucket_edges_stable<4>(g, b, list_e, list_e + p.e, x);
    } else {
      buckets::bucket_edges_stable<kLocalEdges / kThreads>(
          g, b, list_e, list_e + p.e, x);
    }
    fold_block_rows<In, kMulti>(p, smem, row_start, order, row0, rows_here,
                                blockIdx.y);
  } else {
    buckets::Buckets b = {p.counts, p.row_start, p.order, 0, p.n};
    if (blockIdx.x == 0 && threadIdx.x < 2) p.long_count[threadIdx.x] = 0;
    // phases 0-3; phase 2 lists the long rows: (row, start, length), the
    // split ones from the front of the list, the others from its back
    const int cap = (p.e >> 5) + 1;
    buckets::bucket_edges(g, b, [&](int row, int start, int len) {
      if (len > kShort<S>) {
        const bool split = len >= kSplitLen;
        const int i = atomicAdd(p.long_count + !split, 1);
        int* at = p.long_rows + 3 * (split ? i : cap - 1 - i);
        at[0] = row;
        at[1] = start;
        at[2] = len;
      }
    });

    // phase 4: the short rows
    constexpr int kSliceCols = 32 * (16 / static_cast<int>(sizeof(In))) * S;
    const int slices = (p.d + kSliceCols - 1) / kSliceCols;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long step = static_cast<long long>(gridDim.x) * p.rows;
    for (long long row0 = static_cast<long long>(blockIdx.x) * p.rows;
         row0 < p.n; row0 += step) {
      const int rows_here =
          static_cast<int>(p.n - row0 < p.rows ? p.n - row0 : p.rows);
      // warp w takes items w, w + kWarps, ...; lane k reads the segment of
      // the k-th of up to 32 of them in one round trip
      const int items = rows_here * slices;
      for (int it0 = warp; it0 < items; it0 += 32 * kWarps) {
        const int mine = it0 + lane * kWarps;
        int start = 0, len = 0, first = 0;
        if (mine < items) {
          buckets::segment_head(
              b, static_cast<int>(row0) + mine / slices, &start, &len,
              &first);
        }
        const int here = min(32, (items - it0 + kWarps - 1) / kWarps);
        for (int k = 0; k < here; ++k) {
          const int it = it0 + k * kWarps;
          const int seg_len = __shfl_sync(buckets::kFull, len, k);
          if (seg_len > kShort<S>) continue;   // phase 5's
          accumulate_row<In, S, U, kMulti>(
              p, b, static_cast<int>(row0) + it / slices,
              (it % slices) * kSliceCols,
              __shfl_sync(buckets::kFull, start, k), seg_len,
              __shfl_sync(buckets::kFull, first, k));
        }
      }
    }

    // phase 5: the long rows, (row, chunk) units over the grid: the split
    // rows' chunks of kSplitChunk first, then the others' of kBlockChunk
    constexpr int kSplitCols = kSplitChunk / sizeof(In);
    constexpr int kWholeCols = kBlockChunk / sizeof(In);
    const int split_chunks = (p.d + kSplitCols - 1) / kSplitCols;
    const int whole_chunks = (p.d + kWholeCols - 1) / kWholeCols;
    const long long split_units =
        static_cast<long long>(__ldcg(p.long_count)) * split_chunks;
    const long long units =
        split_units +
        static_cast<long long>(__ldcg(p.long_count + 1)) * whole_chunks;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      if (u < split_units) {
        const int* at = p.long_rows + 3 * (u / split_chunks);
        fold_long_row<In, kMulti, kSplitChunk>(
            p, smem, __ldcg(at), static_cast<int>(u % split_chunks),
            __ldcg(at + 1), __ldcg(at + 2));
      } else {
        const long long v = u - split_units;
        const int* at = p.long_rows + 3 * (cap - 1 - v / whole_chunks);
        fold_long_row<In, kMulti, kBlockChunk>(
            p, smem, __ldcg(at), static_cast<int>(v % whole_chunks),
            __ldcg(at + 1), __ldcg(at + 2));
      }
    }
  }
}

// The grid form's kernel for these messages: the sum over a narrow row
// (one slice of 32 lanes covers it) issues 8 edges' loads at once, over a
// wide row 4 slices of 2 edges'; the multi sweep (four wide statistics in
// registers) takes one slice of 8 edges. The block form's: one a type and
// sweep.
using Kernel = void (*)(const Args);

template <typename In, bool kMulti>
Kernel pick(int d, bool grid) {
  constexpr int kNarrow = 32 * 16 / sizeof(In);
  if (!grid) return mp_scatter_kernel<In, 0, 0, kMulti, false>;
  if constexpr (kMulti) {
    return mp_scatter_kernel<In, 1, 8, true, true>;
  } else {
    if (d <= kNarrow) return mp_scatter_kernel<In, 1, 8, false, true>;
    return mp_scatter_kernel<In, 4, 2, false, true>;
  }
}

Kernel pick(int d, int bf16, int multi, bool grid) {
  if (bf16) {
    return multi ? pick<__nv_bfloat16, true>(d, grid)
                 : pick<__nv_bfloat16, false>(d, grid);
  }
  return multi ? pick<float, true>(d, grid) : pick<float, false>(d, grid);
}

// Dynamic shared memory: the block form's ring and buckets for `rows` rows
// and e edges; the grid form's ring and sort (phase 5).
size_t block_smem(int rows, int e) {
  return kRing +
         (2 * static_cast<size_t>(rows) + 1 + std::max(e, 1)) * sizeof(int);
}
constexpr size_t kGridSmem = kRing + long_rows::kSortBytes;

// How a call is launched: the kernel, its grid (x: blocks of rows, y:
// chunks of the block form), the rows a block takes and the dynamic shared
// memory.
struct Plan {
  Kernel kernel;
  int grid, chunks, rows;
  size_t smem;
};

// Lets `kernel` take the most dynamic shared memory either form asks of
// it, once per device and kernel. Returns a CUDA error (0 on success).
int allow_smem(Kernel kernel, size_t most) {
  static std::mutex mu;
  static std::map<std::tuple<int, Kernel>, bool> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> hold(mu);
  const auto key = std::make_tuple(dev, kernel);
  if (done.count(key)) return 0;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
  if (err != cudaSuccess) return static_cast<int>(err);
  done[key] = true;
  return 0;
}

// Blocks of `kernel` the current device holds at once (SMs times blocks an
// SM), asked of the runtime once per device, kernel and shared memory:
// the occupancy query costs host time on every call otherwise. Negative: a
// CUDA error.
int resident_blocks(Kernel kernel, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, Kernel, size_t>, int> known;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const auto key = std::make_tuple(dev, kernel, smem);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find(key);
  if (it != known.end()) return it->second;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kThreads, smem);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return known[key] = sms * per_sm;
}

// The plan of `form` (0 block, 1 grid) for these sizes; rows: the block
// form's rows a block (>= 1), the grid form's rows a block per step (<= 0:
// the kernel's choice). Returns a CUDA error (0 on success).
int plan(const Args& p, int rows, int bf16, int multi, int form, Plan* out) {
  Plan q = {};
  q.kernel = pick(p.d, bf16, multi, form != 0);
  int err = allow_smem(q.kernel, form ? kGridSmem
                                      : block_smem(kLocalRows, kLocalEdges));
  if (err != 0) return err;
  if (form == 0) {
    if (p.e > kLocalEdges || rows < 1 || rows > kLocalRows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int cols = kBlockChunk / (bf16 ? 2 : 4);
    q.grid = (p.n + rows - 1) / rows;
    q.chunks = (p.d + cols - 1) / cols;
    q.rows = rows;
    q.smem = block_smem(rows, p.e);
    *out = q;
    return 0;
  }
  // the cooperative grid: every block the card holds at once (phase 5's
  // long rows are known only inside the launch)
  q.smem = kGridSmem;
  const int most = resident_blocks(q.kernel, q.smem);
  if (most < 0) return -most;
  if (most < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  q.grid = most;
  q.chunks = 1;
  q.rows = rows > 0 ? rows : (p.n + q.grid - 1) / q.grid;
  *out = q;
  return 0;
}

bool aligned(const void* ptr, uintptr_t to = 16) {
  return (reinterpret_cast<uintptr_t>(ptr) & (to - 1)) == 0;
}

int launch(Args& p, int rows, int bf16, int multi, int form, void* scratch,
           void* stream) {
  if (p.d <= 0 || (form != 0 && form != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.n <= 0) return 0;
  if (form == 1) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    p.counts = static_cast<int*>(scratch);
    p.row_start = p.counts + p.n;
    p.order = p.row_start + p.n + 1;
    p.long_count = p.order + p.e;
    p.long_rows = p.long_count + 2;
  }
  Plan q = {};
  const int err = plan(p, rows, bf16, multi, form, &q);
  if (err != 0) return err;
  p.rows = q.rows;
  const int es = bf16 ? 2 : 4;
  const int group = 16 / es;   // elements in 16 bytes
  p.vec = p.d % group == 0 && aligned(p.msg) && aligned(p.sum) &&
          aligned(p.sumsq) && aligned(p.mx) && aligned(p.mn);
  const size_t row_bytes = static_cast<size_t>(p.d) * es;
  p.copy = row_bytes % 16 == 0 && aligned(p.msg)      ? long_rows::kCopy16
           : row_bytes % 4 == 0 && aligned(p.msg, 4) ? long_rows::kCopy4
                                                      : long_rows::kCopyElem;
  void* args[] = {&p};
  const auto fn = reinterpret_cast<const void*>(q.kernel);
  const auto s = static_cast<cudaStream_t>(stream);
  if (form == 0) {
    return static_cast<int>(cudaLaunchKernel(
        fn, dim3(q.grid, q.chunks), dim3(kThreads), args, q.smem, s));
  }
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(q.grid), dim3(kThreads), args, q.smem, s));
}

}  // namespace

// Scatter-sum msg (e, d) into out (n, d) over the unmasked edges, on
// `stream`: both f32, or both bf16 when bf16 != 0 (f32 accumulation), in
// `form` (0: block, rows a block >= 1, e <= 4096; 1: grid, rows <= 0 the
// kernel's choice, on `scratch`: (2n + 1 + e + 2 + 3 ((e >> 5) + 1)) int32
// the kernel clears itself; null for the block form). Returns the launch's
// CUDA error (0 on success).
extern "C" int mp_scatter_launch(const void* msg, const void* rcv,
                                 const void* mask, void* out, int n, int e,
                                 int d, int rows, int bf16, int form,
                                 void* scratch, void* stream) {
  Args p = {};
  p.msg = msg;
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sum = out;
  p.sum_bf16 = bf16 != 0;
  p.n = n;
  p.e = e;
  p.d = d;
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, rows, bf16, 0, form, scratch, stream);
}

// The multi-statistic sweep on `stream`: each non-null output gets its
// statistic (sum, sumsq, max, min of (n, d); count of (n, 1)), all f32,
// from f32 messages, or bf16 ones when bf16 != 0. Form, rows and scratch as
// mp_scatter_launch. Returns the launch's CUDA error (0 on success).
extern "C" int mp_scatter_multi_launch(const void* msg, const void* rcv,
                                       const void* mask, void* sum,
                                       void* sumsq, void* count, void* mx,
                                       void* mn, int n, int e, int d,
                                       int rows, int bf16, int form,
                                       void* scratch, void* stream) {
  Args p = {};
  p.msg = msg;
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sum = sum;
  p.sumsq = static_cast<float*>(sumsq);
  p.count = static_cast<float*>(count);
  p.mx = static_cast<float*>(mx);
  p.mn = static_cast<float*>(mn);
  p.n = n;
  p.e = e;
  p.d = d;
  if (!sum && !sumsq && !count && !mx && !mn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(p, rows, bf16, 1, form, scratch, stream);
}

// How the launchers would launch these sizes in `form` on the current
// device (rows as mp_scatter_launch): *grid blocks of rows, *chunks (the
// block form's column chunks), *rows_out rows a block, *smem dynamic shared
// memory. Returns a CUDA error (0 on success).
extern "C" int mp_scatter_plan(int n, int e, int d, int rows, int bf16,
                               int multi, int form, int* grid, int* chunks,
                               int* rows_out, int* smem) {
  Args p = {};
  p.n = n;
  p.e = e;
  p.d = d;
  Plan q = {};
  if (d <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = plan(p, rows, bf16, multi, form, &q);
  if (err != 0) return err;
  *grid = q.grid;
  *chunks = q.chunks;
  *rows_out = q.rows;
  *smem = static_cast<int>(q.smem);
  return 0;
}
