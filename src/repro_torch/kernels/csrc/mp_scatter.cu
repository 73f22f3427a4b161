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
// sum is ~0.35 MB, ~0.10 us) are bound by the launch and the barriers.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel, the grid
// sized by cudaOccupancyMaxActiveBlocksPerMultiprocessor so that every
// block is resident; a launch the card refuses is returned, with no
// fallback), so that each row reads only its own edges:
//   * Phases 0-3 come from edge_buckets.cuh: clear the per-row counts,
//     count the owned edges per receiver, scan the counts into row_start,
//     place each owned edge's index into its row's segment of order.
//     Atomics count and place; none adds a message. Two forms: the grid's
//     (all rows in the wrapper's int32 scratch, four grid barriers, CUDA
//     12's cooperative_groups grid sync, no -rdc) and the block-local one
//     (each block buckets the rows it is about to fold in shared memory,
//     block barriers only, reading the whole receiver stream itself). The
//     block-local form is taken while E <= kLocalEdges, the block's rows
//     <= kLocalRows and the grid re-reads at most kLocalRereads edges: at
//     the GNN buckets four grid barriers cost more than the re-read.
//   * Phase 4 accumulates. A work item is (row, slice of D); a block takes
//     `rows` rows a step and its 8 warps share the items, lane k of a warp
//     reading the segment head of its k-th item (one round trip for up to
//     32 items). A warp folds the row's edges in stream order (the segment
//     sorted in registers, up to 128 edges in the one-slice kernels and 32
//     in the wide ones, or a sweep of the stream for longer rows:
//     edge_buckets.cuh), loads 16 bytes a lane (8 bf16 or 4 f32) for S
//     slices of 32 lanes, issues the loads of U edges before folding any,
//     and folds into register accumulators with __fadd_rn, __fmul_rn,
//     fmaxf and fminf from the neutrals. Every (row, lane) is folded by one
//     thread in stream order: the outputs are bitwise a float32
//     stream-order fold, for any `rows`, grid, form and run.
//   * Where a row start is not 16-byte aligned (D not a multiple of the
//     16-byte lane group, or a pointer off 16 bytes) the same lanes load and
//     store element by element.
//   * Each statistic is written once: bf16 sums by __float2bfloat16_rn, f32
//     otherwise; count by lane 0 of the row's first slice.
//   * Grid: the grid form takes enough blocks for the edges
//     (kEdgesPerBlock) and the items (kItemsPerBlock), at most every
//     resident block (all SMs at the MoE widths); the block-local form one
//     block per kWarps items. mp_scatter_plan reports the choice.
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

namespace {

using buckets::kThreads;
using buckets::kWarps;
// grid form: blocks for the edges of phases 1 and 3 and the (row, slice)
// items of phase 4
constexpr int kEdgesPerBlock = 4096;
constexpr int kItemsPerBlock = 8;
// block-local form: up to kLocalEdges edges and kLocalRows rows a block
// step (its shared memory: counts, row_start and order), one item a warp
constexpr int kLocalEdges = 4096;
constexpr int kLocalRows = 1024;
constexpr size_t kLocalSmem = (2 * kLocalRows + 1 + kLocalEdges) * sizeof(int);
constexpr int kLocalItemsPerBlock = kWarps;
// edges the block-local grid reads in all (each block the whole stream):
// past it the grid form's barriers cost less (measured at N = 4096, E = 4096)
constexpr long long kLocalRereads = 1 << 19;
// registers a lane for sorting a row's segment: the one-slice (GNN-width)
// kernels sort up to 128 edges and sweep longer rows; the wide ones sort up
// to 32 (the larger sort slowed the MoE dispatch, whose rows hold one edge)
template <int S>
constexpr int kSortRegs = S == 1 ? 4 : 1;

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
  int* counts;           // (n,) scratch
  int* row_start;        // (n + 1,) scratch
  int* order;            // (e,) scratch
  int n, e, d;
  int rows;              // rows a block takes per step of phase 4
  int sum_bf16;          // write sum as bfloat16 (round to nearest even)
  int vec;               // rows start 16-byte aligned: 16-byte loads/stores
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

// Phase 4 for one (row, slice): lane `lane` owns columns col0 + (s * 32 +
// lane) * V + [0, V) for s < S; (start, len, first) is the row's
// segment_head. kMulti keeps all four wide statistics (each written only
// when asked); otherwise the sum alone.
template <typename In, int S, int U, bool kMulti, bool kGrid>
__device__ __forceinline__ void accumulate_row(const Args& p,
                                               const buckets::Edges& g,
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

  buckets::fold_in_stream_order<U, kSortRegs<S>, kGrid>(
      g, b, row, start, len, first, [&](const int (&ids)[U], int cnt) {
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

template <typename In, int S, int U, bool kMulti, bool kGrid>
__global__ void __launch_bounds__(kThreads)
    mp_scatter_kernel(const __grid_constant__ Args p) {
  extern __shared__ int local[];   // the block's buckets unless kGrid
  const buckets::Edges g = {p.rcv, p.mask, p.n, p.e};
  buckets::Buckets b = {p.counts, p.row_start, p.order, 0, p.n};
  if constexpr (kGrid) buckets::bucket_edges<true>(g, b);   // phases 0-3

  constexpr int kSliceCols = 32 * (16 / static_cast<int>(sizeof(In))) * S;
  const int slices = (p.d + kSliceCols - 1) / kSliceCols;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * p.rows;
  for (long long row0 = static_cast<long long>(blockIdx.x) * p.rows;
       row0 < p.n; row0 += step) {
    const int rows_here =
        static_cast<int>(p.n - row0 < p.rows ? p.n - row0 : p.rows);
    if constexpr (!kGrid) {
      b = {local, local + p.rows, local + 2 * p.rows + 1,
           static_cast<int>(row0), static_cast<int>(row0) + rows_here};
      buckets::bucket_edges<false>(g, b);   // phases 0-3, this step's rows
    }
    // warp w takes items w, w + kWarps, ...; lane k reads the segment of
    // the k-th of up to 32 of them in one round trip
    const int items = rows_here * slices;
    for (int it0 = warp; it0 < items; it0 += 32 * kWarps) {
      const int mine = it0 + lane * kWarps;
      int start = 0, len = 0, first = 0;
      if (mine < items) {
        buckets::segment_head<kGrid>(b, static_cast<int>(row0) + mine / slices,
                                     &start, &len, &first);
      }
      const int here = min(32, (items - it0 + kWarps - 1) / kWarps);
      for (int k = 0; k < here; ++k) {
        const int it = it0 + k * kWarps;
        accumulate_row<In, S, U, kMulti, kGrid>(
            p, g, b, static_cast<int>(row0) + it / slices,
            (it % slices) * kSliceCols, __shfl_sync(buckets::kFull, start, k),
            __shfl_sync(buckets::kFull, len, k),
            __shfl_sync(buckets::kFull, first, k));
      }
    }
    if constexpr (!kGrid) __syncthreads();   // the next step rebuilds them
  }
}

// The kernel for these messages: the sum over a narrow row (one slice of 32
// lanes covers it) issues 8 edges' loads at once, over a wide row 4 slices
// of 2 edges'; the multi sweep (four wide statistics in registers) takes
// one slice of 8 edges. Each in the grid and the block-local form.
using Kernel = void (*)(const Args);

template <typename In, bool kMulti, bool kGrid>
Kernel pick(int d) {
  constexpr int kNarrow = 32 * 16 / sizeof(In);
  if constexpr (kMulti) {
    return mp_scatter_kernel<In, 1, 8, true, kGrid>;
  } else {
    if (d <= kNarrow) return mp_scatter_kernel<In, 1, 8, false, kGrid>;
    return mp_scatter_kernel<In, 4, 2, false, kGrid>;
  }
}

template <bool kGrid>
Kernel pick(int d, int bf16, int multi) {
  if (bf16) {
    return multi ? pick<__nv_bfloat16, true, kGrid>(d)
                 : pick<__nv_bfloat16, false, kGrid>(d);
  }
  return multi ? pick<float, true, kGrid>(d) : pick<float, false, kGrid>(d);
}

int slice_cols(int d, int bf16, int multi) {
  const int v = bf16 ? 8 : 4;
  return 32 * v * ((multi || d <= 32 * v) ? 1 : 4);
}

// How a call is launched: the kernel, its cooperative grid, the rows a
// block takes per step and the dynamic shared memory of the block-local
// buckets.
struct Plan {
  Kernel kernel;
  int grid, rows;
  size_t smem;
  bool local;
};

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

// Blocks of the cooperative grid: enough for the edges (grid form) and the
// items, at most every block the card holds at once. Negative: a CUDA
// error.
int grid_size(Kernel kernel, size_t smem, const Args& p, int bf16, int multi,
              bool local) {
  const int most = resident_blocks(kernel, smem);
  if (most < 0) return most;
  const int cols = slice_cols(p.d, bf16, multi);
  const long long items = static_cast<long long>(p.n) * ((p.d + cols - 1) /
                                                         cols);
  const long long want =
      local ? (items + kLocalItemsPerBlock - 1) / kLocalItemsPerBlock
            : std::max((static_cast<long long>(p.e) + kEdgesPerBlock - 1) /
                           kEdgesPerBlock,
                       (items + kItemsPerBlock - 1) / kItemsPerBlock);
  if (most < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(std::max(1LL, std::min<long long>(want, most)));
}

// The block-local form while E and the rows a block takes fit its shared
// memory budget and the grid re-reads at most kLocalRereads edges, else the
// grid form. Returns a CUDA error (0 on success).
int plan(const Args& p, int rows, int bf16, int multi, Plan* out) {
  for (int local = p.e <= kLocalEdges; local >= 0; --local) {
    Plan q = {};
    q.local = local != 0;
    q.kernel = q.local ? pick<false>(p.d, bf16, multi)
                       : pick<true>(p.d, bf16, multi);
    q.grid = grid_size(q.kernel, q.local ? kLocalSmem : 0, p, bf16, multi,
                       q.local);
    if (q.grid < 0) return -q.grid;
    q.rows = rows > 0 ? rows : (p.n + q.grid - 1) / q.grid;
    if (q.local && (q.rows > kLocalRows ||
                    static_cast<long long>(q.grid) * p.e > kLocalRereads)) {
      continue;
    }
    q.smem = q.local ? (2 * static_cast<size_t>(q.rows) + 1 + p.e) *
                           sizeof(int)
                     : 0;
    *out = q;
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidValue);   // not reached
}

bool aligned(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

int launch(Args& p, int rows, int bf16, int multi, void* stream) {
  if (p.d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n <= 0) return 0;
  Plan q = {};
  const int err = plan(p, rows, bf16, multi, &q);
  if (err != 0) return err;
  p.rows = q.rows;
  const int group = bf16 ? 8 : 4;   // elements in 16 bytes
  p.vec = p.d % group == 0 && aligned(p.msg) && aligned(p.sum) &&
          aligned(p.sumsq) && aligned(p.mx) && aligned(p.mn);
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(q.kernel), dim3(q.grid), dim3(kThreads),
      args, q.smem, static_cast<cudaStream_t>(stream)));
}

void set_scratch(Args& p, void* counts, void* row_start, void* order) {
  p.counts = static_cast<int*>(counts);
  p.row_start = static_cast<int*>(row_start);
  p.order = static_cast<int*>(order);
}

}  // namespace

// Scatter-sum msg (e, d) into out (n, d) over the unmasked edges, on
// `stream`: both f32, or both bf16 when bf16 != 0 (f32 accumulation).
// counts (n), row_start (n + 1) and order (e) are int32 scratch the kernel
// clears itself. rows <= 0 lets the kernel choose the rows a block takes
// per step of phase 4. Returns the launch's CUDA error (0 on success).
extern "C" int mp_scatter_launch(const void* msg, const void* rcv,
                                 const void* mask, void* out, int n, int e,
                                 int d, int rows, int bf16, void* counts,
                                 void* row_start, void* order, void* stream) {
  Args p = {};
  p.msg = msg;
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sum = out;
  p.sum_bf16 = bf16 != 0;
  p.n = n;
  p.e = e;
  p.d = d;
  set_scratch(p, counts, row_start, order);
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, rows, bf16, 0, stream);
}

// The multi-statistic sweep on `stream`: each non-null output gets its
// statistic (sum, sumsq, max, min of (n, d); count of (n, 1)), all f32,
// from f32 messages, or bf16 ones when bf16 != 0. Scratch and rows as
// mp_scatter_launch. Returns the launch's CUDA error (0 on success).
extern "C" int mp_scatter_multi_launch(const void* msg, const void* rcv,
                                       const void* mask, void* sum,
                                       void* sumsq, void* count, void* mx,
                                       void* mn, int n, int e, int d,
                                       int rows, int bf16, void* counts,
                                       void* row_start, void* order,
                                       void* stream) {
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
  set_scratch(p, counts, row_start, order);
  if (!sum && !sumsq && !count && !mx && !mn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(p, rows, bf16, 1, stream);
}

// How the launchers would launch these sizes on the current device (rows
// <= 0: the kernel's choice): *grid blocks, *rows a block per step, *local
// 1 for the block-local buckets, 0 for the grid's. Returns a CUDA error (0
// on success).
extern "C" int mp_scatter_plan(int n, int e, int d, int rows, int bf16,
                               int multi, int* grid, int* rows_out,
                               int* local) {
  Args p = {};
  p.n = n;
  p.e = e;
  p.d = d;
  Plan q = {};
  if (d <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = plan(p, rows, bf16, multi, &q);
  if (err != 0) return err;
  *grid = q.grid;
  *rows_out = q.rows;
  *local = q.local;
  return 0;
}
