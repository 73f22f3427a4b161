// One GNN layer in one launch on Hopper (sm_90a): gather, phi, aggregate,
// update MLP.
//
// Replaces the TPU kernel repro/kernels/layer_fused.py::layer_fused (body
// _layer_fused_kernel), in all three of its epilogues:
//
//   phi_e = act( y[snd_e] * src_weight_e + edge_term_e + phi_bias )
//   s1_i  = sum over unmasked edges e with rcv_e == i of phi_e      (f32)
//   self (GIN, GIN-VN, GCN):
//     z_i = s1_i + self_coeff * x_i          (self_coeff scalar or per node)
//   scalers (PNA), with s2 (sum of squares), mx and mn (keyed max / min from
//   -+BIG) accumulated beside s1 and deg the shared in-degrees:
//     mean = s1 / max(deg, 1); std = sqrt(max(s2 / max(deg, 1) - mean^2, 0)
//     + 1e-5); mx, mn -> 0 unless deg > 0 and they moved off -+BIG
//     m_i = [mean | std | mx | mn]; z_i = [x_i | s_0 m_i | ... | s_{S-1} m_i]
//   field (DGN), over the stacked gather buffer y = [x | x] (D = 2 D_x):
//     z_i = [x_i | s1_i[:D_x] / max(deg, 1) | |s1_i[D_x:] - x_i * wsum_i|]
//   h_i   = z_i @ w1 + b1 ; [ h_i = relu(h_i) @ w2 + b2 ] ; out_i = act_out(h_i)
//
// The Pallas kernel gathers and scatters with one-hot matrix products on the
// TPU's matrix unit (_gather_phi_tile, _route_matrix). That is a device of the
// TPU and is not carried over; this kernel computes what layer_fused_ref does.
//
// What bounds it on an H100. At GIN's paper width (D = 100, D_ff = 200) and
// N = 1024, E = 4096 the layer moves ~2.7 MB if each input is read once and
// does ~82 MFLOP of fp32 epilogue outside the tensor cores: both floors are
// ~1 us (3.35 TB/s, 67 TFLOP/s fp32). At the serving buckets (N = 32..64)
// every floor is well under 1 us: the time is latency. A block owns one row
// there; its dense layers are ~40k FMAs over 160 KB of weights (GIN; PNA's
// w1 alone is 333 KB). At the packed batch of 1,024 graphs (N = 32,768,
// E = 65,536) the dense layers' 2.6 GFLOP set the floor, 39.7 us.
// experiments/layer_fused_breakdown.py times the parts: launch, edges,
// weight copies, dense arithmetic.
//
// Design:
//   * Weights on chip while the edges are swept, split-k dense layers with
//     every thread busy (csrc/dense_tile.cuh, shared with the NT kernels).
//     Each dense layer's weight is one chunk where both fit in shared memory
//     (GIN's 160 KB), else it is cut into chunks of whole k rows (<= 32 KB);
//     the chunks stream through the header's ring of shared-memory slots,
//     one mbarrier a slot. At entry the block issues as many chunks as
//     there are slots, and b1 / b2, then sweeps the edges while they land.
//     When every chunk fits (GIN, DGN, GCN) nothing is refilled; otherwise
//     (PNA's w1) a slot is refilled as soon as the block is done with it.
//     The split-k slices depend only on k_dim and n_dim, so an output's
//     arithmetic is the same for any rows per block and from run to run.
//   * No work on padding rows: the dense layers take groups of 8 (16 in the
//     grid form, its quads unrolled 4 deep), 4, 2 and 1 rows, and every
//     pass of the epilogue runs over rows_here alone.
//   * Owner computes for the edges, in one of two forms chosen by the
//     wrapper from the shape (kernels/layer_fused.py::launch_form):
//     - block-local (kGrid false; the serving buckets). Block b owns
//       destination rows [b*R, b*R + R) and sweeps the whole edge stream in
//       stream order, a tile of kEdgeTile edges at a time (mask, receiver
//       and sender loaded together, the next tile's ahead); a block-wide
//       scan appends the tile's owned, unmasked edges to a shared-memory list
//       that keeps stream order across tiles, and the list is folded once
//       (or whenever it would overflow). The grid reads E edges a block, so
//       the sweep grows as blocks x E: past the crossover it is the layer's
//       time (633 us at N = 32,768, E = 65,536, PERF.md).
//     - grid (kGrid; packed batches). One cooperative launch of the resident
//       blocks (persistent: block b takes the tiles of R rows b, b + G, ...).
//       A. the whole grid buckets the owned edges once by tile
//          (edge_buckets.cuh::bucket_edges_keyed, four grid barriers, the
//          wrapper's int32 scratch): each tile's edges are one segment.
//       B. per tile the block ranks its segment by (the row's group of
//          lanes, edge index) (each entry's rank the count of smaller keys;
//          the indices are distinct): each group's run of the list is its
//          rows' edges in stream order, folded 16 edges a round; a segment
//          longer than the list (a hub's tile) is swept as the block-local
//          form sweeps, O(E) for that tile alone. Its x rows are staged by
//          a bulk copy at the tile's start, its other row inputs read with
//          the segment.
//     Either way the list holds, in stream order, exactly the edges the
//     rows own: masked edges never enter it, nor does an edge whose
//     receiver lies outside [0, n) (no row owns it). A sender outside
//     [0, n) enters as -1 and gathers a zero row (y is never read there), as
//     the Pallas kernel's one-hot gather gives. Threads run over the D lanes;
//     every (row, lane) of the f32 accumulators (one, or four for the scalers
//     form) is written by exactly one thread, in stream order: no atomics
//     touch a value (phase A's count and place indices), and the two forms
//     are bitwise equal for any rows per block.
//     A round's loads are all issued before its folds, which are branch
//     free; where a group of lanes owns one row at most (one row a block at
//     the buckets) the sums stay in registers.
//   * Epilogue in the same launch: the self term in place, or the scalers /
//     field input row z built in shared memory (rounded adds and products,
//     no contraction, as the plain version rounds them), then the dense
//     layers; the hidden layer stays in shared memory. A dense layer names
//     its shared-memory input by offset (dense_tile.cuh).
//   * Weights staged once a block. The grid form's persistent block issues
//     the weights at entry, where they land during phase A, and keeps them
//     across its tiles when every chunk has a slot (GIN, GCN, DGN); where
//     the ring refills (PNA's w1), each later tile re-arms the barriers and
//     issues the first chunks again.
//   * Rows per block: one block per SM where the rows allow it (one row a
//     block at the buckets, 8 at N = 1024), the best of 1-16 rows measured
//     at both (PERF.md); in the grid form tiles of min(16, n / SMs) rows
//     (20 to 32 measured within 1.5% at N = 32,768). No thread-block
//     clusters: the weight copies are not what sets a layer's time
//     (PERF.md).
//   * The launcher returns the launch's CUDA error; a grid form whose
//     blocks cannot all be resident is refused (no other form runs in its
//     place). It allocates nothing and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "dense_tile.cuh"
#include "edge_buckets.cuh"
#include "hopper.cuh"

// The block's dynamic shared memory (dense_tile.cuh's smem): weight slots,
// biases, accumulators, z, hidden layer, partial sums, edge lists, barriers.

namespace {

using dense::dense_layer;
using dense::dense_layer_spread;
using dense::issue_first;
using dense::kChunkBytes;
using dense::round_up;
using hopper::mbar_init;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;
constexpr int kUnroll = 8;        // edges whose loads are issued together
constexpr int kGridUnroll = 16;   // the same in the grid form's group lists
constexpr float kBig = 1e30f;     // keyed max / min neutral (mp_pipeline's)
// grid form: rows a tile at most (the kernel's own choice), and edges a
// block of phase A at least (the grid is the resident blocks at most)
constexpr int kGridRows = 16;
constexpr int kEdgesPerBlock = 4096;
constexpr int kDenseUnroll = 4;   // the NT tile's depth (nt_tile.cuh)
constexpr int kDenseGroup = 16;   // grid form: rows a weight load serves

enum SrcWeightMode { kSwNone = 0, kSwScalar = 1, kSwFull = 2, kSwHead = 3 };
enum SelfMode { kSelfNone = 0, kSelfScalar = 1, kSelfNode = 2 };
enum Epilogue { kEpiSelf = 0, kEpiScalers = 1, kEpiField = 2 };

// the dense layers' part (dense::Tile: weights, ring, the rows a block
// owns, the offsets of the biases, partial sums and barriers), then the rest
struct Args : dense::Tile {
  const float* x;        // (n, d_x) carry rows: the self term, z's first part
  const float* y;        // (n, d) gather buffer (x unless node_input)
  const int64_t* snd;    // (e,)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  const float* sw;       // (e,), (e, d), (e, sw_cols) or null
  const float* et;       // (e, d) or null
  const float* pb;       // (d,) or null
  const float* sc;       // (1,) or (n,) or null
  const float* scal;     // (n, n_scalers) degree scalers, or null
  const float* deg;      // (n,) shared in-degrees (scalers, field), or null
  const float* wsum;     // (n,) field-weight sums (field), or null
  float* out;            // (n, d_out)
  int n, e, d, d_x;
  int sw_mode, sw_cols, head_dim;
  int self_mode, epilogue, n_scalers, phi_relu, out_relu;
  // row strides (floats, multiples of 4) of the accumulators, z, hidden
  int ds, zs, hs;
  // offsets (in floats) of the regions after the slots and biases
  int o_acc, o_z, o_hid, o_list;
  // grid form: tiles of `rows` rows, the buckets' int32 scratch (counts,
  // row_start, order) keyed by row / per_key, the offset of the tile's row
  // inputs and group starts, the barriers (slots + 3: the row inputs')
  int tiles, per_key, o_rin, bars;
  int* counts;
  int* row_start;
  int* order;
};

// accumulators: s1, then s2 / max / min for the scalers form
__host__ __device__ inline int n_acc(int epilogue) {
  return epilogue == kEpiScalers ? 4 : 1;
}

// thread tid's kEdgesPerThread consecutive edges of the tile at `base`
// (past the stream: masked, no receiver, no sender)
__device__ __forceinline__ void load_tile(const Args& p, int base, int tid,
                                          uint8_t (&m)[kEdgesPerThread],
                                          int64_t (&r)[kEdgesPerThread],
                                          int64_t (&s)[kEdgesPerThread]) {
#pragma unroll
  for (int k = 0; k < kEdgesPerThread; ++k) {
    const int64_t e = (int64_t)base + tid * kEdgesPerThread + k;
    const bool in = e < p.e;
    m[k] = in ? __ldg(p.mask + e) : 0;
    r[k] = in ? __ldg(p.rcv + e) : -1;
    s[k] = in ? __ldg(p.snd + e) : -1;
  }
}

// phi of one edge at one lane from its loaded terms: the gathered value y
// (0 for a sender outside [0, n)), its src_weight w, edge term t and bias b
__device__ __forceinline__ float phi(const Args& p, float y, float w, float t,
                                     float b) {
  float v = y;
  if (p.sw_mode != kSwNone) v = __fmul_rn(v, w);
  if (p.et != nullptr) v = __fadd_rn(v, t);
  if (p.pb != nullptr) v = __fadd_rn(v, b);
  if (p.phi_relu) v = fmaxf(v, 0.f);
  return v;
}

// The block's accumulators, z, edge list and lanes for the rows it holds
// (rows_here of them, from row0) in shared memory. kScalers: the scalers
// form's four accumulators (a separate instance, so that the other forms'
// edge loop keeps one accumulator and nothing else). kGrid: the grid
// form's dense layers, their quads unrolled kDenseUnroll deep, rows in
// groups of kDenseGroup, their outputs spread over every thread (the same
// sums).
template <bool kScalers, bool kGrid>
struct Rows {
  const Args& p;
  int tid, row0, rows_here;
  float* acc;      // s1: rows x ds, + a trash row
  float* acc_sq;   // scalers only: s2,
  float* acc_mx;   //   max,
  float* acc_mn;   //   min
  float* z;        // rows x zs
  int* list_e;
  int* list_s;
  int* list_r;
  int* scan;       // kWarps + 1
  // grid form: the tile's row inputs, staged at its start (x rows at
  // rows x d_x, then per row the self coefficient, degree and field sum,
  // then rows x n_scalers scalers), and each group's list start
  float* rin;
  int* gstart;     // groups + 1
  // lanes of the accumulate phase (see the design note above)
  bool narrow;
  int groups, group, lane0, lane_step;

  __device__ __forceinline__ Rows(const Args& args, int t, int r0)
      : p(args), tid(t), row0(r0), rows_here(min(args.rows, args.n - r0)) {
    const int acc_len = (p.rows + 1) * p.ds;
    acc = smem + p.o_acc;
    acc_sq = acc + acc_len;
    acc_mx = acc_sq + acc_len;
    acc_mn = acc_mx + acc_len;
    z = smem + p.o_z;
    list_e = reinterpret_cast<int*>(smem + p.o_list);
    list_s = list_e + kEdgeTile;
    list_r = list_s + kEdgeTile;
    scan = list_r + kEdgeTile;
    rin = smem + p.o_rin;
    gstart = reinterpret_cast<int*>(rin + p.rows * (p.d_x + 3 + p.n_scalers));
    narrow = p.d <= kThreads;
    groups = narrow ? kThreads / p.d : 1;
    group = narrow ? tid / p.d : 0;
    lane0 = narrow ? tid % p.d : tid;
    lane_step = narrow ? p.d : kThreads;
  }

  // the accumulators' neutrals on the rows (the caller's barrier follows)
  __device__ __forceinline__ void clear() {
    for (int i = tid; i < rows_here * p.ds; i += kThreads) {
      acc[i] = 0.f;
      if constexpr (kScalers) {
        acc_sq[i] = 0.f;
        acc_mx[i] = -kBig;
        acc_mn[i] = kBig;
      }
    }
  }

  // 3. each (row, lane) adds the listed edges' phi in stream order; a
  //    round's loads are all issued before its first use. Where every group
  //    of lanes owns one row at most (groups >= rows_here: the serving
  //    buckets, one row a block), a lane's sums stay in registers for the
  //    whole list; else each edge folds into its row in shared memory.
  __device__ __forceinline__ void accumulate(int listed) {
    accumulate_range<kUnroll>(0, listed);
  }

  // the same over list entries [begin, end), kU edges a round
  template <int kU>
  __device__ __forceinline__ void accumulate_range(int begin, int end) {
    const bool one_row = groups >= rows_here;
    if (group >= groups || (one_row && group >= rows_here)) return;
    // where a lane's src_weight sits in an edge's row of it
    const int sw_stride = p.sw_mode == kSwFull   ? p.d
                          : p.sw_mode == kSwHead ? p.sw_cols
                                                 : 1;
    for (int dd = lane0; dd < p.d; dd += lane_step) {
      const float pbv = p.pb != nullptr ? __ldg(p.pb + dd) : 0.f;
      const int sw_lane = p.sw_mode == kSwFull   ? dd
                          : p.sw_mode == kSwHead ? dd / p.head_dim
                                                 : 0;
      const int own = group * p.ds + dd;   // the one row's (one_row)
      float s1 = acc[own];
      float s2 = kScalers ? acc_sq[own] : 0.f;
      float mx = kScalers ? acc_mx[own] : 0.f;
      float mn = kScalers ? acc_mn[own] : 0.f;
      for (int i = begin; i < end; i += kU) {
        int rr[kU];
        float yv[kU], wv[kU], tv[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int rg = list_r[i + u];
          const bool mine = i + u < end && (rg & 255) == group;
          rr[u] = mine ? rg >> 8 : -1;
          const int e = mine ? list_e[i + u] : 0;
          const int s = mine ? list_s[i + u] : -1;
          yv[u] = s >= 0 ? __ldg(p.y + (s + dd)) : 0.f;
          wv[u] = mine && p.sw_mode != kSwNone
                      ? __ldg(p.sw + (e * sw_stride + sw_lane))
                      : 1.f;
          tv[u] = mine && p.et != nullptr ? __ldg(p.et + (e * p.d + dd))
                                          : 0.f;
        }
        // no branch between the loads and the folds (one would let the
        // compiler move each load to its fold: a round trip an edge)
        if (one_row) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float v = phi(p, yv[u], wv[u], tv[u], pbv);
            const bool mine = rr[u] >= 0;
            s1 = mine ? s1 + v : s1;
            if constexpr (kScalers) {
              s2 = mine ? __fadd_rn(s2, __fmul_rn(v, v)) : s2;
              mx = mine ? fmaxf(mx, v) : mx;
              mn = mine ? fminf(mn, v) : mn;
            }
          }
        } else {
          // the edges of other rows fold into the trash row
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float v = phi(p, yv[u], wv[u], tv[u], pbv);
            const int a = (rr[u] >= 0 ? rr[u] : p.rows) * p.ds + dd;
            acc[a] += v;
            if constexpr (kScalers) {
              acc_sq[a] = __fadd_rn(acc_sq[a], __fmul_rn(v, v));
              acc_mx[a] = fmaxf(acc_mx[a], v);
              acc_mn[a] = fminf(acc_mn[a], v);
            }
          }
        }
      }
      if (one_row) {
        acc[own] = s1;
        if constexpr (kScalers) {
          acc_sq[own] = s2;
          acc_mx[own] = mx;
          acc_mn[own] = mn;
        }
      }
    }
  }

  // list slot `slot` takes edge e, whose receiver is local row `local`, and
  // its sender s: its row's offset in y; a sender outside [0, n) gathers a
  // zero row (the Pallas kernel's one-hot gather): -1 marks it so that y is
  // never read there. The low 8 bits of list_r name the group of lanes that
  // owns the row.
  __device__ __forceinline__ void list(int slot, int e, int local,
                                       int64_t s) {
    list_e[slot] = e;
    list_s[slot] = (s >= 0 && s < p.n) ? static_cast<int>(s) * p.d : -1;
    list_r[slot] = local << 8 | local % groups;
  }

  // The rows' owned edges in stream order, swept from the whole stream:
  // the owned edges of every tile are appended to one list in stream
  // order, which is accumulated when the next tile would overflow it and
  // at the end: one accumulate pass for the whole stream unless the rows
  // own more than kEdgeTile edges. Returns after a barrier.
  __device__ __forceinline__ void sweep() {
    const int lane = tid & 31;
    const int warp = tid >> 5;
    // this thread's kEdgesPerThread consecutive edges of a tile: mask,
    // receiver and sender, loaded together (the next tile's while this one
    // is accumulated)
    uint8_t m_own[kEdgesPerThread];
    int64_t r_own[kEdgesPerThread], s_own[kEdgesPerThread];
    int listed = 0;
    load_tile(p, 0, tid, m_own, r_own, s_own);
    for (int base = 0; base < p.e; base += kEdgeTile) {
      // 1. which of this thread's consecutive edges do the rows own?
      const int e0 = base + tid * kEdgesPerThread;
      int local[kEdgesPerThread];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kEdgesPerThread; ++k) {
        const int64_t r = r_own[k] - row0;
        local[k] = m_own[k] && r >= 0 && r < rows_here ? static_cast<int>(r)
                                                        : -1;
        cnt += local[k] >= 0;
      }
      // 2. block-wide exclusive scan of the counts: list slots in stream
      //    order
      int incl = cnt;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      if (lane == 31) scan[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int v = lane < kWarps ? scan[lane] : 0;
        int s = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, s, off);
          if (lane >= off) s += u;
        }
        if (lane < kWarps) scan[lane] = s - v;
        if (lane == kWarps - 1) scan[kWarps] = s;
      }
      __syncthreads();
      const int owned = scan[kWarps];
      if (listed + owned > kEdgeTile) {   // the list is full: fold it first
        accumulate(listed);
        __syncthreads();
        listed = 0;
      }
      int slot = listed + scan[warp] + incl - cnt;
#pragma unroll
      for (int k = 0; k < kEdgesPerThread; ++k) {
        if (local[k] >= 0) list(slot++, e0 + k, local[k], s_own[k]);
      }
      listed += owned;
      load_tile(p, base + kEdgeTile, tid, m_own, r_own, s_own);
    }
    __syncthreads();
    accumulate(listed);
    __syncthreads();
  }

  // Grid form: the tile's owned edges from its segment order[start, start
  // + len) of the buckets (len <= kEdgeTile), which phase A placed in no
  // fixed order, listed by group of lanes, each group's edges in stream
  // order: an entry's place is the count of entries before it by (its
  // row's group, edge index) (the indices are distinct). Up to
  // kEdgesPerThread entries a thread: their receivers and senders are read
  // right after their indices, and the tile's row inputs while they are in
  // flight (one round trip after the segment's); then one pass over the
  // segment's keys (the same key read by every lane: a broadcast) places
  // them, and gstart gets each group's first place. Returns after a
  // barrier.
  __device__ __forceinline__ void list_segment(int start, int len) {
    long long* keys = reinterpret_cast<long long*>(list_s);   // until placed
    int e[kEdgesPerThread], local[kEdgesPerThread];
    int64_t snd[kEdgesPerThread];
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const int i = tid + k * kThreads;
      e[k] = i < len ? __ldcg(p.order + start + i) : 0;
    }
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const bool in = tid + k * kThreads < len;
      local[k] = in ? static_cast<int>(__ldg(p.rcv + e[k]) - row0) : 0;
      snd[k] = in ? __ldg(p.snd + e[k]) : -1;
    }
    load_row_inputs();
    long long key[kEdgesPerThread];
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const int i = tid + k * kThreads;
      key[k] = static_cast<long long>(local[k] % groups) << 32 | e[k];
      if (i < len) keys[i] = key[k];
    }
    __syncthreads();
    int place[kEdgesPerThread] = {};
    if (tid < len) {
      for (int j = 0; j < len; ++j) {
        const long long kj = keys[j];
#pragma unroll
        for (int k = 0; k < kEdgesPerThread; ++k) place[k] += kj < key[k];
      }
    }
    for (int g = tid; g <= groups; g += kThreads) {
      int before = 0;
      for (int j = 0; j < len; ++j) before += (keys[j] >> 32) < g;
      gstart[g] = before;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      if (tid + k * kThreads < len) list(place[k], e[k], local[k], snd[k]);
    }
    __syncthreads();
  }

  // Grid form: the tile's per-row inputs into rin (the caller's barrier
  // follows); the x rows are staged apart (stage_x)
  __device__ __forceinline__ void load_row_inputs() {
    const int per_row = 3 + p.n_scalers;
    float* at = rin + p.rows * p.d_x;
    for (int i = tid; i < rows_here * per_row; i += kThreads) {
      const int r = i / per_row;
      const int k = i - r * per_row;
      const int row = row0 + r;
      float v = 0.f;
      if (k == 0) {
        v = p.self_mode == kSelfNode ? __ldg(p.sc + row) : 0.f;
      } else if (k == 1) {
        v = p.deg != nullptr ? __ldg(p.deg + row) : 0.f;
      } else if (k == 2) {
        v = p.wsum != nullptr ? __ldg(p.wsum + row) : 0.f;
      } else {
        v = __ldg(p.scal + (size_t)row * p.n_scalers + (k - 3));
      }
      if (k < 3) {
        at[k * p.rows + r] = v;
      } else {
        at[3 * p.rows + r * p.n_scalers + (k - 3)] = v;
      }
    }
  }

  // Grid form: the tile's x rows (contiguous) into rin by bulk or
  // cp.async copies that complete on `bar` (every thread)
  __device__ __forceinline__ void stage_x(uint64_t* bar) {
    dense::stage(rin, p.x + (size_t)row0 * p.d_x, rows_here * p.d_x, bar,
                 tid);
  }

  // the epilogue's per-row inputs: staged in rin (grid form) or read from
  // device memory
  __device__ __forceinline__ float x_at(int r, int c) const {
    if constexpr (kGrid) {
      return rin[r * p.d_x + c];
    } else {
      return __ldg(p.x + (size_t)(row0 + r) * p.d_x + c);
    }
  }
  __device__ __forceinline__ float row_at(int k, int r, const float* src)
      const {
    if constexpr (kGrid) {
      return rin[p.rows * p.d_x + k * p.rows + r];
    } else {
      return __ldg(src + row0 + r);
    }
  }
  __device__ __forceinline__ float scaler_at(int r, int k) const {
    if constexpr (kGrid) {
      return rin[p.rows * (p.d_x + 3) + r * p.n_scalers + k];
    } else {
      return __ldg(p.scal + (size_t)(row0 + r) * p.n_scalers + k);
    }
  }

  // The epilogue's passes over the rows: element (r, c) of the rows_here x
  // width rows goes to thread (r * width + c) % kThreads
  template <typename F>
  __device__ __forceinline__ void rows_by_threads(int width, F&& f) {
    int r = tid / width;
    int c = tid - r * width;
    const int dr = kThreads / width;
    const int dc = kThreads - dr * width;
    while (r < rows_here) {
      f(r, c);
      r += dr;
      c += dc;
      if (c >= width) {
        c -= width;
        ++r;
      }
    }
  }

  // 4. the first layer's input row (the self term in place on acc, or z
  // from the accumulators: scalers, field), 5. the update MLP into out's
  // rows; the accumulators are ready (after a barrier)
  __device__ __forceinline__ void update() {
    if (p.epilogue == kEpiSelf) {
      if (p.self_mode != kSelfNone) {
        rows_by_threads(p.d, [&](int r, int c) {
          const float sc = p.self_mode == kSelfScalar ? __ldg(p.sc)
                                                      : row_at(0, r, p.sc);
          const float xv = x_at(r, c);
          float* a = acc + r * p.ds + c;
          *a = __fadd_rn(*a, __fmul_rn(sc, xv));
        });
      }
    } else {
      // z's first D_x columns: the carry rows
      rows_by_threads(p.d_x, [&](int r, int c) {
        z[r * p.zs + c] = x_at(r, c);
      });
    }
    if constexpr (kScalers) {
      // m = [mean | std | max | min] at lane c, times each degree scaler
      rows_by_threads(p.d, [&](int r, int c) {
        const int a = r * p.ds + c;
        const float deg = row_at(1, r, p.deg);
        const float rdenom = __fdiv_rn(1.f, fmaxf(deg, 1.f));
        const float mean = __fmul_rn(acc[a], rdenom);
        const float var = fmaxf(
            __fsub_rn(__fmul_rn(acc_sq[a], rdenom), __fmul_rn(mean, mean)),
            0.f);
        const float sd = __fsqrt_rn(__fadd_rn(var, 1e-5f));
        const bool nonempty = deg > 0.f;
        const float mx = nonempty && acc_mx[a] > -kBig ? acc_mx[a] : 0.f;
        const float mn = nonempty && acc_mn[a] < kBig ? acc_mn[a] : 0.f;
        float* zc = z + r * p.zs + p.d_x + c;
        for (int k = 0; k < p.n_scalers; ++k) {
          const float sk = scaler_at(r, k);
          float* zk = zc + k * 4 * p.d;
          zk[0] = __fmul_rn(mean, sk);
          zk[p.d] = __fmul_rn(sd, sk);
          zk[2 * p.d] = __fmul_rn(mx, sk);
          zk[3 * p.d] = __fmul_rn(mn, sk);
        }
      });
    } else if (p.epilogue == kEpiField) {
      // [mean of the plain half | |field half - x * wsum|]
      rows_by_threads(p.d_x, [&](int r, int c) {
        const float rdenom = __fdiv_rn(1.f, fmaxf(row_at(1, r, p.deg), 1.f));
        const float xv = x_at(r, c);
        const float* a = acc + r * p.ds;
        float* zr = z + r * p.zs;
        zr[p.d_x + c] = __fmul_rn(a[c], rdenom);
        zr[2 * p.d_x + c] = fabsf(
            __fsub_rn(a[p.d_x + c], __fmul_rn(xv, row_at(2, r, p.wsum))));
      });
    }
    __syncthreads();

    // 5. the update MLP, its first layer on acc (self) or z
    const bool self = p.epilogue == kEpiSelf;
    const int in_off = self ? p.o_acc : p.o_z;
    const int in_stride = self ? p.ds : p.zs;
    const auto layer = [&](int l, int src_off, int src_stride, int bias_off,
                           int dst_off, int dst_stride, bool global,
                           bool relu) {
      if constexpr (kGrid) {
        dense_layer_spread<float, kDenseUnroll, kDenseGroup>(
            p, l, src_off, src_stride, bias_off, dst_off, dst_stride, global,
            p.out, row0, rows_here, relu, tid);
      } else {
        dense_layer(p, l, src_off, src_stride, bias_off, dst_off, dst_stride,
                    global, p.out, row0, rows_here, relu, tid);
      }
    };
    if (p.w2 != nullptr) {
      layer(0, in_off, in_stride, p.o_b1, p.o_hid, p.hs, false, true);
      __syncthreads();
      layer(1, p.o_hid, p.hs, p.o_b2, 0, 0, true, p.out_relu);
    } else {
      layer(0, in_off, in_stride, p.o_b1, 0, 0, true, p.out_relu);
    }
  }
};

// the weight ring's barriers, one a slot and one a bias, armed for their
// first phase (thread 0)
__device__ __forceinline__ void init_barriers(const Args& p) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  for (int s = 0; s < p.bars; ++s) mbar_init(&bars[s], 1);
  hopper::fence_barrier_init();
}

// Grid form, a later tile whose weights do not all have a slot: the ring's
// and the biases' barriers are re-armed and its first chunks and the
// biases are issued again (every thread; the block is done with the
// previous tile's slots). The row inputs' barrier keeps its phases.
__device__ __forceinline__ void restage(const Args& p, int tid) {
  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
    for (int s = 0; s < p.slots + 2; ++s) {
      asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(
                       hopper::smem_u32(&bars[s]))
                   : "memory");
      mbar_init(&bars[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  issue_first(p, tid);
}

// Grid form, phase A: the whole grid buckets the owned edges by tile
// (after the last of its grid barriers the buckets are ready).
__device__ __forceinline__ void bucket_tiles(const Args& p, int* sh) {
  const buckets::Edges g = {p.rcv, p.mask, p.n, p.e};
  const buckets::Buckets b = {p.counts, p.row_start, p.order, 0,
                              (p.n + p.per_key - 1) / p.per_key};
  buckets::bucket_edges_keyed(g, b, p.per_key, sh);
}

// Grid form: the segment of the rows [row0, row0 + rows_here) in order
// (a tile's bucket, or its rows' buckets when per_key is 1)
__device__ __forceinline__ void segment_of(const Args& p, int row0,
                                           int rows_here, int* start,
                                           int* len) {
  const int k0 = row0 / p.per_key;
  const int k1 = (row0 + rows_here + p.per_key - 1) / p.per_key;
  *start = __ldcg(p.row_start + k0);
  *len = __ldcg(p.row_start + k1) - *start;
}

template <bool kScalers, bool kGrid>
__global__ void __launch_bounds__(kThreads, 1)
    layer_fused_kernel(const __grid_constant__ Args p) {
  const int tid = threadIdx.x;
  if (tid == 0) init_barriers(p);
  if constexpr (!kGrid) {
    Rows<kScalers, false> rows(p, tid, blockIdx.x * p.rows);
    rows.clear();
    __syncthreads();
    issue_first(p, tid);   // land while the edges are swept
    rows.sweep();
    // 4. the first dense layer's input row, 5. the update MLP
    rows.update();
  } else {
    __syncthreads();
    issue_first(p, tid);   // land while the edges are swept
    // A. the owned edges bucketed by tile, across the grid
    bucket_tiles(p, reinterpret_cast<int*>(smem + p.o_list) + 3 * kEdgeTile);
    // B. this block's tiles, the weights kept across them where every
    //    chunk has a slot
    const bool ring = p.slots < p.chunks[0] + p.chunks[1];
    uint64_t* x_bar = reinterpret_cast<uint64_t*>(smem + p.o_bar) +
                      p.slots + 2;
    uint32_t x_phase = 0;
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
      if (ring && t != static_cast<int>(blockIdx.x)) restage(p, tid);
      Rows<kScalers, true> rows(p, tid, t * p.rows);
      rows.stage_x(x_bar);   // lands while the edges are listed and folded
      rows.clear();
      int start = 0, len = 0;
      segment_of(p, rows.row0, rows.rows_here, &start, &len);
      if (len <= kEdgeTile) {
        rows.list_segment(start, len);
        if (rows.group < rows.groups) {
          rows.template accumulate_range<kGridUnroll>(
              rows.gstart[rows.group], rows.gstart[rows.group + 1]);
        }
      } else {
        rows.load_row_inputs();
        rows.sweep();   // a long segment: the stream in order
      }
      __syncthreads();
      hopper::mbar_wait(x_bar, x_phase);
      x_phase ^= 1;
      rows.update();
      __syncthreads();   // before the next tile reuses shared memory
    }
  }
}

// --- the host's plan

// Lay out a block of `rows` rows; returns its bytes. Every region starts on
// 16 bytes (the slots on 128).
size_t layout(Args& p, int rows, int slots, bool grid) {
  const bool two = p.w2 != nullptr;
  p.rows = rows;
  p.slots = slots;
  int o = slots * p.slot_floats;
  p.o_b1 = o;
  o += round_up(p.d_ff, 4);
  p.o_b2 = o;
  o += two ? round_up(p.d_out, 4) : 0;
  p.o_acc = o;
  o += n_acc(p.epilogue) * (rows + 1) * p.ds;   // + a trash row each
  p.o_z = o;
  o += p.epilogue == kEpiSelf ? 0 : rows * p.zs;
  p.o_hid = o;
  o += two ? rows * p.hs : 0;
  p.o_part = o;
  const int part0 = p.split[0] * p.d_ff;
  const int part1 = two ? p.split[1] * p.d_out : 0;
  o += round_up(rows * (part0 > part1 ? part0 : part1), 4);
  p.o_list = o;
  // the lists, the scan, and room for a round read past the list's end
  o += round_up(3 * kEdgeTile + kWarps + 1 +
                    2 * (grid ? kGridUnroll : kUnroll), 4);
  // grid form: the tile's row inputs (Rows::rin), the groups' list starts
  p.o_rin = o;
  o += grid ? round_up(rows * (p.d_x + 3 + p.n_scalers) + kThreads + 1, 4)
            : 0;
  p.o_bar = o;
  p.bars = slots + (grid ? 3 : 2);
  o += 2 * p.bars;
  return static_cast<size_t>(o) * sizeof(float);
}

// The rows a block owns (`rows` if given, > 0; else one block per SM where
// the rows allow it, or in the grid form tiles of that many rows up to
// kGridRows) and the weight ring: each layer's weight whole in a slot of
// its own where both fit beside the rows, else chunks of at most
// kChunkBytes through as many slots as fit (at least two; rows are halved
// until they do, and one block row takes one slot if it must). Returns the
// block's bytes, or 0 if even that does not fit.
size_t plan(Args& p, int rows, bool grid) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool two = p.w2 != nullptr;
  p.ds = round_up(p.d, 4);
  p.zs = round_up(p.d_in, 4);
  p.hs = round_up(p.d_ff, 4);
  p.split[0] = dense::split_of(p.d_in, p.d_ff);
  p.split[1] = two ? dense::split_of(p.d_ff, p.d_out) : 1;
  // chunks of whole layers (whole = true) or of at most kChunkBytes
  auto chunking = [&](bool whole) {
    return dense::chunking(p, whole, sizeof(float), kChunkBytes);
  };
  if (rows <= 0) {
    rows = (p.n + sms - 1) / sms;
    if (grid && rows > kGridRows) rows = kGridRows;
  }
  // each layer's weight in one slot where both fit beside the rows
  int total = chunking(true);
  size_t bytes = layout(p, rows, total, grid);
  if (bytes <= static_cast<size_t>(max_smem)) return bytes;
  total = chunking(false);
  for (;;) {
    const size_t fixed = layout(p, rows, 0, grid);
    const size_t room = fixed < (size_t)max_smem ? max_smem - fixed : 0;
    const size_t per_slot = 4 * (size_t)p.slot_floats + 8;
    int slots = static_cast<int>(room / per_slot);
    if (slots > total) slots = total;
    if (slots >= (total < 2 ? total : 2) || (rows == 1 && slots >= 1)) {
      return layout(p, rows, slots, grid);
    }
    if (rows == 1) return 0;
    rows = (rows + 1) / 2;
  }
}

using Kernel = void (*)(Args);

// Blocks of `kernel` the current device holds at once with `smem` bytes of
// dynamic shared memory (SMs times blocks an SM), asked of the runtime once
// per device, kernel and size: the occupancy query costs host time on
// every call otherwise. Negative: a CUDA error.
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

}  // namespace

// Launch one layer on `stream`. Null pointers switch terms off (w2/b2 null:
// one dense layer); `epilogue` picks the self (0), scalers (1) or field (2)
// form, whose inputs must then be given. rows <= 0 lets the kernel choose;
// rows that would not fit in shared memory are halved until they do.
// `form` 0 launches the block-local form; 1 the grid form, one cooperative
// launch of `grid` blocks (<= 0: as many as the card holds at once, up to
// what the tiles and edges use) on `scratch`, 2 n + 1 + e int32 values
// (counts, row_start, order; the kernel clears what it reads before
// writing). Returns the launch's
// CUDA error (0 on success; a grid that cannot be resident is refused),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int layer_fused_launch(
    const void* x, const void* y, const void* snd, const void* rcv,
    const void* mask, const void* sw, const void* et, const void* pb,
    const void* sc, const void* scal, const void* deg, const void* wsum,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* out, int n, int e, int d, int d_x, int d_in, int d_ff, int d_out,
    int sw_mode, int sw_cols, int head_dim, int self_mode, int epilogue,
    int n_scalers, int phi_relu, int out_relu, int rows, int form, int grid,
    void* scratch, void* stream) {
  Args p = {};
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.snd = static_cast<const int64_t*>(snd);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sw = static_cast<const float*>(sw);
  p.et = static_cast<const float*>(et);
  p.pb = static_cast<const float*>(pb);
  p.sc = static_cast<const float*>(sc);
  p.scal = static_cast<const float*>(scal);
  p.deg = static_cast<const float*>(deg);
  p.wsum = static_cast<const float*>(wsum);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.d = d;
  p.d_x = d_x;
  p.d_in = d_in;
  p.d_ff = d_ff;
  p.d_out = d_out;
  p.sw_mode = sw_mode;
  p.sw_cols = sw_cols;
  p.head_dim = head_dim;
  p.self_mode = self_mode;
  p.epilogue = epilogue;
  p.n_scalers = n_scalers;
  p.phi_relu = phi_relu;
  p.out_relu = out_relu;
  // the contraction width each epilogue needs, as the wrapper checks it
  const int want_in = epilogue == kEpiScalers ? d_x + n_scalers * 4 * d
                      : epilogue == kEpiField ? d_x + d
                                              : d;
  const bool inputs_ok =
      epilogue == kEpiSelf ||
      (deg != nullptr && (epilogue == kEpiScalers ? scal != nullptr
                                                  : wsum != nullptr));
  if (d_in != want_in || (epilogue == kEpiField && d != 2 * d_x) ||
      (epilogue == kEpiSelf && self_mode != kSelfNone && d_x != d) ||
      !inputs_ok || (w2 == nullptr) != (b2 == nullptr) || d_ff < 1 ||
      d_out < 1 || d < 1 || (form != 0 && form != 1) ||
      (form == 1 && scratch == nullptr) ||
      // node and edge rows are indexed with 32-bit offsets
      static_cast<int64_t>(n > e ? n : e) * d >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const bool on_grid = form == 1;
  const size_t bytes = plan(p, rows, on_grid);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool scalers = epilogue == kEpiScalers;
  const Kernel kernel =
      on_grid ? (scalers ? layer_fused_kernel<true, true>
                         : layer_fused_kernel<false, true>)
              : (scalers ? layer_fused_kernel<true, false>
                         : layer_fused_kernel<false, false>);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (!on_grid) {
    const int blocks = (n + p.rows - 1) / p.rows;
    kernel<<<blocks, kThreads, bytes, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  p.tiles = (n + p.rows - 1) / p.rows;
  p.per_key = p.rows;   // the buckets' key: a row's tile
  int* ints = static_cast<int*>(scratch);
  p.counts = ints;
  p.row_start = ints + n;
  p.order = ints + 2 * n + 1;
  int blocks = grid;
  if (blocks <= 0) {
    const int most = resident_blocks(kernel, bytes);
    if (most < 0) return -most;
    if (most < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int want =
        std::max(p.tiles, (e + kEdgesPerBlock - 1) / kEdgesPerBlock);
    blocks = std::min(want, most);
  }
  void* args[] = {&p};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads),
      args, bytes, st);
  cudaGetLastError();   // a refused launch is not left for a later check
  return static_cast<int>(err);
}
