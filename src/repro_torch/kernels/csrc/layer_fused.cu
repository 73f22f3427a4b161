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
// w1 alone is 333 KB). experiments/layer_fused_breakdown.py times the
// parts: launch, edge sweep, weight copies, dense arithmetic.
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
//   * No work on padding rows: the dense layers take groups of 8, 4, 2 and
//     1 rows, and every pass of the epilogue runs over rows_here alone.
//   * Owner computes for the edges. Block b owns destination rows
//     [b*R, b*R + R) and sweeps the whole edge stream in stream order, a tile
//     of kEdgeTile edges at a time (mask, receiver and sender loaded
//     together, the next tile's ahead); a block-wide scan appends the tile's
//     owned, unmasked edges to a shared-memory list that keeps stream order
//     across tiles, and the list is folded once (or whenever it would
//     overflow). Masked edges never enter the list, nor does an edge whose
//     receiver lies outside [0, n) (no block owns it). A sender outside
//     [0, n) enters as -1 and gathers a zero row (y is never read there), as
//     the Pallas kernel's one-hot gather gives. Threads run over the D lanes;
//     every (row, lane) of the f32 accumulators (one, or four for the scalers
//     form) is written by exactly one thread, in stream order: no atomics.
//     A round's loads are all issued before its folds, which are branch
//     free; where a group of lanes owns one row at most (one row a block at
//     the buckets) the sums stay in registers.
//   * Epilogue in the same launch: the self term in place, or the scalers /
//     field input row z built in shared memory (rounded adds and products,
//     no contraction, as the plain version rounds them), then the dense
//     layers; the hidden layer stays in shared memory. A dense layer names
//     its shared-memory input by offset (dense_tile.cuh).
//   * Rows per block: one block per SM where the rows allow it (one row a
//     block at the buckets, 8 at N = 1024), the best of 1-16 rows measured
//     at both (PERF.md). No thread-block clusters: the weight
//     copies are not what sets a layer's time (PERF.md).
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_tile.cuh"
#include "hopper.cuh"

// The block's dynamic shared memory (dense_tile.cuh's smem): weight slots,
// biases, accumulators, z, hidden layer, partial sums, edge lists, barriers.

namespace {

using dense::dense_layer;
using dense::issue_first;
using dense::kChunkBytes;
using dense::round_up;
using hopper::mbar_init;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;
constexpr int kUnroll = 8;        // edges whose loads are issued together
constexpr float kBig = 1e30f;     // keyed max / min neutral (mp_pipeline's)

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

// kScalers: the scalers form's four accumulators (a separate instance, so
// that the other forms' edge loop keeps one accumulator and nothing else)
template <bool kScalers>
__global__ void __launch_bounds__(kThreads, 1)
    layer_fused_kernel(const __grid_constant__ Args p) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const bool two_layer = p.w2 != nullptr;

  constexpr bool scalers = kScalers;
  const int acc_len = (p.rows + 1) * p.ds;            // + the trash row
  float* acc = smem + p.o_acc;                         // s1: rows x ds
  float* acc_sq = acc + acc_len;                       // scalers only: s2,
  float* acc_mx = acc_sq + acc_len;                    //   max,
  float* acc_mn = acc_mx + acc_len;                    //   min
  float* z = smem + p.o_z;                             // rows x zs
  int* list_e = reinterpret_cast<int*>(smem + p.o_list);
  int* list_s = list_e + kEdgeTile;
  int* list_r = list_s + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);

  if (tid == 0) {
    for (int s = 0; s < p.slots + 2; ++s) mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  for (int i = tid; i < rows_here * p.ds; i += kThreads) {
    acc[i] = 0.f;
    if constexpr (scalers) {
      acc_sq[i] = 0.f;
      acc_mx[i] = -kBig;
      acc_mn[i] = kBig;
    }
  }
  __syncthreads();
  issue_first(p, tid);   // land while the edges are swept

  // lanes of the accumulate phase (see the design note above)
  const bool narrow = p.d <= kThreads;
  const int groups = narrow ? kThreads / p.d : 1;
  const int group = narrow ? tid / p.d : 0;
  const int lane0 = narrow ? tid % p.d : tid;
  const int lane_step = narrow ? p.d : kThreads;
  // where a lane's src_weight sits in an edge's row of it
  const int sw_stride = p.sw_mode == kSwFull   ? p.d
                        : p.sw_mode == kSwHead ? p.sw_cols
                                               : 1;

  // this thread's kEdgesPerThread consecutive edges of a tile: mask,
  // receiver and sender, loaded together (the next tile's while this one is
  // accumulated)
  uint8_t m_own[kEdgesPerThread];
  int64_t r_own[kEdgesPerThread], s_own[kEdgesPerThread];
  // 3. each (row, lane) adds the listed edges' phi in stream order; a
  //    round's loads are all issued before its first use. Where every group
  //    of lanes owns one row at most (groups >= rows_here: the serving
  //    buckets, one row a block), a lane's sums stay in registers for the
  //    whole list; else each edge folds into its row in shared memory.
  const bool one_row = groups >= rows_here;
  auto accumulate = [&](int listed) {
    if (group >= groups || (one_row && group >= rows_here)) return;
    for (int dd = lane0; dd < p.d; dd += lane_step) {
      const float pbv = p.pb != nullptr ? __ldg(p.pb + dd) : 0.f;
      const int sw_lane = p.sw_mode == kSwFull   ? dd
                          : p.sw_mode == kSwHead ? dd / p.head_dim
                                                 : 0;
      const int own = group * p.ds + dd;   // the one row's (one_row)
      float s1 = acc[own];
      float s2 = scalers ? acc_sq[own] : 0.f;
      float mx = scalers ? acc_mx[own] : 0.f;
      float mn = scalers ? acc_mn[own] : 0.f;
      for (int i = 0; i < listed; i += kUnroll) {
        int rr[kUnroll];
        float yv[kUnroll], wv[kUnroll], tv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int rg = list_r[i + u];
          const bool mine = i + u < listed && (rg & 255) == group;
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
          for (int u = 0; u < kUnroll; ++u) {
            const float v = phi(p, yv[u], wv[u], tv[u], pbv);
            const bool mine = rr[u] >= 0;
            s1 = mine ? s1 + v : s1;
            if constexpr (scalers) {
              s2 = mine ? __fadd_rn(s2, __fmul_rn(v, v)) : s2;
              mx = mine ? fmaxf(mx, v) : mx;
              mn = mine ? fminf(mn, v) : mn;
            }
          }
        } else {
          // the edges of other rows fold into the trash row
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const float v = phi(p, yv[u], wv[u], tv[u], pbv);
            const int a = (rr[u] >= 0 ? rr[u] : p.rows) * p.ds + dd;
            acc[a] += v;
            if constexpr (scalers) {
              acc_sq[a] = __fadd_rn(acc_sq[a], __fmul_rn(v, v));
              acc_mx[a] = fmaxf(acc_mx[a], v);
              acc_mn[a] = fminf(acc_mn[a], v);
            }
          }
        }
      }
      if (one_row) {
        acc[own] = s1;
        if constexpr (scalers) {
          acc_sq[own] = s2;
          acc_mx[own] = mx;
          acc_mn[own] = mn;
        }
      }
    }
  };

  // The owned edges of every tile are appended to one list in stream
  // order, which is accumulated when the next tile would overflow it and
  // at the end: one accumulate pass for the whole stream unless the block
  // owns more than kEdgeTile edges.
  int listed = 0;
  load_tile(p, 0, tid, m_own, r_own, s_own);
  for (int base = 0; base < p.e; base += kEdgeTile) {
    // 1. which of this thread's consecutive edges does the block own?
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
    // 2. block-wide exclusive scan of the counts: list slots in stream order
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
      if (local[k] >= 0) {
        list_e[slot] = e0 + k;
        // its row's offset in y; a sender outside [0, n) gathers a zero row
        // (the Pallas kernel's one-hot gather): -1 marks it so that y is
        // never read there
        const int64_t s = s_own[k];
        list_s[slot] = (s >= 0 && s < p.n) ? static_cast<int>(s) * p.d : -1;
        // the row and, in the low 8 bits, the group of lanes that owns it
        list_r[slot] = local[k] << 8 | local[k] % groups;
        ++slot;
      }
    }
    listed += owned;
    load_tile(p, base + kEdgeTile, tid, m_own, r_own, s_own);
  }
  __syncthreads();
  accumulate(listed);
  __syncthreads();

  // 4. the first dense layer's input row: the self term in place on acc,
  //    or z from the accumulators (scalers, field); element (r, c) of the
  //    rows_here x width rows goes to thread (r * width + c) % kThreads
  auto rows_by_threads = [&](int width, auto&& f) {
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
  };
  if (p.epilogue == kEpiSelf) {
    if (p.self_mode != kSelfNone) {
      rows_by_threads(p.d, [&](int r, int c) {
        const float sc = __ldg(p.sc + (p.self_mode == kSelfScalar ? 0
                                                                  : row0 + r));
        const float xv = __ldg(p.x + (size_t)(row0 + r) * p.d + c);
        float* a = acc + r * p.ds + c;
        *a = __fadd_rn(*a, __fmul_rn(sc, xv));
      });
    }
  } else {
    // z's first D_x columns: the carry rows
    rows_by_threads(p.d_x, [&](int r, int c) {
      z[r * p.zs + c] = __ldg(p.x + (size_t)(row0 + r) * p.d_x + c);
    });
  }
  if constexpr (scalers) {
    // m = [mean | std | max | min] at lane c, times each degree scaler
    rows_by_threads(p.d, [&](int r, int c) {
      const int a = r * p.ds + c;
      const float deg = __ldg(p.deg + row0 + r);
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
      const float* sr = p.scal + (size_t)(row0 + r) * p.n_scalers;
      for (int k = 0; k < p.n_scalers; ++k) {
        const float sk = __ldg(sr + k);
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
      const float rdenom =
          __fdiv_rn(1.f, fmaxf(__ldg(p.deg + row0 + r), 1.f));
      const float xv = __ldg(p.x + (size_t)(row0 + r) * p.d_x + c);
      const float* a = acc + r * p.ds;
      float* zr = z + r * p.zs;
      zr[p.d_x + c] = __fmul_rn(a[c], rdenom);
      zr[2 * p.d_x + c] = fabsf(__fsub_rn(
          a[p.d_x + c], __fmul_rn(xv, __ldg(p.wsum + row0 + r))));
    });
  }
  __syncthreads();

  // 5. the update MLP, its first layer on acc (self) or z
  const bool self = p.epilogue == kEpiSelf;
  const int in_off = self ? p.o_acc : p.o_z;
  const int in_stride = self ? p.ds : p.zs;
  if (two_layer) {
    dense_layer(p, 0, in_off, in_stride, p.o_b1, p.o_hid, p.hs, false,
                p.out, row0, rows_here, true, tid);
    __syncthreads();
    dense_layer(p, 1, p.o_hid, p.hs, p.o_b2, 0, 0, true, p.out, row0,
                rows_here, p.out_relu, tid);
  } else {
    dense_layer(p, 0, in_off, in_stride, p.o_b1, 0, 0, true, p.out, row0,
                rows_here, p.out_relu, tid);
  }
}

// --- the host's plan

// Lay out a block of `rows` rows; returns its bytes. Every region starts on
// 16 bytes (the slots on 128).
size_t layout(Args& p, int rows, int slots) {
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
  o += round_up(3 * kEdgeTile + kWarps + 1 + 2 * kUnroll, 4);
  p.o_bar = o;
  o += 2 * (slots + 2);
  return static_cast<size_t>(o) * sizeof(float);
}

// The rows a block owns (`rows` if given, > 0; else one block per SM where
// the rows allow it) and the weight ring: each layer's weight whole in a
// slot of its own where both fit beside the rows, else chunks of at most
// kChunkBytes through as many slots as fit (at least two; rows are halved
// until they do, and one block row takes one slot if it must). Returns the
// block's bytes, or 0 if even that does not fit.
size_t plan(Args& p, int rows) {
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
  if (rows <= 0) rows = (p.n + sms - 1) / sms;
  // each layer's weight in one slot where both fit beside the rows
  int total = chunking(true);
  size_t bytes = layout(p, rows, total);
  if (bytes <= static_cast<size_t>(max_smem)) return bytes;
  total = chunking(false);
  for (;;) {
    const size_t fixed = layout(p, rows, 0);
    const size_t room = fixed < (size_t)max_smem ? max_smem - fixed : 0;
    const size_t per_slot = 4 * (size_t)p.slot_floats + 8;
    int slots = static_cast<int>(room / per_slot);
    if (slots > total) slots = total;
    if (slots >= (total < 2 ? total : 2) || (rows == 1 && slots >= 1)) {
      return layout(p, rows, slots);
    }
    if (rows == 1) return 0;
    rows = (rows + 1) / 2;
  }
}

}  // namespace

// Launch one layer on `stream`. Null pointers switch terms off (w2/b2 null:
// one dense layer); `epilogue` picks the self (0), scalers (1) or field (2)
// form, whose inputs must then be given. rows <= 0 lets the kernel choose;
// rows that would not fit in shared memory are halved until they do.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int layer_fused_launch(
    const void* x, const void* y, const void* snd, const void* rcv,
    const void* mask, const void* sw, const void* et, const void* pb,
    const void* sc, const void* scal, const void* deg, const void* wsum,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* out, int n, int e, int d, int d_x, int d_in, int d_ff, int d_out,
    int sw_mode, int sw_cols, int head_dim, int self_mode, int epilogue,
    int n_scalers, int phi_relu, int out_relu, int rows, void* stream) {
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
      d_out < 1 || d < 1 ||
      // node and edge rows are indexed with 32-bit offsets
      static_cast<int64_t>(n > e ? n : e) * d >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const size_t bytes = plan(p, rows);
  if (bytes == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = epilogue == kEpiScalers ? layer_fused_kernel<true>
                                               : layer_fused_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + p.rows - 1) / p.rows;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
