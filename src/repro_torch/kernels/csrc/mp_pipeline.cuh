// The fused gather-phi-scatter edge phase on Hopper (sm_90a), in one launch:
// the kernel and its launcher, shared by mp_pipeline.cu and
// fused_nt_scatter.cu.
//
//
// Replaces the TPU kernel repro/kernels/mp_pipeline.py::mp_pipeline (body
// _mp_pipeline_kernel). For every destination row i, over the unmasked edges
// e with rcv_e == i in stream order:
//
//   phi_e     = act( y[snd_e] * src_weight_e + edge_term_e + bias )
//   sum_i     = sum phi_e          sumsq_i = sum phi_e^2     count_i = #edges
//   max_i     = max phi_e (-BIG when empty)   min_i = min phi_e (+BIG when empty)
//
// src_weight is none, a scalar per edge (E,), full (E, D), or per head (E, H)
// broadcast over D / H lanes. With attention (att_src, att_dst of (N, H)) the
// sweep also runs GAT's edge softmax, per head h = lane / (D / H):
//
//   logit_e = leaky_relu(att_src[snd_e, h] + att_dst[i, h], slope)
//   m = max logit_e;   p_e = exp(logit_e - m);
//   l = sum p_e;       acc = sum p_e phi_e
//
// and normalises in the same launch: sum_i = acc * (l > 0 ? 1 / max(l,
// 1e-16) : 0). att_max = m (-BIG when empty) and att_denom = l (0 when
// empty) come back beside it.
//
// The Pallas kernel gathers and routes with one-hot matrix products on the
// TPU's matrix unit (_gather_phi_tile, mp_scatter._route_matrix). That is a
// device of the TPU and is not carried over; this kernel computes what
// mp_pipeline_ref computes.
//
// What bounds it on an H100. At GAT's paper width (D = 64, H = 4) and the
// hep serving bucket (N = 64, E = 1024, ~800 unmasked) the function moves
// ~0.05 MB if each input is read once and each output written once (node
// rows 16 KB, output 16 KB, the unmasked edges' indices 13 KB): ~0.015 us at
// 3.35 TB/s, far below a launch. At N = 1024, E = 4096 it is ~0.6 MB, ~0.2 us.
// Launch latency and the chain of dependent steps inside the block bound
// it; experiments/pipeline_breakdown.py times the parts.
//
// Design (owner buckets, block-local, as mp_scatter.cu's GNN-size form):
//   * Block b owns destination rows [b*R, b*R + R). The edge stream is taken
//     in tiles of kTileEdges edges (fewer with attention: the tile's
//     per-(edge, head) weights live in shared memory). For each tile the
//     block buckets the owned edges of its rows in shared memory with
//     edge_buckets.cuh's stable form (bucket_edges_stable: mask, receiver
//     and sender loaded together, coalesced, each int64 index read once a
//     tile; a scan lists the owned edges in stream order and one warp
//     places them by row, keeping that order), so each row's segment is in
//     stream order at any length: no sort, no sweep. (bucket_edges with a
//     register sort of each segment took ~2.5 us more at the hep bucket:
//     PERF.md, experiments/pipeline_breakdown.py.) A tile of at most 1,024
//     edges takes the form of 4 edges a thread (a quarter of the
//     instructions of 16, which cost ~1.5 us there). Masked edges (the
//     padding points at node 0) never enter a bucket, nor does an edge
//     whose receiver lies outside [0, n): no block owns it. A sender
//     outside [0, n) is kept as -1 and gathers a zero row (y and att_src
//     are never read there), as the Pallas kernel's one-hot gather gives;
//     check_src (fused_nt_scatter) folds the neutral for it instead, which
//     drops the edge.
//   * Attention in two passes over a row's segment: a warp takes a row, its
//     lanes (slice, head) pairs, and computes each (edge, head) logit once,
//     into shared memory, with the row's max per head; then one expf per
//     (edge, head) in place, which every lane of the head reads in the
//     fold. The fold's first gathers are issued before this pass and land
//     during it. Across tiles the running max rescales the earlier tiles'
//     sums (one expf per row and head a tile); within a tile nothing is
//     rescaled.
//   * The fold: the block's 256 threads form S groups of L lanes, L the
//     power of two >= D (32 at least, 256 at most: a lane of a group folds
//     one column, or several when D > 256), S = 256 / L. S depends on D
//     alone: group s folds slice s of every row, the positions [len s / S,
//     len (s+1) / S) of the row's stream-ordered segment, so that at one row
//     a block every group works. A slice is folded in registers, its loads
//     for 4 or 8 edges (by form) issued before its first fold; folds are
//     branch-free (a select folds the neutral past the slice's end). The
//     slices' partial sums meet in shared memory and are added in slice
//     order, after the earlier tiles' running value, straight into the
//     outputs at the last tile. No atomics ever add a value, and an output's arithmetic depends
//     on D, H and the tiles alone: bitwise the same for any R and from run
//     to run. Any E: tiles follow one another (E = 65,536 takes 16).
//   * The phi and the statistics are fixed at compile time for the forms
//     the paths use (GAT's attention, GIN's sum, GCN's scalar src_weight,
//     PNA's four statistics, DGN's full src_weight, fused_nt_scatter's
//     relu + edge term + check_src, its edge term of float, bfloat16 or
//     float16 widened at the load); one generic form takes the rest, its
//     terms selected without branches and all four statistics folded, and
//     one generic attention form.
//   * The NT form alone is launched with programmatic stream serialization
//     (fused_nt_scatter's second launch): its blocks start while the NT tile
//     that writes y still runs, set up and bucket the first edge tile
//     (receivers, mask and senders; nothing of y), and wait for that grid
//     (griddepcontrol.wait) before the first fold reads y.
//   * Rows per block: one block per SM where the rows allow it, fewer rows
//     while shared memory is short; __launch_bounds__(256, 1), no spills.
//   * expf, not __expf; no fast math; fp32 throughout, no TF32.
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "edge_buckets.cuh"
#include "hopper.cuh"

namespace pipeline {
namespace {   // each source that includes this gets its own kernels

using buckets::kThreads;
using buckets::kWarps;
constexpr int kAttU = 4;              // the attention pass's edges at once
constexpr int kMaxSlices = kThreads / 32;   // S = 256 / L, L >= 32
constexpr int kPerThread = 16;        // a thread's edges of a tile
constexpr int kPerThreadSmall = 4;    // ... of a tile of <= 1,024 edges
constexpr int kTileEdges = kPerThread * kThreads;   // bucketed at a time
constexpr int kProbFloats = 16384;    // the attention's (edge, head) weights
constexpr int kPartFloats = 8192;     // the slices' partial sums
constexpr float kBig = 1e30f;

enum SrcWeightMode { kSwNone = 0, kSwScalar = 1, kSwFull = 2, kSwHead = 3 };
enum Stat { kSum = 1, kSumSq = 2, kMax = 4, kMin = 8 };

struct Args {
  const float* y;        // (n, d) gather buffer
  const int64_t* snd;    // (e,)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  const float* sw;       // (e,), (e, d), (e, sw_cols) or null
  const float* et;       // (e, d) or null
  const float* bias;     // (d,) or null
  const float* att_src;  // (n, heads) or null
  const float* att_dst;  // (n, heads) or null
  float* sum;            // (n, d) or null; each output null when not asked
  float* sumsq;          // (n, d)
  float* count;          // (n, 1)
  float* mx;             // (n, d)
  float* mn;             // (n, d)
  float* att_max;        // (n, heads)
  float* att_denom;      // (n, heads)
  int n, e, d;
  int sw_mode, sw_cols, head_dim;
  int relu, heads;
  float slope;
  int check_src;         // 1: an edge whose sender lies outside [0, n)
                         // adds nothing (fused_nt_scatter's rule)
  // the launch's layout (set by layout()):
  int rows;              // destination rows one block owns
  int tile;              // edges a tile
  int lanes, slices;     // L lanes a group, S = kThreads / L groups
  int batch;             // rows whose slices are folded between two combines
  int ask, nstat;        // the statistics asked (Stat bits; the sum alone
                         // with attention) and how many
  // offsets in 4-byte words of the shared-memory regions
  int o_counts, o_start, o_order, o_list_e, o_list_r, o_snd, o_prob, o_state,
      o_cnt, o_m, o_l, o_corr, o_part, o_part_l, o_red;
};

// The phi and statistics of one instantiation. kGeneric: every term and
// the activation read from Args (selected without branches), all four
// statistics folded.
template <int Sw, bool Et, bool Bias, bool Relu, bool Att, int Stats,
          bool Check, bool Generic = false>
struct Form {
  static constexpr int kSw = Sw;
  static constexpr bool kEt = Et, kBias = Bias, kRelu = Relu, kAtt = Att;
  static constexpr int kStats = Stats;
  static constexpr bool kCheck = Check, kGeneric = Generic;
  // a slice's edges whose gathers are issued together: 4 where the slices
  // are short or a thread's folds are few (GAT's 4 slices of a row; GIN,
  // GCN and the NT form, one sum), 8 for four statistics or one slice a
  // row (PNA, DGN) and the generic forms (measured, PERF.md)
  static constexpr int kU =
      Att || (Stats == kSum && Sw != kSwFull && !Generic) ? 4 : 8;
  using EdgeT = float;                     // the edge term's stored type
  static constexpr bool kWaitPrior = false;   // see NtFormOf
};
constexpr int kFour = kSum | kSumSq | kMax | kMin;
using GatForm = Form<kSwNone, false, false, false, true, kSum, false>;
using GinForm = Form<kSwNone, true, false, true, false, kSum, false>;
using GcnForm = Form<kSwScalar, false, false, false, false, kSum, false>;
using PnaForm = Form<kSwNone, true, true, true, false, kFour, false>;
using DgnForm = Form<kSwFull, false, false, false, false, kSum, false>;
// fused_nt_scatter's form: relu(y[snd] + edge_feat) with the sender check,
// edge_feat stored as E (float, __nv_bfloat16 or __half); launched with
// programmatic stream serialization behind the NT tile, whose y it waits
// for before its first fold
template <typename E>
struct NtFormOf : Form<kSwNone, true, false, true, false, kSum, true> {
  using EdgeT = E;
  static constexpr bool kWaitPrior = true;
};
using NtForm = NtFormOf<float>;
using GenericForm = Form<-1, true, true, true, false, kFour, false, true>;
using GenericAttForm = Form<-1, true, true, true, true, kSum, false, true>;

// the Stat bit of state slot k (the asked statistics in Stat order)
__device__ __forceinline__ int slot_stat(int ask, int k) {
  for (int bit = 1; bit <= kMin; bit <<= 1) {
    if (ask & bit) {
      if (k == 0) return bit;
      --k;
    }
  }
  return 0;
}

__device__ __forceinline__ float neutral(int stat) {
  return stat == kMax ? -kBig : stat == kMin ? kBig : 0.f;
}

template <class F>
__device__ __forceinline__ float phi(const Args& p, float y, float w,
                                     float t, float b) {
  float v = y;
  if constexpr (F::kGeneric) {
    v = p.sw_mode != kSwNone ? __fmul_rn(v, w) : v;
    v = p.et != nullptr ? __fadd_rn(v, t) : v;
    v = p.bias != nullptr ? __fadd_rn(v, b) : v;
    v = p.relu ? fmaxf(v, 0.f) : v;
  } else {
    if constexpr (F::kSw != kSwNone) v = __fmul_rn(v, w);
    if constexpr (F::kEt) v = __fadd_rn(v, t);
    if constexpr (F::kBias) v = __fadd_rn(v, b);
    if constexpr (F::kRelu) v = fmaxf(v, 0.f);
  }
  return v;
}

// The attention's weights of one tile: for each of the block's rows (a warp
// a row) the (edge, head) logits, the row's max per head and one expf per
// (edge, head), in prob[edge of the tile * heads + head]; the running max
// moves to the new max and corr holds the factor of the earlier tiles'
// sums. The warp's lanes are (slice, head) pairs, S = 32 / H slices of the
// row's segment (one when H > 32): a lane computes its slice's logits and
// their max, the lanes of a head take the head's max (by shuffles when H
// divides 32, else through shared memory), then each lane takes the
// exponentials of its slice.
__device__ __forceinline__ void attention_weights(const Args& p, int row0,
                                                  int rows_here) {
  extern __shared__ __align__(16) int smem_i[];
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const int* row_start = smem_i + p.o_start;
  const int* order = smem_i + p.o_order;
  const int* snd_l = smem_i + p.o_snd;
  float* prob = smem_f + p.o_prob;
  float* m_run = smem_f + p.o_m;
  float* corr = smem_f + p.o_corr;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = p.heads;
  const int S = max(1, 32 / H);
  float* red = smem_f + p.o_red + warp * 2 * max(32, H);
  float* red_m = red + max(32, H);
  // the logits of the positions [lo, hi) at head h, into prob; their max
  const auto logits = [&](const float* dst, int h, int lo, int hi) {
    const float b = __ldg(dst + h);
    float mt = -kBig;
    for (int j = lo; j < hi; j += kAttU) {
      const int cnt = min(kAttU, hi - j);
      int id[kAttU];
      float a[kAttU];
#pragma unroll
      for (int u = 0; u < kAttU; ++u) {
        id[u] = order[u < cnt ? j + u : j];
        const int sv = snd_l[id[u]];
        a[u] = sv >= 0 ? __ldg(p.att_src + ((size_t)sv * H + h)) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAttU; ++u) {
        const float z = __fadd_rn(a[u], b);
        const float lg = z >= 0.f ? z : __fmul_rn(p.slope, z);
        if (u < cnt) prob[id[u] * H + h] = lg;
        mt = fmaxf(mt, u < cnt ? lg : -kBig);
      }
    }
    return mt;
  };
  // one expf per (edge, head) of the positions [lo, hi) at head h
  const auto exps = [&](int h, int lo, int hi, float m_h) {
    for (int j = lo; j < hi; ++j) {
      const int i = order[j] * H + h;
      const float lg = prob[i];
      const float pe = expf(__fsub_rn(lg, m_h));
      prob[i] = pe;
    }
  };
  if (S * H == 32) {   // one (slice, head) a lane
    const int s = lane / H;
    const int h = lane - s * H;
    for (int r = warp; r < rows_here; r += kWarps) {
      const int start = row_start[r];
      const int len = row_start[r + 1] - start;
      const int lo = start + len * s / S;
      const int hi = start + len * (s + 1) / S;
      const float m_old = m_run[r * H + h];
      float mt = logits(p.att_dst + (size_t)(row0 + r) * H, h, lo, hi);
      for (int off = 16; off >= H; off >>= 1) {   // lanes of one head
        mt = fmaxf(mt, __shfl_xor_sync(buckets::kFull, mt, off));
      }
      const float m_h = fmaxf(m_old, mt);
      exps(h, lo, hi, m_h);
      if (s == 0) {   // every lane has read m_old: the shuffles came between
        corr[r * H + h] = expf(__fsub_rn(m_old, m_h));
        m_run[r * H + h] = m_h;
      }
    }
    return;
  }
  for (int r = warp; r < rows_here; r += kWarps) {
    const int start = row_start[r];
    const int len = row_start[r + 1] - start;
    // 1. the logits of each lane's (slice, head), and their max
    for (int q = lane; q < S * H; q += 32) {
      const int s = q / H;
      const int h = q - s * H;
      red[q] = logits(p.att_dst + (size_t)(row0 + r) * H, h,
                      start + len * s / S, start + len * (s + 1) / S);
    }
    __syncwarp();
    // 2. the row's max per head; the running max moves to it
    for (int h = lane; h < H; h += 32) {
      float mt = -kBig;
      for (int s = 0; s < S; ++s) mt = fmaxf(mt, red[s * H + h]);
      const float m_old = m_run[r * H + h];
      const float m_h = fmaxf(m_old, mt);
      red_m[h] = m_h;
      corr[r * H + h] = expf(__fsub_rn(m_old, m_h));
      m_run[r * H + h] = m_h;
    }
    __syncwarp();
    // 3. each lane the exponentials of its slice
    for (int q = lane; q < S * H; q += 32) {
      const int s = q / H;
      const int h = q - s * H;
      exps(h, start + len * s / S, start + len * (s + 1) / S, red_m[h]);
    }
    __syncwarp();   // red is rewritten by the warp's next row
  }
}

// What one column of a group folds with: the column, where its src_weight
// sits in an edge's row of it, its bias and its attention head.
struct Column {
  int c;
  int sw_mode, sw_stride, sw_lane;
  bool has_et;
  float bias;
  int h;
  bool head_lane;        // the head's first column writes its denominator
};

template <class F>
__device__ __forceinline__ Column column(const Args& p, int c) {
  Column k;
  k.c = c;
  k.sw_mode = F::kGeneric ? p.sw_mode : F::kSw;
  k.sw_stride = k.sw_mode == kSwFull ? p.d
                : k.sw_mode == kSwHead ? p.sw_cols : 1;
  k.sw_lane = k.sw_mode == kSwFull   ? c
              : k.sw_mode == kSwHead ? c / p.head_dim
                                     : 0;
  k.has_et = F::kGeneric ? p.et != nullptr : F::kEt;
  const bool has_bias = F::kGeneric ? p.bias != nullptr : F::kBias;
  k.bias = has_bias ? __ldg(p.bias + c) : 0.f;
  k.h = F::kAtt ? c / (p.d / p.heads) : 0;
  k.head_lane = F::kAtt && c % (p.d / p.heads) == 0;
  return k;
}

// One round of a slice: U edges' indices and gathered terms, every load
// issued before the first fold (ids[0] again past cnt).
template <int U>
struct Gather {
  int id[U], sv[U];
  float y[U], w[U], t[U];
};

template <class F>
__device__ __forceinline__ void gather(const Args& p, const Column& k,
                                       int base, int j, int cnt,
                                       Gather<F::kU>& g) {
  constexpr int kU = F::kU;
  using EdgeT = typename F::EdgeT;
  extern __shared__ __align__(16) int smem_i[];
  const int* order = smem_i + p.o_order;
  const int* snd_l = smem_i + p.o_snd;
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    g.id[u] = order[u < cnt ? j + u : j];
    g.sv[u] = snd_l[g.id[u]];
  }
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const size_t e = (size_t)base + g.id[u];
    g.y[u] = g.sv[u] >= 0 ? __ldg(p.y + ((size_t)g.sv[u] * p.d + k.c)) : 0.f;
    g.w[u] = k.sw_mode != kSwNone
                 ? __ldg(p.sw + (e * k.sw_stride + k.sw_lane))
                 : 1.f;
    g.t[u] = k.has_et ? hopper::widen(__ldg(
                            reinterpret_cast<const EdgeT*>(p.et) +
                            (e * p.d + k.c)))
                      : 0.f;
  }
}

// The positions [lo, hi) of slice `group` of row r's segment.
__device__ __forceinline__ void slice_of(const Args& p, int r, int group,
                                         int* lo, int* hi) {
  extern __shared__ __align__(16) int smem_i[];
  const int* row_start = smem_i + p.o_start;
  const int start = row_start[r];
  const int len = row_start[r + 1] - start;
  *lo = start + len * group / p.slices;
  *hi = start + len * (group + 1) / p.slices;
}

// Slice `group` of the rows [rb0, rb0 + nb) of this tile, column k.c:
// folded in registers, then written to the partial sums. With `pre` the
// first round of the first row was gathered already.
template <class F>
__device__ __forceinline__ void fold_slice(const Args& p, const Column& k,
                                           int base, int rb0, int nb,
                                           int group, bool use_pre,
                                           const Gather<F::kU>& pre) {
  constexpr int kU = F::kU;
  extern __shared__ __align__(16) int smem_i[];
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const float* prob = smem_f + p.o_prob;
  float* part = smem_f + p.o_part;
  const int d = p.d;
  const int S = p.slices;
  for (int rb = 0; rb < nb; ++rb) {
    int lo, hi;
    slice_of(p, rb0 + rb, group, &lo, &hi);
    float s1 = 0.f, s2 = 0.f, mx = -kBig, mn = kBig, lsum = 0.f;
    for (int j = lo; j < hi; j += kU) {
      const int cnt = min(kU, hi - j);
      Gather<kU> g;
      if (use_pre && rb == 0 && j == lo) {
        g = pre;
      } else {
        gather<F>(p, k, base, j, cnt, g);
      }
      float pv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        pv[u] = F::kAtt ? prob[g.id[u] * p.heads + k.h] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const bool take = u < cnt && (!F::kCheck || g.sv[u] >= 0);
        const float v = phi<F>(p, g.y[u], g.w[u], g.t[u], k.bias);
        if constexpr (F::kAtt) {
          s1 = __fadd_rn(s1, take ? __fmul_rn(pv[u], v) : 0.f);
          lsum = __fadd_rn(lsum, take ? pv[u] : 0.f);
        } else {
          if constexpr ((F::kStats & kSum) != 0) {
            s1 = __fadd_rn(s1, take ? v : 0.f);
          }
          if constexpr ((F::kStats & kSumSq) != 0) {
            s2 = __fadd_rn(s2, take ? __fmul_rn(v, v) : 0.f);
          }
          if constexpr ((F::kStats & kMax) != 0) {
            mx = fmaxf(mx, take ? v : -kBig);
          }
          if constexpr ((F::kStats & kMin) != 0) {
            mn = fminf(mn, take ? v : kBig);
          }
        }
      }
    }
    // slot q of the partial sums: stat q of row rb, slice `group`
    const int stride = p.batch * S * d;
    float* out = part + ((size_t)rb * S + group) * d + k.c;
    int q = 0;
    if (p.ask & kSum) out[stride * q++] = s1;
    if (p.ask & kSumSq) out[stride * q++] = s2;
    if (p.ask & kMax) out[stride * q++] = mx;
    if (p.ask & kMin) out[stride * q++] = mn;
    if (k.head_lane) {
      smem_f[p.o_part_l + ((size_t)rb * S + group) * p.heads + k.h] = lsum;
    }
  }
}

// Row r's denominator at head h: the earlier tiles' (rescaled; none at the
// first) plus the slices' partial sums, in slice order.
__device__ __forceinline__ float head_sum(const float* l_run,
                                          const float* corr,
                                          const float* part_l, int r, int rb,
                                          int h, int H, int S, bool first) {
  float x[kMaxSlices];
#pragma unroll
  for (int s = 0; s < kMaxSlices; ++s) {
    x[s] = s < S ? part_l[((size_t)rb * S + s) * H + h] : 0.f;
  }
  float l = first ? 0.f : __fmul_rn(l_run[r * H + h], corr[r * H + h]);
#pragma unroll
  for (int s = 0; s < kMaxSlices; ++s) {
    if (s < S) l = __fadd_rn(l, x[s]);
  }
  return l;
}

// The slices of rows [rb0, rb0 + nb) added in slice order after the earlier
// tiles' running value (rescaled with attention; the neutral at the first
// tile): into the running state, or at the last tile into the outputs
// (attention normalising its sum there). count takes each row's segment
// length.
template <class F>
__device__ __forceinline__ void combine(const Args& p, int row0, int rb0,
                                        int nb, bool first, bool last) {
  extern __shared__ __align__(16) int smem_i[];
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const int* row_start = smem_i + p.o_start;
  const float* part = smem_f + p.o_part;
  const float* part_l = smem_f + p.o_part_l;
  float* state = smem_f + p.o_state;
  float* l_run = smem_f + p.o_l;
  const float* corr = smem_f + p.o_corr;
  const int tid = threadIdx.x;
  const int d = p.d;
  const int H = p.heads;
  const int S = p.slices;
  const int stride = p.batch * S * d;
  const int att_hd = F::kAtt ? d / H : 1;
  for (int i = tid; i < nb * d; i += kThreads) {
    const int rb = i / d;
    const int c = i - rb * d;
    const int r = rb0 + rb;
    const size_t at = (size_t)(row0 + r) * d + c;
    const float* src = part + (size_t)rb * S * d + c;
    for (int k = 0; k < p.nstat; ++k) {
      const int stat = F::kAtt ? kSum : slot_stat(p.ask, k);
      float* st = state + ((size_t)k * p.rows + r) * d + c;
      float v = first ? neutral(stat) : *st;
      if constexpr (F::kAtt) {
        if (!first) v = __fmul_rn(v, corr[r * H + c / att_hd]);
      }
      const float* sk = src + (size_t)stride * k;
      float x[kMaxSlices];
#pragma unroll
      for (int s = 0; s < kMaxSlices; ++s) {
        x[s] = s < S ? sk[(size_t)s * d] : 0.f;
      }
#pragma unroll
      for (int s = 0; s < kMaxSlices; ++s) {
        if (s < S) {
          v = stat == kMax ? fmaxf(v, x[s])
              : stat == kMin ? fminf(v, x[s]) : __fadd_rn(v, x[s]);
        }
      }
      if (!last) {
        *st = v;
      } else if constexpr (F::kAtt) {
        // the head's denominator, as the (row, head) pass below takes it
        const float l = head_sum(l_run, corr, part_l, r, rb, c / att_hd, H,
                                 S, first);
        const float w = l > 0.f ? 1.f / fmaxf(l, 1e-16f) : 0.f;
        p.sum[at] = __fmul_rn(v, w);
      } else {
        float* out = stat == kSum     ? p.sum
                     : stat == kSumSq ? p.sumsq
                     : stat == kMax   ? p.mx
                                      : p.mn;
        out[at] = v;
      }
    }
  }
  if constexpr (F::kAtt) {
    for (int i = tid; i < nb * H; i += kThreads) {
      const int rb = i / H;
      const int h = i - rb * H;
      const int r = rb0 + rb;
      const float l = head_sum(l_run, corr, part_l, r, rb, h, H, S, first);
      if (last) {
        const size_t at = (size_t)(row0 + r) * H + h;
        p.att_max[at] = smem_f[p.o_m + r * H + h];
        p.att_denom[at] = l;
      } else {
        l_run[r * H + h] = l;
      }
    }
  }
  if (p.count != nullptr) {
    for (int rb = tid; rb < nb; rb += kThreads) {
      const int r = rb0 + rb;
      const float v = __fadd_rn(
          first ? 0.f : smem_f[p.o_cnt + r],
          static_cast<float>(row_start[r + 1] - row_start[r]));
      if (last) {
        p.count[row0 + r] = v;
      } else {
        smem_f[p.o_cnt + r] = v;
      }
    }
  }
}

// Everything after a tile's buckets: the attention's weights, then the
// slices folded and combined, `batch` rows at a time. With attention the
// fold's first round (each thread's first column, the first row) is
// gathered before the attention's pass, so that its loads land during it.
template <class F>
__device__ __forceinline__ void fold_tile(const Args& p, int base, int row0,
                                          int rows_here, bool first,
                                          bool last) {
  const int group = threadIdx.x / p.lanes;
  const int lane_g = threadIdx.x - group * p.lanes;
  Gather<F::kU> pre;
  bool use_pre = false;
  if constexpr (F::kAtt) {
    int lo, hi;
    slice_of(p, 0, group, &lo, &hi);
    if (lane_g < p.d && hi > lo) {
      gather<F>(p, column<F>(p, lane_g), base, lo, min(F::kU, hi - lo),
                pre);
      use_pre = true;
    }
    attention_weights(p, row0, rows_here);
    __syncthreads();
  }
  for (int rb0 = 0; rb0 < rows_here; rb0 += p.batch) {
    const int nb = min(p.batch, rows_here - rb0);
    for (int c = lane_g; c < p.d; c += p.lanes) {
      fold_slice<F>(p, column<F>(p, c), base, rb0, nb, group,
                    use_pre && rb0 == 0 && c == lane_g, pre);
    }
    __syncthreads();
    combine<F>(p, row0, rb0, nb, first, last);
    if (!last || rb0 + p.batch < rows_here) {
      __syncthreads();   // the partial sums are rewritten by the next batch
    }
  }
}

// A tile's senders, loaded beside the buckets' masks and receivers and kept
// (checked: -1 outside [0, n)) for the edges the block owns.
struct Senders {
  const int64_t* snd;    // the tile's
  int* snd_l;            // by edge of the tile
  int n;
  int64_t v[kPerThread];
  __device__ __forceinline__ void load(int k, int i) { v[k] = __ldg(snd + i); }
  __device__ __forceinline__ void store(int k, int i, int, int key) {
    if (key >= 0) {
      snd_l[i] = v[k] >= 0 && v[k] < n ? static_cast<int>(v[k]) : -1;
    }
  }
};

template <class F>
__global__ void __launch_bounds__(kThreads, 1)
    mp_pipeline_kernel(const __grid_constant__ Args p) {
  extern __shared__ __align__(16) int smem_i[];
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  int* snd_l = smem_i + p.o_snd;

  if constexpr (F::kAtt) {
    for (int i = tid; i < rows_here * p.heads; i += kThreads) {
      smem_f[p.o_m + i] = -kBig;
    }
  }
  // one tile (an empty one when E = 0) writes the outputs at its end; more
  // carry a running state in shared memory from one to the next
  for (int base = 0; base == 0 || base < p.e; base += p.tile) {
    const buckets::Edges g = {p.rcv + base, p.mask + base, p.n,
                              min(p.tile, p.e - base)};
    const buckets::Buckets b = {smem_i + p.o_counts, smem_i + p.o_start,
                                smem_i + p.o_order, row0, row0 + rows_here};
    Senders x = {p.snd + base, snd_l, p.n, {}};
    // a tile of at most 1,024 edges (the serving buckets) takes the form
    // of 4 edges a thread, with a quarter of the instructions
    if (g.e <= kThreads * kPerThreadSmall) {
      buckets::bucket_edges_stable<kPerThreadSmall>(
          g, b, smem_i + p.o_list_e, smem_i + p.o_list_r, x);
    } else {
      buckets::bucket_edges_stable<kPerThread>(g, b, smem_i + p.o_list_e,
                                               smem_i + p.o_list_r, x);
    }
    if constexpr (F::kWaitPrior) {
      // y is the grid's before this one (the NT tile): the set-up and the
      // first tile's buckets ran beside it; its writes are whole from here
      if (base == 0) hopper::wait_prior_grid();
    }
    fold_tile<F>(p, base, row0, rows_here, base == 0, base + p.tile >= p.e);
  }
}

// --- the launcher

int popcount(int v) {
  int c = 0;
  for (; v; v &= v - 1) ++c;
  return c;
}

// Fills the launch's layout for `rows` rows a block; returns the dynamic
// shared memory it needs, in bytes.
size_t layout(Args& p, int rows) {
  const bool att = p.heads > 0;
  p.rows = rows;
  p.tile = att ? std::max(32, std::min(kTileEdges,
                                       kProbFloats / p.heads / 32 * 32))
               : kTileEdges;
  p.lanes = 32;
  while (p.lanes < p.d && p.lanes < kThreads) p.lanes *= 2;
  p.slices = kThreads / p.lanes;
  p.nstat = popcount(p.ask);
  const int per_row = p.nstat * p.slices * p.d;
  p.batch = std::max(1, std::min(rows, kPartFloats / std::max(per_row, 1)));
  const int t = std::max(1, std::min(p.tile, p.e));
  const int hr = att ? rows * p.heads : 0;
  size_t words = 0;
  auto take = [&](int n) {
    const int at = static_cast<int>(words);
    words += (static_cast<size_t>(n) + 3) / 4 * 4;   // 16-byte aligned
    return at;
  };
  p.o_counts = take(rows);
  p.o_start = take(rows + 1);
  p.o_order = take(t);
  p.o_list_e = take(t);
  p.o_list_r = take(t);
  p.o_snd = take(t);
  p.o_prob = take(att ? t * p.heads : 0);
  const bool tiles = p.e > p.tile;   // a running state between tiles
  p.o_state = take(tiles ? p.nstat * rows * p.d : 0);
  p.o_cnt = take(tiles && p.count != nullptr ? rows : 0);
  p.o_m = take(hr);
  p.o_l = take(tiles ? hr : 0);
  p.o_corr = take(hr);
  p.o_part = take(p.batch * per_row);
  p.o_part_l = take(att ? p.batch * p.slices * p.heads : 0);
  p.o_red = take(att ? kWarps * 2 * std::max(32, p.heads) : 0);
  return words * 4;
}

int default_rows(Args p) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // one block per SM where the rows allow it, fewer rows if smem is short
  int rows = (p.n + sms - 1) / sms;
  while (rows > 1 && layout(p, rows) > static_cast<size_t>(max_smem)) {
    rows = (rows + 1) / 2;
  }
  return rows < 1 ? 1 : rows;
}

// The statistics a call asks for (Stat bits); attention folds the sum.
int asked(const Args& p) {
  return (p.sum != nullptr ? kSum : 0) | (p.sumsq != nullptr ? kSumSq : 0) |
         (p.mx != nullptr ? kMax : 0) | (p.mn != nullptr ? kMin : 0);
}

// One launch of form F on `stream` (rows <= 0 lets the kernel choose).
template <class F>
int launch_form(Args p, int rows, cudaStream_t stream) {
  if (p.n <= 0) return 0;
  p.ask = F::kAtt ? kSum : asked(p);
  if (p.ask == 0 || p.d <= 0 ||
      (p.heads > 0) != F::kAtt || (p.check_src != 0) != F::kCheck) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = layout(p, rows > 0 ? rows : default_rows(p));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mp_pipeline_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.n + p.rows - 1) / p.rows;
  if constexpr (F::kWaitPrior) {
    // programmatic stream serialization: the grid may start before the one
    // ahead of it on the stream has finished (the kernel waits for it)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, mp_pipeline_kernel<F>, p);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    mp_pipeline_kernel<F><<<blocks, kThreads, smem, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pipeline
