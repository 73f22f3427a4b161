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
// sweep also runs GAT's edge softmax online, per head h = lane / (D / H):
//
//   logit = leaky_relu(att_src[snd_e, h] + att_dst[i, h], slope)
//   m' = max(m, logit); corr = exp(m - m'); p = exp(logit - m')
//   l  = l * corr + p;  acc = acc * corr + p * phi_e;  m = m'
//
// starting from m = -BIG, l = 0 (the first edge gives corr = exp(-BIG - logit)
// = 0, finite; -inf would give inf - inf), and normalises in the same launch:
// sum_i = acc * (l > 0 ? 1 / max(l, 1e-16) : 0). att_max = m (-BIG when
// empty) and att_denom = l (0 when empty) come back beside it.
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
// Launch latency and the serial sweep rule, as they do for layer_fused.
//
// Design (simple and right first; speed is later work), as layer_fused.cu:
//   * Owner computes. Block b owns destination rows [b*R, b*R + R) and sweeps
//     the whole edge stream in stream order, a tile of kEdgeTile edges at a
//     time. A block-wide scan compacts the owned, unmasked edges of the tile
//     into a shared-memory list that keeps stream order. Masked edges (the
//     padding points at node 0) never enter the list, nor does an edge whose
//     receiver lies outside [0, n): no block owns it. A sender outside
//     [0, n) enters as -1 and gathers a zero row (y and att_src are never
//     read there), so phi = act(edge_term + bias) still counts, as the
//     Pallas kernel's one-hot gather gives; check_src drops it instead.
//   * Threads run over the D lanes; with D <= blockDim there are
//     blockDim / D groups of lanes and group g owns the rows r % groups == g.
//     Every (row, lane) of each f32 shared-memory accumulator is written by
//     exactly one thread, in stream order: no atomics, and the result is
//     bitwise the same for any R and from run to run.
//   * Attention keeps m and l per (row, lane): every lane of a (row, head)
//     computes the same m and l from the same edges in the same order, so
//     no lane waits on another and no barrier is needed per edge. One lane
//     per (row, head) writes att_max / att_denom.
//   * expf, not __expf; no fast math; fp32 throughout, no TF32.
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pipeline {
namespace {   // each source that includes this gets its own kernel

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;
constexpr int kUnroll = 4;        // edges whose loads are issued together
constexpr float kBig = 1e30f;

enum SrcWeightMode { kSwNone = 0, kSwScalar = 1, kSwFull = 2, kSwHead = 3 };

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
  int rows;              // destination rows one block owns
};

// f32 arrays of rows x d in shared memory: sum, sumsq, max, min, and the
// attention's m and l
int wide_arrays(const Args& p) {
  const bool att = p.heads > 0;
  return (p.sum != nullptr) + (p.sumsq != nullptr) + (p.mx != nullptr) +
         (p.mn != nullptr) + (att ? 2 : 0);
}

size_t smem_bytes(const Args& p, int rows) {
  const size_t floats =
      (size_t)rows * p.d * wide_arrays(p) + (p.count != nullptr ? rows : 0);
  return floats * sizeof(float) + 3 * kEdgeTile * sizeof(int) +
         (kWarps + 1) * sizeof(int);
}

// s is -1 for a sender outside [0, n): its row reads as zeros
__device__ __forceinline__ float phi(const Args& p, int e, int s, int dd) {
  float v = s >= 0 ? p.y[(size_t)s * p.d + dd] : 0.f;
  if (p.sw_mode == kSwScalar) {
    v = __fmul_rn(v, p.sw[e]);
  } else if (p.sw_mode == kSwFull) {
    v = __fmul_rn(v, p.sw[(size_t)e * p.d + dd]);
  } else if (p.sw_mode == kSwHead) {
    v = __fmul_rn(v, p.sw[(size_t)e * p.sw_cols + dd / p.head_dim]);
  }
  if (p.et != nullptr) v = __fadd_rn(v, p.et[(size_t)e * p.d + dd]);
  if (p.bias != nullptr) v = __fadd_rn(v, p.bias[dd]);
  if (p.relu) v = fmaxf(v, 0.f);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    mp_pipeline_kernel(const __grid_constant__ Args p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rd = p.rows * p.d;
  const bool att = p.heads > 0;

  // carve the accumulators; each is null when not asked for
  float* next = smem;
  auto take = [&](bool want, int size) {
    float* a = want ? next : nullptr;
    next += want ? size : 0;
    return a;
  };
  float* a_sum = take(p.sum != nullptr, rd);
  float* a_sumsq = take(p.sumsq != nullptr, rd);
  float* a_max = take(p.mx != nullptr, rd);
  float* a_min = take(p.mn != nullptr, rd);
  float* a_m = take(att, rd);
  float* a_l = take(att, rd);
  float* a_cnt = take(p.count != nullptr, p.rows);
  int* list_e = reinterpret_cast<int*>(next);
  int* list_s = list_e + kEdgeTile;
  int* list_r = list_s + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1

  for (int i = tid; i < rd; i += kThreads) {
    if (a_sum) a_sum[i] = 0.f;
    if (a_sumsq) a_sumsq[i] = 0.f;
    if (a_max) a_max[i] = -kBig;
    if (a_min) a_min[i] = kBig;
    if (att) {
      a_m[i] = -kBig;
      a_l[i] = 0.f;
    }
  }
  if (a_cnt) {
    for (int i = tid; i < p.rows; i += kThreads) a_cnt[i] = 0.f;
  }

  // lanes of the accumulate phase (see the design note above)
  const bool narrow = p.d <= kThreads;
  const int groups = narrow ? kThreads / p.d : 1;
  const int group = narrow ? tid / p.d : 0;
  const int lane0 = narrow ? tid % p.d : tid;
  const int lane_step = narrow ? p.d : kThreads;
  const int att_hd = att ? p.d / p.heads : 1;

  for (int base = 0; base < p.e; base += kEdgeTile) {
    // 1. which of this thread's consecutive edges does the block own?
    const int e0 = base + tid * kEdgesPerThread;
    int local[kEdgesPerThread];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const int e = e0 + k;
      local[k] = -1;
      if (e < p.e && p.mask[e]) {
        const int64_t r = p.rcv[e] - row0;
        if (r >= 0 && r < rows_here &&
            (!p.check_src || (p.snd[e] >= 0 && p.snd[e] < p.n))) {
          local[k] = static_cast<int>(r);
          ++cnt;
        }
      }
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
    int slot = scan[warp] + incl - cnt;
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      if (local[k] >= 0) {
        list_e[slot] = e0 + k;
        // a sender outside [0, n) gathers a zero row (the Pallas kernel's
        // one-hot gather); -1 marks it so that y is never read there
        const int64_t s = p.snd[e0 + k];
        list_s[slot] = (s >= 0 && s < p.n) ? static_cast<int>(s) : -1;
        list_r[slot] = local[k];
        ++slot;
      }
    }
    __syncthreads();
    const int total = scan[kWarps];

    // 3. each (row, lane) folds its edges' phi in stream order
    if (group < groups) {
      for (int dd = lane0; dd < p.d; dd += lane_step) {
        const int h = dd / att_hd;
        for (int i = 0; i < total; i += kUnroll) {
          float v[kUnroll];
          float logit[kUnroll];
          int rr[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            rr[u] = -1;
            v[u] = 0.f;
            logit[u] = 0.f;
            if (i + u < total && list_r[i + u] % groups == group) {
              const int s = list_s[i + u];
              rr[u] = list_r[i + u];
              v[u] = phi(p, list_e[i + u], s, dd);
              if (att) {
                const float z = __fadd_rn(
                    s >= 0 ? p.att_src[(size_t)s * p.heads + h] : 0.f,
                    p.att_dst[(size_t)(row0 + rr[u]) * p.heads + h]);
                logit[u] = z >= 0.f ? z : __fmul_rn(p.slope, z);
              }
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (rr[u] < 0) continue;
            const int idx = rr[u] * p.d + dd;
            if (att) {
              const float m_old = a_m[idx];
              const float m_new = fmaxf(m_old, logit[u]);
              const float corr = expf(__fsub_rn(m_old, m_new));
              const float pe = expf(__fsub_rn(logit[u], m_new));
              a_l[idx] = __fadd_rn(__fmul_rn(a_l[idx], corr), pe);
              a_sum[idx] = __fadd_rn(__fmul_rn(a_sum[idx], corr),
                                     __fmul_rn(pe, v[u]));
              a_m[idx] = m_new;
            } else {
              if (a_sum) a_sum[idx] = __fadd_rn(a_sum[idx], v[u]);
              if (a_sumsq) {
                a_sumsq[idx] = __fadd_rn(a_sumsq[idx], __fmul_rn(v[u], v[u]));
              }
              if (a_max) a_max[idx] = fmaxf(a_max[idx], v[u]);
              if (a_min) a_min[idx] = fminf(a_min[idx], v[u]);
            }
            // one lane per row counts: lane 0 of the row's group
            if (a_cnt && dd == 0) a_cnt[rr[u]] += 1.f;
          }
        }
      }
    }
    __syncthreads();   // the list is rewritten by the next tile
  }

  // 4. write the block's rows; attention normalises its sum on the way out
  const size_t out0 = (size_t)row0 * p.d;
  for (int i = tid; i < rows_here * p.d; i += kThreads) {
    if (att) {
      const float l = a_l[i];
      const float w = l > 0.f ? 1.f / fmaxf(l, 1e-16f) : 0.f;
      p.sum[out0 + i] = __fmul_rn(a_sum[i], w);
    } else if (a_sum) {
      p.sum[out0 + i] = a_sum[i];
    }
    if (a_sumsq) p.sumsq[out0 + i] = a_sumsq[i];
    if (a_max) p.mx[out0 + i] = a_max[i];
    if (a_min) p.mn[out0 + i] = a_min[i];
  }
  if (a_cnt) {
    for (int r = tid; r < rows_here; r += kThreads) p.count[row0 + r] = a_cnt[r];
  }
  if (att) {
    for (int i = tid; i < rows_here * p.heads; i += kThreads) {
      const int r = i / p.heads;
      const int h = i % p.heads;
      const int idx = r * p.d + h * att_hd;      // the head's first lane
      p.att_max[(size_t)row0 * p.heads + i] = a_m[idx];
      p.att_denom[(size_t)row0 * p.heads + i] = a_l[idx];
    }
  }
}

int default_rows(const Args& p) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // one block per SM where the rows allow it, fewer rows if smem is short
  int rows = (p.n + sms - 1) / sms;
  while (rows > 1 && smem_bytes(p, rows) > static_cast<size_t>(max_smem)) {
    rows = (rows + 1) / 2;
  }
  return rows < 1 ? 1 : rows;
}

// One launch of the edge phase on `stream`. A null output pointer switches
// its statistic off; null att_src/att_dst switch attention off (heads = 0).
// rows <= 0 lets the kernel choose. Returns cudaGetLastError() after the
// launch (0 on success).
int launch(Args p, int rows, cudaStream_t stream) {
  if (p.n <= 0) return 0;
  if (p.heads > 0 &&
      (p.sum == nullptr || p.att_max == nullptr || p.att_denom == nullptr ||
       p.att_src == nullptr || p.att_dst == nullptr || p.d % p.heads != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.rows = rows > 0 ? rows : default_rows(p);
  const size_t smem = smem_bytes(p, p.rows);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mp_pipeline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.n + p.rows - 1) / p.rows;
  mp_pipeline_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pipeline
