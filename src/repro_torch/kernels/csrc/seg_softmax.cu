// The per-destination softmax of an edge stream's logits on Hopper (sm_90a),
// in two launches: statistics, then normalisation.
//
// Replaces the TPU kernel repro/kernels/seg_softmax.py::seg_softmax (its two
// pallas_calls, _stats_kernel and _norm_kernel). For logits l (E, H), per
// destination row i and head h, over the unmasked edges e with rcv_e == i:
//
//   launch 1  m[i, h] = max l[e, h]  and  d[i, h] = sum exp(l[e, h] - m[i, h]),
//             kept online in stream order:
//               m' = max(m, l);  d = d * exp(m - m') + exp(l - m');  m = m'
//             from m = -inf, d = 0. The first edge of a row must not take
//             exp(-inf - -inf): the rescale is 0 while m is -inf. Empty rows
//             come out m = -inf, d = 0.
//   launch 2  w[e, h] = exp(l[e, h] - m[rcv_e, h]) / max(d[rcv_e, h], 1e-16)
//             where e is unmasked and d[rcv_e, h] > 0, else exactly 0.
//
// Normalising needs every edge's statistics first, and blocks cannot wait
// on each other: hence two launches, issued back to back on the caller's
// stream by one launcher.
//
// The Pallas kernels route each edge tile through a one-hot matrix on the
// TPU's matrix unit (_route_matrix, the (edge_tile, N) gather in
// _norm_kernel). That is a device of the TPU and is not carried over; this
// kernel computes what segment_softmax_ref computes.
//
// What bounds it on an H100. Each input read once and each output written
// once: the logits of the unmasked edges, their receivers at 4 bytes, the
// mask, the weights (E, H). At GAT's H = 4 and the hep serving bucket
// (N = 64, E = 1024, ~800 unmasked) that is ~0.03 MB for both launches,
// ~0.01 us at 3.35 TB/s. Two launch latencies and the serial sweep rule.
//
// Design (simple and right first; speed is later work):
//   * Launch 1 is owner computes, as mp_scatter.cu: block b owns rows
//     [b*R, b*R + R) and sweeps the whole stream in stream order;
//     owned_edges.cuh compacts each tile's owned, unmasked edges in stream
//     order. Threads run over the H heads in groups; group g owns the rows
//     r % groups == g, so each (row, head) of m and d is written by one
//     thread, in stream order: no atomics, bitwise the same for any R and
//     from run to run.
//   * Launch 2 is one thread per (edge, head).
//   * expf, not __expf; no fast math; f32 throughout.
//   * The launcher returns cudaGetLastError(); it allocates nothing (m and d
//     are the caller's scratch) and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "owned_edges.cuh"

namespace {

using owned::kEdgeTile;
using owned::kThreads;

struct Args {
  const float* logits;   // (e, h)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  float* m;              // (n, h) running max, -inf when empty
  float* d;              // (n, h) denominator, 0 when empty
  float* out;            // (e, h) weights
  int n, e, h;
  int rows;              // destination rows one block of launch 1 owns
};

size_t stats_smem_bytes(const Args& p, int rows) {
  return (size_t)2 * rows * p.h * sizeof(float) + owned::kListBytes;
}

__global__ void __launch_bounds__(kThreads)
    seg_softmax_stats_kernel(const __grid_constant__ Args p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rh = p.rows * p.h;
  float* a_m = smem;
  float* a_d = a_m + rh;
  int* list_e = reinterpret_cast<int*>(a_d + rh);
  int* list_r = list_e + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1

  for (int i = tid; i < rh; i += kThreads) {
    a_m[i] = -INFINITY;
    a_d[i] = 0.f;
  }

  const bool narrow = p.h <= kThreads;
  const int groups = narrow ? kThreads / p.h : 1;
  const int group = narrow ? tid / p.h : 0;
  const int lane0 = narrow ? tid % p.h : tid;
  const int lane_step = narrow ? p.h : kThreads;

  for (int base = 0; base < p.e; base += kEdgeTile) {
    const int total = owned::compact_owned_edges(
        p.rcv, p.mask, p.e, base, row0, rows_here, list_e, list_r, scan);
    if (group < groups) {
      for (int hh = lane0; hh < p.h; hh += lane_step) {
        for (int i = 0; i < total; ++i) {
          const int r = list_r[i];
          if (r % groups != group) continue;
          const float l = p.logits[(size_t)list_e[i] * p.h + hh];
          const int idx = r * p.h + hh;
          const float m_old = a_m[idx];
          const float m_new = fmaxf(m_old, l);
          // while m is -inf, d is 0 and there is nothing to rescale; a -inf
          // logit adds nothing
          const float corr =
              m_old == -INFINITY ? 0.f : expf(__fsub_rn(m_old, m_new));
          const float pe = l == -INFINITY ? 0.f : expf(__fsub_rn(l, m_new));
          a_d[idx] = __fadd_rn(__fmul_rn(a_d[idx], corr), pe);
          a_m[idx] = m_new;
        }
      }
    }
    __syncthreads();   // the list is rewritten by the next tile
  }

  const size_t out0 = (size_t)row0 * p.h;
  for (int i = tid; i < rows_here * p.h; i += kThreads) {
    p.m[out0 + i] = a_m[i];
    p.d[out0 + i] = a_d[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    seg_softmax_norm_kernel(const __grid_constant__ Args p) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (size_t)p.e * p.h) return;
  const int e = static_cast<int>(i / p.h);
  const int hh = static_cast<int>(i % p.h);
  float w = 0.f;
  if (p.mask[e]) {
    const int64_t r = p.rcv[e];
    if (r >= 0 && r < p.n) {
      const size_t s = (size_t)r * p.h + hh;
      const float den = p.d[s];
      if (den > 0.f) {
        w = expf(__fsub_rn(p.logits[i], p.m[s])) / fmaxf(den, 1e-16f);
      }
    }
  }
  p.out[i] = w;
}

}  // namespace

// Softmax weights of logits (e, h) f32 per destination over the unmasked
// edges into out (e, h), with m and d (n, h) f32 the caller's scratch (the
// statistics come back in them). Two launches on `stream`. rows <= 0 lets
// launch 1 choose the rows a block owns. Returns cudaGetLastError() after
// the launches (0 on success).
extern "C" int seg_softmax_launch(const void* logits, const void* rcv,
                                  const void* mask, void* m, void* d,
                                  void* out, int n, int e, int h, int rows,
                                  void* stream) {
  Args p = {};
  p.logits = static_cast<const float*>(logits);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.m = static_cast<float*>(m);
  p.d = static_cast<float*>(d);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.h = h;
  if (h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    p.rows = rows > 0 ? rows : owned::default_rows(n, [&](int r) {
      return stats_smem_bytes(p, r);
    });
    const size_t smem = stats_smem_bytes(p, p.rows);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          seg_softmax_stats_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int blocks = (n + p.rows - 1) / p.rows;
    seg_softmax_stats_kernel<<<blocks, kThreads, smem, st>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t work = (size_t)e * h;
  if (work == 0) return 0;
  const int blocks = static_cast<int>((work + kThreads - 1) / kThreads);
  seg_softmax_norm_kernel<<<blocks, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
