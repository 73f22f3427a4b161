// The per-destination softmax of an edge stream's logits on Hopper (sm_90a),
// in one launch.
//
// Replaces the TPU kernel repro/kernels/seg_softmax.py::seg_softmax (its two
// pallas_calls, _stats_kernel and _norm_kernel). For logits l (E, H), per
// destination row i of [0, n) (the caller's n_pad rows) and head h, over
// the unmasked edges e with rcv_e == i:
//
//   m[i, h] = max l[e, h]         d[i, h] = sum exp(l[e, h] - m[i, h])
//   w[e, h] = exp(l[e, h] - m[rcv_e, h]) / max(d[rcv_e, h], 1e-16)
//
// where e is unmasked, its receiver lies in [0, n) and d[rcv_e, h] > 0, else
// exactly 0. A -inf logit adds nothing (exp of it is taken as 0), and a row
// whose logits are all -inf keeps d = 0, so its weights are 0. Empty rows
// come out m = -inf, d = 0; m and d are written to the caller's scratch.
//
// The Pallas kernels route each edge tile through a one-hot matrix on the
// TPU's matrix unit (_route_matrix, the (edge_tile, N) gather in
// _norm_kernel). That is a device of the TPU and is not carried over; this
// kernel computes what segment_softmax_ref computes.
//
// What bounds it on an H100. Each input read once and each output written
// once: the logits of the unmasked edges, their receivers at 4 bytes, the
// mask, the weights (E, H). At GAT's H = 4 and the hep serving bucket
// (N = 64, E = 1024, ~800 unmasked) that is ~0.03 MB, ~0.01 us at
// 3.35 TB/s: one launch latency and the chain of dependent steps inside the
// block bound it.
//
// Design (owner buckets, as mp_pipeline.cuh):
//   * Block b owns rows [b*R, b*R + R) and buckets the owned edges of its
//     rows in shared memory with edge_buckets.cuh's stable form
//     (bucket_edges_stable: each row's segment in stream order), a tile of
//     kTileEdges edges at a time. Once a block holds every edge of its rows
//     it can write their weights itself: no second launch and no grid
//     barrier.
//   * A warp takes a row. Its lanes are (slice, head) pairs, S = 32 / H
//     slices (one when H > 32) fixed by H alone: slice s takes the positions
//     [len s / S, len (s+1) / S) of the row's segment. The lanes take the
//     row's max per head, then the sum of exp(l - m) over their slice in
//     stream order; the slices' sums meet by shuffles when H divides 32 (a
//     butterfly, every lane of a head with the same sum) and otherwise in
//     shared memory, added in slice order. Either order is fixed by H.
//     Past the first tile the running max rescales the earlier tiles' sum
//     (one expf per row and head a tile), and the weights take a second
//     sweep of the tiles, bucketing each again; at E <= kTileEdges one
//     bucketing serves both.
//   * The weights: the row's warp, lanes over its edges, one expf and one
//     division per (edge, head). An edge that no row owns (masked, or its
//     receiver outside [0, n)) gets exactly 0 from the one block whose fixed
//     chunk of the stream holds it, as the buckets' loads meet it. Every
//     output element is written exactly once.
//   * No atomics add a value: the result is bitwise the same for any R and
//     from run to run.
//   * expf, not __expf; no fast math; f32 throughout.
//   * The launcher returns cudaGetLastError(); it allocates nothing (m and d
//     are the caller's scratch) and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "edge_buckets.cuh"

namespace {

using buckets::kThreads;
using buckets::kWarps;
constexpr int kU = 4;                 // edges whose loads are issued together
constexpr int kPerThread = 16;        // a thread's edges of a tile
constexpr int kPerThreadSmall = 4;    // ... of a tile of <= 1,024 edges
constexpr int kTileEdges = kPerThread * kThreads;   // bucketed at a time
constexpr int kHeadsAtOnce = 4;       // an edge's heads whose loads go together

struct Args {
  const float* logits;   // (e, h)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  float* m;              // (n, h) max, -inf when empty
  float* d;              // (n, h) denominator, 0 when empty
  float* out;            // (e, h) weights
  int n, e, h;
  int rows;              // destination rows one block owns
  int slices;            // S: slices of a row's segment
  int red;               // floats of a warp's exchange area
  // offsets in 4-byte words of the shared-memory regions
  int o_counts, o_start, o_order, o_list_e, o_list_r, o_m, o_d, o_red;
};

extern __shared__ __align__(16) int smem_i[];

// The zeros of the edges no row owns (masked, or a receiver outside
// [0, n)), written by the block whose fixed chunk [c0, c1) of the stream
// holds them, as the buckets' loads meet them.
struct Zeros {
  float* out;            // the tile's weights
  int h, c0, c1;         // chunk bounds relative to the tile
  __device__ __forceinline__ void load(int, int) {}
  __device__ __forceinline__ void store(int, int i, int owner, int) {
    if (owner < 0 && i >= c0 && i < c1) {
      for (int hh = 0; hh < h; ++hh) out[(size_t)i * h + hh] = 0.f;
    }
  }
};

// The tile's buckets for rows [row0, row0 + rows_here), each row's segment
// in stream order; with `zeros` the unowned edges of the block's chunk get
// their 0. Ends with a barrier.
__device__ __forceinline__ void bucket_tile(const Args& p, int base,
                                            int row0, int rows_here,
                                            bool zeros) {
  const buckets::Edges g = {p.rcv + base, p.mask + base, p.n,
                            min(kTileEdges, p.e - base)};
  const buckets::Buckets b = {smem_i + p.o_counts, smem_i + p.o_start,
                              smem_i + p.o_order, row0, row0 + rows_here};
  const int chunk = (p.e + gridDim.x - 1) / gridDim.x;
  const int c0 = zeros ? blockIdx.x * chunk - base : 0;
  Zeros x = {p.out + (size_t)base * p.h, p.h, c0, zeros ? c0 + chunk : 0};
  // a tile of at most 1,024 edges (the serving buckets) takes the form of
  // 4 edges a thread, with a quarter of the instructions
  if (g.e <= kThreads * kPerThreadSmall) {
    buckets::bucket_edges_stable<kPerThreadSmall>(
        g, b, smem_i + p.o_list_e, smem_i + p.o_list_r, x);
  } else {
    buckets::bucket_edges_stable<kPerThread>(g, b, smem_i + p.o_list_e,
                                             smem_i + p.o_list_r, x);
  }
}

// The max of the positions [lo, hi) of a row's segment at head hh.
__device__ __forceinline__ float slice_max(const float* lg, const int* order,
                                           int H, int hh, int lo, int hi) {
  float mx = -INFINITY;
  for (int j = lo; j < hi; j += kU) {
    const int cnt = min(kU, hi - j);
    float l[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      l[u] = __ldg(lg + ((size_t)order[u < cnt ? j + u : j] * H + hh));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) mx = fmaxf(mx, u < cnt ? l[u] : -INFINITY);
  }
  return mx;
}

// The sum of exp(l - m) over the positions [lo, hi) at head hh, in stream
// order; a -inf logit adds nothing.
__device__ __forceinline__ float slice_sum(const float* lg, const int* order,
                                           int H, int hh, int lo, int hi,
                                           float m) {
  float sum = 0.f;
  for (int j = lo; j < hi; j += kU) {
    const int cnt = min(kU, hi - j);
    float l[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      l[u] = __ldg(lg + ((size_t)order[u < cnt ? j + u : j] * H + hh));
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float pe = expf(__fsub_rn(l[u], m));
      sum = __fadd_rn(sum, u < cnt && l[u] != -INFINITY ? pe : 0.f);
    }
  }
  return sum;
}

// The running m and d of (row r, head hh) after a tile whose max is m_new
// and whose sum of exp(l - m_new) is dt: the earlier sum rescaled, then dt.
__device__ __forceinline__ void fold_stats(float* m_run, float* d_run, int i,
                                           float m_new, float dt) {
  const float m_old = m_run[i];
  const float corr = m_old == -INFINITY ? 0.f : expf(__fsub_rn(m_old, m_new));
  d_run[i] = __fadd_rn(__fmul_rn(d_run[i], corr), dt);
  m_run[i] = m_new;
}

// Row r's max and sum of exponentials over this tile, folded into the
// running m and d (a warp, every lane calls it). Lane q is slice q / H of
// head q % H. When H divides 32 the lanes of a head meet by shuffles (a
// butterfly: every lane of the head ends with the same, bitwise, max and
// sum, in an order fixed by H); otherwise through shared memory, the
// slices' sums added in slice order.
__device__ __forceinline__ void row_stats(const Args& p, int base, int r) {
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const int* row_start = smem_i + p.o_start;
  const int* order = smem_i + p.o_order;
  float* m_run = smem_f + p.o_m;
  float* d_run = smem_f + p.o_d;
  float* red = smem_f + p.o_red + (threadIdx.x >> 5) * 2 * p.red;
  float* red_m = red + p.red;
  const int lane = threadIdx.x & 31;
  const int H = p.h;
  const int S = p.slices;
  const int start = row_start[r];
  const int len = row_start[r + 1] - start;
  const float* lg = p.logits + (size_t)base * H;
  if (S * H == 32) {
    const int s = lane / H;
    const int hh = lane - s * H;
    const int lo = start + len * s / S;
    const int hi = start + len * (s + 1) / S;
    const float m_old = m_run[r * H + hh];
    float mt = slice_max(lg, order, H, hh, lo, hi);
    for (int off = 16; off >= H; off >>= 1) {
      mt = fmaxf(mt, __shfl_xor_sync(buckets::kFull, mt, off));
    }
    const float m_new = fmaxf(m_old, mt);
    float dt = slice_sum(lg, order, H, hh, lo, hi, m_new);
    for (int off = 16; off >= H; off >>= 1) {
      dt = __fadd_rn(dt, __shfl_xor_sync(buckets::kFull, dt, off));
    }
    // every lane read m_old before the shuffles
    if (s == 0) fold_stats(m_run, d_run, r * H + hh, m_new, dt);
    return;
  }
  // 1. each lane's (slice, head): the slice's max
  for (int q = lane; q < S * H; q += 32) {
    const int s = q / H;
    const int hh = q - s * H;
    red[q] = slice_max(lg, order, H, hh, start + len * s / S,
                       start + len * (s + 1) / S);
  }
  __syncwarp();
  // 2. the row's max per head, the running max moved to it
  for (int hh = lane; hh < H; hh += 32) {
    float mt = -INFINITY;
    for (int s = 0; s < S; ++s) mt = fmaxf(mt, red[s * H + hh]);
    red_m[hh] = fmaxf(m_run[r * H + hh], mt);
  }
  __syncwarp();
  // 3. each slice's sum of exp(l - m), in stream order
  for (int q = lane; q < S * H; q += 32) {
    const int s = q / H;
    const int hh = q - s * H;
    red[q] = slice_sum(lg, order, H, hh, start + len * s / S,
                       start + len * (s + 1) / S, red_m[hh]);
  }
  __syncwarp();
  // 4. the slices added in slice order, after the earlier tiles' rescaled sum
  for (int hh = lane; hh < H; hh += 32) {
    float dt = red[hh];
    for (int s = 1; s < S; ++s) dt = __fadd_rn(dt, red[s * H + hh]);
    fold_stats(m_run, d_run, r * H + hh, red_m[hh], dt);
  }
  __syncwarp();   // red is rewritten by the warp's next row
}

// Row r's weights over this tile (a warp, lanes over its edges).
__device__ __forceinline__ void row_weights(const Args& p, int base, int r) {
  const float* smem_f = reinterpret_cast<const float*>(smem_i);
  const int* row_start = smem_i + p.o_start;
  const int* order = smem_i + p.o_order;
  const float* m_run = smem_f + p.o_m + r * p.h;
  const float* d_run = smem_f + p.o_d + r * p.h;
  const int start = row_start[r];
  const int len = row_start[r + 1] - start;
  for (int q = threadIdx.x & 31; q < len; q += 32) {
    const size_t e0 = ((size_t)base + order[start + q]) * p.h;
    for (int h0 = 0; h0 < p.h; h0 += kHeadsAtOnce) {
      float l[kHeadsAtOnce];
#pragma unroll
      for (int u = 0; u < kHeadsAtOnce; ++u) {
        l[u] = h0 + u < p.h ? __ldg(p.logits + e0 + h0 + u) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kHeadsAtOnce; ++u) {
        const int hh = h0 + u;
        if (hh < p.h) {
          const float den = d_run[hh];
          p.out[e0 + hh] = den > 0.f ? expf(__fsub_rn(l[u], m_run[hh])) /
                                           fmaxf(den, 1e-16f)
                                     : 0.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    seg_softmax_kernel(const __grid_constant__ Args p) {
  float* smem_f = reinterpret_cast<float*>(smem_i);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = max(0, min(p.rows, p.n - row0));

  for (int i = tid; i < rows_here * p.h; i += kThreads) {
    smem_f[p.o_m + i] = -INFINITY;
    smem_f[p.o_d + i] = 0.f;
  }

  // the statistics, tile by tile (and the unowned edges' zeros)
  for (int base = 0; base < p.e; base += kTileEdges) {
    bucket_tile(p, base, row0, rows_here, true);
    for (int r = warp; r < rows_here; r += kWarps) row_stats(p, base, r);
    __syncthreads();
  }
  // the weights; one tile's buckets are still in place
  const bool one_tile = p.e <= kTileEdges;
  for (int base = 0; base < p.e; base += kTileEdges) {
    if (!one_tile) bucket_tile(p, base, row0, rows_here, false);
    for (int r = warp; r < rows_here; r += kWarps) row_weights(p, base, r);
    __syncthreads();
  }

  const size_t out0 = (size_t)row0 * p.h;
  for (int i = tid; i < rows_here * p.h; i += kThreads) {
    p.m[out0 + i] = smem_f[p.o_m + i];
    p.d[out0 + i] = smem_f[p.o_d + i];
  }
}

// Fills the launch's layout for `rows` rows a block; returns the dynamic
// shared memory it needs, in bytes.
size_t layout(Args& p, int rows) {
  p.rows = rows;
  p.slices = std::max(1, 32 / p.h);
  p.red = std::max(32, p.h);
  size_t words = 0;
  auto take = [&](size_t n) {
    const int at = static_cast<int>(words);
    words += (n + 3) / 4 * 4;   // 16-byte aligned
    return at;
  };
  const size_t rh = static_cast<size_t>(rows) * p.h;
  p.o_counts = take(rows);
  p.o_start = take(rows + 1);
  const size_t t = std::max(1, std::min(kTileEdges, p.e));
  p.o_order = take(t);
  p.o_list_e = take(t);
  p.o_list_r = take(t);
  p.o_m = take(rh);
  p.o_d = take(rh);
  p.o_red = take(static_cast<size_t>(kWarps) * 2 * p.red);
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

}  // namespace

// Softmax weights of logits (e, h) f32 per destination over the unmasked
// edges into out (e, h), with m and d (n, h) f32 the caller's scratch (the
// statistics come back in them). One launch on `stream`. rows <= 0 lets the
// kernel choose the rows a block owns. Returns cudaGetLastError() after the
// launch (0 on success).
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
  if (h <= 0 || n < 0 || e < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 && e == 0) return 0;
  const size_t smem = layout(p, rows > 0 ? rows : default_rows(p));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        seg_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // n == 0: one block writes the zeros
  const int blocks = std::max(1, (n + p.rows - 1) / p.rows);
  seg_softmax_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
