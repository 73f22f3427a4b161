// The staged split-k dense tile on Hopper (sm_90a), shared by layer_fused.cu
// and the NT kernels (nt_tile.cuh): dense layers whose weights are staged in
// shared memory by bulk copies while the block does other work, computed
// from there with every thread busy.
//
// A block's dense layers
//
//   dst = act(src @ w + b)      src (rows_here, k_dim) f32 in shared memory,
//                               w (k_dim, n_dim), b (n_dim,) of type W
//
// for one layer or two chained (the first writing the hidden rows that the
// second reads). W, the stored weight type, is float, __nv_bfloat16 or
// __half: it is staged as stored and widened to f32 where it is loaded, so
// every product and sum is an fp32 FMA or add (no TF32, no tensor cores).
//
// Design:
//   * Weights on chip. Each layer's weight is cut into chunks of whole k
//     rows (each chunk starting on a multiple of 4 S rows, S below), or is
//     one chunk, as the caller's plan says; the chunks stream through a ring
//     of shared-memory slots, one mbarrier a slot. At entry the block issues
//     as many chunks as there are slots, and the biases; the dense layers
//     wait on each chunk's barrier and consume it as it lands. A chunk whose
//     source is on a 16-byte boundary with a size a multiple of 16 bytes is
//     one cp.async.bulk by thread 0 (completing on the barrier's transaction
//     count); one on 4 bytes is copied 4 bytes a thread by cp.async, tracked
//     by the same barrier; any other (16-bit weights off 4 bytes) by plain
//     loads and stores. Every barrier counts exactly one arrival a piece.
//     When every chunk has a slot nothing is refilled; otherwise a slot is
//     refilled with the chunk `slots` ahead as soon as the block is done
//     with it (after a __syncthreads and fence.proxy.async).
//   * Split-k dense layers, every thread busy. Thread t of a dense layer
//     with n_dim columns takes column j = t % n_dim and slice ks = t / n_dim
//     of S = min(256 / n_dim, k quads) slices (at least 1): the k quads
//     (4 consecutive k) q = ks, ks + S, ks + 2S, ..., summed in k order as
//     fp32 FMAs from shared memory (src as one 16-byte load a quad and row).
//     The slices' partial sums meet in shared memory and are added in the
//     order ks = 0, 1, ..., S - 1, then the bias, then the relu. S and the
//     slices depend only on k_dim and n_dim, never on the rows a block holds,
//     the ring or the grid, so an output's arithmetic is the same for any
//     rows per block and from run to run. No integer division runs per
//     chunk: each is a long chain of dependent instructions.
//   * No work on padding rows. A thread takes a group of 8 rows at once
//     (each weight load shared by the group's FMAs) and the block's last
//     rows in groups of 4, 2 and 1.
//   * A dense layer names its shared-memory input by offset, so that its
//     loads compile as shared-memory loads (a pointer chosen at run time
//     compiled to generic loads and cost layer_fused's scalers form ~1.6x).
//
// The caller lays out the block's dynamic shared memory (`smem`, in 4-byte
// words) and fills a Tile: the weights, the ring, the offsets of the
// biases, the partial sums and the barriers (slots + 2 of them: one a slot,
// one a bias).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

// The block's dynamic shared memory, in 4-byte words; every region is named
// by its offset.
extern __shared__ __align__(128) float smem[];

namespace dense {
namespace {   // each source that includes this gets its own copy

using hopper::mbar_wait;
using hopper::widen;

constexpr int kThreads = 256;
constexpr int kChunkBytes = 32 * 1024;

struct Tile {
  const void* w1;        // (d_in, d_ff) of W
  const void* b1;        // (d_ff,)
  const void* w2;        // (d_ff, d_out) or null: one layer
  const void* b2;        // (d_out,) or null
  int d_in, d_ff, d_out;
  int rows;              // rows one block owns (the partial sums' stride)
  // the weight ring: `slots` slots of slot_floats 4-byte words; per dense
  // layer its k rows a chunk, its chunks and its split-k slices
  int slots, slot_floats;
  int kc[2], chunks[2], split[2];
  // offsets (in floats) of the biases, the partial sums and the barriers
  int o_b1, o_b2, o_part, o_bar;
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// --- staging the weights

// `count` values of W from device memory at `src` into shared memory at
// `dst`, completing on `bar` with one arrival; every thread calls it (the
// cp.async and plain paths need them all)
template <typename W>
__device__ __forceinline__ void stage(float* dst, const W* src, int count,
                                      uint64_t* bar, int tid) {
  constexpr int kPer16 = 16 / sizeof(W);
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  const bool bulk = (at & 15) == 0 && (count & (kPer16 - 1)) == 0;
  bool words = true;   // 4-byte copies (always, for float)
  if constexpr (sizeof(W) != 4) words = (at & 3) == 0 && (count & 1) == 0;
  if (bulk) {
    if (tid == 0) {
      hopper::fence_proxy_async();   // after generic reads of the slot
      hopper::mbar_expect_tx(bar, count * sizeof(W));
      hopper::bulk_load(dst, src, count * sizeof(W), bar);
    }
  } else {
    if (words) {
      const float* s = reinterpret_cast<const float*>(src);
      for (int i = tid; i < count * (int)sizeof(W) / 4; i += kThreads) {
        hopper::cp_async4(dst + i, s + i);
      }
      hopper::cp_async_arrive(bar);   // each thread's copies, counted
    } else {
      W* d = reinterpret_cast<W*>(dst);
      for (int i = tid; i < count; i += kThreads) d[i] = src[i];
    }
    __syncthreads();                // before the one real arrival
    if (tid == 0) hopper::mbar_arrive(bar);
  }
}

// chunk c of the weight stream (layer 0's chunks, then layer 1's) into
// `slot`; every thread calls it
template <typename W = float>
__device__ __forceinline__ void issue_chunk(const Tile& p, int c, int slot,
                                            int tid) {
  const int layer = c < p.chunks[0] ? 0 : 1;
  const int ci = layer ? c - p.chunks[0] : c;
  const int k_dim = layer ? p.d_ff : p.d_in;
  const int n_dim = layer ? p.d_out : p.d_ff;
  const W* w = static_cast<const W*>(layer ? p.w2 : p.w1);
  const int k0 = ci * p.kc[layer];
  const int rows = min(p.kc[layer], k_dim - k0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  stage(smem + slot * p.slot_floats, w + (size_t)k0 * n_dim, rows * n_dim,
        &bars[slot], tid);
}

// the first `slots` chunks and the biases (barriers slots, slots + 1)
template <typename W = float>
__device__ __forceinline__ void issue_first(const Tile& p, int tid) {
  const int total = p.chunks[0] + p.chunks[1];
  for (int c = 0; c < min(p.slots, total); ++c) issue_chunk<W>(p, c, c, tid);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  stage(smem + p.o_b1, static_cast<const W*>(p.b1), p.d_ff, &bars[p.slots],
        tid);
  if (p.w2 != nullptr) {
    stage(smem + p.o_b2, static_cast<const W*>(p.b2), p.d_out,
          &bars[p.slots + 1], tid);
  }
}

// --- the dense layers

// Partial sums of slice ks for the T rows at src_off (row stride
// src_stride) and column j: the k quads q = ks, ks + S, ... that lie in the
// chunk [k0, k1), in order, added to part[t * n_dim] (or from 0 at the
// layer's first chunk). w is the chunk: k rows k0.. of n_dim values; k0 is a
// multiple of 4 S. The short quad past k_dim's last multiple of 4 (slice
// short_ks) comes last, in the layer's last chunk. kUnroll > 1 unrolls the
// quads' loop that many times, so that their loads are issued ahead of the
// FMA chain (more registers; the sums are the same).
template <int T, int kUnroll = 1, typename W = float>
__device__ __forceinline__ void fma_rows(int src_off, int src_stride,
                                         const W* w, int n_dim, int j,
                                         int ks, int S, int k0, int k1,
                                         int k_dim, int short_ks, float* part,
                                         bool first) {
  float a[T];
#pragma unroll
  for (int t = 0; t < T; ++t) a[t] = first ? 0.f : part[t * n_dim];
  const int qe = min(k1, k_dim & ~3) >> 2;   // past the chunk's whole quads
  const auto quad = [&](int q) {
    const int k = 4 * q;
    const W* wk = w + (k - k0) * n_dim + j;
    const float w0 = widen(wk[0]);
    const float w1 = widen(wk[n_dim]);
    const float w2 = widen(wk[2 * n_dim]);
    const float w3 = widen(wk[3 * n_dim]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float4 z = *reinterpret_cast<const float4*>(
          smem + src_off + t * src_stride + k);
      a[t] = fmaf(z.x, w0, a[t]);
      a[t] = fmaf(z.y, w1, a[t]);
      a[t] = fmaf(z.z, w2, a[t]);
      a[t] = fmaf(z.w, w3, a[t]);
    }
  };
  if constexpr (kUnroll > 1) {
#pragma unroll kUnroll
    for (int q = (k0 >> 2) + ks; q < qe; q += S) quad(q);
  } else {
    for (int q = (k0 >> 2) + ks; q < qe; q += S) quad(q);
  }
  if (k1 == k_dim && (k_dim & 3) && ks == short_ks) {   // the short quad
    for (int k = k_dim & ~3; k < k_dim; ++k) {
      const float wv = widen(w[(k - k0) * n_dim + j]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        a[t] = fmaf(smem[src_off + t * src_stride + k], wv, a[t]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) part[t * n_dim] = a[t];
}

// The partial sums of one dense layer for the block's rows_here rows: src
// at src_off (row stride src_stride, k_dim wide), w the weight stream's
// chunks of this layer, each slice's sums at o_part (slice ks of row r at
// (ks rows + r) n_dim). Thread t < S n_dim takes column t % n_dim and slice
// t / n_dim for every group of 8 rows, and the last rows in groups of 4, 2
// and 1 (fma_rows, kUnroll passed on). No integer division in the loops:
// the slot and phase of the ring advance by one a chunk. Returns after the
// layer's bias has landed and a __syncthreads.
template <typename W = float, int kUnroll = 1>
__device__ __forceinline__ void fold_chunks(const Tile& p, int layer,
                                            int src_off, int src_stride,
                                            int rows_here, int tid) {
  const int k_dim = layer ? p.d_ff : p.d_in;
  const int n_dim = layer ? p.d_out : p.d_ff;
  const int S = p.split[layer];
  const int kc = p.kc[layer];
  const int first_chunk = layer ? p.chunks[0] : 0;
  const int total = p.chunks[0] + p.chunks[1];
  const int per_row = S * n_dim;
  const int short_ks = (k_dim >> 2) % S;
  const int ks0 = tid / n_dim;                 // the thread's first (j, ks)
  const int j0 = tid - ks0 * n_dim;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  int slot = first_chunk % p.slots;
  uint32_t phase = (first_chunk / p.slots) & 1;
  for (int ci = 0; ci < p.chunks[layer]; ++ci) {
    const int c = first_chunk + ci;
    mbar_wait(&bars[slot], phase);
    const int k0 = ci * kc;
    const int k1 = min(k0 + kc, k_dim);
    const W* w = reinterpret_cast<const W*>(smem + slot * p.slot_floats);
    int ks = ks0;
    int j = j0;
    for (int t = tid; t < per_row; t += kThreads) {
      // groups of 8 rows, then the last rows as 4 + 2 + 1
      for (int r0 = 0; r0 < rows_here;) {
        const int left = rows_here - r0;
        const int in = src_off + r0 * src_stride;
        float* part =
            smem + p.o_part + ((size_t)ks * p.rows + r0) * n_dim + j;
        const bool first = ci == 0;
        if (left >= 8) {
          fma_rows<8, kUnroll>(in, src_stride, w, n_dim, j, ks, S, k0,
                                k1, k_dim, short_ks, part, first);
          r0 += 8;
        } else if (left >= 4) {
          fma_rows<4, kUnroll>(in, src_stride, w, n_dim, j, ks, S, k0,
                                k1, k_dim, short_ks, part, first);
          r0 += 4;
        } else if (left >= 2) {
          fma_rows<2, kUnroll>(in, src_stride, w, n_dim, j, ks, S, k0,
                                k1, k_dim, short_ks, part, first);
          r0 += 2;
        } else {
          fma_rows<1, kUnroll>(in, src_stride, w, n_dim, j, ks, S, k0,
                                k1, k_dim, short_ks, part, first);
          r0 += 1;
        }
      }
      if (t + kThreads < per_row) {   // the next t (n_dim > kThreads)
        for (j += kThreads; j >= n_dim; j -= n_dim) ++ks;
      }
    }
    if (c + p.slots < total) {   // the block is done with this slot
      __syncthreads();
      issue_chunk<W>(p, c + p.slots, slot, tid);
    }
    if (++slot == p.slots) {
      slot = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&bars[p.slots + layer], 0);   // the bias
  __syncthreads();
}

// One output of a dense layer: slice ks = 0, 1, ... of row r's partial
// sums in order, then the bias, then the relu; to shared memory at dst_off
// (row stride dst_stride) or, with `global` set, to out's row row0 + r
// (rounded to O).
template <typename W, typename O>
__device__ __forceinline__ void finish(const Tile& p, int n_dim, int S,
                                       const W* bias, int dst_off,
                                       int dst_stride, bool global, O* out,
                                       int row0, bool relu, int r, int j) {
  const float* part = smem + p.o_part + (size_t)r * n_dim + j;
  float h = part[0];
  for (int ks = 1; ks < S; ++ks) {
    h = __fadd_rn(h, part[(size_t)ks * p.rows * n_dim]);
  }
  h = __fadd_rn(h, widen(bias[j]));
  if (relu) h = fmaxf(h, 0.f);
  if (global) {
    out[(size_t)(row0 + r) * n_dim + j] = hopper::narrow<O>(h);
  } else {
    smem[dst_off + r * dst_stride + j] = h;
  }
}

// dst = act(src @ w + b) for the block's rows_here rows (fold_chunks, then
// each output finished): src at src_off (row stride src_stride), b at
// bias_off; dst in shared memory at dst_off (row stride dst_stride) or, with
// `global` set, out's rows from row0. The outputs are finished a row at a
// time, a thread a column (layer_fused's form).
template <typename W = float, typename O>
__device__ __forceinline__ void dense_layer(const Tile& p, int layer,
                                            int src_off, int src_stride,
                                            int bias_off, int dst_off,
                                            int dst_stride, bool global,
                                            O* out, int row0, int rows_here,
                                            bool relu, int tid) {
  fold_chunks<W>(p, layer, src_off, src_stride, rows_here, tid);
  const int n_dim = layer ? p.d_out : p.d_ff;
  const W* bias = reinterpret_cast<const W*>(smem + bias_off);
  for (int r = 0; r < rows_here; ++r) {
    for (int j = tid; j < n_dim; j += kThreads) {
      finish(p, n_dim, p.split[layer], bias, dst_off, dst_stride, global,
             out, row0, relu, r, j);
    }
  }
}

// dense_layer with the quads' loop unrolled kUnroll times (fma_rows) and
// its outputs spread over every thread: output (r, j) to thread (r n_dim +
// j) % kThreads, so that a thread finishes a few outputs of several rows
// instead of one a row (the NT tile's form: PERF.md has what each took off
// nt_mlp). The sums are dense_layer's.
template <typename W, int kUnroll, typename O>
__device__ __forceinline__ void dense_layer_spread(
    const Tile& p, int layer, int src_off, int src_stride, int bias_off,
    int dst_off, int dst_stride, bool global, O* out, int row0,
    int rows_here, bool relu, int tid) {
  fold_chunks<W, kUnroll>(p, layer, src_off, src_stride, rows_here, tid);
  const int n_dim = layer ? p.d_out : p.d_ff;
  const int S = p.split[layer];
  const W* bias = reinterpret_cast<const W*>(smem + bias_off);
  const int dr = kThreads / n_dim;
  const int dj = kThreads - dr * n_dim;
  int r = tid / n_dim;
  int j = tid - r * n_dim;
  while (r < rows_here) {
    finish(p, n_dim, S, bias, dst_off, dst_stride, global, out, row0, relu,
           r, j);
    r += dr;
    j += dj;
    if (j >= n_dim) {
      j -= n_dim;
      ++r;
    }
  }
}

// --- the host's plan

// split-k slices of a dense layer: every thread a (column, slice), at most
// one slice per quad of k; a function of k_dim and n_dim alone
inline int split_of(int k_dim, int n_dim) {
  const int s = kThreads / n_dim;
  const int quads = (k_dim + 3) / 4;
  return s < 1 ? 1 : (s < quads ? s : quads);
}

// k rows a chunk of values of `elem` bytes: a multiple of 4 S (every slice
// starts a chunk on its own quad), at most chunk_bytes where that allows one
// such step
inline int chunk_rows(int k_dim, int n_dim, int split, int elem,
                      int chunk_bytes) {
  const int step = 4 * split;
  int kc = chunk_bytes / (elem * n_dim) / step * step;
  if (kc < step) kc = step;
  return kc < k_dim ? kc : k_dim;   // one chunk holds a short layer whole
}

// The chunks of each layer's weight (values of `elem` bytes; p.split set):
// each layer whole (`whole`) or k rows of at most chunk_bytes. Sets kc,
// chunks and slot_floats (a multiple of 32 words); returns the chunks of
// both layers.
inline int chunking(Tile& p, bool whole, int elem, int chunk_bytes) {
  const bool two = p.w2 != nullptr;
  p.kc[0] = whole ? p.d_in
                  : chunk_rows(p.d_in, p.d_ff, p.split[0], elem, chunk_bytes);
  p.kc[1] = !two ? 4 : whole ? p.d_ff : chunk_rows(p.d_ff, p.d_out,
                                                   p.split[1], elem,
                                                   chunk_bytes);
  p.chunks[0] = (p.d_in + p.kc[0] - 1) / p.kc[0];
  p.chunks[1] = two ? (p.d_ff + p.kc[1] - 1) / p.kc[1] : 0;
  const int f0 = p.kc[0] * p.d_ff;
  const int f1 = two ? p.kc[1] * p.d_out : 0;
  p.slot_floats = round_up(((f0 > f1 ? f0 : f1) * elem + 3) / 4, 32);
  return p.chunks[0] + p.chunks[1];
}

}  // namespace
}  // namespace dense
