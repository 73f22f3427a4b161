// The NT tile: a node tile's two-layer MLP with its hidden tile on chip,
// shared by nt_mlp.cu and fused_nt_scatter.cu, on dense_tile.cuh's staged
// split-k dense layers.
//
// Block b owns the node rows [b*R, b*R + R) and computes, in float32,
//
//   h = relu(x_tile @ w1 + b1)        (R, d_ff), in shared memory
//   y = h @ w2 + b2                   (R, d_out), to device memory in O
//
// x, the weights and the biases are all of one type T (float,
// __nv_bfloat16 or __half), widened to f32 where they are loaded; y is
// written in O (T for nt_mlp, rounded to nearest even; float for
// fused_nt_scatter's scratch).
//
// At entry the block issues the copies of both weights (each layer whole in
// a slot of its own where they fit, as GIN's 160 KB and the standard
// point's 64 KB do; else 32 KB chunks through a ring) and of both biases,
// then stages its x rows as f32 (one bulk copy where they are f32 rows of a
// multiple of 4 values on 16 bytes, else loads widened by every thread).
// The first dense layer starts when w1 has landed, while w2 still lands; h
// never leaves shared memory; the second layer writes y. Each layer's
// quads are unrolled four deep and its outputs finished by every thread
// (dense_layer_spread). The
// split-k slices depend on the layer's widths alone, so the result is
// bitwise the same for any rows per block and from run to run; no work is
// done on padding rows.
//
// Each block issues griddepcontrol.launch_dependents as it starts: a grid
// queued behind it with programmatic stream serialization (fused_nt_scatter's
// edge phase) may start its set-up at once, and waits for this grid before
// it reads y.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dense_tile.cuh"
#include "hopper.cuh"

namespace nt {
namespace {   // each source that includes this gets its own kernels

using dense::dense_layer_spread;
using dense::issue_first;
using dense::kThreads;
using dense::round_up;
using hopper::mbar_init;
using hopper::mbar_wait;

// the dense layers' quads unrolled together (dense_tile.cuh's kUnroll): 4
// took ~0.45 us off the buckets' 1-row blocks and ~0.6 off N=1024 (PERF.md)
constexpr int kQuadsAhead = 4;

// the operands' type, as the wrappers pass it
enum Dtype { kF32 = 0, kBf16 = 1, kF16 = 2 };

struct Mlp : dense::Tile {
  const void* x;         // (n, d_in) of T
  void* y;               // (n, d_out) of O
  int n;
  int xs, hs;            // row strides (floats) of x's and h's tiles
  int o_x, o_h;          // their offsets (floats)
};

// The block's x rows go to shared memory as f32 at o_x (row stride xs),
// completing on the barrier after the biases' (slots + 2). Where they are
// f32 rows of a multiple of 4 values on 16 bytes, by one bulk copy, issued
// here; returns whether it was.
template <typename T>
__device__ __forceinline__ bool x_by_bulk(const Mlp& p, int row0,
                                          int rows_here, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    const float* x0 = static_cast<const float*>(p.x) + (size_t)row0 * p.d_in;
    if (p.xs == p.d_in && (reinterpret_cast<uintptr_t>(x0) & 15) == 0) {
      uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
      dense::stage(smem + p.o_x, x0, rows_here * p.d_in, &bars[p.slots + 2],
                   tid);
      return true;
    }
  }
  return false;
}

// ... else by loads widened by every thread: read-only loads (__ldg), four
// in flight a thread before their stores
template <typename T>
__device__ __forceinline__ void stage_x(const Mlp& p, int row0, int rows_here,
                                        int tid) {
  constexpr int kU = 4;
  const T* x0 = static_cast<const T*>(p.x) + (size_t)row0 * p.d_in;
  const int count = rows_here * p.d_in;
  for (int i0 = tid; i0 < count; i0 += kU * kThreads) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      v[u] = i < count ? hopper::widen(__ldg(x0 + i)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < count) {
        const int r = i / p.d_in;
        smem[p.o_x + r * p.xs + (i - r * p.d_in)] = v[u];
      }
    }
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_arrive(reinterpret_cast<uint64_t*>(smem + p.o_bar) +
                        p.slots + 2);
  }
}

template <typename T, typename O>
__global__ void __launch_bounds__(kThreads, 1)
    mlp_tile_kernel(const __grid_constant__ Mlp p) {
  hopper::launch_dependents();
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + p.o_bar);
  if (tid == 0) {
    for (int s = 0; s < p.slots + 3; ++s) mbar_init(&bars[s], 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // x first where one bulk copy takes it, then the weights; x by loads
  // while the weights land where not
  const bool x_bulk = x_by_bulk<T>(p, row0, rows_here, tid);
  issue_first<T>(p, tid);   // land while x is staged
  if (!x_bulk) stage_x<T>(p, row0, rows_here, tid);
  mbar_wait(&bars[p.slots + 2], 0);   // x's rows
  O* y = static_cast<O*>(p.y);
  dense_layer_spread<T, kQuadsAhead>(p, 0, p.o_x, p.xs, p.o_b1, p.o_h,
                                     p.hs, false, y, row0, rows_here, true,
                                     tid);
  __syncthreads();
  dense_layer_spread<T, kQuadsAhead>(p, 1, p.o_h, p.hs, p.o_b2, 0, 0, true,
                                     y, row0, rows_here, false, tid);
}

// Lay out a block of `rows` rows with `slots` ring slots; returns its bytes.
// Every region starts on 16 bytes (the slots on 128).
size_t layout(Mlp& p, int rows, int slots) {
  p.rows = rows;
  p.slots = slots;
  int o = slots * p.slot_floats;
  p.o_b1 = o;
  o += round_up(p.d_ff, 4);
  p.o_b2 = o;
  o += round_up(p.d_out, 4);
  p.o_x = o;
  o += rows * p.xs;
  p.o_h = o;
  o += rows * p.hs;
  p.o_part = o;
  const int part0 = p.split[0] * p.d_ff;
  const int part1 = p.split[1] * p.d_out;
  o += round_up(rows * (part0 > part1 ? part0 : part1), 4);
  p.o_bar = o;
  o += 2 * (slots + 3);
  return static_cast<size_t>(o) * sizeof(float);
}

// The rows a block owns (`rows` if > 0, else one block per SM where the
// rows allow it) and the weights' staging: each layer's weight whole in a
// slot of its own where both fit beside the rows (GIN's 160 KB; every
// chunk costs ~0.4 us of its own, PERF.md), else chunks of at most
// dense::kChunkBytes through as many slots as fit (at least two; rows are
// halved until they do, and one block row takes one slot if it must).
// Returns the block's bytes, or 0 if even that does not fit.
size_t plan(Mlp& p, int rows, int elem) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  p.xs = round_up(p.d_in, 4);
  p.hs = round_up(p.d_ff, 4);
  p.split[0] = dense::split_of(p.d_in, p.d_ff);
  p.split[1] = dense::split_of(p.d_ff, p.d_out);
  if (rows <= 0) rows = (p.n + sms - 1) / sms;
  int total = dense::chunking(p, true, elem, dense::kChunkBytes);
  const size_t whole = layout(p, rows, total);
  if (whole <= static_cast<size_t>(max_smem)) return whole;
  total = dense::chunking(p, false, elem, dense::kChunkBytes);
  for (;;) {
    const size_t fixed = layout(p, rows, 0);
    const size_t room = fixed < (size_t)max_smem ? max_smem - fixed : 0;
    const size_t per_slot = 4 * (size_t)p.slot_floats + 8;
    int slots = static_cast<int>(room / per_slot);
    if (slots > total) slots = total;
    if (slots >= 2 || (rows == 1 && slots >= 1)) {
      return layout(p, rows, slots);
    }
    if (rows == 1) return 0;
    rows = (rows + 1) / 2;
  }
}

// One launch of the tile kernel over all n rows on `stream`, x and the
// weights of type T, y of type O. rows <= 0 lets the plan choose. Returns
// the CUDA error (0 on success); allocates nothing and does not
// synchronise.
template <typename T, typename O>
int launch_mlp(Mlp p, int rows, cudaStream_t stream) {
  if (p.d_in <= 0 || p.d_ff <= 0 || p.d_out <= 0 || p.w2 == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.n <= 0) return 0;
  const size_t smem = plan(p, rows, sizeof(T));
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_tile_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.n + p.rows - 1) / p.rows;
  mlp_tile_kernel<T, O><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The operands of one MLP in a Mlp (y and its type are the caller's).
Mlp make_mlp(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* y, int n, int d_in, int d_ff, int d_out) {
  Mlp m = {};
  m.x = x;
  m.w1 = w1;
  m.b1 = b1;
  m.w2 = w2;
  m.b2 = b2;
  m.y = y;
  m.n = n;
  m.d_in = d_in;
  m.d_ff = d_ff;
  m.d_out = d_out;
  return m;
}

}  // namespace
}  // namespace nt
