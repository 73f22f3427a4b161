// The NT tile: a node tile's two-layer MLP with its hidden tile on chip,
// shared by nt_mlp.cu and fused_nt_scatter.cu.
//
// Block b owns the node rows [b*R, b*R + R) and computes, in float32,
//
//   h = relu(x_tile @ w1 + b1)        (R, d_ff), in shared memory
//   y = h @ w2 + b2                   (R, d_out), to device memory
//
// x's tile is staged in shared memory first; h never leaves it. Rows past
// the block's last real row are zeros in x's tile, and whatever they give
// is never written out.
//
// Each output is a serial FMA chain over k = 0 .. d_in - 1 in that order,
// then the bias added (__fadd_rn), then the relu: plain fp32 on the FMA
// units, no TF32 and no tensor cores. An output's arithmetic does not depend
// on R, on the row group below or on the run, so the result is bitwise the
// same for any rows per block and from run to run.
//
// Threads cover rows x columns: an item is one column j of a group of TM
// rows, whose TM sums share each load of w[k][j]; neighbouring threads take
// neighbouring columns, so the loads of w coalesce and the x (or h) value
// of a row is one shared-memory broadcast. TM is the widest of 8, 4, 2, 1
// that still gives every thread an item, so the block is not left mostly
// idle when a layer is narrow.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nt {
namespace {   // each source that includes this gets its own kernel

constexpr int kThreads = 256;

struct Mlp {
  const float* x;       // (n, d_in)
  const float* w1;      // (d_in, d_ff)
  const float* b1;      // (d_ff,)
  const float* w2;      // (d_ff, d_out)
  const float* b2;      // (d_out,)
  float* y;             // (n, d_out)
  int n, d_in, d_ff, d_out;
  int rows;             // node rows one block owns
};

// Rows of the shared tiles for R rows a block: R rounded up so that every
// row group of the chosen TM (<= the result) lies inside them.
__host__ __device__ int padded_rows(int rows) {
  if (rows <= 4) return rows <= 1 ? 1 : rows <= 2 ? 2 : 4;
  return (rows + 7) / 8 * 8;
}

size_t smem_bytes(const Mlp& p, int rows) {
  return (size_t)padded_rows(rows) * (p.d_in + p.d_ff) * sizeof(float);
}

// out(r, j) for r < ceil(rows_here / TM) * TM, j < d_out, from the (padded)
// shared rows `in` of width d_in; `sink(r, j, v)` stores one output.
template <int TM, typename Sink>
__device__ __forceinline__ void dense_tm(const float* in, int rows_here,
                                         int d_in,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         int d_out, bool relu, Sink sink) {
  const int groups = (rows_here + TM - 1) / TM;
  for (int item = threadIdx.x; item < groups * d_out; item += kThreads) {
    const int j = item % d_out;
    const int g = item / d_out;
    const float* a = in + (size_t)g * TM * d_in;
    float acc[TM];
#pragma unroll
    for (int t = 0; t < TM; ++t) acc[t] = 0.f;
    for (int k = 0; k < d_in; ++k) {
      const float wv = __ldg(w + (size_t)k * d_out + j);
#pragma unroll
      for (int t = 0; t < TM; ++t) acc[t] = fmaf(a[t * d_in + k], wv, acc[t]);
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      float v = __fadd_rn(acc[t], bj);
      if (relu) v = fmaxf(v, 0.f);
      sink(g * TM + t, j, v);
    }
  }
}

template <typename Sink>
__device__ __forceinline__ void dense(const float* in, int rows_here,
                                      int rows_pad, int d_in, const float* w,
                                      const float* b, int d_out, bool relu,
                                      Sink sink) {
  auto items = [&](int tm) { return (rows_here + tm - 1) / tm * d_out; };
  if (rows_pad >= 8 && items(8) >= kThreads) {
    dense_tm<8>(in, rows_here, d_in, w, b, d_out, relu, sink);
  } else if (rows_pad >= 4 && items(4) >= kThreads) {
    dense_tm<4>(in, rows_here, d_in, w, b, d_out, relu, sink);
  } else if (rows_pad >= 2 && items(2) >= kThreads) {
    dense_tm<2>(in, rows_here, d_in, w, b, d_out, relu, sink);
  } else {
    dense_tm<1>(in, rows_here, d_in, w, b, d_out, relu, sink);
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_tile_kernel(const __grid_constant__ Mlp p) {
  extern __shared__ float smem[];
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rows_pad = padded_rows(p.rows);
  float* xs = smem;                                   // (rows_pad, d_in)
  float* hs = xs + (size_t)rows_pad * p.d_in;         // (rows_pad, d_ff)

  const float* x0 = p.x + (size_t)row0 * p.d_in;
  for (int i = threadIdx.x; i < rows_pad * p.d_in; i += kThreads) {
    xs[i] = i < rows_here * p.d_in ? x0[i] : 0.f;
  }
  __syncthreads();
  const int d_ff = p.d_ff;
  dense(xs, rows_here, rows_pad, p.d_in, p.w1, p.b1, d_ff, true,
        [&](int r, int j, float v) { hs[r * d_ff + j] = v; });
  __syncthreads();
  float* y0 = p.y + (size_t)row0 * p.d_out;
  const int d_out = p.d_out;
  dense(hs, rows_here, rows_pad, d_ff, p.w2, p.b2, d_out, false,
        [&](int r, int j, float v) {
          if (r < rows_here) y0[(size_t)r * d_out + j] = v;
        });
}

// One launch of the tile kernel over all n rows on `stream`. rows <= 0
// takes one block per SM where the rows allow it, fewer rows per block
// while the tiles are over the device's shared memory. Returns the CUDA
// error (0 on success); allocates nothing and does not synchronise.
int launch_mlp(Mlp p, int rows, cudaStream_t stream) {
  if (p.d_in <= 0 || p.d_ff <= 0 || p.d_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (p.n <= 0) return 0;
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (rows <= 0) {
    rows = (p.n + sms - 1) / sms;
    while (rows > 1 && smem_bytes(p, rows) > static_cast<size_t>(max_smem)) {
      rows = (rows + 1) / 2;
    }
  }
  p.rows = rows;
  const size_t smem = smem_bytes(p, rows);
  if (smem > static_cast<size_t>(max_smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlp_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.n + rows - 1) / rows;
  mlp_tile_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace nt
