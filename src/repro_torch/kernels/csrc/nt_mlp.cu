// The FlowGNN NT unit on Hopper (sm_90a): a two-layer MLP over node tiles
// with the hidden tile on chip.
//
// Replaces the TPU kernel repro/kernels/nt_mlp.py::nt_mlp (body
// _nt_mlp_kernel). For x (n, d_in), in float32:
//
//   y = relu(x @ w1 + b1) @ w2 + b2        (n, d_out)
//
// The Pallas kernel keeps a (node_tile, d_ff) f32 accumulator in VMEM while
// blocks of d_in stream through, and runs the second layer on the last
// block, so the hidden matrix never reaches HBM. Here the block's whole
// (rows, d_ff) hidden tile lives in shared memory instead (nt_tile.cuh):
// one block per node tile, the rows a block owns shrinking until x's and
// h's tiles fit the 227 KB a block may use. The tile knobs of the TPU grid
// (node_tile, k_tile) are not a part of it.
//
// What bounds it on an H100. Each input read once and the output written
// once; 2 n (d_in d_ff + d_ff d_out) operations plus the bias and relu.
// GIN's 100 -> 200 -> 100 at n = 1024 is ~82 MFLOP against ~0.9 MB: bound
// by operations, ~1.2 us at the 67 TFLOP/s of fp32 outside the tensor
// cores. This first kernel keeps to that fp32 FMA path (no TF32, no
// tensor cores); each FMA waits on a shared-memory and an L1 load, so it
// runs well above the bound. The tensor cores in fp32-exact form are later
// work.
//
// The launcher returns cudaGetLastError(); it allocates nothing and does
// not synchronise.

#include <cuda_runtime.h>

#include "nt_tile.cuh"

// y (n, d_out) = relu(x @ w1 + b1) @ w2 + b2, all f32, on `stream`. rows <= 0
// lets the kernel choose the node rows a block owns. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int nt_mlp_launch(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int n,
                             int d_in, int d_ff, int d_out, int rows,
                             void* stream) {
  nt::Mlp p = {};
  p.x = static_cast<const float*>(x);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.y = static_cast<float*>(y);
  p.n = n;
  p.d_in = d_in;
  p.d_ff = d_ff;
  p.d_out = d_out;
  return nt::launch_mlp(p, rows, static_cast<cudaStream_t>(stream));
}
