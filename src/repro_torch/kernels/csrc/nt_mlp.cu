// The FlowGNN NT unit on Hopper (sm_90a): a two-layer MLP over node tiles
// with the hidden tile on chip.
//
// Replaces the TPU kernel repro/kernels/nt_mlp.py::nt_mlp (body
// _nt_mlp_kernel). For x (n, d_in), computed in float32:
//
//   y = relu(x @ w1 + b1) @ w2 + b2        (n, d_out)
//
// The Pallas kernel keeps a (node_tile, d_ff) f32 accumulator in VMEM while
// blocks of d_in stream through, and runs the second layer on the last
// block, so the hidden matrix never reaches HBM. Here the block's whole
// (rows, d_ff) hidden tile lives in shared memory instead (nt_tile.cuh):
// one block per node tile, one block per SM where the rows allow it, the
// weights staged beside the tiles (a ring of chunks where they do not all
// fit the 227 KB a block may use). The tile knobs of the TPU grid
// (node_tile, k_tile) are not a part of it.
//
// What bounds it on an H100. Each input read once and the output written
// once; 2 n (d_in d_ff + d_ff d_out) operations plus the bias and relu.
// GIN's 100 -> 200 -> 100 at n = 1024 is ~82 MFLOP against ~0.9 MB: bound
// by operations, ~1.2 us at the 67 TFLOP/s of fp32 outside the tensor
// cores; at the serving buckets (n = 32, 64) by bytes, under 0.1 us. Both
// are below a launch. What sets the time instead: the launch and set-up,
// each block's copy of the whole weight set into shared memory (160 KB at
// GIN in f32, 80 KB in bf16 or f16: every block needs every weight), and
// the dense layers' chains of dependent FMAs. The tile (nt_tile.cuh on
// dense_tile.cuh) overlaps the copies with the first layer chunk by chunk,
// keeps every thread busy by split-k, and does no work on padding rows;
// experiments/nt_breakdown.py times those parts. The tensor cores are not
// used: at these sizes their gain is under a launch, and fp32 stays fp32
// (no TF32).
//
// x, w1, b1, w2 and b2 share one type, float32, bfloat16 or float16; y is
// written in it (rounded to nearest even from the f32 result). The
// launcher returns cudaGetLastError(); it allocates nothing and does not
// synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "nt_tile.cuh"

// y (n, d_out) = relu(x @ w1 + b1) @ w2 + b2, computed in f32, every operand
// and y of the type `dtype` names (nt::Dtype: 0 float32, 1 bfloat16, 2
// float16), on `stream`. rows <= 0 lets the kernel choose the node rows a
// block owns. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int nt_mlp_launch(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, void* y, int n,
                             int d_in, int d_ff, int d_out, int dtype,
                             int rows, void* stream) {
  const nt::Mlp p = nt::make_mlp(x, w1, b1, w2, b2, y, n, d_in, d_ff, d_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case nt::kF32:
      return nt::launch_mlp<float, float>(p, rows, st);
    case nt::kBf16:
      return nt::launch_mlp<__nv_bfloat16, __nv_bfloat16>(p, rows, st);
    case nt::kF16:
      return nt::launch_mlp<__half, __half>(p, rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
