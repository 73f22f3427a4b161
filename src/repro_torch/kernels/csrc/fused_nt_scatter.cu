// NT fused with the GIN-style message transform and scatter, on Hopper
// (sm_90a), in two launches on one stream.
//
// Replaces the TPU kernel repro/kernels/fused_nt_scatter.py::
// fused_nt_scatter (body _fused_kernel). For x (n, d_in), an MLP
// d_in -> d_ff -> d, edges (snd, rcv, mask) and edge_feat (e, d), in f32:
//
//   y      = relu(x @ w1 + b1) @ w2 + b2                        (n, d)
//   out[i] = sum over unmasked e with rcv_e == i, in stream order,
//            of relu(y[snd_e] + edge_feat[e])                   (n, d)
//
// An edge whose sender or receiver lies outside [0, n) adds nothing, as in
// the Pallas kernel (no node tile owns its source, no lane its receiver).
// Empty destinations are 0.
//
// The Pallas kernel walks the node tiles in order on one core: each step
// runs the MLP on its tile and at once pushes the edges whose source lies
// there through a one-hot gather and a one-hot scatter into the resident
// (n, d) output, so y never reaches HBM. On Hopper blocks run in no order
// and cannot wait on each other, so y must be whole before any block
// gathers it: the one launcher issues two launches back to back on the
// caller's stream.
//   launch 1  the NT tile (nt_tile.cuh on dense_tile.cuh: weights staged,
//             split-k dense layers) writes y to the caller's (n, d) f32
//             scratch; each of its blocks issues griddepcontrol.
//             launch_dependents as it starts;
//   launch 2  the edge phase of mp_pipeline.cuh in its NT form (the sum
//             alone, the edge term edge_feat, a relu and its sender check
//             on), launched with programmatic stream serialization: its
//             blocks start while the NT tile runs, do their set-up and
//             bucket the first edge tile by owner (receivers and the mask:
//             nothing of y), then wait for the NT grid (griddepcontrol.wait)
//             before the first fold reads y. Each block folds the
//             stream-ordered edges of the destination rows it owns: no
//             atomics, bitwise the same for any rows per block and from run
//             to run, and bitwise nt_mlp followed by mp_pipeline.
// In the kernel's regime (n up to ~2k, e up to ~8k, per its docstring) y is
// under 1 MB and stays in the 50 MB L2 between the two launches. One launch
// with a grid-wide barrier was not taken: a cooperative launch costs the
// host 32-92 us a call (PERF.md), and a plain launch has no guarantee that
// all its blocks are resident for a spin barrier.
//
// What bounds it on an H100. Each input read once (x, the weights, the
// unmasked edges' indices and edge features, the mask), the output written
// once; the MLP's 2 n (d_in d_ff + d_ff d) operations plus, per unmasked
// edge and lane, an add, a relu and the sum. At n = 1024, e = 4096 and the
// MLP 64 -> 128 -> 64, ~1.3 MB and ~34 MFLOP: ~0.5 us, by operations.
//
// x, w1, b1, w2 and b2 share one type (float32, bfloat16 or float16);
// edge_feat is of any of the three; both are widened to f32 at the load and
// y and out stay f32. The launcher returns the first failed launch's error
// or cudaGetLastError(); it allocates nothing (y is the caller's scratch)
// and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mp_pipeline.cuh"
#include "nt_tile.cuh"

namespace {

// the NT tile into f32 y for operands of the type `dtype` names
int launch_nt(const nt::Mlp& m, int dtype, int rows, cudaStream_t st) {
  switch (dtype) {
    case nt::kF32:
      return nt::launch_mlp<float, float>(m, rows, st);
    case nt::kBf16:
      return nt::launch_mlp<__nv_bfloat16, float>(m, rows, st);
    case nt::kF16:
      return nt::launch_mlp<__half, float>(m, rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the edge phase for an edge_feat of the type `dtype` names
int launch_edges(const pipeline::Args& p, int dtype, int rows,
                 cudaStream_t st) {
  using pipeline::NtFormOf;
  switch (dtype) {
    case nt::kF32:
      return pipeline::launch_form<NtFormOf<float>>(p, rows, st);
    case nt::kBf16:
      return pipeline::launch_form<NtFormOf<__nv_bfloat16>>(p, rows, st);
    case nt::kF16:
      return pipeline::launch_form<NtFormOf<__half>>(p, rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (n, d) f32 = the scatter-sum over the unmasked edges of relu(y[snd] +
// edge_feat) with y = relu(x @ w1 + b1) @ w2 + b2 in f32; the MLP's operands
// of the type `dtype` names, edge_feat of `et_dtype`'s (nt::Dtype: 0
// float32, 1 bfloat16, 2 float16); y is the caller's (n, d) f32 scratch.
// Two launches on `stream`. rows_nt / rows_scatter <= 0 let each launch
// choose the rows a block owns. Returns the error of the launch that failed,
// else cudaGetLastError() after both (0 on success).
extern "C" int fused_nt_scatter_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* snd, const void* rcv, const void* mask,
    const void* edge_feat, void* y, void* out, int n, int e, int d_in,
    int d_ff, int d, int dtype, int et_dtype, int rows_nt, int rows_scatter,
    void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || et_dtype < nt::kF32 || et_dtype > nt::kF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const nt::Mlp m = nt::make_mlp(x, w1, b1, w2, b2, y, n, d_in, d_ff, d);
  const int err = launch_nt(m, dtype, rows_nt, st);
  if (err != 0) return err;
  pipeline::Args p = {};
  p.y = static_cast<const float*>(y);
  p.snd = static_cast<const int64_t*>(snd);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.et = static_cast<const float*>(edge_feat);   // of et_dtype's type
  p.sum = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.d = d;
  p.sw_mode = pipeline::kSwNone;
  p.relu = 1;
  p.check_src = 1;
  return launch_edges(p, et_dtype, rows_scatter, st);
}
