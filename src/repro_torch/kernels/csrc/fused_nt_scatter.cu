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
//   launch 1  the NT tile (nt_tile.cuh) writes y to the caller's (n, d) f32
//             scratch;
//   launch 2  the edge phase of mp_pipeline.cuh in its NT form (the sum
//             alone, the edge term edge_feat, a relu and its sender check
//             on): owner buckets, each block folding the stream-ordered
//             edges of the destination rows it owns, no atomics, bitwise
//             the same for any rows per block and from run to run.
// In the kernel's regime (n up to ~2k, e up to ~8k, per its docstring) y is
// under 1 MB and stays in the 50 MB L2 between the two launches, so in
// practice it does not make the round trip to HBM either. One launch with a
// grid-wide barrier (a cooperative launch) is later work.
//
// What bounds it on an H100. Each input read once (x, the weights, the
// unmasked edges' indices and edge features, the mask), the output written
// once; the MLP's 2 n (d_in d_ff + d_ff d) operations plus, per unmasked
// edge and lane, an add, a relu and the sum. At n = 1024, e = 4096 and the
// MLP 64 -> 128 -> 64, ~1.3 MB and ~34 MFLOP: ~0.5 us, by operations.
//
// The launcher returns cudaGetLastError(); it allocates nothing (y is the
// caller's scratch) and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mp_pipeline.cuh"
#include "nt_tile.cuh"

// out (n, d) f32 = the scatter-sum over the unmasked edges of relu(y[snd] +
// edge_feat) with y = relu(x @ w1 + b1) @ w2 + b2, everything f32; y is the
// caller's (n, d) scratch. Two launches on `stream`. rows_nt / rows_scatter
// <= 0 let each launch choose the rows a block owns. Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int fused_nt_scatter_launch(
    const void* x, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* snd, const void* rcv, const void* mask,
    const void* edge_feat, void* y, void* out, int n, int e, int d_in,
    int d_ff, int d, int rows_nt, int rows_scatter, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  nt::Mlp m = {};
  m.x = static_cast<const float*>(x);
  m.w1 = static_cast<const float*>(w1);
  m.b1 = static_cast<const float*>(b1);
  m.w2 = static_cast<const float*>(w2);
  m.b2 = static_cast<const float*>(b2);
  m.y = static_cast<float*>(y);
  m.n = n;
  m.d_in = d_in;
  m.d_ff = d_ff;
  m.d_out = d;
  const int err = nt::launch_mlp(m, rows_nt, st);
  if (err != 0) return err;
  pipeline::Args p = {};
  p.y = static_cast<const float*>(y);
  p.snd = static_cast<const int64_t*>(snd);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.et = static_cast<const float*>(edge_feat);
  p.sum = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.d = d;
  p.sw_mode = pipeline::kSwNone;
  p.relu = 1;
  p.check_src = 1;
  return pipeline::launch_form<pipeline::NtForm>(p, rows_scatter, st);
}
