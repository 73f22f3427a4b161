// The fused gather-phi-scatter edge phase on Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel repro/kernels/mp_pipeline.py::mp_pipeline (body
// _mp_pipeline_kernel). The kernel, its design and its launcher are in
// mp_pipeline.cuh, which fused_nt_scatter.cu shares (its own form alone);
// this source picks the form a call's arguments name and is its plain C
// interface.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mp_pipeline.cuh"

namespace pipeline {
namespace {

// One launch of the edge phase on `stream`, in the form its arguments
// name. A null output pointer switches its statistic off; null
// att_src/att_dst switch attention off (heads = 0). rows <= 0 lets the
// kernel choose. Returns cudaGetLastError() after the launch (0 on
// success).
int launch(Args p, int rows, cudaStream_t stream) {
  if (p.heads > 0 &&
      (p.sum == nullptr || p.att_max == nullptr || p.att_denom == nullptr ||
       p.att_src == nullptr || p.att_dst == nullptr || p.d % p.heads != 0 ||
       p.sumsq != nullptr || p.mx != nullptr || p.mn != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ask = asked(p);
  const bool plain_phi = p.sw_mode == kSwNone && p.et == nullptr &&
                         p.bias == nullptr && !p.relu;
  const bool gin_phi = p.sw_mode == kSwNone && p.et != nullptr &&
                       p.bias == nullptr && p.relu;
  if (p.check_src) {
    if (!gin_phi || ask != kSum || p.heads > 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_form<NtForm>(p, rows, stream);
  }
  if (p.heads > 0) {
    return plain_phi ? launch_form<GatForm>(p, rows, stream)
                     : launch_form<GenericAttForm>(p, rows, stream);
  }
  const bool no_terms = p.et == nullptr && p.bias == nullptr && !p.relu;
  if (gin_phi && ask == kSum) return launch_form<GinForm>(p, rows, stream);
  if (p.sw_mode == kSwScalar && no_terms && ask == kSum) {
    return launch_form<GcnForm>(p, rows, stream);
  }
  if (p.sw_mode == kSwNone && p.et != nullptr && p.bias != nullptr &&
      p.relu && ask == kFour) {
    return launch_form<PnaForm>(p, rows, stream);
  }
  if (p.sw_mode == kSwFull && no_terms && ask == kSum) {
    return launch_form<DgnForm>(p, rows, stream);
  }
  return launch_form<GenericForm>(p, rows, stream);
}

}  // namespace
}  // namespace pipeline

// Launch the edge phase on `stream`. A null output pointer switches its
// statistic off; null att_src/att_dst switch attention off (heads = 0).
// rows <= 0 lets the kernel choose. Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int mp_pipeline_launch(
    const void* y, const void* snd, const void* rcv, const void* mask,
    const void* sw, const void* et, const void* bias, const void* att_src,
    const void* att_dst, void* sum, void* sumsq, void* count, void* mx,
    void* mn, void* att_max, void* att_denom, int n, int e, int d,
    int sw_mode, int sw_cols, int head_dim, int relu, int heads, float slope,
    int rows, void* stream) {
  pipeline::Args p = {};
  p.y = static_cast<const float*>(y);
  p.snd = static_cast<const int64_t*>(snd);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sw = static_cast<const float*>(sw);
  p.et = static_cast<const float*>(et);
  p.bias = static_cast<const float*>(bias);
  p.att_src = static_cast<const float*>(att_src);
  p.att_dst = static_cast<const float*>(att_dst);
  p.sum = static_cast<float*>(sum);
  p.sumsq = static_cast<float*>(sumsq);
  p.count = static_cast<float*>(count);
  p.mx = static_cast<float*>(mx);
  p.mn = static_cast<float*>(mn);
  p.att_max = static_cast<float*>(att_max);
  p.att_denom = static_cast<float*>(att_denom);
  p.n = n;
  p.e = e;
  p.d = d;
  p.sw_mode = sw_mode;
  p.sw_cols = sw_cols;
  p.head_dim = head_dim;
  p.relu = relu;
  p.heads = heads;
  p.slope = slope;
  return pipeline::launch(p, rows, static_cast<cudaStream_t>(stream));
}
