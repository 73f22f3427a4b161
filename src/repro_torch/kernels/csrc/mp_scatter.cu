// The scatter of a materialised edge stream on Hopper (sm_90a): masked
// scatter-sum, and the single-pass multi-statistic sweep.
//
// Replaces the TPU kernels repro/kernels/mp_scatter.py::mp_scatter (body
// _mp_scatter_kernel) and ::mp_scatter_multi (body _mp_scatter_multi_kernel).
// For every destination row i, over the unmasked edges e with rcv_e == i in
// stream order, with m_e the f32 message row (E, D):
//
//   sum_i   = sum m_e         sumsq_i = sum m_e^2 (squared in f32)
//   count_i = #edges  (N, 1)
//   max_i   = max m_e (-inf when empty)   min_i = min m_e (+inf when empty)
//
// mp_scatter_launch computes sum alone; mp_scatter_multi_launch any subset,
// a null output pointer switching its statistic off. Empty destinations
// keep the accumulators' neutrals: 0, -inf and +inf (mp_pipeline's keyed
// extrema use the finite -+1e30 instead; this contract is the reference's).
// Receivers outside [0, n) are never owned and add nothing.
//
// Messages are float32 or bfloat16 (the MoE dispatch's tokens). Either is
// widened on load and accumulated in float32. mp_scatter_launch returns
// the messages' dtype, as the reference (which accumulates in f32 and casts
// with astype, round to nearest even): bfloat16 sums are rounded here with
// __float2bfloat16_rn, not written as f32 for a cast to finish. The multi
// sweep's outputs are always the raw f32 accumulators.
//
// The Pallas kernels route each edge tile through a one-hot matrix on the
// TPU's matrix unit (_route_matrix) and take max / min by an (edge_tile,
// bank, D) mask-select. Both are devices of the TPU and are not carried
// over; this kernel computes what mp_scatter_ref / mp_scatter_multi_ref
// compute.
//
// What bounds it on an H100. Each input read once and each output written
// once: the unmasked edges' message rows, their receivers at 4 bytes, the
// mask, the outputs. At the hep serving bucket (N = 64, E = 1024, ~800
// unmasked) GIN's D = 100 sum is ~0.35 MB, ~0.10 us at 3.35 TB/s; PNA's
// four statistics at D = 80 ~0.10 us; DGN's D = 200 sum ~0.21 us. All far
// below a launch: launch latency and the serial sweep rule. The MoE
// dispatch (olmoe-1b-7b, 8,192 bf16 rows of D = 2048 into 10,240 slots) is
// bound by bytes at ~22 us; there shared memory holds ~20 rows a block, so
// 512 blocks each sweep all 8,192 receivers.
//
// Design (simple and right first; speed is later work), as mp_pipeline.cu:
//   * Owner computes. Block b owns destination rows [b*R, b*R + R) and sweeps
//     the whole edge stream in stream order, a tile at a time;
//     owned_edges.cuh compacts the tile's owned, unmasked edges into a
//     shared-memory list that keeps stream order.
//   * Threads run over the D lanes; with D <= blockDim there are
//     blockDim / D groups of lanes and group g owns the rows r % groups == g.
//     Every (row, lane) of each f32 shared-memory accumulator is written by
//     exactly one thread, in stream order: no atomics, and the result is
//     bitwise the same for any R and from run to run.
//   * f32 throughout, the square taken after the load; no fast math.
//   * The launchers return cudaGetLastError(); they allocate nothing and do
//     not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "owned_edges.cuh"

namespace {

using owned::kEdgeTile;
using owned::kThreads;
constexpr int kUnroll = 4;        // edges whose loads are issued together

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

struct Args {
  const void* msg;       // (e, d) float or __nv_bfloat16
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  void* sum;             // (n, d) float, or __nv_bfloat16 when sum_bf16;
                         // each output null when not asked
  float* sumsq;          // (n, d)
  float* count;          // (n, 1)
  float* mx;             // (n, d)
  float* mn;             // (n, d)
  int n, e, d;
  int rows;              // destination rows one block owns
  int sum_bf16;          // write sum as bfloat16 (round to nearest even)
};

size_t smem_bytes(const Args& p, int rows) {
  const int wide = (p.sum != nullptr) + (p.sumsq != nullptr) +
                   (p.mx != nullptr) + (p.mn != nullptr);
  const size_t floats =
      (size_t)rows * p.d * wide + (p.count != nullptr ? rows : 0);
  return floats * sizeof(float) + owned::kListBytes;
}

template <typename In>
__global__ void __launch_bounds__(kThreads)
    mp_scatter_kernel(const __grid_constant__ Args p) {
  extern __shared__ float smem[];
  const In* msg = static_cast<const In*>(p.msg);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rd = p.rows * p.d;

  // carve the accumulators; each is null when not asked for
  float* next = smem;
  auto take = [&](bool want, int size) {
    float* a = want ? next : nullptr;
    next += want ? size : 0;
    return a;
  };
  float* a_sum = take(p.sum != nullptr, rd);
  float* a_sumsq = take(p.sumsq != nullptr, rd);
  float* a_max = take(p.mx != nullptr, rd);
  float* a_min = take(p.mn != nullptr, rd);
  float* a_cnt = take(p.count != nullptr, p.rows);
  int* list_e = reinterpret_cast<int*>(next);
  int* list_r = list_e + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1

  for (int i = tid; i < rd; i += kThreads) {
    if (a_sum) a_sum[i] = 0.f;
    if (a_sumsq) a_sumsq[i] = 0.f;
    if (a_max) a_max[i] = -INFINITY;
    if (a_min) a_min[i] = INFINITY;
  }
  if (a_cnt) {
    for (int i = tid; i < p.rows; i += kThreads) a_cnt[i] = 0.f;
  }

  // lanes of the accumulate phase (see the design note above)
  const bool narrow = p.d <= kThreads;
  const int groups = narrow ? kThreads / p.d : 1;
  const int group = narrow ? tid / p.d : 0;
  const int lane0 = narrow ? tid % p.d : tid;
  const int lane_step = narrow ? p.d : kThreads;

  for (int base = 0; base < p.e; base += kEdgeTile) {
    const int total = owned::compact_owned_edges(
        p.rcv, p.mask, p.e, base, row0, rows_here, list_e, list_r, scan);

    // each (row, lane) folds its edges' messages in stream order
    if (group < groups) {
      for (int dd = lane0; dd < p.d; dd += lane_step) {
        for (int i = 0; i < total; i += kUnroll) {
          float v[kUnroll];
          int rr[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            rr[u] = -1;
            v[u] = 0.f;
            if (i + u < total && list_r[i + u] % groups == group) {
              rr[u] = list_r[i + u];
              v[u] = widen(msg[(size_t)list_e[i + u] * p.d + dd]);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (rr[u] < 0) continue;
            const int idx = rr[u] * p.d + dd;
            if (a_sum) a_sum[idx] = __fadd_rn(a_sum[idx], v[u]);
            if (a_sumsq) {
              a_sumsq[idx] = __fadd_rn(a_sumsq[idx], __fmul_rn(v[u], v[u]));
            }
            if (a_max) a_max[idx] = fmaxf(a_max[idx], v[u]);
            if (a_min) a_min[idx] = fminf(a_min[idx], v[u]);
            // one lane per row counts: lane 0 of the row's group
            if (a_cnt && dd == 0) a_cnt[rr[u]] += 1.f;
          }
        }
      }
    }
    __syncthreads();   // the list is rewritten by the next tile
  }

  // write the block's rows
  const size_t out0 = (size_t)row0 * p.d;
  for (int i = tid; i < rows_here * p.d; i += kThreads) {
    if (a_sum) {
      if (p.sum_bf16) {
        static_cast<__nv_bfloat16*>(p.sum)[out0 + i] =
            __float2bfloat16_rn(a_sum[i]);
      } else {
        static_cast<float*>(p.sum)[out0 + i] = a_sum[i];
      }
    }
    if (a_sumsq) p.sumsq[out0 + i] = a_sumsq[i];
    if (a_max) p.mx[out0 + i] = a_max[i];
    if (a_min) p.mn[out0 + i] = a_min[i];
  }
  if (a_cnt) {
    for (int r = tid; r < rows_here; r += kThreads) p.count[row0 + r] = a_cnt[r];
  }
}

template <typename In>
int launch_as(const Args& p, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mp_scatter_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (p.n + p.rows - 1) / p.rows;
  mp_scatter_kernel<In><<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch(Args& p, int rows, int bf16, void* stream) {
  if (p.d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n <= 0) return 0;
  p.rows = rows > 0 ? rows : owned::default_rows(
                                 p.n, [&](int r) { return smem_bytes(p, r); });
  const size_t smem = smem_bytes(p, p.rows);
  return bf16 ? launch_as<__nv_bfloat16>(p, smem, stream)
              : launch_as<float>(p, smem, stream);
}

}  // namespace

// Scatter-sum msg (e, d) into out (n, d) over the unmasked edges, on
// `stream`: both f32, or both bf16 when bf16 != 0 (f32 accumulation). rows
// <= 0 lets the kernel choose the rows a block owns. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mp_scatter_launch(const void* msg, const void* rcv,
                                 const void* mask, void* out, int n, int e,
                                 int d, int rows, int bf16, void* stream) {
  Args p = {};
  p.msg = msg;
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sum = out;
  p.sum_bf16 = bf16 != 0;
  p.n = n;
  p.e = e;
  p.d = d;
  if (out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(p, rows, bf16, stream);
}

// The multi-statistic sweep on `stream`: each non-null output gets its
// statistic (sum, sumsq, max, min of (n, d); count of (n, 1)), all f32,
// from f32 messages, or bf16 ones when bf16 != 0. rows <= 0 lets the
// kernel choose. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int mp_scatter_multi_launch(const void* msg, const void* rcv,
                                       const void* mask, void* sum,
                                       void* sumsq, void* count, void* mx,
                                       void* mn, int n, int e, int d,
                                       int rows, int bf16, void* stream) {
  Args p = {};
  p.msg = msg;
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sum = sum;
  p.sumsq = static_cast<float*>(sumsq);
  p.count = static_cast<float*>(count);
  p.mx = static_cast<float*>(mx);
  p.mn = static_cast<float*>(mn);
  p.n = n;
  p.e = e;
  p.d = d;
  if (!sum && !sumsq && !count && !mx && !mn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(p, rows, bf16, stream);
}
