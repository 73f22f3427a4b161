// The row gather of the MoE combine on Hopper (sm_90a): out[i] = y[idx[i]].
//
// Replaces the TPU kernel repro/kernels/gather_rows.py::gather_rows (body
// _gather_kernel). For every output row i of s, with y (n, d) float32 or
// bfloat16:
//
//   out[i, :] = float32(y[idx[i], :])   where mask[i] and 0 <= idx[i] < n
//             = 0                       otherwise
//
// An unmasked index outside [0, n) gives a zero row, as in the Pallas
// kernel, where no bank owns it (its oracle gather_rows_ref clips instead).
// The output is float32 for every y dtype.
//
// The Pallas kernel selects each bank's rows with a one-hot routing matmul
// on the TPU's matrix unit. That is a device of the TPU and is not carried
// over: a gather is indexed loads.
//
// What bounds it on an H100. Each needed input read once and each output
// written once: the s indices and the mask, the gathered rows of y, the
// (s, d) f32 output. At the olmoe-1b-7b combine (s = 8,192, d = 2048, bf16 y)
// that is ~34 MB read and ~67 MB written, ~30 us at 3.35 TB/s. It is bound
// by bytes; nothing is computed but the widening.
//
// Design: one thread per 16-byte piece of an output row, the pieces of
// consecutive rows laid end to end, so a block covers a run of output rows
// and neighbouring threads touch neighbouring addresses. A float32 piece is
// one float4 load and one float4 store; a bfloat16 piece is one 16-byte
// load of 8 values and two float4 stores. Where d does not allow whole
// pieces, one thread per value. No shared memory, no atomics: each output
// value is written once, so the result is exact and the same every run.
// The launcher returns cudaGetLastError(); it allocates nothing and does
// not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const void* y;          // (n, d) float or __nv_bfloat16
  const int64_t* idx;     // (s,)
  const uint8_t* mask;    // (s,) bool
  float* out;             // (s, d)
  int n, s, d;
};

// the source row of output row i, or -1 for a zero row
__device__ __forceinline__ int64_t source_row(const Args& p, int i) {
  const int64_t r = p.idx[i];
  return (p.mask[i] && r >= 0 && r < p.n) ? r : -1;
}

// one thread per 16-byte piece: 4 floats, or 8 bfloat16 widened to 8 floats
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_pieces_kernel(const __grid_constant__ Args p) {
  constexpr int kPer = 16 / sizeof(T);            // values in a piece
  const int per_row = p.d / kPer;
  const int64_t total = (int64_t)p.s * per_row;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int i = static_cast<int>(t / per_row);
    const int piece = static_cast<int>(t % per_row);
    const int64_t r = source_row(p, i);
    float4* dst = reinterpret_cast<float4*>(p.out + (size_t)i * p.d) +
                  piece * (kPer / 4);
    if (r < 0) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) dst[q] = z;
      continue;
    }
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const T*>(p.y) + (size_t)r * p.d) + piece);
    if constexpr (sizeof(T) == 4) {
      dst[0] = make_float4(__uint_as_float(raw.x), __uint_as_float(raw.y),
                           __uint_as_float(raw.z), __uint_as_float(raw.w));
    } else {
      // a bfloat16 is the high half of the float32 of the same value
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float v[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[2 * q] = __uint_as_float(w[q] << 16);
        v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
      }
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// one thread per value, for widths that do not split into pieces
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_values_kernel(const __grid_constant__ Args p) {
  const int64_t total = (int64_t)p.s * p.d;
  for (int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * kThreads) {
    const int i = static_cast<int>(t / p.d);
    const int j = static_cast<int>(t % p.d);
    const int64_t r = source_row(p, i);
    float v = 0.f;
    if (r >= 0) {
      const T x = static_cast<const T*>(p.y)[(size_t)r * p.d + j];
      if constexpr (sizeof(T) == 4) {
        v = x;
      } else {
        v = __bfloat162float(x);
      }
    }
    p.out[t] = v;
  }
}

template <typename T>
int launch_as(const Args& p, cudaStream_t stream) {
  constexpr int kPer = 16 / sizeof(T);
  const bool pieces = p.d % kPer == 0 &&
                      reinterpret_cast<uintptr_t>(p.y) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  const int64_t work = (int64_t)p.s * (pieces ? p.d / kPer : p.d);
  int dev = 0;
  int sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks to fill every SM several times over, then a grid stride
  const int64_t want = (work + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 16LL * sms ? want : 16LL * sms);
  if (pieces) {
    gather_pieces_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    gather_values_kernel<T><<<blocks, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (s, d) f32 = y[idx] over the masked, in-range indices, zero rows
// elsewhere, on `stream`; y (n, d) is f32, or bf16 when bf16 != 0. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gather_rows_launch(const void* y, const void* idx,
                                  const void* mask, void* out, int n, int s,
                                  int d, int bf16, void* stream) {
  Args p = {};
  p.y = y;
  p.idx = static_cast<const int64_t*>(idx);
  p.mask = static_cast<const uint8_t*>(mask);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.s = s;
  p.d = d;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (s <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_as<__nv_bfloat16>(p, st) : launch_as<float>(p, st);
}
