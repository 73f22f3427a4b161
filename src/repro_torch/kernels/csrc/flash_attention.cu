// Flash attention on Hopper (sm_90a): causal, windowed and softcapped
// attention with an online softmax, f32 arithmetic, in one launch.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). For q (BH, Sq, D) and k, v (BH, Sk, D), float32 or
// bfloat16, with scale = 1 / sqrt(D):
//
//   s[i, j]  = sum_d (q[i, d] * scale) * k[j, d]       q scaled in f32 first
//   s[i, j]  = cap * tanh(s[i, j] / cap)                 with a softcap
//   q_pos    = i + (Sk - Sq);  k_pos = j                 end-aligned positions
//   visible  = (!causal || k_pos <= q_pos) && (!window || k_pos > q_pos - window)
//   out[i]   = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30),
//              p = exp(s - m) on visible keys, 0 elsewhere
//
// with the running max m, denominator and accumulator in f32, rescaled per
// key tile as the Pallas kernel does (m starts at -1e30, so a row that sees
// no key comes out 0, not NaN). The output has the inputs' dtype (bfloat16
// rounded to nearest even).
//
// The Pallas kernel walks a (BH, q tiles, kv tiles) grid in order, keeping
// its carries in VMEM scratch across the kv steps. That order is a device of
// the TPU: here one block owns one (bh, q tile) and loops over the kv tiles
// itself, with the carries in registers. Its block sizes do not bind: the
// caller's q_tile / kv_tile are a contract on the lengths only.
//
// What bounds it on an H100. Per visible (query, key) pair 4 D operations
// (the two products of D multiply-adds each); the bytes are q, k, v and out
// once each. At llama3-8b's prefill (B=1, H=32, S=2048, D=128, causal, bf16)
// that is 34.4 GFLOP against 67 MB: operations bound, ~35 us at bf16's 989
// TFLOP/s on the tensor cores, ~0.51 ms at f32's 67 TFLOP/s outside them.
// This first kernel runs every product as f32 FMAs (bf16 inputs widened on
// load), so the f32 rate is its ceiling; bf16 mma/wgmma with f32
// accumulation is later work.
//
// Design (simple and right first):
//   * One block of 128 threads per (bh, 64-row q tile). The q tile, scaled,
//     stays in shared memory as f32; each 64-key tile of k and v is staged
//     there too (widened to f32), rows padded by 4 floats so that the
//     16-byte reads below hit distinct banks.
//   * Thread (rg, cg) = (tid / 8, tid % 8) owns query rows rg + 16 r (r < 4)
//     and, of the score tile, keys cg + 8 j (j < 8); of the output, the
//     column groups cg + 8 c of kVec columns each (4, and 2 at D = 16), read
//     from shared memory as one vector. A row's 8 threads sit in 8 lanes
//     side by side in one warp: its max and sum are xor-shuffles over them
//     (every lane gets the same bits), and P.V takes each probability from
//     the lane that holds it by a shuffle, so P never goes through shared
//     memory.
//   * Only the kv tiles the causal and window masks leave visible to some
//     row of the tile are visited (nn/flash.py::_block_schedule's skip);
//     masked tiles would add nothing.
//   * expf and tanhf, not the fast intrinsics; fp32 throughout, no TF32. No
//     atomics: the result is the same bits from run to run.
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockQ = 64;       // query rows a block owns
constexpr int kBlockK = 64;       // keys per staged tile
constexpr int kRows = 4;          // query rows per thread: rg + 16 r
constexpr int kCols = 8;          // keys per thread in a score tile: cg + 8 j
constexpr float kNeg = -1e30f;    // the Pallas kernel's _NEG_INF

struct Args {
  const void* q;       // (bh, sq, d)
  const void* k;       // (bh, sk, d)
  const void* v;       // (bh, sk, d)
  void* out;           // (bh, sq, d), q's dtype
  int sq, sk;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// rows [row0, row0 + kBlockQ) of a (rows, D) matrix of T into shared memory
// as f32 (times ``mul``), row stride D + 4; rows past ``rows`` are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int rows, float mul, bool scaled) {
  constexpr int kPer = 16 / sizeof(T);              // values per 16 bytes
  constexpr int kPieces = D / kPer;                 // 16-byte pieces a row
  constexpr int kLd = D + 4;
  for (int t = threadIdx.x; t < kBlockQ * kPieces; t += kThreads) {
    const int r = t / kPieces;
    const int piece = t % kPieces;
    float vals[kPer];
    if (row0 + r < rows) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D) + piece);
      if constexpr (sizeof(T) == 4) {
        vals[0] = __uint_as_float(raw.x);
        vals[1] = __uint_as_float(raw.y);
        vals[2] = __uint_as_float(raw.z);
        vals[3] = __uint_as_float(raw.w);
      } else {
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {             // bf16 widening is exact
          vals[2 * i] = __uint_as_float(w[i] << 16);
          vals[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
      if (scaled) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) vals[i] = __fmul_rn(vals[i], mul);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) vals[i] = 0.f;
    }
    float4* d4 = reinterpret_cast<float4*>(dst + r * kLd + piece * kPer);
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      d4[i] = make_float4(vals[4 * i], vals[4 * i + 1], vals[4 * i + 2],
                          vals[4 * i + 3]);
    }
  }
}

// N = 4 or 2 floats from 16- or 8-byte aligned shared memory
template <int N>
__device__ __forceinline__ void load_vec(const float* src, float* dst) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[1] = v.y;
  }
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __grid_constant__ Args p) {
  constexpr int kLd = D + 4;
  constexpr int kVec = D >= 32 ? 4 : D / 8;         // columns a group
  constexpr int kOut = D / 8;                       // output columns a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * kLd;
  float* vs = ks + kBlockK * kLd;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  // the heaviest causal tiles (the last ones) are launched first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + bh * p.sq * D;
  const T* k = static_cast<const T*>(p.k) + bh * p.sk * D;
  const T* v = static_cast<const T*>(p.v) + bh * p.sk * D;
  T* out = static_cast<T*>(p.out) + bh * p.sq * D;

  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                               // first row
  const int q_hi = min(q0 + kBlockQ, p.sq) - 1 + offset;      // last row
  // the keys some row of this tile may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;

  stage<T, D>(qs, q, q0, p.sq, p.scale, true);

  float m[kRows], l[kRows];
  float acc[kRows][kOut];       // group c, column i at acc[r][c * kVec + i]
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[r][c] = 0.f;
  }

  for (int kb = k_begin / kBlockK * kBlockK; kb < k_end; kb += kBlockK) {
    __syncthreads();                  // the previous tile has been read
    stage<T, D>(ks, k, kb, p.sk, 1.f, false);
    stage<T, D>(vs, v, kb, p.sk, 1.f, false);
    __syncthreads();

    // scores of the thread's 4 x 8 (row, key) pairs
    float s[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[r][j] = 0.f;
    }
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(qs + (rg + 16 * r) * kLd + dd);
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (cg + 8 * j) * kLd + dd);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = s[r][j];
          a = fmaf(qv[r].x, kv.x, a);
          a = fmaf(qv[r].y, kv.y, a);
          a = fmaf(qv[r].z, kv.z, a);
          a = fmaf(qv[r].w, kv.w, a);
          s[r][j] = a;
        }
      }
    }

    // softcap, mask, and the online softmax of each row
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int q_pos = q0 + rg + 16 * r + offset;
      uint32_t seen = 0;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int k_pos = kb + cg + 8 * j;
        const bool ok = k_pos < p.sk && (!p.causal || k_pos <= q_pos) &&
                        (!p.has_window || k_pos > q_pos - p.window);
        float x = s[r][j];
        if (p.has_softcap) x = __fmul_rn(p.softcap, tanhf(x / p.softcap));
        x = ok ? x : kNeg;
        s[r][j] = x;
        seen |= ok ? (1u << j) : 0u;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pj = (seen >> j) & 1u ? expf(s[r][j] - m_new) : 0.f;
        s[r][j] = pj;
        sum += pj;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[r] = fmaf(l[r], alpha, sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[r][c] *= alpha;
    }

    // acc += P V over the tile's keys in order; key cg' + 8 j's probability
    // sits in lane (lane & ~7) | cg' as s[r][j]
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
#pragma unroll
      for (int src = 0; src < 8; ++src) {
        float pr[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pr[r] = __shfl_sync(0xffffffffu, s[r][j], (lane & ~7) | src);
        }
        const float* vrow = vs + (src + 8 * j) * kLd + cg * kVec;
#pragma unroll
        for (int c = 0; c < kOut / kVec; ++c) {
          float vv[kVec];
          load_vec<kVec>(vrow + 8 * kVec * c, vv);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              acc[r][c * kVec + i] = fmaf(pr[r], vv[i], acc[r][c * kVec + i]);
            }
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30): 0 for a row that saw no key
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + rg + 16 * r;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (size_t)row * D + cg * kVec;
#pragma unroll
    for (int c = 0; c < kOut / kVec; ++c) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        store(orow + 8 * kVec * c + i, acc[r][c * kVec + i] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch_as(const Args& p, int bh, cudaStream_t st) {
  const size_t smem = (size_t)(kBlockQ + 2 * kBlockK) * (D + 4) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const Args& p, int bh, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch_as<T, 16>(p, bh, st);
    case 32: return launch_as<T, 32>(p, bh, st);
    case 64: return launch_as<T, 64>(p, bh, st);
    case 128: return launch_as<T, 128>(p, bh, st);
    case 256: return launch_as<T, 256>(p, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d): float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), contiguous, 16-byte aligned; d one of 16, 32, 64,
// 128, 256; bh <= 65535. window and softcap count only where has_window /
// has_softcap are set.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bh,
                                      int sq, int sk, int d, int bf16,
                                      int causal, int has_window, int window,
                                      int has_softcap, float softcap,
                                      float scale, void* stream) {
  Args p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  if (bh <= 0 || sq <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(p, bh, d, st)
              : launch_d<float>(p, bh, d, st);
}
