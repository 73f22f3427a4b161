// The backward of flash attention on Hopper (sm_90a): dQ, dK and dV of the
// causal, windowed and softcapped attention of csrc/flash_attention.cu, in
// two launches and no atomics.
//
// Replaces no Pallas kernel: the TPU path differentiates its attention with
// nn/flash.py::_bwd, the custom VJP of flash_mha, in jnp outside any kernel.
// The port's forward is a hand-written kernel, so its backward is one too.
// For q (BH, Sq, D), k and v (BH, Sk, D), dout (BH, Sq, D), float32 or
// bfloat16, the forward's row log-sum-exp lse (BH, Sq) and
// delta[i] = sum_d dout[i, d] out[i, d] (BH, Sq), both float32, with
// scale = 1 / sqrt(D):
//
//   s[i, j]  = sum_d (q[i, d] * scale) k[j, d]
//   s[i, j]  = cap * tanh(s[i, j] / cap),  dcap = 1 - tanh^2   with a softcap
//   p[i, j]  = exp(s[i, j] - lse[i])  on visible keys (the forward's masks,
//              end-aligned), 0 elsewhere and on rows past Sq
//   dp[i, j] = sum_d dout[i, d] v[j, d]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) (* dcap)
//   dv[j]    = sum_i p[i, j] dout[i]
//   dk[j]    = sum_i ds[i, j] (q[i] * scale)
//   dq[i]    = sum_j ds[i, j] k[j] * scale
//
// as _bwd computes them; a row that sees no key gets zero gradients. The
// outputs have the inputs' dtype (bfloat16 rounded to nearest even); every
// sum is float32. delta is a PyTorch reduction in the wrapper, as the
// reference computes it with an einsum outside its loop.
//
// The reference accumulates dq, dk and dv over one (q block, kv block)
// schedule into whole-sequence carries. On the card that order would need
// atomics across blocks. Instead two launches each own what they write:
//   * dkv: one block owns a tile of kBlockK keys of one (b, h), keeps its dK
//     and dV in registers, and sweeps the q tiles that can see those keys
//     (causal: from the tile's first key on; window: up to its last key
//     plus the window), in order;
//   * dq: one block owns kBlockQ = 64 query rows and sweeps the kv tiles
//     they can see, as the forward does.
// Each recomputes s, p, dp and ds for its pairs, so the (q, k) pairs cost
// 7 D multiply-adds in all (s, dp and dV or dQ in each launch, dK in one)
// against the 5 D of a backward that shares them through atomics: the
// price of sums in a fixed order, the same bits every run.
//
// What bounds it on an H100. Per visible (query, key) pair the backward
// needs 10 D operations (its five products of D multiply-adds: s, dp, dq,
// dk and dv); the bytes are q, k, v, dout, lse and delta read once and dq,
// dk, dv written once. At qwen1.5-0.5b's training shape (B=8, H=16,
// S=2048, D=64, causal, bf16) that is 172 GFLOP against 101 MB: operations
// bound, 0.174 ms at bf16's 989 TFLOP/s on the tensor cores. This kernel
// keeps both products on FMAs outside the tensor cores (f32's 67 TFLOP/s),
// so it runs well above that bound; it is the simple, right one.
//
// Design (both launches, 256 threads, FMA, float32 throughout, no TF32):
//   * tiles staged in shared memory as float32 (bf16 widened on the load),
//     rows padded by 4 floats: q (scaled by 1/sqrt(D) as it is staged),
//     dout, k and v; p and ds of the current (q tile, kv tile) in shared
//     memory too, with lse and delta of the q tile;
//   * thread (hi, lo) = (tid / 16, tid % 16) computes the scores of rows
//     hi + 16 r and keys lo + 16 c, then accumulates dK / dV of keys
//     hi + 16 a (dkv) or dQ of rows hi + 16 a (dq) over column groups
//     lo + 16 b of kCW columns, in registers;
//   * kBlockQ = 64, kBlockK = 64 keys (32 at D = 256, for registers and
//     shared memory).
// expf and tanhf, not the fast intrinsics. The launcher returns a CUDA
// error code (cudaGetLastError() after each launch); it allocates nothing
// and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;

struct Args {
  const void* q;        // (bh, sq, d)
  const void* k;        // (bh, sk, d)
  const void* v;        // (bh, sk, d)
  const void* dout;     // (bh, sq, d)
  const float* lse;     // (bh, sq)
  const float* delta;   // (bh, sq)
  void* dq;             // (bh, sq, d), q's dtype
  void* dk;             // (bh, sk, d)
  void* dv;             // (bh, sk, d)
  int sq, sk;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 32 : 64;
  static constexpr int kLd = D + 4;                  // a staged row, floats
  static constexpr int kPLd = kBlockK + 1;           // a row of p or ds
  static constexpr int kRQ = kBlockQ / 16;           // score rows a thread
  static constexpr int kRK = kBlockK / 16;           // score keys a thread
  static constexpr int kCW = D >= 64 ? 4 : D / 16;   // columns a group
  static constexpr int kNB = D / (16 * kCW);         // groups a thread
  static constexpr int kCols = kCW * kNB;            // columns a thread
  // q, dout, k, v; p, ds; lse, delta
  static constexpr int kSmem =
      ((2 * kBlockQ + 2 * kBlockK) * kLd + 2 * kBlockQ * kPLd +
       2 * kBlockQ) * static_cast<int>(sizeof(float));
};

__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* src) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(src));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// rows [row0, row0 + n) of a (rows, D) matrix into shared memory as
// float32 (times ``mul`` where ``scaled``), row stride D + 4; rows past
// ``rows`` are zeros
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int row0,
                                      int n, int rows, float mul,
                                      bool scaled) {
  constexpr int kPieces = D / 4;
  constexpr int kLd = D + 4;
  for (int t = threadIdx.x; t < n * kPieces; t += kThreads) {
    const int r = t / kPieces;
    const int piece = t % kPieces;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = load4(src + (size_t)(row0 + r) * D + 4 * piece);
      if (scaled) {
        val.x = __fmul_rn(val.x, mul);
        val.y = __fmul_rn(val.y, mul);
        val.z = __fmul_rn(val.z, mul);
        val.w = __fmul_rn(val.w, mul);
      }
    }
    *reinterpret_cast<float4*>(dst + r * kLd + 4 * piece) = val;
  }
}

// lse and delta of the q tile's rows (0 past Sq)
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const Args& p, size_t bh,
                                           int q0) {
  for (int t = threadIdx.x; t < kBlockQ; t += kThreads) {
    const bool in = q0 + t < p.sq;
    lse_s[t] = in ? p.lse[bh * p.sq + q0 + t] : 0.f;
    delta_s[t] = in ? p.delta[bh * p.sq + q0 + t] : 0.f;
  }
}

// p and ds of the staged (q tile at q0, kv tile at kb) into shared memory:
// thread (hi, lo) computes rows hi + 16 r and keys lo + 16 c
template <int D>
__device__ __forceinline__ void scores(const float* qs, const float* dos,
                                       const float* ks, const float* vs,
                                       const float* lse_s,
                                       const float* delta_s, float* ps,
                                       float* dss, const Args& p, int q0,
                                       int kb, int hi, int lo) {
  using T = Tile<D>;
  float s[T::kRQ][T::kRK], dp[T::kRQ][T::kRK];
#pragma unroll
  for (int r = 0; r < T::kRQ; ++r) {
#pragma unroll
    for (int c = 0; c < T::kRK; ++c) {
      s[r][c] = 0.f;
      dp[r][c] = 0.f;
    }
  }
#pragma unroll 2
  for (int dd = 0; dd < D; dd += 4) {
    float4 qv[T::kRQ], ov[T::kRQ];
#pragma unroll
    for (int r = 0; r < T::kRQ; ++r) {
      qv[r] = *reinterpret_cast<const float4*>(qs + (hi + 16 * r) * T::kLd +
                                               dd);
      ov[r] = *reinterpret_cast<const float4*>(dos + (hi + 16 * r) * T::kLd +
                                               dd);
    }
#pragma unroll
    for (int c = 0; c < T::kRK; ++c) {
      const float4 kv =
          *reinterpret_cast<const float4*>(ks + (lo + 16 * c) * T::kLd + dd);
      const float4 vv =
          *reinterpret_cast<const float4*>(vs + (lo + 16 * c) * T::kLd + dd);
#pragma unroll
      for (int r = 0; r < T::kRQ; ++r) {
        float a = s[r][c];
        a = fmaf(qv[r].x, kv.x, a);
        a = fmaf(qv[r].y, kv.y, a);
        a = fmaf(qv[r].z, kv.z, a);
        a = fmaf(qv[r].w, kv.w, a);
        s[r][c] = a;
        float b = dp[r][c];
        b = fmaf(ov[r].x, vv.x, b);
        b = fmaf(ov[r].y, vv.y, b);
        b = fmaf(ov[r].z, vv.z, b);
        b = fmaf(ov[r].w, vv.w, b);
        dp[r][c] = b;
      }
    }
  }
  const int offset = p.sk - p.sq;
#pragma unroll
  for (int r = 0; r < T::kRQ; ++r) {
    const int i = hi + 16 * r;
    const int q_pos = q0 + i + offset;
#pragma unroll
    for (int c = 0; c < T::kRK; ++c) {
      const int j = lo + 16 * c;
      const int k_pos = kb + j;
      const bool ok = q0 + i < p.sq && k_pos < p.sk &&
                      (!p.causal || k_pos <= q_pos) &&
                      (!p.has_window || k_pos > q_pos - p.window);
      float x = s[r][c];
      float dcap = 1.f;
      if (p.has_softcap) {
        const float t = tanhf(x / p.softcap);
        x = __fmul_rn(p.softcap, t);
        dcap = 1.f - t * t;
      }
      const float pr = ok ? expf(x - lse_s[i]) : 0.f;
      float ds = pr * (dp[r][c] - delta_s[i]);
      if (p.has_softcap) ds *= dcap;
      ps[i * T::kPLd + j] = pr;
      dss[i * T::kPLd + j] = ds;
    }
  }
}

// the dK / dV launch: block (x, y) owns keys [x kBlockK, (x + 1) kBlockK)
// of head y and sweeps the q tiles that can see them
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv(const __grid_constant__ Args p) {
  using T = Tile<D>;
  constexpr int BK = T::kBlockK;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBlockQ * T::kLd;
  float* ks = dos + kBlockQ * T::kLd;
  float* vs = ks + BK * T::kLd;
  float* ps = vs + BK * T::kLd;
  float* dss = ps + kBlockQ * T::kPLd;
  float* lse_s = dss + kBlockQ * T::kPLd;
  float* delta_s = lse_s + kBlockQ;

  const int hi = threadIdx.x / 16;
  const int lo = threadIdx.x % 16;
  const int kb = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const E* q = static_cast<const E*>(p.q) + bh * p.sq * D;
  const E* k = static_cast<const E*>(p.k) + bh * p.sk * D;
  const E* v = static_cast<const E*>(p.v) + bh * p.sk * D;
  const E* dout = static_cast<const E*>(p.dout) + bh * p.sq * D;

  stage<D>(ks, k, kb, BK, p.sk, 1.f, false);
  stage<D>(vs, v, kb, BK, p.sk, 1.f, false);

  float dk[T::kRK][T::kCols], dv[T::kRK][T::kCols];
#pragma unroll
  for (int a = 0; a < T::kRK; ++a) {
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) {
      dk[a][c] = 0.f;
      dv[a][c] = 0.f;
    }
  }

  // the q rows some key of this tile is visible to
  const int offset = p.sk - p.sq;
  const int row_begin = p.causal ? max(0, kb - offset) : 0;
  const int row_end =
      p.has_window ? min(p.sq, max(0, kb + BK - 1 + p.window - offset))
                   : p.sq;
  for (int q0 = row_begin / kBlockQ * kBlockQ; q0 < row_end;
       q0 += kBlockQ) {
    __syncthreads();                  // the previous q tile has been read
    stage<D>(qs, q, q0, kBlockQ, p.sq, p.scale, true);
    stage<D>(dos, dout, q0, kBlockQ, p.sq, 1.f, false);
    stage_rows(lse_s, delta_s, p, bh, q0);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, p, q0, kb, hi, lo);
    __syncthreads();
    // dv[j] += sum_i p[i, j] dout[i]; dk[j] += sum_i ds[i, j] q_scaled[i]
#pragma unroll 4
    for (int i = 0; i < kBlockQ; ++i) {
      float pa[T::kRK], da[T::kRK];
#pragma unroll
      for (int a = 0; a < T::kRK; ++a) {
        pa[a] = ps[i * T::kPLd + hi + 16 * a];
        da[a] = dss[i * T::kPLd + hi + 16 * a];
      }
#pragma unroll
      for (int b = 0; b < T::kNB; ++b) {
        const int col = T::kCW * (lo + 16 * b);
        float ov[T::kCW], qv[T::kCW];
#pragma unroll
        for (int e = 0; e < T::kCW; ++e) {
          ov[e] = dos[i * T::kLd + col + e];
          qv[e] = qs[i * T::kLd + col + e];
        }
#pragma unroll
        for (int a = 0; a < T::kRK; ++a) {
#pragma unroll
          for (int e = 0; e < T::kCW; ++e) {
            dv[a][b * T::kCW + e] = fmaf(pa[a], ov[e],
                                         dv[a][b * T::kCW + e]);
            dk[a][b * T::kCW + e] = fmaf(da[a], qv[e],
                                         dk[a][b * T::kCW + e]);
          }
        }
      }
    }
  }

  E* dko = static_cast<E*>(p.dk) + bh * p.sk * D;
  E* dvo = static_cast<E*>(p.dv) + bh * p.sk * D;
#pragma unroll
  for (int a = 0; a < T::kRK; ++a) {
    const int j = kb + hi + 16 * a;
    if (j >= p.sk) continue;
#pragma unroll
    for (int b = 0; b < T::kNB; ++b) {
      const int col = T::kCW * (lo + 16 * b);
#pragma unroll
      for (int e = 0; e < T::kCW; ++e) {
        store(dko + (size_t)j * D + col + e, dk[a][b * T::kCW + e]);
        store(dvo + (size_t)j * D + col + e, dv[a][b * T::kCW + e]);
      }
    }
  }
}

// the dQ launch: block (x, y) owns query rows [x kBlockQ, (x + 1) kBlockQ)
// of head y and sweeps the kv tiles they can see
template <int D, typename E>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq(const __grid_constant__ Args p) {
  using T = Tile<D>;
  constexpr int BK = T::kBlockK;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBlockQ * T::kLd;
  float* ks = dos + kBlockQ * T::kLd;
  float* vs = ks + BK * T::kLd;
  float* ps = vs + BK * T::kLd;
  float* dss = ps + kBlockQ * T::kPLd;
  float* lse_s = dss + kBlockQ * T::kPLd;
  float* delta_s = lse_s + kBlockQ;

  const int hi = threadIdx.x / 16;
  const int lo = threadIdx.x % 16;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const E* q = static_cast<const E*>(p.q) + bh * p.sq * D;
  const E* k = static_cast<const E*>(p.k) + bh * p.sk * D;
  const E* v = static_cast<const E*>(p.v) + bh * p.sk * D;
  const E* dout = static_cast<const E*>(p.dout) + bh * p.sq * D;

  stage<D>(qs, q, q0, kBlockQ, p.sq, p.scale, true);
  stage<D>(dos, dout, q0, kBlockQ, p.sq, 1.f, false);
  stage_rows(lse_s, delta_s, p, bh, q0);

  float dq[T::kRQ][T::kCols];
#pragma unroll
  for (int a = 0; a < T::kRQ; ++a) {
#pragma unroll
    for (int c = 0; c < T::kCols; ++c) dq[a][c] = 0.f;
  }

  // the keys some row of this tile may see (the forward's range)
  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;
  const int q_hi = min(q0 + kBlockQ, p.sq) - 1 + offset;
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;
  for (int kb = k_begin / BK * BK; kb < k_end; kb += BK) {
    __syncthreads();                  // the previous kv tile has been read
    stage<D>(ks, k, kb, BK, p.sk, 1.f, false);
    stage<D>(vs, v, kb, BK, p.sk, 1.f, false);
    __syncthreads();
    scores<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, p, q0, kb, hi, lo);
    __syncthreads();
    // dq[i] += sum_j ds[i, j] k[j] (times scale at the end)
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float da[T::kRQ];
#pragma unroll
      for (int a = 0; a < T::kRQ; ++a) {
        da[a] = dss[(hi + 16 * a) * T::kPLd + j];
      }
#pragma unroll
      for (int b = 0; b < T::kNB; ++b) {
        const int col = T::kCW * (lo + 16 * b);
        float kv[T::kCW];
#pragma unroll
        for (int e = 0; e < T::kCW; ++e) kv[e] = ks[j * T::kLd + col + e];
#pragma unroll
        for (int a = 0; a < T::kRQ; ++a) {
#pragma unroll
          for (int e = 0; e < T::kCW; ++e) {
            dq[a][b * T::kCW + e] = fmaf(da[a], kv[e],
                                         dq[a][b * T::kCW + e]);
          }
        }
      }
    }
  }

  E* dqo = static_cast<E*>(p.dq) + bh * p.sq * D;
#pragma unroll
  for (int a = 0; a < T::kRQ; ++a) {
    const int i = q0 + hi + 16 * a;
    if (i >= p.sq) continue;
#pragma unroll
    for (int b = 0; b < T::kNB; ++b) {
      const int col = T::kCW * (lo + 16 * b);
#pragma unroll
      for (int e = 0; e < T::kCW; ++e) {
        store(dqo + (size_t)i * D + col + e,
              __fmul_rn(dq[a][b * T::kCW + e], p.scale));
      }
    }
  }
}

template <int D, typename E>
int launch(const Args& p, int bh, cudaStream_t st) {
  using T = Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv<D, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq<D, E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.sk > 0) {
    const dim3 grid((p.sk + T::kBlockK - 1) / T::kBlockK, bh);
    flash_bwd_dkv<D, E><<<grid, kThreads, T::kSmem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.sq > 0) {
    const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, bh);
    flash_bwd_dq<D, E><<<grid, kThreads, T::kSmem, st>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

template <typename E>
int launch_d(const Args& p, int bh, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch<16, E>(p, bh, st);
    case 32: return launch<32, E>(p, bh, st);
    case 64: return launch<64, E>(p, bh, st);
    case 128: return launch<128, E>(p, bh, st);
    case 256: return launch<256, E>(p, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
void tiling(int* block_q, int* block_k, int* smem_bytes) {
  *block_q = kBlockQ;
  *block_k = Tile<D>::kBlockK;
  *smem_bytes = Tile<D>::kSmem;
}

}  // namespace

// query rows and keys a block takes per tile, and the dynamic shared
// memory a block of either launch asks for, at head width d; returns 0, or
// an error for another d
extern "C" int flash_attention_bwd_tiling(int d, int* block_q, int* block_k,
                                          int* smem_bytes) {
  switch (d) {
    case 16: tiling<16>(block_q, block_k, smem_bytes); return 0;
    case 32: tiling<32>(block_q, block_k, smem_bytes); return 0;
    case 64: tiling<64>(block_q, block_k, smem_bytes); return 0;
    case 128: tiling<128>(block_q, block_k, smem_bytes); return 0;
    case 256: tiling<256>(block_q, block_k, smem_bytes); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, dout (bh, sq, d), k, v (bh, sk, d), float32 (bf16 = 0) or bfloat16
// (bf16 = 1); lse, delta (bh, sq) float32; dq (bh, sq, d), dk, dv (bh, sk,
// d) in the inputs' type, every one written. All contiguous, 16-byte
// aligned; d one of 16, 32, 64, 128, 256; bh <= 65535. Two launches on
// ``stream``: dK / dV, then dQ.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, void* dk, void* dv,
    int bh, int sq, int sk, int d, int bf16, int causal, int has_window,
    int window, int has_softcap, float softcap, float scale, void* stream) {
  Args p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  if (bh <= 0 || (sq <= 0 && sk <= 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(p, bh, d, st)
              : launch_d<float>(p, bh, d, st);
}
