// The backward of flash attention on Hopper (sm_90a): dQ, dK and dV of the
// causal, windowed and softcapped attention of csrc/flash_attention.cu, in
// two launches and no atomics. bfloat16 inputs run on the tensor cores
// (wgmma on tiles staged by TMA); float32 inputs run an FMA body.
//
// Replaces no Pallas kernel: the TPU path differentiates its attention with
// nn/flash.py::_bwd, the custom VJP of flash_mha, in jnp outside any kernel.
// The port's forward is a hand-written kernel, so its backward is one too.
// For q (BH, Sq, D), k and v (BH, Sk, D), the forward's out and the
// output's gradient dout (BH, Sq, D), float32 or bfloat16, and the
// forward's row log-sum-exp lse (BH, Sq) float32, with scale = 1 / sqrt(D):
//
//   s[i, j]  = sum_d (q[i, d] * scale) k[j, d]
//   s[i, j]  = cap * tanh(s[i, j] / cap),  dcap = 1 - tanh^2   with a softcap
//   p[i, j]  = exp(s[i, j] - lse[i])  on visible keys (the forward's masks,
//              end-aligned), 0 elsewhere and on rows past Sq
//   delta[i] = sum_d dout[i, d] out[i, d]
//   dp[i, j] = sum_d dout[i, d] v[j, d]
//   ds[i, j] = p[i, j] (dp[i, j] - delta[i]) (* dcap)
//   dv[j]    = sum_i p[i, j] dout[i]
//   dk[j]    = sum_i ds[i, j] (q[i] * scale)
//   dq[i]    = sum_j ds[i, j] k[j] * scale
//
// as _bwd computes them; a row that sees no key gets zero gradients. The
// outputs have the inputs' dtype (bfloat16 rounded to nearest even).
//
// The reference accumulates dq, dk and dv over one (q block, kv block)
// schedule into whole-sequence carries. On the card that order would need
// atomics across blocks. Instead two launches each own what they write:
//   * dQ, first: a block owns query rows and sweeps the kv tiles they can
//     see, as the forward does. It also computes delta for its rows (float32,
//     in a fixed order), and writes each row's lse and delta to ``stats``
//     (BH, 2, Sq_pad), Sq_pad = Sq rounded up to 64, rows past Sq as 0;
//   * dK / dV, after it on the stream: a block owns a tile of keys of one
//     (b, h), keeps its dK and dV in registers, and sweeps the q tiles that
//     can see those keys (causal: from the tile's first key on; window: up
//     to its last key plus the window), reading lse and delta from
//     ``stats``.
// Each recomputes s, p, dp and ds for its pairs, so the (q, k) pairs cost
// 7 D multiply-adds in all (s, dp and dV or dQ in each launch, dK in one)
// against the 5 D of a backward that shares them through atomics: the price of sums in a fixed
// order, the same bits every run.
//
// What bounds it on an H100. Per visible (query, key) pair the backward
// needs 10 D operations (its five products of D multiply-adds: s, dp, dq,
// dk and dv); the bytes are q, k, v, out, dout and lse read once and dq,
// dk, dv written once. At qwen1.5-0.5b's training shape (B=8, H=16,
// S=2048, D=64, causal, bf16) that is 172 GFLOP against 269 MB: operations
// bound, 0.174 ms at bf16's 989 TFLOP/s on the tensor cores.
//
// bfloat16: the tensor-core kernels (namespace tc), 256 threads, two
// consumer warpgroups, no producer warp:
//   * dQ: a warpgroup owns 64 query rows (a block 128); K and V tiles of 64
//     keys reach shared memory by TMA through 3-d tensor maps (BH, S, D), in
//     boxes of 64 columns with a 128-byte swizzle (at D = 16 and 32 one box
//     of the row, 32- and 64-byte swizzle), in a ring of kStages stages;
//     Q and dO are loaded once. S = Q K^T and dP = dO V^T by wgmma
//     m64n64k16, both operands K-major from shared memory; dQ += dS K by
//     wgmma with A from registers (the score accumulator's layout is the A
//     fragment's) and B the staged K tile read MN-major.
//   * dK / dV: a warpgroup owns 64 keys (a block 128), K and V loaded once;
//     Q and dO tiles of 64 rows and the rows' lse and delta (two 256-byte
//     bulk copies) come through the ring. S^T = K Q^T and dP^T = V dO^T
//     (wgmma m64n64k16, K-major); then p and ds on the accumulator
//     fragments, lse and delta by column from shared memory; dV += P^T dO
//     and dK += dS^T Q by wgmma from registers, the staged dO / Q tile read
//     MN-major (the K-major descriptor of the same tile served S^T).
//   * D = 256: dK and dV of 64 keys over 256 columns (or dQ with its
//     scores) do not fit one warpgroup's registers, so both warpgroups own
//     the same 64 rows or keys and each accumulates half of the columns;
//     each computes the whole S and dP (the two score products run twice
//     at this width). The ring has two stages there (shared memory).
//     At D = 128 the dK / dV kernel holds 128 accumulator registers a
//     thread and ptxas spills ~200 bytes; owning the same keys in both
//     warpgroups there too removes the spill but ran 1.5-1.8x slower
//     (experiments/flash_bwd_breakdown.py, split_d128).
//   * The ring, without atomics: each stage has a full mbarrier (TMA's
//     bytes) and an empty one that each warpgroup arrives on once it is
//     done with the stage (after its own named barrier). Thread 0 refills:
//     with three stages the stage of the tile before the one it just
//     finished (kLag = 1: the other warpgroup is then almost surely done
//     with it, and the load still has a tile's time to land), with two the
//     stage it just finished. No warp of the block only loads.
//   * Rounding: P and dS enter the tensor cores as one bf16 term each
//     (kTerms = 1, round to nearest even), where the forward splits P in
//     two (hi + lo). One term is what the 2^-7 tolerance asks: each
//     gradient rounds to bf16 on both sides, so the tolerance admits one
//     bf16 unit, and one term's error (at most 2^-8 of each probability,
//     signs mixed over the keys) stays under a unit. On an H100 it passed
//     every case and seed tried: phase 10's six bf16 cases x 3 seeds and
//     the CPU test's seven small cases x 8 (experiments/
//     flash_bwd_breakdown.py accuracy), at up to 0.985 of the tolerance;
//     two terms read up to 0.60 of it, run the register-A products twice
//     (10 D operations a pair where one term needs 7) and took 13-22%
//     more time at phase 10's four bf16 training shapes (the breakdown's
//     two_terms).
//   * Scale, softcap and mask are passes of their own behind one uniform
//     branch each (the forward found a branch per element ~1.9x slower);
//     masks run only on tiles that straddle the diagonal, the window's edge
//     or a ragged end. q is staged raw: s = (q . k) * scale, and dK is
//     scaled once at the end, as dQ is.
//   * Blocks start head group by head group (8 heads), the heaviest tiles
//     of a group under a causal mask first: the dQ launch's last q tiles,
//     the dK / dV launch's first key tiles.
//
// float32: the FMA body, float32 throughout, no TF32:
//   * tiles staged in shared memory, rows padded by 4 floats: q (scaled by 1/sqrt(D) as it is staged),
//     dout, k and v; p and ds of the current (q tile, kv tile) in shared
//     memory too, with lse and delta of the q tile;
//   * thread (hi, lo) = (tid / 16, tid % 16) computes the scores of rows
//     hi + 16 r and keys lo + 16 c, then accumulates dK / dV of keys
//     hi + 16 a (dkv) or dQ of rows hi + 16 a (dq) over column groups
//     lo + 16 b of kCW columns, in registers;
//   * kBlockQ = 64, kBlockK = 64 keys (32 at D = 256).
//   Its dQ launch computes delta (four threads a row) and writes ``stats``
//   as the tensor-core one does.
//
// tanhf, not the fast intrinsic (its ~2^-11 would move a capped score by
// up to cap 2^-11). The exponential: expf in the FMA body; the tensor-core
// kernels take 2^((s - lse) log2 e) by ex2.approx (relative error ~2^-22,
// far below the bf16 terms' 2^-17), which saved 6-10% of the call at
// phase 10's bf16 shapes against expf (experiments/flash_bwd_breakdown.py,
// accurate_exp). The launchers
// return a CUDA error code (cudaGetLastError() after each launch); they
// allocate nothing and do not synchronise. The tensor maps are built with
// cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kPad = 64;      // Sq_pad: Sq rounded up to this

struct Args {
  const void* q;        // (bh, sq, d)
  const void* k;        // (bh, sk, d)
  const void* v;        // (bh, sk, d)
  const void* out;      // (bh, sq, d): the forward's output
  const void* dout;     // (bh, sq, d)
  const float* lse;     // (bh, sq)
  float* stats;         // (bh, 2, sq_pad): lse and delta, by the dQ launch
  void* dq;             // (bh, sq, d), q's dtype
  void* dk;             // (bh, sk, d)
  void* dv;             // (bh, sk, d)
  int sq, sk, sq_pad;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// --- float32: the FMA body -----------------------------------------------

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

// rows [row0, row0 + n) of a (rows, D) matrix into shared memory as
// float32 (times ``mul`` where ``scaled``), row stride D + 4; rows past
// ``rows`` are zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
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

// lse and delta of the q tile's rows (0 past Sq), as the dQ launch wrote
// them into ``stats``
__device__ __forceinline__ void stage_rows(float* lse_s, float* delta_s,
                                           const Args& p, size_t bh,
                                           int q0) {
  for (int t = threadIdx.x; t < kBlockQ; t += kThreads) {
    lse_s[t] = p.stats[bh * 2 * p.sq_pad + q0 + t];
    delta_s[t] = p.stats[(bh * 2 + 1) * p.sq_pad + q0 + t];
  }
}

// delta of the q tile's rows from out and dout, four threads a row in a
// fixed order, into delta_s; lse and delta into ``stats`` (rows < Sq_pad)
template <int D>
__device__ __forceinline__ void row_deltas(float* lse_s, float* delta_s,
                                           const Args& p, size_t bh,
                                           int q0) {
  static_assert(kThreads == 4 * kBlockQ, "four threads a row");
  const int r = threadIdx.x / 4;
  const int part = threadIdx.x % 4;
  const int row = q0 + r;
  float acc = 0.f;
  if (row < p.sq) {
    const float* o = static_cast<const float*>(p.out) + (bh * p.sq + row) * D;
    const float* g = static_cast<const float*>(p.dout) + (bh * p.sq + row) * D;
    for (int c = 4 * part; c < D; c += 16) {
      const float4 a = load4(o + c);
      const float4 b = load4(g + c);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    const float lse = row < p.sq ? p.lse[bh * p.sq + row] : 0.f;
    lse_s[r] = lse;
    delta_s[r] = acc;
    if (row < p.sq_pad) {
      p.stats[bh * 2 * p.sq_pad + row] = lse;
      p.stats[(bh * 2 + 1) * p.sq_pad + row] = acc;
    }
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
template <int D>
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
  const float* q = static_cast<const float*>(p.q) + bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + bh * p.sk * D;
  const float* dout = static_cast<const float*>(p.dout) + bh * p.sq * D;

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

  float* dko = static_cast<float*>(p.dk) + bh * p.sk * D;
  float* dvo = static_cast<float*>(p.dv) + bh * p.sk * D;
#pragma unroll
  for (int a = 0; a < T::kRK; ++a) {
    const int j = kb + hi + 16 * a;
    if (j >= p.sk) continue;
#pragma unroll
    for (int b = 0; b < T::kNB; ++b) {
      const int col = T::kCW * (lo + 16 * b);
#pragma unroll
      for (int e = 0; e < T::kCW; ++e) {
        dko[(size_t)j * D + col + e] = dk[a][b * T::kCW + e];
        dvo[(size_t)j * D + col + e] = dv[a][b * T::kCW + e];
      }
    }
  }
}

// the dQ launch: block (x, y) owns query rows [x kBlockQ, (x + 1) kBlockQ)
// of head y and sweeps the kv tiles they can see
template <int D>
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
  const float* q = static_cast<const float*>(p.q) + bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + bh * p.sk * D;
  const float* dout = static_cast<const float*>(p.dout) + bh * p.sq * D;

  stage<D>(qs, q, q0, kBlockQ, p.sq, p.scale, true);
  stage<D>(dos, dout, q0, kBlockQ, p.sq, 1.f, false);
  row_deltas<D>(lse_s, delta_s, p, bh, q0);

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

  float* dqo = static_cast<float*>(p.dq) + bh * p.sq * D;
#pragma unroll
  for (int a = 0; a < T::kRQ; ++a) {
    const int i = q0 + hi + 16 * a;
    if (i >= p.sq) continue;
#pragma unroll
    for (int b = 0; b < T::kNB; ++b) {
      const int col = T::kCW * (lo + 16 * b);
#pragma unroll
      for (int e = 0; e < T::kCW; ++e) {
        dqo[(size_t)i * D + col + e] =
            __fmul_rn(dq[a][b * T::kCW + e], p.scale);
      }
    }
  }
}

// the FMA body's two launches: dQ (and stats), then dK / dV
template <int D>
int fma_launch(const Args& p, int bh, cudaStream_t st) {
  using T = Tile<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.sq > 0) {
    const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, bh);
    flash_bwd_dq<D><<<grid, kThreads, T::kSmem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.sk > 0) {
    const dim3 grid((p.sk + T::kBlockK - 1) / T::kBlockK, bh);
    flash_bwd_dkv<D><<<grid, kThreads, T::kSmem, st>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

int fma_launch_d(const Args& p, int bh, int d, cudaStream_t st) {
  switch (d) {
    case 16: return fma_launch<16>(p, bh, st);
    case 32: return fma_launch<32>(p, bh, st);
    case 64: return fma_launch<64>(p, bh, st);
    case 128: return fma_launch<128>(p, bh, st);
    case 256: return fma_launch<256>(p, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- bfloat16: the tensor-core kernels -------------------------------------

namespace tc {

using namespace hopper;

constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kRows = 64;         // rows of a warpgroup's accumulator
constexpr int kTile = 64;         // keys (dQ) or query rows (dK / dV) a stage
constexpr int kHeadGroup = 8;     // heads whose tiles start together
constexpr int kTerms = 1;         // bf16 terms of P and dS in the products

template <int D>
struct Cfg {
  static constexpr int kBoxCols = D < 64 ? D : 64;      // columns per box
  static constexpr int kRowBytes = 2 * kBoxCols;        // a box row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr Swizzle kSwizzle = swizzle_of(kRowBytes);
  // D = 256: both warpgroups own the same rows, each half the columns
  static constexpr bool kSplit = D == 256;
  static constexpr int kOwn = kSplit ? kRows : 2 * kRows;   // rows a block
  static constexpr int kCols = kSplit ? D / 2 : D;          // a warpgroup's
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kLag = kStages >= 3 ? 1 : 0;
  static constexpr int kOwnBytes = kOwn * D * 2;        // one owned tile
  static constexpr int kTileBytes = kTile * D * 2;      // one staged tile
  static constexpr int kStatBytes = 2 * kTile * 4;      // lse, delta a stage
  // the owned pair (Q, dO or K, V), the stages' pairs, the dK / dV
  // launch's stats, then the full / empty barriers and the owned pair's;
  // 1024 bytes of slack to align the start to the swizzle's atom
  static constexpr int kSmem = 1024 + 2 * kOwnBytes +
                               kStages * (2 * kTileBytes + kStatBytes) +
                               8 * (2 * kStages + 1);
};

// a K-major operand of a tile whose boxes hold ``rows`` rows, at k step kk
// (16 columns): box kk * 16 / kBoxCols, then 32 bytes a step in its row
template <int D>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int rows, int kk) {
  using C = Cfg<D>;
  const int box = kk * 16 / C::kBoxCols;
  const int off = (kk * 16 % C::kBoxCols) * 2;
  return desc(tile + box * rows * C::kRowBytes + off, 16, 8 * C::kRowBytes,
              C::kSwizzle);
}

// the same tile as an MN-major B operand (its rows are the product's k),
// k step kk: lbo steps from one 64-column box to the next, sbo from 8 rows
// to the next 8
template <int D>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile,
                                            int rows, int kk) {
  using C = Cfg<D>;
  return desc(tile + kk * 16 * C::kRowBytes, rows * C::kRowBytes,
              8 * C::kRowBytes, C::kSwizzle);
}

// rows [row0, row0 + rows) of a (BH, S, D) tensor map into ``dst``, box by
// box; the barrier counts the bytes
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0,
                                          int bh) {
  using C = Cfg<D>;
  for (int b = 0; b < C::kBoxes; ++b) {
    tma_load_3d(dst + b * rows * C::kRowBytes, map, bar, b * C::kBoxCols,
                row0, bh);
  }
}

// a 64 x 64 accumulator in kTerms bf16 terms (the first rounded to
// nearest even, each next one what the terms before it miss), laid out as
// the A fragments of the four k steps of a product over its columns:
// register r of step kk holds elements 8 kk + 2 r and 8 kk + 2 r + 1
__device__ __forceinline__ void to_frags(const float (&x)[32],
                                         uint32_t (&a)[kTerms][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float e0 = x[8 * kk + 2 * r];
      float e1 = x[8 * kk + 2 * r + 1];
#pragma unroll
      for (int n = 0; n < kTerms; ++n) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(e0, e1);
        a[n][kk][r] = *reinterpret_cast<const uint32_t*>(&h);
        e0 -= __low2float(h);
        e1 -= __high2float(h);
      }
    }
  }
}

// d += A B over 64 k rows, A in its kTerms terms, B the kTile-row staged
// ``tile`` (from the warpgroup's first column) read MN-major; issued, not
// waited
template <int D>
__device__ __forceinline__ void product_rs(float (&d)[Cfg<D>::kCols / 2],
                                           const uint32_t (&a)[kTerms][4][4],
                                           const unsigned char* tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t b = mnmajor<D>(tile, kTile, kk);
#pragma unroll
    for (int n = 0; n < kTerms; ++n) {
      wgmma_rs<Cfg<D>::kCols>(d, a[n][kk], b);
    }
  }
}

// the block's (bh, tile) from its id: heads in groups of kHeadGroup, a
// group's tiles from the heaviest (``last_first``: the last) to the
// lightest, its heads side by side
__device__ __forceinline__ void schedule(int& bh, int& tile,
                                         bool last_first) {
  const int tiles = gridDim.y;
  const int id = blockIdx.x + blockIdx.y * gridDim.x;
  const int g0 = id / (kHeadGroup * tiles) * kHeadGroup;
  const int g = min(kHeadGroup, static_cast<int>(gridDim.x) - g0);
  bh = g0 + (id - g0 * tiles) % g;
  const int t = (id - g0 * tiles) / g;
  tile = last_first ? tiles - 1 - t : t;
}

// a warpgroup is done with tile j's stage: its threads meet on their named
// barrier and one arrives on the stage's empty barrier; then thread 0
// refills the stage of tile j - kLag, once both warpgroups have released
// it, with tile j - kLag + kStages (``load(t)``)
template <int D, typename Load>
__device__ __forceinline__ void release(uint64_t* empty, int j, int tiles,
                                        Load&& load) {
  using C = Cfg<D>;
  const int tid = threadIdx.x;
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + tid / 128) : "memory");
  if (tid % 128 == 0) mbar_arrive(&empty[j % C::kStages]);
  const int r = j - C::kLag;
  if (tid == 0 && r >= 0 && r + C::kStages < tiles) {
    mbar_wait(&empty[r % C::kStages], (r / C::kStages) & 1);
    fence_proxy_async();
    load(r + C::kStages);
  }
  __syncwarp();
}

// 2^x by the special function unit (ex2.approx; subnormals flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// p = exp(s - lse) and ds = p (dp - delta) (* dcap) on a 64 x 64 score
// accumulator pair, each a pass behind one uniform branch; ``lse`` and
// ``delta`` give element i's row statistics
template <typename Lse, typename Delta>
__device__ __forceinline__ void grads_of_scores(float (&s)[32],
                                                float (&dp)[32],
                                                const Args& p, Lse&& lse,
                                                Delta&& delta) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= p.scale;
  if (p.has_softcap) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float t = tanhf(s[i] / p.softcap);
      s[i] = __fmul_rn(p.softcap, t);
      dp[i] = (dp[i] - delta(i)) * (1.f - t * t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] -= delta(i);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = exp2_approx((s[i] - lse(i)) * kLog2e);
    dp[i] *= s[i];
  }
}

// the dQ launch: a block owns kOwn query rows of one (b, h) and sweeps the
// kv tiles they can see; it computes delta for its rows first
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dos = qs + C::kOwnBytes;
  unsigned char* ks = dos + C::kOwnBytes;              // stage s at s * kTile
  unsigned char* vs = ks + S * C::kTileBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + S * C::kTileBytes +
                                               S * C::kStatBytes);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int bh, tile;
  schedule(bh, tile, true);
  const int q0 = tile * C::kOwn;
  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                                // first row
  const int q_hi = min(q0 + C::kOwn, p.sq) - 1 + offset;       // last row
  // the keys some row of this block may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;
  const int kb0 = k_begin / kTile * kTile;
  const int tiles = k_end > kb0 ? (k_end - kb0 + kTile - 1) / kTile : 0;

  auto load_kv = [&](int j) {
    const int st = j % S;
    mbar_expect_tx(&full[st], 2 * C::kTileBytes);
    load_tile<D>(ks + st * C::kTileBytes, &tk, &full[st], kTile,
                 kb0 + j * kTile, bh);
    load_tile<D>(vs + st * C::kTileBytes, &tv, &full[st], kTile,
                 kb0 + j * kTile, bh);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
    if (tiles > 0) {
      mbar_expect_tx(qbar, 2 * C::kOwnBytes);
      load_tile<D>(qs, &tq, qbar, C::kOwn, q0, bh);
      load_tile<D>(dos, &tdo, qbar, C::kOwn, q0, bh);
      for (int j = 0; j < S && j < tiles; ++j) load_kv(j);
    }
  }
  __syncthreads();

  // this thread's two rows (of the accumulators' layout), in the block
  const int own = C::kSplit ? 0 : 64 * wg;     // the warpgroup's first row
  const int row0 = own + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);               // first column of a chunk
  const int col0 = C::kSplit ? wg * C::kCols : 0;   // the dQ columns held

  // delta = rowsum(dout * out) of the two rows (f32, columns in a fixed
  // order, then the row's four lanes), and lse; one warpgroup writes both
  // to stats (rows < Sq_pad; 0 past Sq)
  float lse[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    float acc = 0.f;
    if (row < p.sq) {
      const size_t base = ((size_t)bh * p.sq + row) * D;
      const __nv_bfloat162* o =
          reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(p.out) + base + c0);
      const __nv_bfloat162* g =
          reinterpret_cast<const __nv_bfloat162*>(
              static_cast<const __nv_bfloat16*>(p.dout) + base + c0);
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const float2 a = __bfloat1622float2(o[4 * c]);
        const float2 b = __bfloat1622float2(g[4 * c]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[h] = acc;
    lse[h] = row < p.sq ? p.lse[(size_t)bh * p.sq + row] : 0.f;
    if ((!C::kSplit || wg == 0) && lane % 4 == 0 && row < p.sq_pad) {
      p.stats[(size_t)bh * 2 * p.sq_pad + row] = lse[h];
      p.stats[((size_t)bh * 2 + 1) * p.sq_pad + row] = delta[h];
    }
  }

  const int qp[2] = {q0 + row0 + offset, q0 + row0 + 8 + offset};
  const int wg_lo = q0 + own + offset;         // the warpgroup's first row
  const unsigned char* qwg = qs + own * C::kRowBytes;
  const unsigned char* dowg = dos + own * C::kRowBytes;
  const int col_bytes = col0 / C::kBoxCols * kTile * C::kRowBytes;

  float dq[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) dq[i] = 0.f;

  if (tiles > 0) {
    mbar_wait(qbar, 0);
    __syncwarp();
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = j % S;
    const int kb = kb0 + j * kTile;
    const unsigned char* kt = ks + st * C::kTileBytes;
    const unsigned char* vt = vs + st * C::kTileBytes;
    mbar_wait(&full[st], (j / S) & 1);
    __syncwarp();                 // wgmma wants the warp converged

    // S = Q K^T and dP = dO V^T on the raw bf16 tiles
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(s, kmajor<D>(qwg, C::kOwn, kk), kmajor<D>(kt, kTile, kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(dp, kmajor<D>(dowg, C::kOwn, kk),
                   kmajor<D>(vt, kTile, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // element i: row h = (i / 2) % 2 of the thread's two
    grads_of_scores(s, dp, p, [&](int i) { return lse[(i / 2) % 2]; },
                    [&](int i) { return delta[(i / 2) % 2]; });
    const bool whole = kb + kTile <= p.sk &&
                       (!p.causal || kb + kTile - 1 <= wg_lo) &&
                       (!p.has_window || kb > wg_lo + 63 - p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int k_pos = kb + 8 * (i / 4) + c0 + i % 2;
        const bool ok = k_pos < p.sk && (!p.causal || k_pos <= qp[h]) &&
                        (!p.has_window || k_pos > qp[h] - p.window);
        dp[i] = ok ? dp[i] : 0.f;
      }
    }
    // dQ += dS K; K (keys x D) read MN-major
    uint32_t ds[kTerms][4][4];
    to_frags(dp, ds);
    wgmma_fence();
    product_rs<D>(dq, ds, kt + col_bytes);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dq);

    release<D>(empty, j, tiles, load_kv);
  }

  // dq * scale, rows < Sq
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.dq) + (size_t)bh * p.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow = out + (size_t)row * D + col0 + c0;
#pragma unroll
    for (int c = 0; c < C::kCols / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(__fmul_rn(dq[4 * c + 2 * h], p.scale),
                                __fmul_rn(dq[4 * c + 2 * h + 1], p.scale));
    }
  }
}

// the dK / dV launch: a block owns kOwn keys of one (b, h) and sweeps the
// q tiles that can see them, lse and delta from the dQ launch's stats
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* vs = ks + C::kOwnBytes;
  unsigned char* qs = vs + C::kOwnBytes;               // stage s at s * kTile
  unsigned char* dos = qs + S * C::kTileBytes;
  float* stats = reinterpret_cast<float*>(dos + S * C::kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + S * 2 * kTile);
  uint64_t* empty = full + S;
  uint64_t* kvbar = empty + S;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int bh, tile;
  schedule(bh, tile, false);
  const int kb = tile * C::kOwn;
  // the q rows some key of this block is visible to
  const int offset = p.sk - p.sq;
  const int row_begin = p.causal ? max(0, kb - offset) : 0;
  const int row_end =
      p.has_window ? min(p.sq, max(0, kb + C::kOwn - 1 + p.window - offset))
                   : p.sq;
  const int qb0 = row_begin / kTile * kTile;
  const int tiles =
      row_end > qb0 ? (row_end - qb0 + kTile - 1) / kTile : 0;

  auto load_q = [&](int j) {
    const int st = j % S;
    const int q0 = qb0 + j * kTile;
    mbar_expect_tx(&full[st], 2 * C::kTileBytes + C::kStatBytes);
    load_tile<D>(qs + st * C::kTileBytes, &tq, &full[st], kTile, q0, bh);
    load_tile<D>(dos + st * C::kTileBytes, &tdo, &full[st], kTile, q0, bh);
    const float* rows = p.stats + (size_t)bh * 2 * p.sq_pad + q0;
    bulk_load(stats + st * 2 * kTile, rows, kTile * 4, &full[st]);
    bulk_load(stats + st * 2 * kTile + kTile, rows + p.sq_pad, kTile * 4,
              &full[st]);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_init(kvbar, 1);
    fence_barrier_init();
    if (tiles > 0) {
      mbar_expect_tx(kvbar, 2 * C::kOwnBytes);
      load_tile<D>(ks, &tk, kvbar, C::kOwn, kb, bh);
      load_tile<D>(vs, &tv, kvbar, C::kOwn, kb, bh);
      for (int j = 0; j < S && j < tiles; ++j) load_q(j);
    }
  }
  __syncthreads();

  // this thread's two keys (the accumulators' rows), in the block
  const int own = C::kSplit ? 0 : 64 * wg;     // the warpgroup's first key
  const int key0 = own + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);               // first column of a chunk
  const int col0 = C::kSplit ? wg * C::kCols : 0;   // the dK / dV columns
  const int kp[2] = {kb + key0, kb + key0 + 8};
  const int wk = kb + own;                     // the warpgroup's first key
  const unsigned char* kwg = ks + own * C::kRowBytes;
  const unsigned char* vwg = vs + own * C::kRowBytes;
  const int col_bytes = col0 / C::kBoxCols * kTile * C::kRowBytes;

  float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  if (tiles > 0) {
    mbar_wait(kvbar, 0);
    __syncwarp();
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = j % S;
    const int q0 = qb0 + j * kTile;
    const unsigned char* qt = qs + st * C::kTileBytes;
    const unsigned char* dot = dos + st * C::kTileBytes;
    const float* lse_s = stats + st * 2 * kTile;
    const float* delta_s = lse_s + kTile;
    mbar_wait(&full[st], (j / S) & 1);
    __syncwarp();                 // wgmma wants the warp converged

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns query rows
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(s, kmajor<D>(kwg, C::kOwn, kk), kmajor<D>(qt, kTile, kk),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<64>(dp, kmajor<D>(vwg, C::kOwn, kk),
                   kmajor<D>(dot, kTile, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // element i: query column 8 (i / 4) + c0 + i % 2 of the tile
    grads_of_scores(
        s, dp, p, [&](int i) { return lse_s[8 * (i / 4) + c0 + i % 2]; },
        [&](int i) { return delta_s[8 * (i / 4) + c0 + i % 2]; });
    const bool whole = q0 + kTile <= p.sq && wk + 64 <= p.sk &&
                       (!p.causal || wk + 63 <= q0 + offset) &&
                       (!p.has_window || wk > q0 + 63 + offset - p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int k_pos = kp[(i / 2) % 2];
        const int row = q0 + 8 * (i / 4) + c0 + i % 2;
        const int q_pos = row + offset;
        const bool ok = row < p.sq && k_pos < p.sk &&
                        (!p.causal || k_pos <= q_pos) &&
                        (!p.has_window || k_pos > q_pos - p.window);
        s[i] = ok ? s[i] : 0.f;
        dp[i] = ok ? dp[i] : 0.f;
      }
    }
    // dV += P^T dO and dK += dS^T Q: dO and Q (query rows x D) read
    // MN-major; dS^T's fragments are made while the dV product runs
    uint32_t pf[kTerms][4][4], dsf[kTerms][4][4];
    to_frags(s, pf);
    wgmma_fence();
    product_rs<D>(dv, pf, dot + col_bytes);
    to_frags(dp, dsf);
    wgmma_fence();
    product_rs<D>(dk, dsf, qt + col_bytes);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(dv);
    fence_regs(dk);

    release<D>(empty, j, tiles, load_q);
  }

  // dk * scale and dv, keys < Sk
  __nv_bfloat16* dko =
      static_cast<__nv_bfloat16*>(p.dk) + (size_t)bh * p.sk * D;
  __nv_bfloat16* dvo =
      static_cast<__nv_bfloat16*>(p.dv) + (size_t)bh * p.sk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kp[h];
    if (key >= p.sk) continue;
    const size_t at = (size_t)key * D + col0 + c0;
#pragma unroll
    for (int c = 0; c < C::kCols / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dko + at + 8 * c) =
          __floats2bfloat162_rn(__fmul_rn(dk[4 * c + 2 * h], p.scale),
                                __fmul_rn(dk[4 * c + 2 * h + 1], p.scale));
      *reinterpret_cast<__nv_bfloat162*>(dvo + at + 8 * c) =
          __floats2bfloat162_rn(dv[4 * c + 2 * h], dv[4 * c + 2 * h + 1]);
    }
  }
}

// dQ (and stats), then dK / dV, on ``st``
template <int D>
int launch(const Args& p, int bh, cudaStream_t st) {
  using C = Cfg<D>;
  // the runtime's calls first: on a thread where no context is current
  // yet (an autograd worker whose first CUDA work this is) they make the
  // device's primary context current, which cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  // each launch's maps: its owned pair in boxes of kOwn rows, the staged
  // pair in boxes of kTile; a side with no rows needs no map
  CUtensorMap q_own{}, do_own{}, k_tile{}, v_tile{};
  CUtensorMap q_tile{}, do_tile{}, k_own{}, v_own{};
  int err = 0;
  if (p.sq > 0) {
    err = encode_bf16_3d(&q_own, p.q, bh, p.sq, D, C::kOwn);
    if (err == 0) err = encode_bf16_3d(&do_own, p.dout, bh, p.sq, D, C::kOwn);
    if (err == 0) err = encode_bf16_3d(&q_tile, p.q, bh, p.sq, D, kTile);
    if (err == 0) {
      err = encode_bf16_3d(&do_tile, p.dout, bh, p.sq, D, kTile);
    }
  }
  if (err == 0 && p.sk > 0) {
    err = encode_bf16_3d(&k_tile, p.k, bh, p.sk, D, kTile);
    if (err == 0) err = encode_bf16_3d(&v_tile, p.v, bh, p.sk, D, kTile);
    if (err == 0) err = encode_bf16_3d(&k_own, p.k, bh, p.sk, D, C::kOwn);
    if (err == 0) err = encode_bf16_3d(&v_own, p.v, bh, p.sk, D, C::kOwn);
  }
  if (err != 0) return err;
  if (p.sq > 0) {
    const dim3 grid(bh, (p.sq + C::kOwn - 1) / C::kOwn);
    flash_bwd_dq_wgmma<D><<<grid, kThreads, C::kSmem, st>>>(
        q_own, k_tile, v_tile, do_own, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.sk > 0) {
    const dim3 grid(bh, (p.sk + C::kOwn - 1) / C::kOwn);
    flash_bwd_dkv_wgmma<D><<<grid, kThreads, C::kSmem, st>>>(
        q_tile, k_own, v_own, do_tile, p);
    e = cudaGetLastError();
  }
  return static_cast<int>(e);
}

int launch_d(const Args& p, int bh, int d, cudaStream_t st) {
  switch (d) {
    case 16: return launch<16>(p, bh, st);
    case 32: return launch<32>(p, bh, st);
    case 64: return launch<64>(p, bh, st);
    case 128: return launch<128>(p, bh, st);
    case 256: return launch<256>(p, bh, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// the tiling of the kernels that run inputs of this type at head width D
template <int D>
void tiling(int bf16, int* block_q, int* block_k, int* smem_bytes) {
  if (bf16) {
    *block_q = tc::Cfg<D>::kOwn;
    *block_k = tc::kTile;
    *smem_bytes = tc::Cfg<D>::kSmem;
  } else {
    *block_q = kBlockQ;
    *block_k = Tile<D>::kBlockK;
    *smem_bytes = Tile<D>::kSmem;
  }
}

}  // namespace

// query rows a dQ block owns, keys (dQ) or query rows (dK / dV) a block
// takes per staged tile, and the dynamic shared memory a block asks for, of
// the kernels that take bf16 (bf16 = 1) or float32 inputs at head width d;
// returns 0, or an error for another d
extern "C" int flash_attention_bwd_tiling(int d, int bf16, int* block_q,
                                          int* block_k, int* smem_bytes) {
  switch (d) {
    case 16: tiling<16>(bf16, block_q, block_k, smem_bytes); return 0;
    case 32: tiling<32>(bf16, block_q, block_k, smem_bytes); return 0;
    case 64: tiling<64>(bf16, block_q, block_k, smem_bytes); return 0;
    case 128: tiling<128>(bf16, block_q, block_k, smem_bytes); return 0;
    case 256: tiling<256>(bf16, block_q, block_k, smem_bytes); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// q, out, dout (bh, sq, d), k, v (bh, sk, d), float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); lse (bh, sq) float32; stats (bh, 2, sq_pad)
// float32, sq_pad = sq rounded up to 64, written (each row's lse and delta,
// 0 past sq); dq (bh, sq, d), dk, dv (bh, sk, d) in the inputs' type, every
// one written. All contiguous, 16-byte aligned; d one of 16, 32, 64, 128,
// 256. Two launches on ``stream``: dQ, then dK / dV (the tensor-core
// kernels for bf16, the FMA body for float32).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* stats, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int bf16, int causal,
    int has_window, int window, int has_softcap, float softcap, float scale,
    void* stream) {
  Args p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.dout = dout;
  p.lse = lse;
  p.stats = stats;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = (sq + kPad - 1) / kPad * kPad;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  if (bh <= 0 || (sq <= 0 && sk <= 0)) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16) return fma_launch_d(p, bh, d, st);
  return tc::launch_d(p, bh, d, st);
}
