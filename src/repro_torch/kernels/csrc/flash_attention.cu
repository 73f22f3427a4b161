// Flash attention on Hopper (sm_90a): causal, windowed and softcapped
// attention with an online softmax, in one launch. bfloat16 inputs run on
// the tensor cores (wgmma, K and V staged by TMA); float32 inputs run an
// FMA body.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _flash_kernel). For q (BH, Sq, D) and k, v (BH, Sk, D), float32 or
// bfloat16, with scale = 1 / sqrt(D):
//
//   s[i, j]  = sum_d q[i, d] k[j, d] * scale             (see below)
//   s[i, j]  = cap * tanh(s[i, j] / cap)                 with a softcap
//   q_pos    = i + (Sk - Sq);  k_pos = j                 end-aligned positions
//   visible  = (!causal || k_pos <= q_pos)
//              && (!window || k_pos > q_pos - window)
//   out[i]   = sum_j p[i, j] v[j] / max(sum_j p[i, j], 1e-30),
//              p = exp(s - m) on visible keys, 0 elsewhere
//   lse[i]   = m + log(max(sum_j p[i, j], 1e-30))      where lse is given
//
// with the running max m, denominator and accumulator in f32, rescaled per
// key tile as the Pallas kernel does (m starts at -1e30, so a row that sees
// no key comes out 0, not NaN). The output has the inputs' dtype (bfloat16
// rounded to nearest even). With a non-null ``lse`` pointer the block also
// writes each row's log-sum-exp in float32, (BH, Sq): the residual that
// nn/flash.py::_fwd saves for the backward (csrc/flash_attention_bwd.cu).
// Serving passes null and writes nothing more.
//
// The Pallas kernel walks a (BH, q tiles, kv tiles) grid in order, keeping
// its carries in VMEM scratch across the kv steps. That order is a device of
// the TPU: here one block owns one (bh, q tile) and loops over the kv tiles
// itself, with the carries in registers. Its block sizes do not bind: the
// caller's q_tile / kv_tile are a contract on the lengths only. Only the kv
// tiles the causal and window masks leave visible to some row of the block
// are visited (nn/flash.py::_block_schedule's skip).
//
// What bounds it on an H100. Per visible (query, key) pair 4 D operations
// (the two products of D multiply-adds each); the bytes are q, k, v and out
// once each. At llama3-8b's prefill (B=2, H=32, S=2048, D=128, causal, bf16)
// that is 68.7 GFLOP against 134 MB: operations bound, 69.5 us at bf16's
// 989 TFLOP/s on the tensor cores (the bytes alone 40 us). float32 inputs
// (B=1: 34.4 GFLOP) are bound at 0.51 ms by f32's 67 TFLOP/s outside them.
//
// bfloat16: the tensor-core kernel (FlashAttention-3's structure, without
// its warp specialisation and ping-pong scheduling):
//   * A block of two consumer warpgroups (256 threads) owns 128 query rows
//     of one (b, h), 64 rows a warpgroup. Blocks start head group by head
//     group (8 heads), each group's last q tiles, the heaviest under a
//     causal mask, first: heavy tiles start early and a group's K and V
//     are read from L2 (experiments/flash_breakdown.py times the other
//     orders: all heads' last tiles first, one head after another).
//   * K and V tiles of kBlockK keys (128; 64 at D = 256, for registers and
//     shared memory) reach shared memory by TMA through one 3-d tensor map
//     each (BH, S, D), in boxes of 64 columns with a 128-byte swizzle (at
//     D = 16 and 32 one box of the row, 32- and 64-byte swizzle), in a ring
//     of two stages with an mbarrier each: tile j + 1's loads run while
//     tile j is multiplied. The warpgroup that is done with a stage second
//     (a count in shared memory says which) issues its refill, so neither
//     waits for the other there. Q is loaded once, by thread 0.
//     Rows past Sq or Sk arrive as zeros; the masks drop those keys.
//   * S = Q K^T by wgmma m64nBKk16, both operands from shared memory, f32
//     accumulator, on the raw bf16 q; then s *= scale in f32. bf16 x bf16
//     products are exact in f32, so this differs from the Pallas kernel's
//     (q * scale) . k, and from the plain version's, by f32 rounding only.
//   * Softcap, mask and online softmax on the accumulator fragments: tanhf
//     and expf, masks applied only on tiles that straddle the diagonal, the
//     window's edge or the ragged end. Scale, softcap and mask are passes
//     of their own, each behind one uniform branch: with the branches
//     inside one loop over the elements the compiler kept a branch per
//     element and the kernel ran ~1.9x slower (flash_breakdown.py). A row
//     lives in 4 lanes: its max and sum are two xor-shuffles.
//   * O += P V by wgmma with A from registers (the score accumulator's
//     layout is the A fragment's) and B the V tile, MN-major (transposed).
//     P is split into two bf16 terms, P_hi = bf16(P), P_lo = bf16(P - P_hi),
//     and both are multiplied: one bf16 term would err by ~2^-9 per
//     probability, the two by ~2^-17, below the 1e-5 floor of the tolerance
//     that holds the output against the plain version. l sums the f32 P.
//     The split costs half as many tensor-core instructions again (the P.V
//     half of the work twice): at the LM shape ~35 us more of the bound.
//   * out = O / max(l, 1e-30), rounded to bf16 nearest-even, stored for
//     rows < Sq. No atomics and no split over keys: the same bits from run
//     to run.
//
// float32: the FMA body, which keeps fp32 throughout (no TF32): one block
// of 128 threads per (bh, 64-row q tile); the q tile (scaled by 1/sqrt(D)
// in f32 first) and each 64-key tile of k and v staged in shared memory as
// f32, rows padded by 4 floats; thread (rg, cg) = (tid / 8, tid % 8) owns
// query rows rg + 16 r (r < 4) and keys cg + 8 j (j < 8) of a score tile
// and column groups cg + 8 c of the output; a row's max and sum are
// xor-shuffles over its 8 lanes and P.V takes each probability from its
// lane by a shuffle. Its ceiling is f32's 67 TFLOP/s.
//
// Both: expf and tanhf, not the fast intrinsics. The launcher returns a
// CUDA error code (cudaGetLastError() after the launch); it allocates
// nothing and does not synchronise. It builds the bf16 kernel's tensor maps
// with cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// the FMA body's constants (float32)
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
  float* lse;          // (bh, sq) float32, or null
  int sq, sk;
  int causal, has_window, window, has_softcap;
  float softcap, scale;
};

// rows [row0, row0 + kBlockQ) of a (rows, D) float32 matrix into shared
// memory (times ``mul``), row stride D + 4; rows past ``rows`` are zeros
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int rows, float mul, bool scaled) {
  constexpr int kPieces = D / 4;                    // float4 pieces a row
  constexpr int kLd = D + 4;
  for (int t = threadIdx.x; t < kBlockQ * kPieces; t += kThreads) {
    const int r = t / kPieces;
    const int piece = t % kPieces;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) {
      val = __ldg(reinterpret_cast<const float4*>(
          src + (size_t)(row0 + r) * D) + piece);
      if (scaled) {
        val.x = __fmul_rn(val.x, mul);
        val.y = __fmul_rn(val.y, mul);
        val.z = __fmul_rn(val.z, mul);
        val.w = __fmul_rn(val.w, mul);
      }
    }
    *reinterpret_cast<float4*>(dst + r * kLd + piece * 4) = val;
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

template <int D>
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
  const float* q = static_cast<const float*>(p.q) + bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + bh * p.sk * D;
  float* out = static_cast<float*>(p.out) + bh * p.sq * D;

  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                               // first row
  const int q_hi = min(q0 + kBlockQ, p.sq) - 1 + offset;      // last row
  // the keys some row of this tile may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;

  stage<D>(qs, q, q0, p.sq, p.scale, true);

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
    stage<D>(ks, k, kb, p.sk, 1.f, false);
    stage<D>(vs, v, kb, p.sk, 1.f, false);
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
    // the row's 8 lanes hold the same m and l; the first writes its lse
    if (p.lse != nullptr && cg == 0) {
      p.lse[bh * p.sq + row] = m[r] + logf(denom);
    }
    float* orow = out + (size_t)row * D + cg * kVec;
#pragma unroll
    for (int c = 0; c < kOut / kVec; ++c) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        orow[8 * kVec * c + i] = acc[r][c * kVec + i] / denom;
      }
    }
  }
}

// --- bfloat16: the tensor-core kernel --------------------------------------

namespace tc {

using namespace hopper;

constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kBlockQ = 128;      // query rows a block owns, 64 a warpgroup
constexpr int kStages = 2;        // K / V ring
constexpr int kHeadGroup = 8;     // heads whose q tiles start together

template <int D>
struct Tile {
  static constexpr int kBlockK = D == 256 ? 64 : 128;   // keys per stage
  static constexpr int kBoxCols = D < 64 ? D : 64;      // columns per box
  static constexpr int kRowBytes = 2 * kBoxCols;        // a box row
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr Swizzle kSwizzle = swizzle_of(kRowBytes);
  static constexpr int kQBytes = kBlockQ * D * 2;
  static constexpr int kKvBytes = kBlockK * D * 2;      // one K or V tile
  // Q, then the stages' K and V, the barriers and the stages' claim
  // counts; 1024 bytes of slack to align the start to the swizzle's atom
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKvBytes + 8 * (kStages + 1) +
      4 * kStages;
};

// a 64-row (or kBlockK-row) K-major operand at k step kk (16 columns):
// box kk * 16 / kBoxCols, then 32 bytes a step inside the box's row
template <int D>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile,
                                           int rows, int kk) {
  using T = Tile<D>;
  const int box = kk * 16 / T::kBoxCols;
  const int off = (kk * 16 % T::kBoxCols) * 2;
  return desc(tile + box * rows * T::kRowBytes + off, 16, 8 * T::kRowBytes,
              T::kSwizzle);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ Args p) {
  using T = Tile<D>;
  constexpr int BK = T::kBlockK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + T::kQBytes;                 // stage s at s * kKv
  unsigned char* vs = ks + kStages * T::kKvBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * T::kKvBytes);
  uint64_t* qbar = full + kStages;
  int* claims = reinterpret_cast<int*>(qbar + 1);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // the order blocks start in: heads in groups of kHeadGroup, each
  // group's q tiles from the last (the heaviest under a causal mask) to
  // the first, its heads side by side, so that heavy tiles start early and
  // a group's K and V are read from L2
  const int q_tiles = gridDim.y;
  const int id = blockIdx.x + blockIdx.y * gridDim.x;
  const int g0 = id / (kHeadGroup * q_tiles) * kHeadGroup;
  const int g = min(kHeadGroup, static_cast<int>(gridDim.x) - g0);
  const int bh = g0 + (id - g0 * q_tiles) % g;
  const int q0 = (q_tiles - 1 - (id - g0 * q_tiles) / g) * kBlockQ;
  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                                // first row
  const int q_hi = min(q0 + kBlockQ, p.sq) - 1 + offset;       // last row
  // the keys some row of this tile may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;
  const int kb0 = k_begin / BK * BK;
  const int tiles = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;

  // tile j of K and V into stage j % kStages
  auto load_kv = [&](int j) {
    const int st = j % kStages;
    mbar_expect_tx(&full[st], 2 * T::kKvBytes);
    for (int b = 0; b < T::kBoxes; ++b) {
      const int off = st * T::kKvBytes + b * BK * T::kRowBytes;
      tma_load_3d(ks + off, &tk, &full[st], b * T::kBoxCols, kb0 + j * BK,
                  bh);
      tma_load_3d(vs + off, &tv, &full[st], b * T::kBoxCols, kb0 + j * BK,
                  bh);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      claims[s] = 0;
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
    if (tiles > 0) {
      mbar_expect_tx(qbar, T::kQBytes);
      for (int b = 0; b < T::kBoxes; ++b) {
        tma_load_3d(qs + b * kBlockQ * T::kRowBytes, &tq, qbar,
                    b * T::kBoxCols, q0, bh);
      }
      for (int j = 0; j < kStages && j < tiles; ++j) load_kv(j);
    }
  }
  __syncthreads();

  // this thread's two rows (of the accumulators' layout) and positions
  const int row0 = 64 * wg + 16 * warp + lane / 4;          // in the block
  const int qp[2] = {q0 + row0 + offset, q0 + row0 + 8 + offset};
  const int wg_lo = q0 + 64 * wg + offset;   // the warpgroup's first row
  const int c0 = 2 * (lane % 4);             // first column of a chunk
  const unsigned char* qwg = qs + 64 * wg * T::kRowBytes;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  if (tiles > 0) {
    mbar_wait(qbar, 0);
    __syncwarp();
  }
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    const int kb = kb0 + j * BK;
    const unsigned char* kt = ks + st * T::kKvBytes;
    const unsigned char* vt = vs + st * T::kKvBytes;
    mbar_wait(&full[st], (j / kStages) & 1);
    __syncwarp();                 // wgmma wants the warp converged

    // S = Q K^T on the raw bf16 q
    float s[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss<BK>(s, kmajor<D>(qwg, kBlockQ, kk), kmajor<D>(kt, BK, kk),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);

    // scale, softcap and mask, each a pass of its own behind one uniform
    // branch (a branch per element serialised the elements); a masked key
    // becomes -inf, which no row max (from -1e30) takes and whose exp is 0
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] *= p.scale;
    if (p.has_softcap) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = __fmul_rn(p.softcap, tanhf(s[i] / p.softcap));
      }
    }
    const bool whole = kb + BK <= p.sk &&
                       (!p.causal || kb + BK - 1 <= wg_lo) &&
                       (!p.has_window || kb > wg_lo + 63 - p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i / 2) % 2;
        const int k_pos = kb + 8 * (i / 4) + c0 + i % 2;
        const bool ok = k_pos < p.sk && (!p.causal || k_pos <= qp[h]) &&
                        (!p.has_window || k_pos > qp[h] - p.window);
        s[i] = ok ? s[i] : -INFINITY;
      }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    // P in two bf16 terms, laid out as the A fragments of P.V's k steps
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const int h = r % 2;
        const float a = expf(s[i] - m[h]);
        const float b = expf(s[i + 1] - m[h]);
        sum[h] += a + b;
        const __nv_bfloat162 ph = __floats2bfloat162_rn(a, b);
        const __nv_bfloat162 pl = __floats2bfloat162_rn(
            a - __low2float(ph), b - __high2float(ph));
        hi[kk][r] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[kk][r] = *reinterpret_cast<const uint32_t*>(&pl);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = fmaf(l[h], alpha[h], sum[h]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P_hi V + P_lo V; V (keys x D) is MN-major: lbo steps from one
    // 64-column box to the next, sbo from 8 keys to the next 8
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t vd = desc(vt + kk * 16 * T::kRowBytes,
                               BK * T::kRowBytes, 8 * T::kRowBytes,
                               T::kSwizzle);
      wgmma_rs<D>(o, hi[kk], vd);
      wgmma_rs<D>(o, lo[kk], vd);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);

    // release the stage: the warpgroup that is done with it second refills
    // it with tile j + kStages, so neither waits for the other here
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (tid % 128 == 0 && atomicAdd(&claims[st], 1) % 2 == 1 &&
        j + kStages < tiles) {
      load_kv(j + kStages);
    }
    __syncwarp();
  }

  // out = O / max(l, 1e-30): 0 for a row that saw no key
  __nv_bfloat16* out =
      static_cast<__nv_bfloat16*>(p.out) + (size_t)bh * p.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // the row's 4 lanes hold the same m and l; the first writes its lse
    if (p.lse != nullptr && lane % 4 == 0) {
      p.lse[(size_t)bh * p.sq + row] = m[h] + logf(denom);
    }
    __nv_bfloat16* orow = out + (size_t)row * D + c0;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * h] / denom,
                                o[4 * c + 2 * h + 1] / denom);
    }
  }
}

template <int D>
int launch(const Args& p, int bh, cudaStream_t st) {
  using T = Tile<D>;
  // the runtime's call first: on a thread where no context is current yet
  // (an autograd worker whose first CUDA work this is) it makes the
  // device's primary context current, which cuTensorMapEncodeTiled needs
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // no keys (Sk = 0): no tile is loaded, so K and V need no map
  CUtensorMap tq{}, tk{}, tv{};
  int err = encode_bf16_3d(&tq, p.q, bh, p.sq, D, kBlockQ);
  if (err == 0 && p.sk > 0) {
    err = encode_bf16_3d(&tk, p.k, bh, p.sk, D, T::kBlockK);
    if (err == 0) err = encode_bf16_3d(&tv, p.v, bh, p.sk, D, T::kBlockK);
  }
  if (err != 0) return err;
  const dim3 grid(bh, (p.sq + kBlockQ - 1) / kBlockQ);
  flash_attention_wgmma<D><<<grid, kThreads, T::kSmem, st>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
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

// --- float32: the FMA body's launch

// the FMA body's shared memory: the q tile and one k and one v tile, f32
template <int D>
constexpr int fma_smem() {
  return (kBlockQ + 2 * kBlockK) * (D + 4) * static_cast<int>(sizeof(float));
}

template <int D>
int fma_launch(const Args& p, int bh, cudaStream_t st) {
  const size_t smem = fma_smem<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_kernel<D><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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

// the tiling of the kernel that runs inputs of this type at head width D
template <int D>
void tiling(int bf16, int* block_q, int* block_k, int* smem_bytes) {
  if (bf16) {
    *block_q = tc::kBlockQ;
    *block_k = tc::Tile<D>::kBlockK;
    *smem_bytes = tc::Tile<D>::kSmem;
  } else {
    *block_q = kBlockQ;
    *block_k = kBlockK;
    *smem_bytes = fma_smem<D>();
  }
}

}  // namespace

// query rows a block owns, keys per staged tile and the dynamic shared
// memory a block asks for, of the kernel that takes bf16 (bf16 = 1) or
// float32 inputs at head width d; returns 0, or an error for another d
extern "C" int flash_attention_tiling(int d, int bf16, int* block_q,
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

// q (bh, sq, d), k and v (bh, sk, d), out (bh, sq, d): float32 (bf16 = 0) or
// bfloat16 (bf16 = 1), contiguous, 16-byte aligned; d one of 16, 32, 64,
// 128, 256; bh <= 65535. lse (bh, sq) float32 or null (nothing written).
// window and softcap count only where has_window / has_softcap are set.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int bh,
                                      int sq, int sk, int d, int bf16,
                                      int causal, int has_window, int window,
                                      int has_softcap, float softcap,
                                      float scale, void* stream) {
  Args p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
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
  // a dispatch on the inputs' type: bf16 only ever runs the tensor cores
  return bf16 ? tc::launch_d(p, bh, d, st) : fma_launch_d(p, bh, d, st);
}
