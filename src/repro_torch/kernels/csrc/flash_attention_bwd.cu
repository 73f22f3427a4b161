// The backward of flash attention on Hopper (sm_90a): dQ, dK and dV of the
// causal, windowed and softcapped attention of csrc/flash_attention.cu, in
// two launches and no atomics, on the tensor cores: bfloat16 inputs as they
// are (wgmma on tiles staged by TMA), float32 inputs with each operand split
// into three bf16 terms (csrc/split3.cuh; never TF32).
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
// bound, 0.174 ms at bf16's 989 TFLOP/s on the tensor cores. float32 takes
// six bf16 products a product: at B=1 (21.5 GFLOP) 129 GFLOP, 0.13 ms.
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
// float32: the same two launches on three-term operands (namespace x3):
//   * every operand of the five products is split into hi, mid and lo bf16
//     planes in shared memory, in the swizzled box layout TMA gives the
//     bf16 kernels (the block's threads load f32 rows by 16-byte loads,
//     split them and store the planes: TMA cannot split); q is scaled by
//     1/sqrt(D) in f32 before its split, as the plain version scales it,
//     so dK needs no scaling and dQ is scaled once at the end.
//   * S, dP (and S^T, dP^T) are six wgmma products each from shared
//     memory, the small ones first; p, ds, the softcap's tanhf and the
//     masks stay f32 on the accumulators (expf: ex2.approx's ~2^-22 is 4x
//     float32's rounding); P and dS are split into three terms as A
//     fragments, and dQ += dS K, dV += P^T dO, dK += dS^T Q are six
//     register-A products each. Every tile's part goes into a fresh
//     accumulator, 64 columns at a time, added to the running sum by f32
//     adds: the tensor cores' f32 sums, which may truncate, never run over
//     more than one tile.
//   * Shared memory and registers bound the tiling (Cfg): the owned pair's
//     planes (Q, dO or K, V) stay, the other pair's tiles are staged, one
//     while the other's product runs. Two warpgroups own 64 rows or keys
//     each on 64-row tiles at D <= 64; at D = 128 one warpgroup owns 64 on
//     32-row tiles (its accumulators, fresh sums and terms fill the
//     registers); at D = 256 both own the same 64, each half the columns
//     (S and dP run in each), on 16-row tiles that take turns in one slot
//     (the owned planes take 192 KB).
//   * delta is computed in the dQ launch in f32 (columns in a fixed order,
//     then the row's four lanes) and handed over in ``stats`` as by the
//     bf16 kernels. The same order every run: bitwise stable.
//
// tanhf, not the fast intrinsic (its ~2^-11 would move a capped score by
// up to cap 2^-11). The exponential: expf in float32; the bf16 kernels
// take 2^((s - lse) log2 e) by ex2.approx (relative error ~2^-22,
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
#include "split3.cuh"

namespace {

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

// --- float32: the tensor-core kernels, each operand in three bf16 terms ---

namespace x3 {

using namespace hopper;
using namespace split3;

constexpr int kTermsUsed = 3;     // bf16 terms of each float32 operand
constexpr bool kFresh = true;     // each tile's dQ, dK, dV into a fresh sum
constexpr bool kProducts = true;  // the tensor-core products (a probe's off)

// both launches' tiling at head width D
template <int D>
struct Cfg {
  // D <= 64: two warpgroups own 64 rows or keys each; D >= 128: both own
  // the same 64 and each holds half of the columns (each computes the
  // whole S and dP): their accumulators, fresh sums and terms fit the
  // registers (experiments/flash_bwd_breakdown.py times one warpgroup
  // owning 64 and two owning 64 each at D = 128)
  static constexpr int kWarpgroups = 2;
  static constexpr bool kSplit = D >= 128;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kOwn = kSplit || kWarpgroups == 1 ? 64 : 128;
  // keys (dQ) or query rows (dK / dV) a staged tile; at D = 256 the two
  // staged operands take turns in one slot (the owned pair's planes take
  // 192 KB)
  static constexpr int kTile = D == 256 ? 16 : 64;
  static constexpr bool kShared = D == 256;
  static constexpr int kCols = kSplit ? D / 2 : D;      // a warpgroup's
  static constexpr int kFold = kCols < 64 ? kCols : 64;  // a fresh sum's
  static constexpr int kOwnBytes = Planes<D>::bytes(kOwn);
  static constexpr int kTileBytes = Planes<D>::bytes(kTile);
  static constexpr int kStatBytes = 2 * kTile * 4;      // lse, delta (dK / dV)
  // the owned pair's planes, the staged tiles', the dK / dV launch's
  // stats; 1024 bytes of slack to align the start
  static constexpr int kSmem = 1024 + 2 * kOwnBytes +
                               (kShared ? 1 : 2) * kTileBytes + kStatBytes;
};

// p = exp(s - lse) and ds = p (dp - delta) (* dcap) on a score
// accumulator pair, in place (s becomes p, dp becomes ds), as the plain
// version rounds them; ``lse(i)`` and ``delta(i)`` are element i's row
// statistics. One uniform branch for the softcap.
template <int N, typename Lse, typename Delta>
__device__ __forceinline__ void grads(float (&s)[N], float (&dp)[N],
                                      const Args& p, Lse&& lse,
                                      Delta&& delta) {
  if (p.has_softcap) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float t = tanhf(s[i] / p.softcap);
      s[i] = expf(__fmul_rn(p.softcap, t) - lse(i));
      dp[i] = s[i] * (dp[i] - delta(i)) * (1.f - t * t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s[i] = expf(s[i] - lse(i));
      dp[i] = s[i] * (dp[i] - delta(i));
    }
  }
}

// the dQ launch: a block owns kOwn query rows of one (b, h) and sweeps the
// kv tiles they can see; it computes delta for its rows first
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_bwd_dq_x3(const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int T = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* dos = qs + C::kOwnBytes;
  unsigned char* ks = dos + C::kOwnBytes;
  unsigned char* vs = C::kShared ? ks : ks + C::kTileBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int bh, tile;
  tc::schedule(bh, tile, true);
  const int q0 = tile * C::kOwn;
  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                                // first row
  const int q_hi = min(q0 + C::kOwn, p.sq) - 1 + offset;       // last row
  // the keys some row of this block may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;
  const int kb0 = k_begin / T * T;
  const int tiles = k_end > kb0 ? (k_end - kb0 + T - 1) / T : 0;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.sk * D;
  const float* dout =
      static_cast<const float*>(p.dout) + (size_t)bh * p.sq * D;

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
      const size_t base = ((size_t)bh * p.sq + row) * D + c0;
      const float* o = static_cast<const float*>(p.out) + base;
      const float* g = static_cast<const float*>(p.dout) + base;
#pragma unroll 4
      for (int c = 0; c < D / 8; ++c) {
        const float2 a = *reinterpret_cast<const float2*>(o + 8 * c);
        const float2 b = *reinterpret_cast<const float2*>(g + 8 * c);
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
  float dq[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) dq[i] = 0.f;

  // q scaled by 1/sqrt(D) in float32 first, then split, as the plain
  // version scales it; dO; V's first tile
  if (tiles > 0) {
    stage3<D, C::kOwn, C::kThreads>(qs, q, q0, p.sq, p.scale, true);
    stage3<D, C::kOwn, C::kThreads>(dos, dout, q0, p.sq, 1.f, false);
    if constexpr (!C::kShared) {
      stage3<D, T, C::kThreads>(vs, v, kb0, p.sk, 1.f, false);
    }
    fence_proxy_async();
  }
  __syncthreads();

  for (int j = 0; j < tiles; ++j) {
    const int kb = kb0 + j * T;
    const Operand<D, C::kOwn> qd(qs), dod(dos);
    const Operand<D, T> kd(ks), vd(vs);
    if constexpr (C::kShared) {
      stage3<D, T, C::kThreads>(vs, v, kb, p.sk, 1.f, false);
      fence_proxy_async();
      __syncthreads();
    }
    // dP = dO V^T; K's tile is loaded before it is issued and split into
    // its slot while it runs
    Rows<D, T, C::kThreads> rows;
    rows.load(k, kb, p.sk);
    float dp[T / 2];
    wgmma_fence();
    ss_products<T, D / 16, kTermsUsed, kProducts>(
        dp, [&](int t, int kk) { return dod.kmajor(t, own, kk); },
        [&](int t, int kk) { return vd.kmajor(t, 0, kk); });
    wgmma_commit();
    if constexpr (C::kShared) {
      wgmma_wait0();
      fence_regs(dp);
      __syncthreads();          // every warpgroup is done with V's tile
    }
    rows.store(ks, 1.f, false);
    fence_proxy_async();
    __syncthreads();            // K's tile is visible
    // S = Q K^T
    float s[T / 2];
    wgmma_fence();
    ss_products<T, D / 16, kTermsUsed, kProducts>(
        s, [&](int t, int kk) { return qd.kmajor(t, own, kk); },
        [&](int t, int kk) { return kd.kmajor(t, 0, kk); });
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // element i: row h = (i / 2) % 2 of the thread's two
    grads(s, dp, p, [&](int i) { return lse[(i / 2) % 2]; },
          [&](int i) { return delta[(i / 2) % 2]; });
    const bool whole = kb + T <= p.sk &&
                       (!p.causal || kb + T - 1 <= wg_lo) &&
                       (!p.has_window || kb > wg_lo + 63 - p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
        const int h = (i / 2) % 2;
        const int k_pos = kb + 8 * (i / 4) + c0 + i % 2;
        const bool ok = k_pos < p.sk && (!p.causal || k_pos <= qp[h]) &&
                        (!p.has_window || k_pos > qp[h] - p.window);
        dp[i] = ok ? dp[i] : 0.f;
      }
    }
    // dQ += dS K, six products into a fresh sum per kFold columns; K
    // (keys x D) read MN-major. V's next tile is loaded before they are
    // issued and split into its slot while the first part runs.
    uint32_t dsf[3][T / 16][4];
    to_frags3<T / 16>(dp, dsf);
    const bool more = !C::kShared && j + 1 < tiles;
    if (more) rows.load(v, kb + T, p.sk);
    rs_products<C::kCols, C::kFold, T / 16, kTermsUsed, kProducts, kFresh>(
        dq, dsf,
        [&](int t, int c, int kk) { return kd.mnmajor(t, col0 + c, kk); },
        [&](int i, float x) { return dq[i] + x; },
        [&] {
          if constexpr (!C::kShared) {
            __syncthreads();    // every warpgroup is done with V's tile
            if (more) {
              rows.store(vs, 1.f, false);
              fence_proxy_async();
            }
          }
        });
    __syncthreads();            // K's slot is free; V's next tile visible
  }

  // dq * scale, rows < Sq
  float* out = static_cast<float*>(p.dq) + (size_t)bh * p.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= p.sq) continue;
    float* orow = out + (size_t)row * D + col0 + c0;
#pragma unroll
    for (int c = 0; c < C::kCols / 8; ++c) {
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(__fmul_rn(dq[4 * c + 2 * h], p.scale),
                      __fmul_rn(dq[4 * c + 2 * h + 1], p.scale));
    }
  }
}

// the dK / dV launch: a block owns kOwn keys of one (b, h) and sweeps the
// q tiles that can see them, lse and delta from the dQ launch's stats
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_bwd_dkv_x3(const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int T = C::kTile;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ks = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* vs = ks + C::kOwnBytes;
  unsigned char* qs = vs + C::kOwnBytes;
  unsigned char* dos = C::kShared ? qs : qs + C::kTileBytes;
  float* stats = reinterpret_cast<float*>(
      qs + (C::kShared ? 1 : 2) * C::kTileBytes);   // lse, then delta

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int bh, tile;
  tc::schedule(bh, tile, false);
  const int kb = tile * C::kOwn;
  // the q rows some key of this block is visible to
  const int offset = p.sk - p.sq;
  const int row_begin = p.causal ? max(0, kb - offset) : 0;
  const int row_end =
      p.has_window ? min(p.sq, max(0, kb + C::kOwn - 1 + p.window - offset))
                   : p.sq;
  const int qb0 = row_begin / T * T;
  const int tiles = row_end > qb0 ? (row_end - qb0 + T - 1) / T : 0;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.sk * D;
  const float* dout =
      static_cast<const float*>(p.dout) + (size_t)bh * p.sq * D;

  // this thread's two keys (the accumulators' rows), in the block
  const int own = C::kSplit ? 0 : 64 * wg;     // the warpgroup's first key
  const int key0 = own + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);               // first column of a chunk
  const int col0 = C::kSplit ? wg * C::kCols : 0;   // the dK / dV columns
  const int kp[2] = {kb + key0, kb + key0 + 8};
  const int wk = kb + own;                     // the warpgroup's first key

  // a q tile's rows' lse and delta, as the dQ launch wrote them (0 past Sq)
  auto stage_stats = [&](int q0) {
    const float* rows = p.stats + (size_t)bh * 2 * p.sq_pad + q0;
    for (int t = tid; t < T; t += C::kThreads) {
      stats[t] = rows[t];
      stats[T + t] = rows[p.sq_pad + t];
    }
  };

  float dk[C::kCols / 2], dv[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  if (tiles > 0) {
    stage3<D, C::kOwn, C::kThreads>(ks, k, kb, p.sk, 1.f, false);
    stage3<D, C::kOwn, C::kThreads>(vs, v, kb, p.sk, 1.f, false);
    if constexpr (!C::kShared) {
      stage3<D, T, C::kThreads>(dos, dout, qb0, p.sq, 1.f, false);
    }
    fence_proxy_async();
  }
  __syncthreads();

  for (int j = 0; j < tiles; ++j) {
    const int q0 = qb0 + j * T;
    const Operand<D, C::kOwn> kd(ks), vd(vs);
    const Operand<D, T> qd(qs), dod(dos);
    if constexpr (C::kShared) {
      stage3<D, T, C::kThreads>(dos, dout, q0, p.sq, 1.f, false);
      fence_proxy_async();
      __syncthreads();
    }
    // dP^T = V dO^T: rows are keys, columns query rows; Q's tile is loaded
    // before it is issued and split (scaled by 1/sqrt(D) first, as the
    // plain version scales it) into its slot while it runs, with its rows'
    // statistics
    Rows<D, T, C::kThreads> rows;
    rows.load(q, q0, p.sq);
    float dp[T / 2];
    wgmma_fence();
    ss_products<T, D / 16, kTermsUsed, kProducts>(
        dp, [&](int t, int kk) { return vd.kmajor(t, own, kk); },
        [&](int t, int kk) { return dod.kmajor(t, 0, kk); });
    wgmma_commit();
    if constexpr (C::kShared) {
      wgmma_wait0();
      fence_regs(dp);
      __syncthreads();          // every warpgroup is done with dO's tile
    }
    rows.store(qs, p.scale, true);
    stage_stats(q0);
    fence_proxy_async();
    __syncthreads();            // Q's tile and the statistics are visible
    // S^T = K Q^T
    float s[T / 2];
    wgmma_fence();
    ss_products<T, D / 16, kTermsUsed, kProducts>(
        s, [&](int t, int kk) { return kd.kmajor(t, own, kk); },
        [&](int t, int kk) { return qd.kmajor(t, 0, kk); });
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // element i: query column 8 (i / 4) + c0 + i % 2 of the tile
    grads(s, dp, p,
          [&](int i) { return stats[8 * (i / 4) + c0 + i % 2]; },
          [&](int i) { return stats[T + 8 * (i / 4) + c0 + i % 2]; });
    const bool whole = q0 + T <= p.sq && wk + 64 <= p.sk &&
                       (!p.causal || wk + 63 <= q0 + offset) &&
                       (!p.has_window || wk > q0 + T - 1 + offset - p.window);
    if (!whole) {
#pragma unroll
      for (int i = 0; i < T / 2; ++i) {
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
    // dV += P^T dO and dK += dS^T Q, six products each into a fresh sum
    // per kFold columns; dO and Q (query rows x D) read MN-major
    uint32_t pf[3][T / 16][4], dsf[3][T / 16][4];
    auto dv_of = [&](auto&& between) {
      to_frags3<T / 16>(s, pf);
      rs_products<C::kCols, C::kFold, T / 16, kTermsUsed, kProducts, kFresh>(
          dv, pf,
          [&](int t, int c, int kk) { return dod.mnmajor(t, col0 + c, kk); },
          [&](int i, float x) { return dv[i] + x; }, between);
    };
    auto dk_of = [&](auto&& between) {
      to_frags3<T / 16>(dp, dsf);
      rs_products<C::kCols, C::kFold, T / 16, kTermsUsed, kProducts, kFresh>(
          dk, dsf,
          [&](int t, int c, int kk) { return qd.mnmajor(t, col0 + c, kk); },
          [&](int i, float x) { return dk[i] + x; }, between);
    };
    if constexpr (C::kShared) {
      // Q's tile first, then dO's again in the same slot
      dk_of([] {});
      __syncthreads();          // every warpgroup is done with Q's tile
      stage3<D, T, C::kThreads>(dos, dout, q0, p.sq, 1.f, false);
      fence_proxy_async();
      __syncthreads();
      dv_of([] {});
    } else {
      dv_of([] {});
      // dO's next tile is loaded before dK's products are issued and split
      // into its slot while the first part runs
      const bool more = j + 1 < tiles;
      if (more) rows.load(dout, q0 + T, p.sq);
      dk_of([&] {
        __syncthreads();        // every warpgroup is done with dO's tile
        if (more) {
          rows.store(dos, 1.f, false);
          fence_proxy_async();
        }
      });
    }
    __syncthreads();            // the slots are free; dO's next tile visible
  }

  // dk (q was scaled) and dv, keys < Sk
  float* dko = static_cast<float*>(p.dk) + (size_t)bh * p.sk * D;
  float* dvo = static_cast<float*>(p.dv) + (size_t)bh * p.sk * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kp[h];
    if (key >= p.sk) continue;
    const size_t at = (size_t)key * D + col0 + c0;
#pragma unroll
    for (int c = 0; c < C::kCols / 8; ++c) {
      *reinterpret_cast<float2*>(dko + at + 8 * c) =
          make_float2(dk[4 * c + 2 * h], dk[4 * c + 2 * h + 1]);
      *reinterpret_cast<float2*>(dvo + at + 8 * c) =
          make_float2(dv[4 * c + 2 * h], dv[4 * c + 2 * h + 1]);
    }
  }
}

// dQ (and stats), then dK / dV, on ``st``
template <int D>
int launch(const Args& p, int bh, cudaStream_t st) {
  using C = Cfg<D>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(flash_bwd_dkv_x3<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.sq > 0) {
    const dim3 grid(bh, (p.sq + C::kOwn - 1) / C::kOwn);
    flash_bwd_dq_x3<D><<<grid, C::kThreads, C::kSmem, st>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.sk > 0) {
    const dim3 grid(bh, (p.sk + C::kOwn - 1) / C::kOwn);
    flash_bwd_dkv_x3<D><<<grid, C::kThreads, C::kSmem, st>>>(p);
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

}  // namespace x3

// the tiling of the kernels that run inputs of this type at head width D
template <int D>
void tiling(int bf16, int* block_q, int* block_k, int* smem_bytes) {
  if (bf16) {
    *block_q = tc::Cfg<D>::kOwn;
    *block_k = tc::kTile;
    *smem_bytes = tc::Cfg<D>::kSmem;
  } else {
    *block_q = x3::Cfg<D>::kOwn;
    *block_k = x3::Cfg<D>::kTile;
    *smem_bytes = x3::Cfg<D>::kSmem;
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
  if (!bf16) return x3::launch_d(p, bh, d, st);
  return tc::launch_d(p, bh, d, st);
}
