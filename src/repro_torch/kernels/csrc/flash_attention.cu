// Flash attention on Hopper (sm_90a): causal, windowed and softcapped
// attention with an online softmax, in one launch, on the tensor cores:
// bfloat16 inputs as they are (wgmma, K and V staged by TMA), float32 inputs
// with each operand split into three bf16 terms (csrc/split3.cuh; never
// TF32).
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
// (B=1: 34.4 GFLOP) take six bf16 products a product by the fp32-accurate
// route: 206 GFLOP on the tensor cores, 0.21 ms (f32's 67 TFLOP/s outside
// them would take 0.51 ms).
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
// float32: the same structure on three-term operands (namespace x3):
//   * q is scaled by 1/sqrt(D) in f32 first, as the plain version scales
//     it, then split: hi, mid and lo bf16 planes of Q, K and V in shared
//     memory, each in the swizzled box layout TMA gives the bf16 kernel
//     (TMA cannot split, so the block's threads load f32 rows by 16-byte
//     loads, split them and store the planes; no f32 copy of a tile).
//   * S = Q K^T is six wgmma products (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid
//     and lo.hi, the small ones first); the softcap (tanhf), masks and the
//     online softmax (expf: ex2.approx's ~2^-22 is 4x float32's rounding)
//     stay f32 on the accumulator fragments; P = exp(s - m) is split into
//     three terms as A fragments and O += P V is six register-A products.
//     Each kv tile's P V goes into a fresh accumulator, 64 columns at a
//     time, folded into O by FMAs (O = O alpha + part): the tensor cores'
//     f32 sums, which may truncate, never run over more than one tile.
//   * Shared memory bounds the tiling: three planes of a 128-row Q tile at
//     D = 128 take 96 KB and a 64-key K or V tile 48 KB. A block of two
//     warpgroups owns 128 query rows with one K and one V slot of 64 keys
//     (192 KB at D = 128); at D = 256 both warpgroups own the same 64 rows,
//     each half of O's columns (each computes the whole S), on 32-key
//     tiles. Each tile's f32 rows are loaded before the products they
//     overlap are issued (V's before S, K's next before P V) and split
//     into their slot while those run; two block barriers a tile.
//   * out = O / max(l, 1e-30) in f32. The same order every run: bitwise
//     stable.
//
// Both: expf and tanhf, not the fast intrinsics. The launcher returns a
// CUDA error code (cudaGetLastError() after the launch); it allocates
// nothing and does not synchronise. It builds the bf16 kernel's tensor maps
// with cuTensorMapEncodeTiled, fetched through the runtime (no -lcuda).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "split3.cuh"

namespace {

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

// --- float32: the tensor-core kernel, each operand in three bf16 terms ----

namespace x3 {

using namespace hopper;
using namespace split3;

constexpr int kThreads = 256;     // two consumer warpgroups
constexpr int kTermsUsed = 3;     // bf16 terms of each float32 operand
constexpr bool kFresh = true;     // each kv tile's P.V into a fresh sum
constexpr bool kProducts = true;  // the tensor-core products (a probe's off)

template <int D>
struct Cfg {
  // D = 256: both warpgroups own the same 64 rows and each holds half of
  // O's columns (each computes the whole S), for registers
  static constexpr bool kSplit = D == 256;
  static constexpr int kOwn = kSplit ? 64 : 128;       // query rows a block
  static constexpr int kBlockK = D == 256 ? 32 : 64;   // keys a tile
  static constexpr int kCols = kSplit ? D / 2 : D;     // O's, a warpgroup's
  static constexpr int kFold = kCols < 64 ? kCols : 64;  // a fresh sum's
  static constexpr int kQBytes = Planes<D>::bytes(kOwn);
  static constexpr int kKvBytes = Planes<D>::bytes(kBlockK);
  // Q's planes, then K's and V's; 1024 bytes of slack to align the start
  static constexpr int kSmem = 1024 + kQBytes + 2 * kKvBytes;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_x3(const __grid_constant__ Args p) {
  using C = Cfg<D>;
  constexpr int BK = C::kBlockK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = qs + C::kQBytes;
  unsigned char* vs = ks + C::kKvBytes;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  // the bf16 kernel's order: heads in groups of kHeadGroup, each group's
  // q tiles from the last (the heaviest under a causal mask) to the first
  const int q_tiles = gridDim.y;
  const int id = blockIdx.x + blockIdx.y * gridDim.x;
  const int g0 = id / (tc::kHeadGroup * q_tiles) * tc::kHeadGroup;
  const int g = min(tc::kHeadGroup, static_cast<int>(gridDim.x) - g0);
  const int bh = g0 + (id - g0 * q_tiles) % g;
  const int q0 = (q_tiles - 1 - (id - g0 * q_tiles) / g) * C::kOwn;
  const int offset = p.sk - p.sq;
  const int q_lo = q0 + offset;                                // first row
  const int q_hi = min(q0 + C::kOwn, p.sq) - 1 + offset;       // last row
  // the keys some row of this block may see
  const int k_end = p.causal ? min(p.sk, q_hi + 1) : p.sk;
  const int k_begin = p.has_window ? max(0, q_lo - p.window + 1) : 0;
  const int kb0 = k_begin / BK * BK;
  const int tiles = k_end > kb0 ? (k_end - kb0 + BK - 1) / BK : 0;
  const float* q = static_cast<const float*>(p.q) + (size_t)bh * p.sq * D;
  const float* k = static_cast<const float*>(p.k) + (size_t)bh * p.sk * D;
  const float* v = static_cast<const float*>(p.v) + (size_t)bh * p.sk * D;

  // this thread's two rows (of the accumulators' layout) and positions
  const int own = C::kSplit ? 0 : 64 * wg;   // the warpgroup's first row
  const int row0 = own + 16 * warp + lane / 4;               // in the block
  const int qp[2] = {q0 + row0 + offset, q0 + row0 + 8 + offset};
  const int wg_lo = q0 + own + offset;
  const int c0 = 2 * (lane % 4);             // first column of a chunk
  const int col0 = C::kSplit ? wg * C::kCols : 0;   // O's columns held

  float o[C::kCols / 2];
#pragma unroll
  for (int i = 0; i < C::kCols / 2; ++i) o[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  // q scaled by 1/sqrt(D) in float32 first, then split, as the plain
  // version scales it; K's first tile
  if (tiles > 0) {
    stage3<D, C::kOwn, kThreads>(qs, q, q0, p.sq, p.scale, true);
    stage3<D, BK, kThreads>(ks, k, kb0, p.sk, 1.f, false);
    fence_proxy_async();
  }
  __syncthreads();

  for (int j = 0; j < tiles; ++j) {
    const int kb = kb0 + j * BK;
    const Operand<D, C::kOwn> qd(qs);
    const Operand<D, BK> kd(ks), vd(vs);
    // S = Q K^T, six products; V's tile is loaded before they are issued
    // and split into its slot while they run
    Rows<D, BK, kThreads> rows;
    rows.load(v, kb, p.sk);
    float s[BK / 2];
    wgmma_fence();
    ss_products<BK, D / 16, kTermsUsed, kProducts>(
        s, [&](int t, int kk) { return qd.kmajor(t, own, kk); },
        [&](int t, int kk) { return kd.kmajor(t, 0, kk); });
    wgmma_commit();
    rows.store(vs, 1.f, false);
    fence_proxy_async();
    wgmma_wait0();
    fence_regs(s);

    // softcap and mask, each a pass behind one uniform branch; a masked key
    // becomes -inf, which no row max (from -1e30) takes and whose exp is 0
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
    // P = exp(s - m) in float32, then its three terms as A fragments
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = expf(s[i] - m[(i / 2) % 2]);
      sum[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = fmaf(l[h], alpha[h], sum[h]);
    }
    uint32_t pf[3][BK / 16][4];
    to_frags3<BK / 16>(s, pf);
    __syncthreads();      // V's tile is visible; every warpgroup is done
                          // with K's

    // O = O alpha + P V, six products into a fresh sum per kFold columns;
    // K's next tile is loaded before they are issued and split into its
    // slot while the first part runs
    const bool more = j + 1 < tiles;
    if (more) rows.load(k, kb + BK, p.sk);
    rs_products<C::kCols, C::kFold, BK / 16, kTermsUsed, kProducts, kFresh>(
        o, pf,
        [&](int t, int c, int kk) { return vd.mnmajor(t, col0 + c, kk); },
        [&](int i, float x) { return fmaf(o[i], alpha[(i / 2) % 2], x); },
        [&] {
          if (more) {
            rows.store(ks, 1.f, false);
            fence_proxy_async();
          }
        });
    __syncthreads();      // K's next tile is visible; V's slot is free
  }

  // out = O / max(l, 1e-30): 0 for a row that saw no key
  float* out = static_cast<float*>(p.out) + (size_t)bh * p.sq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + row0 + 8 * h;
    if (row >= p.sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // the row's 4 lanes (of one warpgroup) hold the same m and l; the
    // first writes its lse
    if (p.lse != nullptr && lane % 4 == 0 && (!C::kSplit || wg == 0)) {
      p.lse[(size_t)bh * p.sq + row] = m[h] + logf(denom);
    }
    float* orow = out + (size_t)row * D + col0 + c0;
#pragma unroll
    for (int c = 0; c < C::kCols / 8; ++c) {
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(o[4 * c + 2 * h] / denom, o[4 * c + 2 * h + 1] / denom);
    }
  }
}

template <int D>
int launch(const Args& p, int bh, cudaStream_t st) {
  using C = Cfg<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_x3<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (p.sq + C::kOwn - 1) / C::kOwn);
  flash_attention_x3<D><<<grid, kThreads, C::kSmem, st>>>(p);
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

}  // namespace x3

// the tiling of the kernel that runs inputs of this type at head width D
template <int D>
void tiling(int bf16, int* block_q, int* block_k, int* smem_bytes) {
  if (bf16) {
    *block_q = tc::kBlockQ;
    *block_k = tc::Tile<D>::kBlockK;
    *smem_bytes = tc::Tile<D>::kSmem;
  } else {
    *block_q = x3::Cfg<D>::kOwn;
    *block_k = x3::Cfg<D>::kBlockK;
    *smem_bytes = x3::Cfg<D>::kSmem;
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
  return bf16 ? tc::launch_d(p, bh, d, st) : x3::launch_d(p, bh, d, st);
}
