// Float32 products on the bf16 tensor cores, for the float32 forms of
// csrc/flash_attention.cu and csrc/flash_attention_bwd.cu (never TF32).
//
// Each float32 operand x is split into three bf16 terms, each rounded to
// nearest even: hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid).
// Both differences are exact in float32 and lo holds what is left whole, so
// hi + mid + lo == x for every x whose lo term is a normal bf16 (|x| above
// ~2^-110, and 0); |mid| <= 2^-8 |x| and |lo| <= 2^-16 |x|. bf16 has
// float32's exponent range, so no term overflows where x does not (but for
// x within half a bf16 unit of float32's largest value). A product
// a b is the sum of the six cross products that reach 2^-16 of |a| |b|:
// hi.hi, hi.mid, mid.hi, hi.lo, mid.mid and lo.hi; the three left out
// (mid.lo, lo.mid, lo.lo) weigh at most 2^-23 of it together, float32's own
// rounding. Each bf16 x bf16 product is exact in float32, and wgmma sums the
// products in a float32 accumulator. The small cross products are issued
// first and hi.hi last, so the large sums come after the small ones; the
// kernels add each tile's products into a fresh accumulator and fold it
// into the running sum in float32 (``kFresh``), so that no tensor-core sum,
// which may truncate, runs over more than one tile.
//
// The planes. A (rows, D) tile is three bf16 planes, hi, mid and lo, one
// after another, each laid out as TMA writes a tile of the bf16 kernels:
// boxes of min(D, 64) columns, rows of 32, 64 or 128 bytes whose 16-byte
// chunks are swizzled (chunk ^= row bits, as the tensor map's 32-, 64- or
// 128-byte swizzle), each box ``rows`` x row bytes, every box on 1024 bytes.
// ``Rows`` loads float32 rows by 16-byte loads, splits them and writes the
// planes by 16-byte stores, so that the K-major and MN-major descriptors of
// the bf16 kernels read them as they are: TMA cannot split, so the block's
// threads do, and no float32 copy of a tile is kept in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace split3 {

using namespace hopper;

// the six cross products (a term, b term) in the order they are issued, the
// small ones first: (lo, hi), (hi, lo), (mid, mid), (mid, hi), (hi, mid),
// (hi, hi); terms 0 = hi, 1 = mid, 2 = lo. Two terms keep the last three.
__host__ __device__ constexpr int term_a(int t) {
  return t == 0 ? 2 : (t == 2 || t == 3) ? 1 : 0;
}
__host__ __device__ constexpr int term_b(int t) {
  return t == 1 ? 2 : (t == 2 || t == 4) ? 1 : 0;
}
// the first of the six products that runs with ``terms`` terms (3 or 2)
__host__ __device__ constexpr int first_product(int terms) {
  return terms == 3 ? 0 : 3;
}

// a and b as one bf16x2 register of each of their three terms
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float a1 = a - __low2float(h);
  const float b1 = b - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(a1, b1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a1 - __low2float(m),
                                                 b1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments of a 64 x (16 kSteps) accumulator's three terms: register
// r of k step kk holds elements 8 kk + 2 r and 8 kk + 2 r + 1
template <int kSteps>
__device__ __forceinline__ void to_frags3(const float (&x)[8 * kSteps],
                                          uint32_t (&a)[3][kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], a[0][kk][r],
             a[1][kk][r], a[2][kk][r]);
    }
  }
}

// the box layout of a tile at head width D
template <int D>
struct Planes {
  static constexpr int kBoxCols = D < 64 ? D : 64;     // columns per box
  static constexpr int kRowBytes = 2 * kBoxCols;       // a box row
  static constexpr Swizzle kSwizzle = swizzle_of(kRowBytes);
  static constexpr int kChunkMask = kRowBytes / 16 - 1;
  // the three planes of a tile of ``rows`` rows
  static constexpr int bytes(int rows) { return 3 * rows * D * 2; }
};

// the byte offset, in one plane of a ``rows``-row tile, of the 16-byte chunk
// that holds columns [col, col + 8) of row r, swizzled
template <int D>
__device__ __forceinline__ int chunk_at(int rows, int r, int col) {
  using P = Planes<D>;
  const int o = r * P::kRowBytes + (col % P::kBoxCols) * 2;
  return col / P::kBoxCols * rows * P::kRowBytes +
         (o ^ (((o >> 7) & P::kChunkMask) << 4));
}

// rows [row0, row0 + R) of a float32 (total, D) matrix in registers, each
// thread's share of the tile's 8-column chunks, between their loads and
// their split into planes: ``load`` issues every 16-byte load at once
// (rows past ``total`` are zeros), ``store`` splits the rows (times ``mul``
// where ``scaled``, rounded once) and writes the three planes of ``tile``.
// Loaded before a product is issued and stored after, the loads' latency
// runs under the products.
template <int D, int R, int kThreads>
struct Rows {
  static constexpr int kChunks = R * D / 8;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  float4 x[kPer][2];

  __device__ __forceinline__ void load(const float* src, int row0,
                                       int total) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = threadIdx.x + i * kThreads;
      const int r = t / (D / 8);
      x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < kChunks && row0 + r < total) {
        const float4* g = reinterpret_cast<const float4*>(
            src + (size_t)(row0 + r) * D + t % (D / 8) * 8);
        x[i][0] = __ldg(g);
        x[i][1] = __ldg(g + 1);
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* tile, float mul,
                                        bool scaled) const {
    constexpr int kPlane = R * D * 2;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int t = threadIdx.x + i * kThreads;
      if (t >= kChunks) continue;
      float v[8] = {x[i][0].x, x[i][0].y, x[i][0].z, x[i][0].w,
                    x[i][1].x, x[i][1].y, x[i][1].z, x[i][1].w};
      if (scaled) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(v[e], mul);
      }
      uint4 h, m, l;
      split2(v[0], v[1], h.x, m.x, l.x);
      split2(v[2], v[3], h.y, m.y, l.y);
      split2(v[4], v[5], h.z, m.z, l.z);
      split2(v[6], v[7], h.w, m.w, l.w);
      const int at = chunk_at<D>(R, t / (D / 8), t % (D / 8) * 8);
      *reinterpret_cast<uint4*>(tile + at) = h;
      *reinterpret_cast<uint4*>(tile + kPlane + at) = m;
      *reinterpret_cast<uint4*>(tile + 2 * kPlane + at) = l;
    }
  }
};

// ``Rows``' load and store at once
template <int D, int R, int kThreads>
__device__ __forceinline__ void stage3(unsigned char* tile, const float* src,
                                       int row0, int total, float mul,
                                       bool scaled) {
  Rows<D, R, kThreads> rows;
  rows.load(src, row0, total);
  rows.store(tile, mul, scaled);
}

// an R-row tile's planes as wgmma operands. The start's descriptors (K-major
// and MN-major) are made where the Operand is, in a sweep's loop, and
// hidden from the compiler there, so that each operand's descriptor (one
// add to them) is made at its product: unhidden, the compiler kept every
// descriptor of an owned tile live across the sweep (2 registers each; at
// D = 256 the backward spilled), and a loop over the k steps instead of
// unrolling them made the products ~15% slower.
template <int D, int R>
struct Operand {
  using P = Planes<D>;
  uint64_t k, mn;

  __device__ __forceinline__ explicit Operand(const unsigned char* tile)
      : k(desc(tile, 16, 8 * P::kRowBytes, P::kSwizzle)),
        mn(desc(tile, R * P::kRowBytes, 8 * P::kRowBytes, P::kSwizzle)) {
    asm volatile("" : "+l"(k), "+l"(mn));
  }

  // term t as a K-major operand from row ``row0`` (a multiple of 8), k
  // step kk (16 columns)
  __device__ __forceinline__ uint64_t kmajor(int t, int row0, int kk) const {
    return k + ((t * R * D * 2 + kk * 16 / P::kBoxCols * R * P::kRowBytes +
                 row0 * P::kRowBytes + (kk * 16 % P::kBoxCols) * 2) >> 4);
  }

  // term t as an MN-major B operand (the tile's rows are the product's k)
  // from column ``col0`` (a multiple of the box's width where D >= 64), k
  // step kk: lbo steps from one box to the next, sbo from 8 rows to the
  // next 8
  __device__ __forceinline__ uint64_t mnmajor(int t, int col0,
                                              int kk) const {
    return mn + ((t * R * D * 2 + col0 / P::kBoxCols * R * P::kRowBytes +
                  kk * 16 * P::kRowBytes) >> 4);
  }
};

// d (64 x N) = A B over kSteps k steps, A and B from shared memory: the
// products of kTerms terms (``a(term, kk)``, ``b(term, kk)`` their
// descriptors), the first overwriting d; issued, not waited. ``kOn`` false
// issues nothing (a probe).
template <int N, int kSteps, int kTerms, bool kOn, typename A, typename B>
__device__ __forceinline__ void ss_products(float (&d)[N / 2], A&& a,
                                            B&& b) {
  if constexpr (kOn) {
    constexpr int first = first_product(kTerms);
#pragma unroll
    for (int t = first; t < 6; ++t) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_ss<N>(d, a(term_a(t), kk), b(term_b(t), kk),
                    t > first || kk > 0);
      }
    }
  }
}

// d (64 x kCols, a warpgroup's accumulator) gets A B, A the three terms'
// fragments of a 64 x (16 kSteps) operand, B ``b(term, col, kk)`` (the
// descriptor of term ``term`` from column ``col``), kFold columns at a
// time. With kFresh each part's products go into a fresh accumulator and
// ``fold(j, x)`` gives d[j] from it (x its element j of d's layout);
// without, ``fold(j, 0)`` is applied first and the products go into d.
// ``between()`` runs while the first part's products run. Every part is
// waited.
template <int kCols, int kFold, int kSteps, int kTerms, bool kOn,
          bool kFresh, typename B, typename Fold, typename Between>
__device__ __forceinline__ void rs_products(float (&d)[kCols / 2],
                                            const uint32_t (&a)[3][kSteps][4],
                                            B&& b, Fold&& fold,
                                            Between&& between) {
  constexpr int first = first_product(kTerms);
  auto issue = [&](float (&acc)[kFold / 2], int c) {
    wgmma_fence();
    if constexpr (kOn) {
#pragma unroll
      for (int t = first; t < 6; ++t) {
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          wgmma_rs<kFold>(acc, a[term_a(t)][kk], b(term_b(t), c, kk));
        }
      }
    }
    wgmma_commit();
    if (c == 0) between();
    wgmma_wait0();
    fence_regs(acc);
  };
#pragma unroll
  for (int c = 0; c < kCols; c += kFold) {
    if constexpr (kFresh) {
      float acc[kFold / 2];
#pragma unroll
      for (int i = 0; i < kFold / 2; ++i) acc[i] = 0.f;
      issue(acc, c);
#pragma unroll
      for (int i = 0; i < kFold / 2; ++i) {
        d[c / 2 + i] = fold(c / 2 + i, acc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kFold / 2; ++i) {
        d[c / 2 + i] = fold(c / 2 + i, 0.f);
      }
      issue(*reinterpret_cast<float(*)[kFold / 2]>(&d[c / 2]), c);
    }
  }
}

}  // namespace split3
