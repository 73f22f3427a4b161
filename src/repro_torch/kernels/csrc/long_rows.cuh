// A row's fold spread over a block (sm_90a): the block's threads stream the
// row's message rows through a shared-memory ring by asynchronous copies,
// tens of KB ahead, while the threads that own the row's columns fold them
// from shared memory in stream order; and, where the row's segment was
// placed out of order (edge_buckets.cuh's bucket_edges), a block-level sort
// of that segment alone. mp_scatter.cu folds every row of its block form and
// the long rows of its grid form this way; mp_pipeline, seg_softmax and
// layer_fused's hub tiles could take the same two pieces.
//
// The ring. A block folds one chunk of at most kChunkBytes of each message
// row (the columns [c0, c0 + cw)): kStages slots of kStageBytes, each
// holding as many rows' chunks as fit at a stride of the chunk's bytes
// rounded up to 16 (40 rows of D = 100 float32, 128 of 128-byte chunks).
// Every thread copies: 16 bytes of one chunk a thread and instruction
// (cp.async.cg; the block's 256 lanes cover as many whole chunks as fit)
// where rows start on 16 bytes, 4 bytes a lane of one warp's entry where
// they start on 4, else element by element through registers. Each stage
// is one cp.async group; kStages - 1 stages (up to 48 KB) are in flight
// while one is folded, and one block barrier a stage hands a landed stage
// to the owners and its slot back to the copies. Threads 0-127 own the
// chunk's 4-byte words (one float32 column or two bfloat16 ones) and fold
// each over the stage's entries in order, 8 entries' words read before any
// is folded: every (row, column) is folded by one thread, in the order of
// the entries, whatever the block's size, the grid or the run. (Handing
// stages over by mbarriers instead, producer and consumer warps apart,
// measured slower on an H100: ~0.4-1.4 us a stage went to the hand-over; a
// bulk copy a row, cp.async.bulk, moved 128-byte chunks at ~5 GB/s an SM.)
//
// The sort. sorted_segment lists a segment of distinct edge indices, written
// in any order, in ascending order: for each window of kWindow indices the
// block sets one bit an edge in a bitmap in shared memory (one atomicOr a
// word a warp: a segment's runs share words), counts each thread's
// consecutive words, scans the counts and lists the indices kList at a
// time. It reads the segment once a window and never the edge stream:
// O(len * ceil(E / kWindow) + E / 32) work for a row of len edges.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "edge_buckets.cuh"
#include "hopper.cuh"

namespace long_rows {

using buckets::kThreads;
using buckets::kWarps;

// the bytes of a message row one block folds: 128 words, one a consumer
constexpr int kChunkBytes = 512;
constexpr int kChunkWords = kChunkBytes / 4;
// a ring of kStages slots of kStageBytes
template <int kStageBytes, int kStages>
constexpr int kRingBytes = kStages * kStageBytes;
// the sort: a bitmap of kWindow edge indices (8 KB) and a list of kList
constexpr int kWindow = 1 << 16;
constexpr int kBitmapWords = kWindow / 32;
constexpr int kList = 2048;
// shared memory of sorted_segment: bitmap, list, scan
constexpr int kSortBytes = (kBitmapWords + kList + kWarps + 1) * 4;

// how a chunk is copied: rows on 16 bytes, on 4, or neither
enum Copy { kCopy16 = 0, kCopy4 = 1, kCopyElem = 2 };

// The chunk a block folds: columns [c0, c0 + cw) of the (e, d) rows of
// `es`-byte elements at msg, cw * es <= kChunkBytes; slot: its stride in a
// stage, cw * es rounded up to 16.
struct Chunk {
  const uint8_t* msg;
  int d, es, c0, cw;
  int copy;   // Copy: the same for every row of a launch
  int slot;
};

__host__ __device__ constexpr int slot_of(int bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ const uint8_t* chunk_src(const Chunk& c, int id) {
  return c.msg + (static_cast<size_t>(id) * c.d + c.c0) * c.es;
}

// Lane `lane` of one warp copies its part of row id's chunk to dst, rows
// off 16 bytes (kCopy4 or kCopyElem).
__device__ __forceinline__ void copy_chunk(const Chunk& c, int id,
                                           uint8_t* dst, int lane) {
  const uint8_t* src = chunk_src(c, id);
  const int bytes = c.cw * c.es;
  if (c.copy == kCopy4) {
#pragma unroll
    for (int q = 0; q < kChunkWords / 32; ++q) {
      const int o = (lane + 32 * q) * 4;
      if (o < bytes) hopper::cp_async4(dst + o, src + o);
    }
  } else if (c.es == 2) {
    const auto* s16 = reinterpret_cast<const unsigned short*>(src);
    auto* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
    for (int q = 0; q < kChunkBytes / 64; ++q) {
      const int k = lane + 32 * q;
      if (k < c.cw) d16[k] = __ldg(s16 + k);
    }
  } else {
    const auto* s32 = reinterpret_cast<const unsigned*>(src);
    auto* d32 = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int q = 0; q < kChunkWords / 32; ++q) {
      const int k = lane + 32 * q;
      if (k < c.cw) d32[k] = __ldg(s32 + k);
    }
  }
}

// Streams the chunks of the rows ids[0, total) (ids in shared memory)
// through the ring in order, and calls consume(j0, cnt, stage) once the
// chunks of entries [j0, j0 + cnt) have landed in `stage` (entry j0 + k at
// stage + k * c.slot). Every thread of the block calls it; consume must not
// wait on the block. Returns after a barrier, every copy landed.
template <int kStageBytes, int kStages, typename Consume>
__device__ __forceinline__ void stream(const Chunk& c, const int* ids,
                                       int total, uint8_t* ring,
                                       Consume&& consume) {
  const int per = kStageBytes / c.slot;   // entries a stage
  const int stages = (total + per - 1) / per;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // 16-byte copies: thread t one 16-byte group of one of `fit` whole
  // chunks an instruction of the block; else a warp an entry
  const bool wide = c.copy == kCopy16;
  const int groups = c.slot / 16;
  const int fit = kThreads / groups;
  const int mine = tid / groups;
  const int group = tid - mine * groups;
  const auto issue = [&](int s) {
    uint8_t* dst = ring + (s % kStages) * kStageBytes;
    const int j0 = s * per;
    const int cnt = min(per, total - j0);
    if (wide) {
      if (mine < fit) {
        for (int jj = mine; jj < cnt; jj += fit) {
          hopper::cp_async16(dst + jj * c.slot + group * 16,
                             chunk_src(c, ids[j0 + jj]) + group * 16);
        }
      }
    } else {
      for (int jj = warp; jj < cnt; jj += kWarps) {
        copy_chunk(c, ids[j0 + jj], dst + jj * c.slot, lane);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < stages) issue(s);
    hopper::cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    hopper::cp_async_wait<kStages - 2>();
    // stage s has landed for every thread, and every owner has folded
    // stage s - 1, whose slot the next issue rewrites
    __syncthreads();
    if (s + kStages - 1 < stages) issue(s + kStages - 1);
    hopper::cp_async_commit();
    const int j0 = s * per;
    consume(j0, min(per, total - j0), ring + (s % kStages) * kStageBytes);
  }
  hopper::cp_async_wait<0>();
  __syncthreads();
}

// The words of n entries from `at` (stride `stride` words), all read
// before any is folded.
template <int n, typename Fold>
__device__ __forceinline__ void fold_batch(const uint32_t* at, int stride,
                                           Fold&& fold) {
  uint32_t v[n];
#pragma unroll
  for (int u = 0; u < n; ++u) v[u] = at[u * stride];
#pragma unroll
  for (int u = 0; u < n; ++u) fold(v[u]);
}

// fold(word) for the entries [lo, hi) of a stage (stride `slot` bytes),
// word w of each, in order: 8 entries' words read before any of them is
// folded, then 4, then one at a time. (Predicating a last batch of 8
// doubled a hub's fold on an H100.)
template <typename Fold>
__device__ __forceinline__ void fold_range(const uint8_t* stage, int slot,
                                           int lo, int hi, int w,
                                           Fold&& fold) {
  const int stride = slot / 4;
  const uint32_t* at = reinterpret_cast<const uint32_t*>(stage) + w;
  int k = lo;
  for (; k + 8 <= hi; k += 8) fold_batch<8>(at + k * stride, stride, fold);
  if (k + 4 <= hi) {
    fold_batch<4>(at + k * stride, stride, fold);
    k += 4;
  }
  for (; k < hi; ++k) fold(at[k * stride]);
}

// Calls take(list, cnt) with the segment seg[0, len) (distinct edge indices
// in [0, e), in any order; global memory written before a grid barrier, read
// through L2) in ascending order, kList at a time, the list in shared
// memory. `smem` holds kSortBytes. Every thread of the block calls it, and
// take, which may use the block's barriers; take's list is rewritten only
// after take returns and a barrier.
template <typename Take>
__device__ __forceinline__ void sorted_segment(const int* seg, int len,
                                               int e, uint8_t* smem,
                                               Take&& take) {
  uint32_t* bitmap = reinterpret_cast<uint32_t*>(smem);
  int* list = reinterpret_cast<int*>(bitmap + kBitmapWords);
  int* sh = list + kList;
  const int tid = threadIdx.x;
  for (int w0 = 0; w0 < e; w0 += kWindow) {
    const int span = min(kWindow, e - w0);
    const int words = (span + 31) >> 5;
    for (int k = tid; k < words; k += kThreads) bitmap[k] = 0u;
    __syncthreads();
    // one atomicOr a word a warp (a segment's runs, a warp's placement,
    // share words); 8 entries' loads a thread in flight
    constexpr int kBatch = 8;
    for (int j0 = 0; j0 < len; j0 += kBatch * kThreads) {
      int rel[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * kThreads + tid;
        rel[u] = j < len ? __ldcg(seg + j) - w0 : -1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const bool in = rel[u] >= 0 && rel[u] < span;
        const int word = in ? rel[u] >> 5 : -1;
        const unsigned peers = __match_any_sync(buckets::kFull, word);
        const uint32_t bits = __reduce_or_sync(peers, in ? 1u << (rel[u] & 31)
                                                         : 0u);
        if (in && (tid & 31) == __ffs(peers) - 1) {
          atomicOr(bitmap + word, bits);
        }
      }
    }
    __syncthreads();
    // thread t lists the words [lo, hi): its indices follow every earlier
    // thread's
    const int per = (words + kThreads - 1) / kThreads;
    const int lo = min(words, tid * per);
    const int hi = min(words, lo + per);
    int mine = 0;
    for (int k = lo; k < hi; ++k) mine += __popc(bitmap[k]);
    int total = 0;
    const int base = buckets::block_exclusive_scan(mine, sh, &total);
    for (int p0 = 0; p0 < total; p0 += kList) {
      if (base < p0 + kList && base + mine > p0) {
        int at = base;
        for (int k = lo; k < hi && at < p0 + kList; ++k) {
          uint32_t bits = bitmap[k];
          const int cnt = __popc(bits);
          if (at + cnt <= p0) {
            at += cnt;
            continue;
          }
          while (bits) {
            const int bit = __ffs(bits) - 1;
            bits &= bits - 1;
            if (at >= p0 && at < p0 + kList) {
              list[at - p0] = w0 + (k << 5) + bit;
            }
            ++at;
          }
        }
      }
      __syncthreads();
      take(static_cast<const int*>(list), min(kList, total - p0));
      __syncthreads();   // the list is rewritten next
    }
  }
}

}  // namespace long_rows
