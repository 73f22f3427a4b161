// Owner bucketing of a materialised edge stream, so that each destination
// row reads only its own edges, in stream order: bucket_edges for kernels
// launched cooperatively (cudaLaunchCooperativeKernel, every block
// resident; mp_scatter.cu's grid form), bucket_edges_keyed for such kernels
// whose blocks own tiles of rows (layer_fused.cu's grid form),
// bucket_edges_stable for one block's rows of a tile (mp_pipeline.cuh,
// seg_softmax.cu, mp_scatter.cu's block form).
//
// bucket_edges builds the buckets of the rows [lo, hi) in four phases, each
// followed by a barrier:
//   0. clear counts
//   1. count the owned edges per row: unmasked, receiver in [lo, hi) and in
//      [0, n). One integer atomicAdd per distinct row of a warp's 32 edges
//      (__match_any_sync); counts do not depend on the order of the adds.
//      A thread loads the mask and receiver of its first kKeys edges at
//      once and keeps their rows in registers for phase 3.
//   2. exclusive scan of counts into row_start (hi - lo + 1 entries); the
//      caller's `scanned(row, start, count)` sees each row once here
//      (mp_scatter lists its long rows).
//   3. place each owned edge's index into order, inside its row's segment
//      order[row_start[r], row_start[r+1]) (r relative to lo): one atomicSub
//      on counts[r] per distinct row of a warp (counts end at 0). Lanes of
//      one warp keep stream order among themselves; warps do not, so a
//      segment's order is not stream order yet.
// The whole grid builds the buckets of every row in global scratch, with
// grid barriers (cooperative_groups::this_grid().sync(); CUDA 12 needs no
// -rdc for it). In phase 2 block b scans its chunk of rows with a block
// scan, offset by the sum of the counts before the chunk, which it adds up
// itself: no second barrier, O(grid * n) reads from L2 in all. Scratch
// reads after a barrier go through L2 (__ldcg): a block's L1 may hold a
// line that another SM has since rewritten.
// segment_head reads a row's segment start, length and first edge; one
// lane a row, so one round trip serves a warp's next 32 work items.
// fold_sorted restores a short segment's stream order in registers: a
// segment of at most 32 edges is sorted ascending in one register a lane,
// one of at most 32 * K in K (a bitonic network over shuffles and
// registers; the caller picks K). A longer segment is not a warp's: its
// order comes from long_rows.cuh's block-level sort of that segment alone.
// bucket_edges_stable (below) keeps stream order as it places the edges,
// so its segments need no sort at all.
//
// Atomics count and place edges here, where order cannot change a value;
// no message is ever added by an atomic.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace buckets {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// edges a thread keeps in registers from phase 1 to phase 3 (all of them
// at the GNN buckets and the MoE widths); any further edge is read again
constexpr int kKeys = 16;

struct Edges {
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  int n, e;
};

// The buckets of the rows [lo, hi), indexed relative to lo: counts
// (hi - lo), row_start (hi - lo + 1), order (room for the rows' owned
// edges, at most e).
struct Buckets {
  int* counts;
  int* row_start;
  int* order;
  int lo, hi;
};

// The destination row of edge i when the edge is owned, else -1. The mask
// and the receiver are loaded together, not one after the other.
__device__ __forceinline__ int owned_row(const Edges& g, long long i) {
  if (i >= g.e) return -1;
  const bool unmasked = __ldg(g.mask + i) != 0;
  const int64_t r = __ldg(g.rcv + i);
  return (unmasked && r >= 0 && r < g.n) ? static_cast<int>(r) : -1;
}

// Edge i's row relative to b.lo when it is owned and in b's rows, else -1.
__device__ __forceinline__ int bucket_of(const Edges& g, const Buckets& b,
                                         long long i) {
  const int r = owned_row(g, i);
  return (r >= b.lo && r < b.hi) ? r - b.lo : -1;
}

// scratch written by other blocks before a grid barrier: read through L2
__device__ __forceinline__ int load(const int* p) { return __ldcg(p); }

__device__ __forceinline__ void barrier() {
  cooperative_groups::this_grid().sync();
}

// Block-wide exclusive scan of one int a thread; *total gets the block's
// sum. `sh` holds kWarps + 1 ints; every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* sh,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kWarps ? sh[lane] : 0;
    int s = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += u;
    }
    if (lane < kWarps) sh[lane] = s - w;
    if (lane == kWarps - 1) sh[kWarps] = s;
  }
  __syncthreads();
  const int out = sh[warp] + incl - v;
  *total = sh[kWarps];
  __syncthreads();   // sh is rewritten by the next call
  return out;
}

// Phases 0-3 with the bucket of edge i given by key_of(i) (-1: none),
// `sh` kWarps + 1 ints of shared memory; scanned(key, start, count) is
// called once for each bucket as phase 2 scans it. Every thread of the
// cooperative grid calls it. Returns after the last barrier, the buckets
// ready.
template <typename Key, typename Scanned>
__device__ __forceinline__ void bucket_edges_by(const Edges& g,
                                                const Buckets& b,
                                                Key&& key_of, int* sh,
                                                Scanned&& scanned) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int blocks = static_cast<int>(gridDim.x);
  const int me = static_cast<int>(blockIdx.x);
  const long long stride = static_cast<long long>(blocks) * kThreads;
  const long long first = static_cast<long long>(me) * kThreads;
  const int rows = b.hi - b.lo;

  // 0. clear
  for (long long i = first + tid; i < rows; i += stride) b.counts[i] = 0;
  barrier();

  // 1. count; loop bounds are the same for all lanes of a warp, so every
  // lane reaches __match_any_sync. The first kKeys edges of each thread are
  // loaded at once and kept for phase 3.
  int keys[kKeys];
#pragma unroll
  for (int k = 0; k < kKeys; ++k) keys[k] = key_of(first + k * stride + tid);
  const auto count = [&](int key) {
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(b.counts + key, __popc(peers));
    }
  };
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (first + k * stride < g.e) count(keys[k]);
  }
  for (long long base = first + kKeys * stride; base < g.e; base += stride) {
    count(key_of(base + tid));
  }
  barrier();

  // 2. scan: this block takes rows [lo, hi)
  const int chunk = (rows + blocks - 1) / blocks;
  const int lo = min(rows, me * chunk);
  const int hi = min(rows, lo + chunk);
  if (lo < hi) {
    int before = 0;
    for (int i = tid; i < lo; i += kThreads) {
      before += load(b.counts + i);
    }
    int offset = 0;
    block_exclusive_scan(before, sh, &offset);
    for (int base = lo; base < hi; base += kThreads) {
      const int i = base + tid;
      const int v = i < hi ? load(b.counts + i) : 0;
      int total = 0;
      const int excl = block_exclusive_scan(v, sh, &total);
      if (i < hi) {
        b.row_start[i] = offset + excl;
        scanned(i, offset + excl, v);
      }
      offset += total;
    }
    if (hi == rows && tid == 0) b.row_start[rows] = offset;
  }
  barrier();

  // 3. place
  const auto place = [&](int key, long long i) {
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    const int take = __popc(peers);
    int left = 0;
    if (key >= 0 && lane == leader) left = atomicSub(b.counts + key, take);
    left = __shfl_sync(kFull, left, leader);
    if (key >= 0) {
      const int rank = __popc(peers & ((1u << lane) - 1u));
      b.order[load(b.row_start + key) + left - take + rank] =
          static_cast<int>(i);
    }
  };
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    if (first + k * stride < g.e) place(keys[k], first + k * stride + tid);
  }
  for (long long base = first + kKeys * stride; base < g.e; base += stride) {
    place(key_of(base + tid), base + tid);
  }
  barrier();
}

// A bucketing's phase 2 with nothing to note.
struct Unscanned {
  __device__ __forceinline__ void operator()(int, int, int) const {}
};

// Phases 0-3 by row (b's rows [lo, hi)) across the cooperative grid;
// scanned(row - lo, start, count) as bucket_edges_by's.
template <typename Scanned>
__device__ __forceinline__ void bucket_edges(const Edges& g, const Buckets& b,
                                             Scanned&& scanned) {
  __shared__ int sh[kWarps + 1];
  bucket_edges_by(
      g, b, [&](long long i) { return bucket_of(g, b, i); }, sh, scanned);
}

// Phases 0-3 across the grid by tile: the owned edges of the rows [0, g.n)
// keyed by row / per_key, b's keys [0, ceil(n / per_key)) (b.lo = 0). A
// tile of per_key rows then reads its edges as one segment, and phase 2
// scans n / per_key counts, not n. Every thread of a cooperative grid
// calls it; `sh` is kWarps + 1 ints of the caller's shared memory.
__device__ __forceinline__ void bucket_edges_keyed(const Edges& g,
                                                   const Buckets& b,
                                                   int per_key, int* sh) {
  bucket_edges_by(
      g, b,
      [&](long long i) {
        const int r = owned_row(g, i);
        return r >= 0 ? r / per_key : -1;
      },
      sh, Unscanned{});
}

// Ascending sort of 32 * K ints across the warp, element r * 32 + lane in
// v[r] (a bitonic network: shuffles between lanes, swaps between a
// thread's registers).
template <int K>
__device__ __forceinline__ void warp_sort(int (&v)[K]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32 * K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const bool up = ((r * 32 + lane) & k) == 0;
        if (j < 32) {
          const int other = __shfl_xor_sync(kFull, v[r], j);
          const bool low = (lane & j) == 0;
          v[r] = (low == up) ? min(v[r], other) : max(v[r], other);
        } else if ((r & (j >> 5)) == 0) {
          const int q = r | (j >> 5);   // the partner, 32 * q + lane
          const int lo = min(v[r], v[q]), hi = max(v[r], v[q]);
          v[r] = up ? lo : hi;
          v[q] = up ? hi : lo;
        }
      }
    }
  }
}

// The segment of `row` (in b's rows): its start in order, its length and,
// when it is not empty, its first edge. Each lane may ask for another row,
// so that one round trip serves up to 32 work items.
__device__ __forceinline__ void segment_head(const Buckets& b, int row,
                                             int* start, int* len,
                                             int* first) {
  *start = load(b.row_start + row - b.lo);
  *len = load(b.row_start + row - b.lo + 1) - *start;
  *first = *len > 0 ? load(b.order + *start) : 0;
}

// Calls fold(ids, cnt) for the segment's edges in ascending order, in
// batches of at most U: the segment (start, len <= 32 * K) sorted in K
// registers a lane; a lone edge is `first`, read from no memory.
template <int K, int U, typename Fold>
__device__ __forceinline__ void fold_sorted(const Buckets& b, int start,
                                            int len, int first, Fold&& fold) {
  const int lane = threadIdx.x & 31;
  int v[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int t = r * 32 + lane;
    v[r] = t >= len ? INT_MAX : len == 1 ? first
                                         : load(b.order + start + t);
  }
  if (len > 1) warp_sort<K>(v);
  for (int j = 0; j < len; j += U) {
    int ids[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = (j + u) & (32 * K - 1);
      int held = v[0];
#pragma unroll
      for (int r = 1; r < K; ++r) held = (t >> 5) == r ? v[r] : held;
      ids[u] = __shfl_sync(kFull, held, t & 31);
    }
    fold(ids, min(U, len - j));
  }
}

// Calls fold(ids, cnt) for the owned edges of a row in stream order, in
// batches of at most U: ids[0, cnt) ascending, the same in every lane.
// (start, len <= 32 * K, first) is the row's segment_head, the same in
// every lane; every lane of the warp calls it. A segment of up to 32 edges
// is sorted in one register a lane, a longer one in K.
template <int U, int K, typename Fold>
__device__ __forceinline__ void fold_in_stream_order(const Buckets& b,
                                                     int start, int len,
                                                     int first, Fold&& fold) {
  if (K == 1 || len <= 32) {
    fold_sorted<1, U>(b, start, len, first, fold);
  } else {
    fold_sorted<K, U>(b, start, len, first, fold);
  }
}

// The stable block-local form: the owned edges of rows [b.lo, b.hi) among
// the tile's edges [0, g.e), g.e <= kThreads * kPer, each row's segment in
// stream order, so that no sort follows. Every thread of one block calls
// it. In round k thread t takes edge k * kThreads + t (coalesced) and
// loads its mask and receiver together (and the caller's streams beside
// them, x.load); a ballot per warp and round gives each owned edge its
// rank among its warp's, and one warp's scan of the (round, warp) counts
// its place in stream order. With one row that is the segment itself;
// with more the edges are listed in list_e (the edge) and list_r (its row
// relative to b.lo), then one warp counts the list's edges per row
// (__match_any_sync: one add per distinct row of 32 consecutive entries),
// scans the counts into row_start and places each entry after the earlier
// entries of its row, 32 at a time in list order: a stable counting sort.
// counts end at each row's segment end. Two to four block barriers and one
// warp's passes over the list, where bucket_edges takes atomics from every
// warp and fold_in_stream_order a sort of every segment.
// x.load(k, i) issues the caller's loads of edge i (the thread's k-th);
// x.store(k, i, owner, key) runs once they are in, with owner the edge's
// row when any row of [0, g.n) owns it (else -1) and key its row relative
// to b.lo when this block's rows do (else -1). Returns after a barrier,
// the buckets ready.
template <int kPer, typename Extra>
__device__ __forceinline__ void bucket_edges_stable(const Edges& g,
                                                    const Buckets& b,
                                                    int* list_e, int* list_r,
                                                    Extra& x) {
  // owned edges per (round, warp), then their exclusive scan; the total last
  __shared__ int before[kPer * kWarps + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = b.hi - b.lo;
  const int rounds = (g.e + kThreads - 1) / kThreads;
  uint8_t m[kPer];
  int64_t r[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + tid;
    const bool in = k < rounds && i < g.e;
    m[k] = in ? __ldg(g.mask + i) : 0;
    r[k] = in ? __ldg(g.rcv + i) : -1;
    if (in) x.load(k, i);
  }
  int key[kPer];
  unsigned bal[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + tid;
    const int owner = m[k] && r[k] >= 0 && r[k] < g.n ? static_cast<int>(r[k])
                                                       : -1;
    key[k] = owner >= b.lo && owner < b.hi ? owner - b.lo : -1;
    if (k < rounds) {
      bal[k] = __ballot_sync(kFull, key[k] >= 0);
      if (lane == 0) before[k * kWarps + warp] = __popc(bal[k]);
      if (i < g.e) x.store(k, i, owner, key[k]);
    }
  }
  __syncthreads();
  if (warp == 0) {   // the scan: kPer * kWarps / 32 entries a lane, in order
    constexpr int kEach = kPer * kWarps / 32;
    const int n = rounds * kWarps;
    int v[kEach];
    int sum = 0;
#pragma unroll
    for (int t = 0; t < kEach; ++t) {
      v[t] = lane * kEach + t < n ? before[lane * kEach + t] : 0;
      sum += v[t];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += u;
    }
    int run = incl - sum;
#pragma unroll
    for (int t = 0; t < kEach; ++t) {
      if (lane * kEach + t < n) before[lane * kEach + t] = run;
      run += v[t];
    }
    if (lane == 31) before[kPer * kWarps] = incl;
  }
  __syncthreads();
  const int total = before[kPer * kWarps];
  const unsigned below = (1u << lane) - 1u;
  if (rows == 1) {   // the list is the one row's segment
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (k < rounds && key[k] >= 0) {
        b.order[before[k * kWarps + warp] + __popc(bal[k] & below)] =
            k * kThreads + tid;
      }
    }
    if (tid == 0) {
      b.row_start[0] = 0;
      b.row_start[1] = b.counts[0] = total;
    }
    __syncthreads();
    return;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (k < rounds && key[k] >= 0) {
      const int slot = before[k * kWarps + warp] + __popc(bal[k] & below);
      list_e[slot] = k * kThreads + tid;
      list_r[slot] = key[k];
    }
  }
  __syncthreads();
  if (tid < 32) {
    for (int q = lane; q < rows; q += 32) b.counts[q] = 0;
    __syncwarp();
    for (int c = 0; c < total; c += 32) {
      const int q = c + lane < total ? list_r[c + lane] : -1;
      const unsigned peers = __match_any_sync(kFull, q);
      if (q >= 0 && lane == __ffs(peers) - 1) b.counts[q] += __popc(peers);
      __syncwarp();
    }
    int carry = 0;
    for (int q0 = 0; q0 < rows; q0 += 32) {
      const int q = q0 + lane;
      const int v = q < rows ? b.counts[q] : 0;
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += u;
      }
      if (q < rows) b.row_start[q] = b.counts[q] = carry + incl - v;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) b.row_start[rows] = carry;
    __syncwarp();
    for (int c = 0; c < total; c += 32) {
      const int q = c + lane < total ? list_r[c + lane] : -1;
      const unsigned peers = __match_any_sync(kFull, q);
      const int at = q >= 0 ? b.counts[q] : 0;
      __syncwarp();   // every lane has read its row's cursor
      if (q >= 0) {
        b.order[at + __popc(peers & ((1u << lane) - 1u))] = list_e[c + lane];
        if (lane == __ffs(peers) - 1) b.counts[q] = at + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

}  // namespace buckets
