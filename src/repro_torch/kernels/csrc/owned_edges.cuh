// Owner-computes edge compaction, shared by the scatter kernels that sweep a
// materialised edge stream (mp_scatter.cu, seg_softmax.cu).
//
// A block owns the destination rows [row0, row0 + rows_here) and sweeps the
// whole edge stream in stream order, kEdgeTile edges at a time. For each
// tile, compact_owned_edges lists the tile's unmasked edges whose receiver
// the block owns, in stream order, in shared memory: list_e holds the edge
// index, list_r the row relative to row0. Masked edges (the padding points
// at node 0) and receivers outside the block's rows never enter the list.
// Each thread looks at kEdgesPerThread consecutive edges; a block-wide
// exclusive scan of the per-thread counts gives each its list slots.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace owned {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;

// Shared-memory bytes of the list and the scan: list_e, list_r, scan.
constexpr size_t kListBytes = (2 * kEdgeTile + kWarps + 1) * sizeof(int);

// Every thread of the block calls this with the same arguments; `scan`
// holds kWarps + 1 ints. Returns the number of listed edges. Ends with a
// barrier, so the list is ready to read; the caller puts a barrier between
// its reads and the next call, which rewrites the list.
__device__ __forceinline__ int compact_owned_edges(
    const int64_t* rcv, const uint8_t* mask, int e_total, int base,
    int row0, int rows_here, int* list_e, int* list_r, int* scan) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e0 = base + tid * kEdgesPerThread;
  int local[kEdgesPerThread];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kEdgesPerThread; ++k) {
    const int e = e0 + k;
    local[k] = -1;
    if (e < e_total && mask[e]) {
      const int64_t r = rcv[e] - row0;
      if (r >= 0 && r < rows_here) {
        local[k] = static_cast<int>(r);
        ++cnt;
      }
    }
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? scan[lane] : 0;
    int s = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += u;
    }
    if (lane < kWarps) scan[lane] = s - v;
    if (lane == kWarps - 1) scan[kWarps] = s;
  }
  __syncthreads();
  int slot = scan[warp] + incl - cnt;
#pragma unroll
  for (int k = 0; k < kEdgesPerThread; ++k) {
    if (local[k] >= 0) {
      list_e[slot] = e0 + k;
      list_r[slot] = local[k];
      ++slot;
    }
  }
  __syncthreads();
  return scan[kWarps];
}

// Rows per block when the caller does not choose: one block per SM where
// the rows allow it, fewer rows while the block's shared memory
// (smem(rows) bytes) is over the device's limit.
template <typename SmemFn>
int default_rows(int n, SmemFn smem) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int rows = (n + sms - 1) / sms;
  while (rows > 1 && smem(rows) > static_cast<size_t>(max_smem)) {
    rows = (rows + 1) / 2;
  }
  return rows < 1 ? 1 : rows;
}

}  // namespace owned
