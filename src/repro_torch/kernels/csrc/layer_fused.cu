// One GNN layer in one launch on Hopper (sm_90a): gather, phi, sum, update MLP.
//
// Replaces the TPU kernel repro/kernels/layer_fused.py::layer_fused (body
// _layer_fused_kernel), in its self-term epilogue (GIN, GCN):
//
//   phi_e = act( y[snd_e] * src_weight_e + edge_term_e + phi_bias )
//   acc_i = sum over unmasked edges e with rcv_e == i of phi_e     (f32)
//   z_i   = acc_i + self_coeff * x_i        (self_coeff scalar or per node)
//   h_i   = z_i @ w1 + b1 ; [ h_i = relu(h_i) @ w2 + b2 ] ; out_i = act_out(h_i)
//
// The Pallas kernel gathers and scatters with one-hot matrix products on the
// TPU's matrix unit (_gather_phi_tile, _route_matrix). That is a device of the
// TPU and is not carried over; this kernel computes what layer_fused_ref does.
//
// What bounds it on an H100. At GIN's paper width (D = 100, D_ff = 200) and
// N = 1024, E = 4096 the layer moves ~2.7 MB if each input is read once
// (edge_term 1.6 MB, node rows 0.4 MB, output 0.4 MB, weights 0.16 MB, indices
// 0.07 MB) and does ~82 MFLOP of epilogue in fp32 outside the tensor cores:
// both floors are ~1 us (3.35 TB/s, 67 TFLOP/s fp32). At the serving buckets
// (N = 32..64 nodes) the floors are well under 1 us and launch overhead rules.
//
// Design (simple and right first; speed is later work):
//   * Owner computes. Block b owns destination rows [b*R, b*R + R) and sweeps
//     the whole edge stream in stream order, a tile of kEdgeTile edges at a
//     time. Each thread classifies kEdgesPerThread consecutive edges; a
//     block-wide scan compacts the owned, unmasked edges of the tile into a
//     shared-memory list that keeps stream order. Masked edges never enter
//     the list, so they contribute nothing, not even their edge_term.
//   * Threads run over the D lanes; with D <= blockDim there are
//     blockDim / D groups of lanes and group g owns the rows r % groups == g.
//     Every (row, lane) of the f32 shared-memory accumulator is written by
//     exactly one thread, which adds its edges in stream order: no atomics,
//     and the result is bitwise the same for any R and from run to run.
//   * Epilogue in the same launch: the self term, then each dense layer as
//     fp32 FMAs with k in order (weights read through L2, kRowChunk rows per
//     weight load); the hidden layer (R x D_ff floats) stays in shared memory.
//     No TF32 anywhere. Shared memory above 48 KB is opted into per launch.
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;
constexpr int kRowChunk = 8;      // rows sharing one weight load in the MLP
constexpr int kUnroll = 4;        // edges whose loads are issued together

enum SrcWeightMode { kSwNone = 0, kSwScalar = 1, kSwFull = 2, kSwHead = 3 };
enum SelfMode { kSelfNone = 0, kSelfScalar = 1, kSelfNode = 2 };

struct Args {
  const float* x;        // (n, d) carry rows, read by the self term
  const float* y;        // (n, d) gather buffer (x unless node_input)
  const int64_t* snd;    // (e,)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  const float* sw;       // (e,), (e, d), (e, sw_cols) or null
  const float* et;       // (e, d) or null
  const float* pb;       // (d,) or null
  const float* sc;       // (1,) or (n,) or null
  const float* w1;       // (d, d_ff)
  const float* b1;       // (d_ff,)
  const float* w2;       // (d_ff, d_out) or null
  const float* b2;       // (d_out,) or null
  float* out;            // (n, d_out)
  int n, e, d, d_ff, d_out;
  int sw_mode, sw_cols, head_dim;
  int self_mode, phi_relu, out_relu;
  int rows;              // destination rows one block owns
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

size_t smem_bytes(int rows, int d, int d_ff, bool two_layer) {
  const size_t rows_alloc = round_up(rows, kRowChunk);
  const size_t floats = rows_alloc * d + (two_layer ? rows_alloc * d_ff : 0);
  return floats * sizeof(float) + 3 * kEdgeTile * sizeof(int) +
         (kWarps + 1) * sizeof(int);
}

__device__ __forceinline__ float phi(const Args& p, int e, int s, int dd) {
  float v = p.y[(size_t)s * p.d + dd];
  if (p.sw_mode == kSwScalar) {
    v = __fmul_rn(v, p.sw[e]);
  } else if (p.sw_mode == kSwFull) {
    v = __fmul_rn(v, p.sw[(size_t)e * p.d + dd]);
  } else if (p.sw_mode == kSwHead) {
    v = __fmul_rn(v, p.sw[(size_t)e * p.sw_cols + dd / p.head_dim]);
  }
  if (p.et != nullptr) v = __fadd_rn(v, p.et[(size_t)e * p.d + dd]);
  if (p.pb != nullptr) v = __fadd_rn(v, p.pb[dd]);
  if (p.phi_relu) v = fmaxf(v, 0.f);
  return v;
}

// dst[r, j] = act(b[j] + sum_k src[r, k] * w[k, j]) for r < rows, summed over
// k in order, so a row's result does not depend on how many rows a block has.
// src must hold round_up(rows, kRowChunk) rows.
__device__ void dense_rows(const float* src, int k_dim, int rows,
                           const float* __restrict__ w,
                           const float* __restrict__ b, int n_dim, float* dst,
                           int relu) {
  for (int j = threadIdx.x; j < n_dim; j += kThreads) {
    const float bj = b[j];
    for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
      float a[kRowChunk];
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) a[q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < k_dim; ++k) {
        const float wk = w[(size_t)k * n_dim + j];
#pragma unroll
        for (int q = 0; q < kRowChunk; ++q) {
          a[q] = fmaf(src[(r0 + q) * k_dim + k], wk, a[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        if (r0 + q < rows) {
          float h = a[q] + bj;
          if (relu) h = fmaxf(h, 0.f);
          dst[(size_t)(r0 + q) * n_dim + j] = h;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    layer_fused_kernel(const __grid_constant__ Args p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rows_alloc = round_up(p.rows, kRowChunk);
  const bool two_layer = p.w2 != nullptr;

  float* acc = smem;                                   // rows_alloc x d
  float* hid = acc + (size_t)rows_alloc * p.d;         // rows_alloc x d_ff
  int* list_e = reinterpret_cast<int*>(
      hid + (two_layer ? (size_t)rows_alloc * p.d_ff : 0));
  int* list_s = list_e + kEdgeTile;
  int* list_r = list_s + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1

  for (int i = tid; i < rows_alloc * p.d; i += kThreads) acc[i] = 0.f;
  if (two_layer) {
    for (int i = tid; i < rows_alloc * p.d_ff; i += kThreads) hid[i] = 0.f;
  }

  // lanes of the accumulate phase (see the design note above)
  const bool narrow = p.d <= kThreads;
  const int groups = narrow ? kThreads / p.d : 1;
  const int group = narrow ? tid / p.d : 0;
  const int lane0 = narrow ? tid % p.d : tid;
  const int lane_step = narrow ? p.d : kThreads;

  for (int base = 0; base < p.e; base += kEdgeTile) {
    // 1. which of this thread's consecutive edges does the block own?
    const int e0 = base + tid * kEdgesPerThread;
    int local[kEdgesPerThread];
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < kEdgesPerThread; ++k) {
      const int e = e0 + k;
      local[k] = -1;
      if (e < p.e && p.mask[e]) {
        const int64_t r = p.rcv[e] - row0;
        if (r >= 0 && r < rows_here) {
          local[k] = static_cast<int>(r);
          ++cnt;
        }
      }
    }
    // 2. block-wide exclusive scan of the counts: list slots in stream order
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
        list_s[slot] = static_cast<int>(p.snd[e0 + k]);
        list_r[slot] = local[k];
        ++slot;
      }
    }
    __syncthreads();
    const int total = scan[kWarps];

    // 3. each (row, lane) adds its edges' phi in stream order
    if (group < groups) {
      for (int dd = lane0; dd < p.d; dd += lane_step) {
        for (int i = 0; i < total; i += kUnroll) {
          float v[kUnroll];
          int rr[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            rr[u] = -1;
            v[u] = 0.f;
            if (i + u < total && list_r[i + u] % groups == group) {
              rr[u] = list_r[i + u];
              v[u] = phi(p, list_e[i + u], list_s[i + u], dd);
            }
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (rr[u] >= 0) acc[rr[u] * p.d + dd] += v[u];
          }
        }
      }
    }
    __syncthreads();   // the list is rewritten by the next tile
  }

  // 4. self term: z = acc + self_coeff * x
  if (p.self_mode != kSelfNone) {
    for (int i = tid; i < rows_here * p.d; i += kThreads) {
      const int r = i / p.d;
      const float c = p.self_mode == kSelfScalar ? p.sc[0] : p.sc[row0 + r];
      acc[i] = __fadd_rn(acc[i], __fmul_rn(c, p.x[(size_t)row0 * p.d + i]));
    }
  }
  __syncthreads();

  // 5. the update MLP
  float* out = p.out + (size_t)row0 * p.d_out;
  if (two_layer) {
    dense_rows(acc, p.d, rows_here, p.w1, p.b1, p.d_ff, hid, 1);
    __syncthreads();
    dense_rows(hid, p.d_ff, rows_here, p.w2, p.b2, p.d_out, out, p.out_relu);
  } else {
    dense_rows(acc, p.d, rows_here, p.w1, p.b1, p.d_ff, out, p.out_relu);
  }
}

int default_rows(int n, int d, int d_ff, bool two_layer) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  // one block per SM where the rows allow it, fewer rows if smem is short
  int rows = (n + sms - 1) / sms;
  while (rows > 1 &&
         smem_bytes(rows, d, d_ff, two_layer) > static_cast<size_t>(max_smem)) {
    rows = (rows + 1) / 2;
  }
  return rows < 1 ? 1 : rows;
}

}  // namespace

// Launch one layer on `stream`. Null pointers switch terms off (w2/b2 null:
// one dense layer). rows <= 0 lets the kernel choose. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int layer_fused_launch(
    const void* x, const void* y, const void* snd, const void* rcv,
    const void* mask, const void* sw, const void* et, const void* pb,
    const void* sc, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, int n, int e, int d, int d_ff, int d_out,
    int sw_mode, int sw_cols, int head_dim, int self_mode, int phi_relu,
    int out_relu, int rows, void* stream) {
  Args p;
  p.x = static_cast<const float*>(x);
  p.y = static_cast<const float*>(y);
  p.snd = static_cast<const int64_t*>(snd);
  p.rcv = static_cast<const int64_t*>(rcv);
  p.mask = static_cast<const uint8_t*>(mask);
  p.sw = static_cast<const float*>(sw);
  p.et = static_cast<const float*>(et);
  p.pb = static_cast<const float*>(pb);
  p.sc = static_cast<const float*>(sc);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.d = d;
  p.d_ff = d_ff;
  p.d_out = d_out;
  p.sw_mode = sw_mode;
  p.sw_cols = sw_cols;
  p.head_dim = head_dim;
  p.self_mode = self_mode;
  p.phi_relu = phi_relu;
  p.out_relu = out_relu;
  if (n <= 0) return 0;
  const bool two_layer = w2 != nullptr;
  p.rows = rows > 0 ? rows : default_rows(n, d, d_ff, two_layer);
  const size_t smem = smem_bytes(p.rows, d, d_ff, two_layer);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        layer_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + p.rows - 1) / p.rows;
  layer_fused_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
