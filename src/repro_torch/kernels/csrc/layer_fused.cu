// One GNN layer in one launch on Hopper (sm_90a): gather, phi, aggregate,
// update MLP.
//
// Replaces the TPU kernel repro/kernels/layer_fused.py::layer_fused (body
// _layer_fused_kernel), in all three of its epilogues:
//
//   phi_e = act( y[snd_e] * src_weight_e + edge_term_e + phi_bias )
//   s1_i  = sum over unmasked edges e with rcv_e == i of phi_e      (f32)
//   self (GIN, GIN-VN, GCN):
//     z_i = s1_i + self_coeff * x_i          (self_coeff scalar or per node)
//   scalers (PNA), with s2 (sum of squares), mx and mn (keyed max / min from
//   -+BIG) accumulated beside s1 and deg the shared in-degrees:
//     mean = s1 / max(deg, 1); std = sqrt(max(s2 / max(deg, 1) - mean^2, 0)
//     + 1e-5); mx, mn -> 0 unless deg > 0 and they moved off -+BIG
//     m_i = [mean | std | mx | mn]; z_i = [x_i | s_0 m_i | ... | s_{S-1} m_i]
//   field (DGN), over the stacked gather buffer y = [x | x] (D = 2 D_x):
//     z_i = [x_i | s1_i[:D_x] / max(deg, 1) | |s1_i[D_x:] - x_i * wsum_i|]
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
// both floors are ~1 us (3.35 TB/s, 67 TFLOP/s fp32). PNA's first dense layer
// contracts over D_x + 12 D = 1,040 inputs (w1 333 KB at D = 80) and DGN's
// lane weights are a full (E, 2 D) stream: at the serving buckets (N = 32..64
// nodes) every floor is well under 1 us and launch overhead and the serial
// epilogue rule.
//
// Design (simple and right first; speed is later work):
//   * Owner computes. Block b owns destination rows [b*R, b*R + R) and sweeps
//     the whole edge stream in stream order, a tile of kEdgeTile edges at a
//     time. Each thread classifies kEdgesPerThread consecutive edges; a
//     block-wide scan compacts the owned, unmasked edges of the tile into a
//     shared-memory list that keeps stream order. Masked edges never enter
//     the list, so they contribute nothing, not even their edge_term; nor
//     does an edge whose receiver lies outside [0, n) (no block owns it). A
//     sender outside [0, n) enters as -1 and gathers a zero row (y is never
//     read there), as the Pallas kernel's one-hot gather gives.
//   * Threads run over the D lanes; with D <= blockDim there are
//     blockDim / D groups of lanes and group g owns the rows r % groups == g;
//     a wider D takes one group whose threads stride over the lanes. Every
//     (row, lane) of the f32 shared-memory accumulators (one, or four for
//     the scalers form) is written by exactly one thread, which adds its
//     edges in stream order: no atomics, and the result is bitwise the same
//     for any R and from run to run.
//   * Epilogue in the same launch: the self term in place, or the scalers /
//     field input row z built in shared memory (rounded adds and products,
//     no contraction, as the plain version rounds them), then each dense
//     layer as fp32 FMAs with k in order (weights read through L2, kRowChunk
//     rows per weight load, eight weight rows in flight); the hidden layer
//     (R x D_ff floats) stays in shared memory. A dense layer names its
//     input by its offset in shared memory: chosen as a pointer at run time
//     (acc or z) its loads compiled as generic loads and the scalers form's
//     1,040-deep first layer ran ~1.6x slower. No TF32 anywhere. Shared
//     memory above 48 KB is opted into per launch.
//   * The launcher returns cudaGetLastError(); it allocates nothing and does
//     not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

// The block's dynamic shared memory: accumulators, z, hidden layer, lists.
extern __shared__ float smem[];

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdgesPerThread = 4;
constexpr int kEdgeTile = kThreads * kEdgesPerThread;
constexpr int kRowChunk = 8;      // rows sharing one weight load in the MLP
constexpr int kUnroll = 4;        // edges whose loads are issued together
constexpr float kBig = 1e30f;     // keyed max / min neutral (mp_pipeline's)

enum SrcWeightMode { kSwNone = 0, kSwScalar = 1, kSwFull = 2, kSwHead = 3 };
enum SelfMode { kSelfNone = 0, kSelfScalar = 1, kSelfNode = 2 };
enum Epilogue { kEpiSelf = 0, kEpiScalers = 1, kEpiField = 2 };

struct Args {
  const float* x;        // (n, d_x) carry rows: the self term, z's first part
  const float* y;        // (n, d) gather buffer (x unless node_input)
  const int64_t* snd;    // (e,)
  const int64_t* rcv;    // (e,)
  const uint8_t* mask;   // (e,) bool
  const float* sw;       // (e,), (e, d), (e, sw_cols) or null
  const float* et;       // (e, d) or null
  const float* pb;       // (d,) or null
  const float* sc;       // (1,) or (n,) or null
  const float* scal;     // (n, n_scalers) degree scalers, or null
  const float* deg;      // (n,) shared in-degrees (scalers, field), or null
  const float* wsum;     // (n,) field-weight sums (field), or null
  const float* w1;       // (d_in, d_ff)
  const float* b1;       // (d_ff,)
  const float* w2;       // (d_ff, d_out) or null
  const float* b2;       // (d_out,) or null
  float* out;            // (n, d_out)
  int n, e, d, d_x, d_in, d_ff, d_out;
  int sw_mode, sw_cols, head_dim;
  int self_mode, epilogue, n_scalers, phi_relu, out_relu;
  int rows;              // destination rows one block owns
};

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// accumulators: s1, then s2 / max / min for the scalers form
__host__ __device__ inline int n_acc(int epilogue) {
  return epilogue == kEpiScalers ? 4 : 1;
}

// rows_alloc x (n_acc * d [+ d_in: z] [+ d_ff: hidden]) floats, then the
// edge list and the scan
size_t smem_bytes(int rows, int d, int d_in, int d_ff, bool two_layer,
                  int epilogue) {
  const size_t rows_alloc = round_up(rows, kRowChunk);
  const size_t per_row = static_cast<size_t>(n_acc(epilogue)) * d +
                         (epilogue == kEpiSelf ? 0 : d_in) +
                         (two_layer ? d_ff : 0);
  return rows_alloc * per_row * sizeof(float) + 3 * kEdgeTile * sizeof(int) +
         (kWarps + 1) * sizeof(int);
}

// s is -1 for a sender outside [0, n): its row reads as zeros
__device__ __forceinline__ float phi(const Args& p, int e, int s, int dd) {
  float v = s >= 0 ? p.y[(size_t)s * p.d + dd] : 0.f;
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
// src = smem + src_off (named by its offset so that its loads always compile
// as shared-memory loads) must hold round_up(rows, kRowChunk) rows.
__device__ __forceinline__ void dense_rows(int src_off, int k_dim, int rows,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int n_dim, float* dst, int relu) {
  for (int j = threadIdx.x; j < n_dim; j += kThreads) {
    const float bj = b[j];
    for (int r0 = 0; r0 < rows; r0 += kRowChunk) {
      float a[kRowChunk];
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) a[q] = 0.f;
#pragma unroll 8  // weight rows whose loads are issued together
      for (int k = 0; k < k_dim; ++k) {
        const float wk = w[(size_t)k * n_dim + j];
#pragma unroll
        for (int q = 0; q < kRowChunk; ++q) {
          a[q] = fmaf(smem[src_off + (r0 + q) * k_dim + k], wk, a[q]);
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

// kScalers: the scalers form's four accumulators (a separate instance, so
// that the other forms' edge loop keeps one accumulator and nothing else)
template <bool kScalers>
__global__ void __launch_bounds__(kThreads)
    layer_fused_kernel(const __grid_constant__ Args p) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * p.rows;
  const int rows_here = min(p.rows, p.n - row0);
  const int rows_alloc = round_up(p.rows, kRowChunk);
  const bool two_layer = p.w2 != nullptr;

  constexpr bool scalers = kScalers;
  const size_t acc_len = (size_t)rows_alloc * p.d;
  float* acc = smem;                                   // s1: rows_alloc x d
  float* acc_sq = acc + acc_len;                       // scalers only: s2,
  float* acc_mx = acc_sq + acc_len;                    //   max,
  float* acc_mn = acc_mx + acc_len;                    //   min
  float* z = acc + n_acc(p.epilogue) * acc_len;        // rows_alloc x d_in
  float* hid = z + (p.epilogue == kEpiSelf ? 0 : (size_t)rows_alloc * p.d_in);
  int* list_e = reinterpret_cast<int*>(
      hid + (two_layer ? (size_t)rows_alloc * p.d_ff : 0));
  int* list_s = list_e + kEdgeTile;
  int* list_r = list_s + kEdgeTile;
  int* scan = list_r + kEdgeTile;                      // kWarps + 1

  for (int i = tid; i < rows_alloc * p.d; i += kThreads) {
    acc[i] = 0.f;
    if constexpr (scalers) {
      acc_sq[i] = 0.f;
      acc_mx[i] = -kBig;
      acc_mn[i] = kBig;
    }
  }
  if (p.epilogue != kEpiSelf) {
    for (int i = tid; i < rows_alloc * p.d_in; i += kThreads) z[i] = 0.f;
  }
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
        // a sender outside [0, n) gathers a zero row (the Pallas kernel's
        // one-hot gather); -1 marks it so that y is never read there
        const int64_t s = p.snd[e0 + k];
        list_s[slot] = (s >= 0 && s < p.n) ? static_cast<int>(s) : -1;
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
            if (rr[u] >= 0) {
              const int a = rr[u] * p.d + dd;
              acc[a] += v[u];
              if constexpr (scalers) {
                acc_sq[a] = __fadd_rn(acc_sq[a], __fmul_rn(v[u], v[u]));
                acc_mx[a] = fmaxf(acc_mx[a], v[u]);
                acc_mn[a] = fminf(acc_mn[a], v[u]);
              }
            }
          }
        }
      }
    }
    __syncthreads();   // the list is rewritten by the next tile
  }

  // 4. the first dense layer's input row: the self term in place on acc,
  //    or z from the accumulators (scalers, field)
  if (p.epilogue == kEpiSelf && p.self_mode != kSelfNone) {
    for (int i = tid; i < rows_here * p.d; i += kThreads) {
      const int r = i / p.d;
      const float c = p.self_mode == kSelfScalar ? p.sc[0] : p.sc[row0 + r];
      acc[i] = __fadd_rn(acc[i], __fmul_rn(c, p.x[(size_t)row0 * p.d + i]));
    }
  } else if (p.epilogue != kEpiSelf) {
    // z's first D_x columns: the carry rows
    for (int i = tid; i < rows_here * p.d_x; i += kThreads) {
      const int r = i / p.d_x;
      z[(size_t)r * p.d_in + i % p.d_x] = p.x[(size_t)row0 * p.d_x + i];
    }
  }
  if constexpr (scalers) {
    // m = [mean | std | max | min] at lane c, times each degree scaler
    const int width = 4 * p.d;
    for (int i = tid; i < rows_here * p.d; i += kThreads) {
      const int r = i / p.d;
      const int c = i % p.d;
      const float deg = p.deg[row0 + r];
      const float rdenom = __fdiv_rn(1.f, fmaxf(deg, 1.f));
      const float mean = __fmul_rn(acc[i], rdenom);
      const float var = fmaxf(
          __fsub_rn(__fmul_rn(acc_sq[i], rdenom), __fmul_rn(mean, mean)),
          0.f);
      const float sd = __fsqrt_rn(__fadd_rn(var, 1e-5f));
      const bool nonempty = deg > 0.f;
      const float mx = nonempty && acc_mx[i] > -kBig ? acc_mx[i] : 0.f;
      const float mn = nonempty && acc_mn[i] < kBig ? acc_mn[i] : 0.f;
      float* zr = z + (size_t)r * p.d_in + p.d_x + c;
      const float* s = p.scal + (size_t)(row0 + r) * p.n_scalers;
      for (int k = 0; k < p.n_scalers; ++k) {
        const float sk = s[k];
        float* zk = zr + k * width;
        zk[0] = __fmul_rn(mean, sk);
        zk[p.d] = __fmul_rn(sd, sk);
        zk[2 * p.d] = __fmul_rn(mx, sk);
        zk[3 * p.d] = __fmul_rn(mn, sk);
      }
    }
  } else if (p.epilogue == kEpiField) {
    // [mean of the plain half | |field half - x * wsum|]
    for (int i = tid; i < rows_here * p.d_x; i += kThreads) {
      const int r = i / p.d_x;
      const int c = i % p.d_x;
      const float rdenom = __fdiv_rn(1.f, fmaxf(p.deg[row0 + r], 1.f));
      const float xv = p.x[(size_t)row0 * p.d_x + i];
      const float* a = acc + (size_t)r * p.d;
      float* zr = z + (size_t)r * p.d_in;
      zr[p.d_x + c] = __fmul_rn(a[c], rdenom);
      zr[2 * p.d_x + c] = fabsf(
          __fsub_rn(a[p.d_x + c], __fmul_rn(xv, p.wsum[row0 + r])));
    }
  }
  __syncthreads();

  // 5. the update MLP, its first layer on acc (self) or z
  const int in_off = static_cast<int>(
      (p.epilogue == kEpiSelf ? acc : z) - smem);
  const int hid_off = static_cast<int>(hid - smem);
  float* out = p.out + (size_t)row0 * p.d_out;
  if (two_layer) {
    dense_rows(in_off, p.d_in, rows_here, p.w1, p.b1, p.d_ff, hid, 1);
    __syncthreads();
    dense_rows(hid_off, p.d_ff, rows_here, p.w2, p.b2, p.d_out, out,
               p.out_relu);
  } else {
    dense_rows(in_off, p.d_in, rows_here, p.w1, p.b1, p.d_ff, out,
               p.out_relu);
  }
}

// Rows one block owns: `rows` if given (> 0), else one block per SM where
// the rows allow it; then fewer while the shared memory would not fit.
int block_rows(int rows, int n, int d, int d_in, int d_ff, bool two_layer,
               int epilogue) {
  int dev = 0;
  int sms = 132;
  int max_smem = 227 * 1024;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (rows <= 0) rows = (n + sms - 1) / sms;
  while (rows > 1 &&
         smem_bytes(rows, d, d_in, d_ff, two_layer, epilogue) >
             static_cast<size_t>(max_smem)) {
    rows = (rows + 1) / 2;
  }
  return rows < 1 ? 1 : rows;
}

}  // namespace

// Launch one layer on `stream`. Null pointers switch terms off (w2/b2 null:
// one dense layer); `epilogue` picks the self (0), scalers (1) or field (2)
// form, whose inputs must then be given. rows <= 0 lets the kernel choose;
// rows that would not fit in shared memory are halved until they do.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int layer_fused_launch(
    const void* x, const void* y, const void* snd, const void* rcv,
    const void* mask, const void* sw, const void* et, const void* pb,
    const void* sc, const void* scal, const void* deg, const void* wsum,
    const void* w1, const void* b1, const void* w2, const void* b2,
    void* out, int n, int e, int d, int d_x, int d_in, int d_ff, int d_out,
    int sw_mode, int sw_cols, int head_dim, int self_mode, int epilogue,
    int n_scalers, int phi_relu, int out_relu, int rows, void* stream) {
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
  p.scal = static_cast<const float*>(scal);
  p.deg = static_cast<const float*>(deg);
  p.wsum = static_cast<const float*>(wsum);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.out = static_cast<float*>(out);
  p.n = n;
  p.e = e;
  p.d = d;
  p.d_x = d_x;
  p.d_in = d_in;
  p.d_ff = d_ff;
  p.d_out = d_out;
  p.sw_mode = sw_mode;
  p.sw_cols = sw_cols;
  p.head_dim = head_dim;
  p.self_mode = self_mode;
  p.epilogue = epilogue;
  p.n_scalers = n_scalers;
  p.phi_relu = phi_relu;
  p.out_relu = out_relu;
  // the contraction width each epilogue needs, as the wrapper checks it
  const int want_in = epilogue == kEpiScalers ? d_x + n_scalers * 4 * d
                      : epilogue == kEpiField ? d_x + d
                                              : d;
  const bool inputs_ok =
      epilogue == kEpiSelf ||
      (deg != nullptr && (epilogue == kEpiScalers ? scal != nullptr
                                                  : wsum != nullptr));
  if (d_in != want_in || (epilogue == kEpiField && d != 2 * d_x) ||
      (epilogue == kEpiSelf && self_mode != kSelfNone && d_x != d) ||
      !inputs_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return 0;
  const bool two_layer = w2 != nullptr;
  p.rows = block_rows(rows, n, d, d_in, d_ff, two_layer, epilogue);
  const size_t bytes = smem_bytes(p.rows, d, d_in, d_ff, two_layer, epilogue);
  const auto kernel = epilogue == kEpiScalers ? layer_fused_kernel<true>
                                               : layer_fused_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + p.rows - 1) / p.rows;
  kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
