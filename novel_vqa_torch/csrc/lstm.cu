// LSTM kernels for Hopper (sm_90a), fp32, built with nvcc into a shared
// library with a plain C interface (see novel_vqa_torch/kernels/build.py).
//
// Both kernels compute the fused-gate LSTM cell of the JAX package (the cell
// and the gate products are in cell.cuh; b = bx + bh):
//
//     gates = x @ Wx + h @ Wh + b;  c', h' = cell(gates, c)
//
// A thread owns one hidden unit j and a few batch rows, and accumulates the
// unit's four gate columns (j, H+j, 2H+j, 3H+j) for those rows in registers.
// The rows' inputs are staged in shared memory transposed; the weights are
// read from global memory, where they stay hot in the 50 MB L2 cache.  The
// cell update runs in the epilogue, so the (N, 4H) gate matrix never reaches
// device memory.  All arithmetic is fp32 FMA (no tensor cores, no TF32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cell.cuh"

namespace cg = cooperative_groups;

namespace {

// Seq kernel: CTAs per cluster, batch rows per thread, the unroll of its k
// loops, and threads per CTA at most (96 registers each).  The rows per
// cluster are chosen at launch (seq_plan).
constexpr int kSeqCluster = 4;
constexpr int kSeqRowsPerThread = 4;
constexpr int kSeqUnroll = 8;
constexpr int kSeqMaxThreads = 640;
// More than half of an SM's 228 KB of shared memory, less the 1 KB the
// card reserves per block: an SM holds one seq CTA, so a cluster's CTAs
// land on as many SMs and the card holds a fixed number of clusters.
constexpr size_t kSeqMinSmem = 116 * 1024;
constexpr int kStepRows = 8;      // batch rows per block, step kernel
constexpr int kStepUnits = 128;   // hidden units per block, step kernel

// dst[k * R + r] = src[(n0 + r) * K + k], zero for rows n0 + r >= N.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n0, int N, int K, int R) {
  for (int e = threadIdx.x; e < R * K; e += blockDim.x) {
    const int r = e / K;
    const int k = e - r * K;
    const int n = n0 + r;
    dst[k * R + r] = n < N ? src[(size_t)n * K + k] : 0.0f;
  }
}

template <int R>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n0, int N, int K) {
  stage_rows(dst, src, n0, N, K, R);
}

// ---------------------------------------------------------------------------
// Seq kernel.  Replaces novel_vqa_tpu/ops/pallas_lstm.py::_seq_kernel: one
// masked LSTM layer over all T steps for a tile of batch rows, from a zero
// state; outputs the final c, h and the (T, N, H) post-mask hidden sequence.
//
// Bound on the H100: operations.  At the eval shapes (N=500, T=16, In=200 or
// 512, H=512) a layer is 23-34 GFLOP of fp32 FMA (67 TFLOP/s) against ~40 MB
// of traffic, so it sits far above the fp32 ridge point, and the two
// products per step are the whole cost.
//
// Design: a cluster of C CTAs owns a tile of R rows for all T steps; rows
// are independent, so clusters never synchronise with each other.  The gate
// columns are split across the cluster: CTA q owns hidden units
// [q * U, (q + 1) * U), U = ceil(H / C), with all four gate columns of each,
// and computes x_t @ Wx + h @ Wh + b for them and the tile's rows, its
// threads split over those units and over groups of RT rows.  So a tile
// keeps C SMs busy, and each SM reads only its own 1/C of the weight
// columns from L2 per step.  Every unit's gates read the whole previous h,
// so each CTA keeps the whole h tile (double-buffered) beside its x_t tile
// and the c of its own units.  After the cell update a CTA pushes its
// units' new h into the other h buffer of every CTA of the cluster
// (distributed shared memory), and one barrier.cluster per step orders
// those stores before the next step's reads; a step writes only the buffer
// that every CTA finished reading before the previous barrier.
//
// Occupancy: the launch takes the fewest rows per cluster R (a multiple of
// RT) whose clusters the card holds at once, so the grid runs in one wave
// on as many SMs as it can (seq_plan).  At N = 500 on an H100 that is
// 25 clusters of 20 rows, 100 CTAs: the card holds 30 clusters of 4, not
// 33, because a cluster stays within one GPC, and 16-row tiles (32
// clusters, 128 CTAs) take two waves and nearly twice the time.
//
// A step on which no row of the tile is active leaves c and h as they are,
// whatever the mask, so its products are skipped and hs[t] = h.  The CTAs of
// a cluster hold the same rows and decide alike, so the barrier stays
// uniform.  Right-aligned masks skip a tile's steps before its longest row.
//
// Each output sums the bias, then x @ Wx over k = 0..In-1, then h @ Wh over
// k = 0..H-1, one fmaf each, in the order of the one-block-per-tile kernel
// this replaced: the split over the cluster changes no bit.
//
// Shared memory: (In + 2H + U) * R floats (130 KB at In = H = 512, R = 20),
// at least kSeqMinSmem; a shape that needs more than the card offers fails
// at cudaFuncSetAttribute.
// ---------------------------------------------------------------------------
template <int C, int RT, int KU>
__global__ void __launch_bounds__(kSeqMaxThreads, 1)
    lstm_seq_kernel(const float* __restrict__ xs,
                    const float* __restrict__ mask,
                    const float* __restrict__ wx,
                    const float* __restrict__ wh,
                    const float* __restrict__ b, float* __restrict__ c_out,
                    float* __restrict__ h_out, float* __restrict__ hs_out,
                    int T, int N, int In, int H, int R) {
  static_assert(RT % 4 == 0, "h is pushed as float4");
  cg::cluster_group cluster = cg::this_cluster();
  const int G = R / RT;  // row groups
  const int U = (H + C - 1) / C;
  const int j0 = (int)cluster.block_rank() * U;
  const int Uq = max(0, min(U, H - j0));  // this CTA's units
  const int n0 = (blockIdx.x / C) * R;

  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // In * R, [k][row]
  float* h_s = x_s + (size_t)In * R;             // 2 * H * R, [unit][row]
  float* c_s = h_s + (size_t)2 * H * R;          // R * U, [row][own unit]

  for (int e = threadIdx.x; e < H * R; e += blockDim.x) h_s[e] = 0.0f;
  for (int e = threadIdx.x; e < U * R; e += blockDim.x) c_s[e] = 0.0f;
  // every CTA of the cluster runs, and has zeroed its first h buffer,
  // before a peer stores into its shared memory
  cluster.sync();

  int cur = 0;  // the h buffer that holds h; flips on each computed step
  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (size_t)cur * H * R;
    bool row_active = false;
    for (int r = threadIdx.x; r < R && n0 + r < N; r += blockDim.x)
      row_active |= mask[(size_t)t * N + n0 + r] > 0.0f;
    if (!__syncthreads_or(row_active)) {
      for (int e = threadIdx.x; e < Uq * R; e += blockDim.x) {
        const int r = e / Uq;
        const int j = j0 + (e - r * Uq);
        const int n = n0 + r;
        if (n < N) hs_out[((size_t)t * N + n) * H + j] = h_cur[j * R + r];
      }
      continue;
    }
    float* h_nxt = h_s + (size_t)(cur ^ 1) * H * R;
    stage_rows(x_s, xs + (size_t)t * N * In, n0, N, In, R);
    __syncthreads();  // x_t staged

    for (int item = threadIdx.x; item < Uq * G; item += blockDim.x) {
      const int g = item / Uq;
      const int u = item - g * Uq;
      const int j = j0 + u;
      const int r0 = g * RT;
      float acc[4][RT];
      init_bias<RT>(acc, b, H, j);
      gate_products_strided<RT, KU>(acc, x_s + r0, R, In, wx, H, j);
      gate_products_strided<RT, KU>(acc, h_cur + r0, R, H, wh, H, j);
      float hv[RT];
#pragma unroll
      for (int e = 0; e < RT; ++e) {
        const int r = r0 + e;
        const int n = n0 + r;
        const float c_prev = c_s[r * U + u];
        float cn, hn;
        lstm_cell(acc[0][e], acc[1][e], acc[2][e], acc[3][e], c_prev, &cn,
                  &hn);
        const bool active = n < N && mask[(size_t)t * N + n] > 0.0f;
        c_s[r * U + u] = active ? cn : c_prev;
        hv[e] = active ? hn : h_cur[j * R + r];
        if (n < N) hs_out[((size_t)t * N + n) * H + j] = hv[e];
      }
      // the unit's new h for rows r0 .. r0 + RT into every CTA's h_nxt
      float* dst = h_nxt + (size_t)j * R + r0;
#pragma unroll
      for (int p = 0; p < C; ++p) {
        float4* peer =
            reinterpret_cast<float4*>(cluster.map_shared_rank(dst, p));
#pragma unroll
        for (int v = 0; v < RT / 4; ++v)
          peer[v] = make_float4(hv[4 * v], hv[4 * v + 1], hv[4 * v + 2],
                                hv[4 * v + 3]);
      }
    }
    // every CTA's pushes of this step land before any CTA reads them, and
    // every read of x_s and h_cur is done before either is written again
    cluster.sync();
    cur ^= 1;
  }
  // Each computed step ended in cluster.sync(), so no peer stores into this
  // CTA's shared memory any more, and it may exit once its rows are out.
  const float* h_fin = h_s + (size_t)cur * H * R;
  for (int e = threadIdx.x; e < Uq * R; e += blockDim.x) {
    const int r = e / Uq;
    const int u = e - r * Uq;
    const int n = n0 + r;
    if (n < N) {
      c_out[(size_t)n * H + j0 + u] = c_s[r * U + u];
      h_out[(size_t)n * H + j0 + u] = h_fin[(j0 + u) * R + r];
    }
  }
}

// ---------------------------------------------------------------------------
// Step kernel.  Replaces novel_vqa_tpu/ops/pallas_lstm.py::_fused_step_kernel:
// one LSTM cell step, the two products, the bias, the gate nonlinearities
// and the cell update in one pass, the gates never leaving the chip.
//
// Bound on the H100: operations.  At N=500, In=H=512 a step is 2.1 GFLOP of
// fp32 FMA against ~10 MB of traffic.
//
// Design: the grid covers (row tile x hidden-unit tile): kStepRows rows by
// kStepUnits units per block, 252 blocks at N=500, H=512.  A block stages
// its x and h rows in shared memory, each thread accumulates the four gate
// columns of its unit over K = In + H, and the cell update runs in the
// epilogue.  The ragged edges of N and H are masked in place: no padding.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kStepUnits)
    lstm_step_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c,
                     const float* __restrict__ wx,
                     const float* __restrict__ wh,
                     const float* __restrict__ b, float* __restrict__ c_out,
                     float* __restrict__ h_out, int N, int In, int H) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // In * R
  float* h_s = x_s + (size_t)In * R;             // H * R
  const int n0 = blockIdx.x * R;
  const int j = blockIdx.y * blockDim.x + threadIdx.x;

  stage_rows<R>(x_s, x, n0, N, In);
  stage_rows<R>(h_s, h, n0, N, H);
  __syncthreads();
  if (j >= H) return;

  float acc[4][R];
  init_bias<R>(acc, b, H, j);
  gate_products<R>(acc, x_s, In, wx, H, j);
  gate_products<R>(acc, h_s, H, wh, H, j);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r;
    if (n < N) {
      float cn, hn;
      lstm_cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r],
                c[(size_t)n * H + j], &cn, &hn);
      c_out[(size_t)n * H + j] = cn;
      h_out[(size_t)n * H + j] = hn;
    }
  }
}

// The seq kernel as launched (host code).
auto seq_kernel() {
  return &lstm_seq_kernel<kSeqCluster, kSeqRowsPerThread, kSeqUnroll>;
}

// The seq kernel's launch at (N, In, H): one cluster of kSeqCluster CTAs
// per tile of `rows` rows, and the clusters the card holds at once at that
// launch (cudaOccupancyMaxActiveClusters).
struct SeqPlan {
  dim3 grid, block;
  size_t smem;
  int rows;
  int max_clusters;
};

cudaLaunchConfig_t seq_config(const SeqPlan& plan, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSeqCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = plan.grid;
  config.blockDim = plan.block;
  config.dynamicSmemBytes = plan.smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

// The plans made so far, by (device, N, In, H), and per device the largest
// dynamic shared memory the seq kernel has been allowed, which covers every
// plan of that device: a launch after the first at a shape makes no query.
std::mutex seq_plans_mutex;
std::map<std::tuple<int, int, int, int>, SeqPlan> seq_plans;
std::map<int, size_t> seq_smem_allowed;

// Allows the seq kernel `smem` bytes of dynamic shared memory on `dev`; a
// shape that needs more than the card offers fails here.
cudaError_t allow_seq_smem(int dev, size_t smem) {
  size_t& allowed = seq_smem_allowed[dev];
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      seq_kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// R is the least multiple of kSeqRowsPerThread whose ceil(N / R) clusters
// the card holds at once, within the threads a CTA may have (one per unit
// and row group) and the shared memory it may use; past those limits, the
// largest R that fits them.  Called with seq_plans_mutex held.
cudaError_t make_seq_plan(int dev, int N, int In, int H, SeqPlan* plan) {
  constexpr int RT = kSeqRowsPerThread;
  int smem_optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, seq_kernel());
  if (err != cudaSuccess) return err;
  const int max_threads = fa.maxThreadsPerBlock / 32 * 32;
  const int units = (H + kSeqCluster - 1) / kSeqCluster;
  const size_t row_bytes = (size_t)(In + 2 * H + units) * sizeof(float);
  int r_max = (int)((size_t)smem_optin / row_bytes) / RT * RT;
  const int groups_max = max_threads / units;
  if (groups_max >= 1 && groups_max * RT < r_max) r_max = groups_max * RT;
  if (r_max < RT) r_max = RT;

  auto shape = [&](int R) {
    const int items = units * (R / RT);
    plan->rows = R;
    plan->grid = dim3(((N + R - 1) / R) * kSeqCluster);
    plan->block = dim3(items >= max_threads ? max_threads
                                            : (items + 31) / 32 * 32);
    plan->smem = row_bytes * R < kSeqMinSmem ? kSeqMinSmem : row_bytes * R;
    cudaError_t e = allow_seq_smem(dev, plan->smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = seq_config(*plan, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(&plan->max_clusters, seq_kernel(),
                                          &config);
  };
  // the clusters the card holds at once: one CTA per SM (kSeqMinSmem), so
  // the same for every R
  err = shape(RT);
  if (err != cudaSuccess) return err;
  int R = RT;
  while (R < r_max && (N + R - 1) / R > plan->max_clusters) R += RT;
  return shape(R);  // and the count again at the launch's own threads
}

cudaError_t seq_plan(int N, int In, int H, SeqPlan* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(seq_plans_mutex);
  const auto key = std::make_tuple(dev, N, In, H);
  const auto it = seq_plans.find(key);
  if (it != seq_plans.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  err = make_seq_plan(dev, N, In, H, plan);
  if (err == cudaSuccess) seq_plans[key] = *plan;
  return err;
}

size_t step_smem_bytes(int In, int H) {
  return (size_t)(In + H) * kStepRows * sizeof(float);
}

}  // namespace

extern "C" {

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 on success).  A shape that needs
// more dynamic shared memory than the card offers fails at
// cudaFuncSetAttribute, whose error is returned as well.
int nvqa_lstm_seq_forward(const float* xs, const float* mask, const float* wx,
                          const float* wh, const float* b, float* c_out,
                          float* h_out, float* hs_out, int T, int N, int In,
                          int H, void* stream) {
  SeqPlan plan;
  cudaError_t err = seq_plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      seq_config(plan, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&config, seq_kernel(), xs, mask, wx, wh, b, c_out,
                           h_out, hs_out, T, N, In, H, plan.rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The seq kernel's launch at (N, In, H), launching nothing: info[0..5] =
// CTAs per cluster, rows per cluster, CTAs in the grid, the clusters the
// card can hold at once (cudaOccupancyMaxActiveClusters), threads per CTA,
// dynamic shared memory per CTA in bytes.
int nvqa_lstm_seq_launch_info(int N, int In, int H, int* info) {
  SeqPlan plan;
  cudaError_t err = seq_plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  const int out[6] = {kSeqCluster, plan.rows, (int)plan.grid.x,
                      plan.max_clusters, (int)plan.block.x, (int)plan.smem};
  for (int i = 0; i < 6; ++i) info[i] = out[i];
  return 0;
}

int nvqa_lstm_step_forward(const float* x, const float* h, const float* c,
                           const float* wx, const float* wh, const float* b,
                           float* c_out, float* h_out, int N, int In, int H,
                           void* stream) {
  const size_t smem = step_smem_bytes(In, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_step_kernel<kStepRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kStepRows - 1) / kStepRows,
                  (H + kStepUnits - 1) / kStepUnits);
  lstm_step_kernel<kStepRows><<<grid, kStepUnits, smem, (cudaStream_t)stream>>>(
      x, h, c, wx, wh, b, c_out, h_out, N, In, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
