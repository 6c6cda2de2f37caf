// Fused two-layer LSTM training forward for Hopper (sm_90a), built with nvcc
// into a shared library with a plain C interface (see
// novel_vqa_torch/kernels/build.py).
//
// Replaces novel_vqa_tpu/ops/pallas_lstm2.py::_seq2_kernel: both layers of
// a 2-layer masked LSTM over all T steps, from a zero state, with the
// inter-layer dropout multiplier applied to layer 1's hidden state as layer
// 2's input.  Storage is bf16, arithmetic fp32, exactly as in the Pallas
// kernel (pallas_lstm2.py:69-119):
//
//     gates1 = x_t @ Wx1 + bf16(h1) @ Wh1 + f32(b1)       (bf16 x bf16, f32 sum)
//     c1, h1 = where(mask[t] > 0, cell(gates1, c1), (c1, h1))   (f32 carries)
//     hs1[t] = bf16(h1)
//     d      = bf16(f32(bf16(h1)) * f32(drop[t]))
//     gates2 = d @ Wx2 + bf16(h2) @ Wh2 + f32(b2)
//     c2, h2 = where(mask[t] > 0, cell(gates2, c2), (c2, h2))
//     hs2[t] = bf16(h2)
//
// The cell, gate order and gate products are cell.cuh's; b = bx + bh
// rounded to bf16.  Outputs: the final c1, h1, c2, h2 (N, H) in f32 and
// hs1, hs2 (T, N, H) in bf16.
//
// Bound on the H100: operations.  At N=500, T=16, In=200, H=512 the
// products are 2 * (In + 3H) * 4H = 7.1 MFLOP per active (row, step); on
// the bf16 tensor cores (989 TFLOP/s) the active pairs of the kernel
// check's masks take 0.0301 ms, and its ~39 MB of traffic 0.012 ms.
//
// Design: the seq kernel's thread-block cluster (lstm.cu), for both layers.
// A cluster of C CTAs owns a tile of R rows for all T steps; clusters never
// synchronise with each other.  CTA q owns hidden units [q * U, (q + 1) * U),
// U = ceil(H / C), with all four gate columns of each in both layers, its
// threads split over those units and groups of RT rows; so each SM reads
// only its 1/C of the four weight matrices from L2 per step, and the launch
// picks the fewest rows per tile whose clusters fit one wave (seq2_plan):
// 25 clusters of 20 rows, 100 CTAs at N = 500.
//
// The steps run as the Pallas kernel's wavefront: iteration t = 0..T runs
// layer-1 step t and then layer-2 step t-1, which reads the previous
// iteration's d.  Each CTA keeps the whole tile of x_t, bf16(h1), d and
// bf16(h2) in shared memory, the last three double-buffered, and the f32
// carries of its own units.  After its cell updates a CTA pushes its units'
// bf16(h1), d (computed by the unit's owner, with the five bf16 roundings
// where the formulas above have them) and bf16(h2) into the other buffer of
// every CTA of the cluster (distributed shared memory); one barrier.cluster
// per iteration orders those stores before the next iteration's reads.
// The d buffer pushed at layer-1 step t is read by layer-2 step t only,
// which has the same mask, so d shares layer 1's buffer index.  d is pushed
// by its owner, not made by every CTA from the whole bf16(h1) tile: so drop
// is read once, and the second d buffer (20 KB) fits.  Staging as
// bf16 is exact (every staged value is bf16) and halves the tile: (In + 6H)
// * R * 2 + 4 * U * R * 4 bytes, 168 KB at In=200, H=512, R=20; in f32 it
// would not fit a block.  The products read 4 rows as one 8-byte load and
// widen each by a shift or a mask.
//
// A layer whose step no row of the tile takes (mask all zero) leaves c and h
// as they are, so its products are skipped, its buffers keep their index,
// and hs = bf16(h) is written from the current buffer.  The CTAs of a
// cluster hold the same rows and decide alike; an iteration with nothing to
// compute makes no barrier.  The skip is exact for any mask.
//
// Each output sums the bias, then the input product over k = 0..K-1, then
// the recurrent product over k = 0..H-1, one fmaf each, in the order of the
// one-block-per-tile kernel this replaced: its outputs are bit-identical.
//
// What this leaves: the products are fp32 FMA, not tensor cores (a bf16 x
// bf16 product is exact in fp32, so the kernel matches its plain version up
// to the order of the sums); mma.sync / wgmma over the staged bf16 tile is
// the way down to the bound, and changes the order of the sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cell.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// CTAs per cluster, batch rows per thread, the unroll of the k loops and
// threads per CTA at most (96 registers each); the rows per cluster are
// chosen at launch (seq2_plan).
constexpr int kSeq2Cluster = 4;
constexpr int kSeq2RowsPerThread = 4;
constexpr int kSeq2Unroll = 8;
constexpr int kSeq2MaxThreads = 640;
// More than half of an SM's shared memory: one CTA per SM, so the clusters
// the card holds at once do not depend on the rows per cluster.
constexpr size_t kSeq2MinSmem = 116 * 1024;

// The two bf16 of a 32-bit word widened to f32, low half first (exact).
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// Four bf16, row order, as one 8-byte word.
__device__ __forceinline__ uint2 pack4(const bf16 (&v)[4]) {
  const uint32_t b0 = __bfloat16_as_ushort(v[0]), b1 = __bfloat16_as_ushort(v[1]);
  const uint32_t b2 = __bfloat16_as_ushort(v[2]), b3 = __bfloat16_as_ushort(v[3]);
  return make_uint2(b0 | b1 << 16, b2 | b3 << 16);
}

// acc[q][e] += sum_k a_s[k * S + e] * f32(w[k * 4H + q * H + j]), q = 0..3,
// e = 0..3, in order of k, one fmaf each: gate_products_strided<4, KU>
// (cell.cuh) over activations staged as bf16.  One 8-byte load broadcasts
// four rows of column k to the warp.
template <int KU>
__device__ __forceinline__ void gate_products_bf16(
    float (&acc)[4][4], const bf16* a_s, int S, int K,
    const bf16* __restrict__ w, int H, int j) {
  const size_t ld = 4 * (size_t)H;
  const bf16* wj = w + j;
#pragma unroll (KU)
  for (int k = 0; k < K; ++k) {
    const bf16* wk = wj + (size_t)k * ld;
    const float w0 = load_weight(wk);
    const float w1 = load_weight(wk + H);
    const float w2 = load_weight(wk + 2 * H);
    const float w3 = load_weight(wk + 3 * H);
    const uint2 a = *reinterpret_cast<const uint2*>(a_s + (size_t)k * S);
    const float av[4] = {bf16_lo(a.x), bf16_hi(a.x), bf16_lo(a.y), bf16_hi(a.y)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[0][e] = fmaf(av[e], w0, acc[0][e]);
      acc[1][e] = fmaf(av[e], w1, acc[1][e]);
      acc[2][e] = fmaf(av[e], w2, acc[2][e]);
      acc[3][e] = fmaf(av[e], w3, acc[3][e]);
    }
  }
}

// The same 8 bytes into `dst` of every CTA of the cluster.
template <int C>
__device__ __forceinline__ void push(cg::cluster_group& cluster, bf16* dst,
                                     uint2 v) {
#pragma unroll
  for (int p = 0; p < C; ++p)
    *reinterpret_cast<uint2*>(cluster.map_shared_rank(dst, p)) = v;
}

// hs[t] = the current bf16 buffer for this CTA's units: a skipped step.
__device__ __forceinline__ void copy_state(bf16* __restrict__ hs_out,
                                           const bf16* buf, int t, int n0,
                                           int N, int H, int R, int j0,
                                           int Uq) {
  for (int e = threadIdx.x; e < Uq * R; e += blockDim.x) {
    const int r = e / Uq;
    const int j = j0 + (e - r * Uq);
    const int n = n0 + r;
    if (n < N) hs_out[((size_t)t * N + n) * H + j] = buf[(size_t)j * R + r];
  }
}

template <int C, int RT, int KU>
__global__ void __launch_bounds__(kSeq2MaxThreads, 1)
    lstm_seq2_kernel(const bf16* __restrict__ xs,
                     const float* __restrict__ mask,
                     const bf16* __restrict__ drop,
                     const bf16* __restrict__ wx1,
                     const bf16* __restrict__ wh1,
                     const bf16* __restrict__ b1,
                     const bf16* __restrict__ wx2,
                     const bf16* __restrict__ wh2,
                     const bf16* __restrict__ b2,
                     float* __restrict__ c1_out, float* __restrict__ h1_out,
                     float* __restrict__ c2_out, float* __restrict__ h2_out,
                     bf16* __restrict__ hs1_out, bf16* __restrict__ hs2_out,
                     int T, int N, int In, int H, int R) {
  static_assert(RT == 4, "rows are read and pushed as 8-byte words");
  cg::cluster_group cluster = cg::this_cluster();
  const int G = R / RT;  // row groups
  const int U = (H + C - 1) / C;
  const int j0 = (int)cluster.block_rank() * U;
  const int Uq = max(0, min(U, H - j0));  // this CTA's units
  const int n0 = (blockIdx.x / C) * R;
  const size_t HR = (size_t)H * R;

  extern __shared__ float4 smem4[];
  // f32 carries of this CTA's units, [row][own unit]
  float* c1_s = reinterpret_cast<float*>(smem4);
  float* h1_s = c1_s + (size_t)R * U;
  float* c2_s = h1_s + (size_t)R * U;
  float* h2_s = c2_s + (size_t)R * U;
  // bf16 tiles, [unit or k][row]: bf16(h1), d and bf16(h2) double-buffered
  bf16* h1b = reinterpret_cast<bf16*>(h2_s + (size_t)R * U);
  bf16* d_b = h1b + 2 * HR;
  bf16* h2b = d_b + 2 * HR;
  bf16* x_s = h2b + 2 * HR;  // In * R

  uint32_t* tiles = reinterpret_cast<uint32_t*>(h1b);
  for (size_t e = threadIdx.x; e < 3 * HR; e += blockDim.x) tiles[e] = 0u;
  for (int e = threadIdx.x; e < 4 * R * U; e += blockDim.x) c1_s[e] = 0.0f;
  // every CTA of the cluster runs, and has zeroed its buffers, before a
  // peer stores into its shared memory
  cluster.sync();

  // The buffers that hold the current bf16(h1) (and the d of the last
  // computed layer-1 step) and bf16(h2); each flips on a computed step.
  int cur1 = 0, cur2 = 0;
  bool prev1 = false;  // layer-1 step t-1 was computed: so is layer-2 t-1
  for (int t = 0; t <= T; ++t) {
    bool row_active = false;
    if (t < T) {
      for (int r = threadIdx.x; r < R && n0 + r < N; r += blockDim.x)
        row_active |= mask[(size_t)t * N + n0 + r] > 0.0f;
      // Stage x_t as bf16 pairs of rows, word k * R/2 + p holding rows 2p
      // and 2p + 1 of column k, so consecutive threads write consecutive
      // words.  x_s was last read before the last barrier.
      const int P = R / 2;
      const unsigned short* xt =
          reinterpret_cast<const unsigned short*>(xs) + (size_t)t * N * In;
      uint32_t* xw = reinterpret_cast<uint32_t*>(x_s);
      for (int e = threadIdx.x; e < In * P; e += blockDim.x) {
        const int k = e / P;
        const int n = n0 + 2 * (e - k * P);
        const uint32_t lo = n < N ? xt[(size_t)n * In + k] : 0u;
        const uint32_t hi = n + 1 < N ? xt[(size_t)(n + 1) * In + k] : 0u;
        xw[e] = lo | hi << 16;
      }
    }
    const bool do1 = __syncthreads_or(row_active);  // and x_t staged
    const bool do2 = prev1;
    prev1 = do1;
    const bf16* h1_cur = h1b + (size_t)cur1 * HR;
    const bf16* d_cur = d_b + (size_t)cur1 * HR;
    const bf16* h2_cur = h2b + (size_t)cur2 * HR;
    if (!do1 && t < T) copy_state(hs1_out, h1_cur, t, n0, N, H, R, j0, Uq);
    if (!do2 && t > 0) copy_state(hs2_out, h2_cur, t - 1, n0, N, H, R, j0, Uq);
    if (!do1 && !do2) continue;
    bf16* h1_nxt = h1b + (size_t)(cur1 ^ 1) * HR;
    bf16* d_nxt = d_b + (size_t)(cur1 ^ 1) * HR;
    bf16* h2_nxt = h2b + (size_t)(cur2 ^ 1) * HR;

    for (int item = threadIdx.x; item < Uq * G; item += blockDim.x) {
      const int g = item / Uq;
      const int u = item - g * Uq;
      const int j = j0 + u;
      const int r0 = g * RT;
      if (do1) {  // layer-1 step t
        float acc[4][RT];
        init_bias<RT>(acc, b1, H, j);
        gate_products_bf16<KU>(acc, x_s + r0, R, In, wx1, H, j);
        gate_products_bf16<KU>(acc, h1_cur + r0, R, H, wh1, H, j);
        bf16 h1x[RT], dx[RT];
#pragma unroll
        for (int e = 0; e < RT; ++e) {
          const int r = r0 + e;
          const int n = n0 + r;
          const int s = r * U + u;
          const float c_prev = c1_s[s];
          float cn, hn;
          lstm_cell(acc[0][e], acc[1][e], acc[2][e], acc[3][e], c_prev, &cn,
                    &hn);
          const bool active = n < N && mask[(size_t)t * N + n] > 0.0f;
          c1_s[s] = active ? cn : c_prev;
          const float h = active ? hn : h1_s[s];
          h1_s[s] = h;
          const bf16 hb1 = __float2bfloat16_rn(h);
          h1x[e] = hb1;
          dx[e] = __float2bfloat16_rn(0.0f);
          if (n < N) {
            const size_t o = ((size_t)t * N + n) * H + j;
            hs1_out[o] = hb1;
            const float d = __bfloat162float(hb1) * __bfloat162float(drop[o]);
            dx[e] = __float2bfloat16_rn(d);
          }
        }
        push<C>(cluster, h1_nxt + (size_t)j * R + r0, pack4(h1x));
        push<C>(cluster, d_nxt + (size_t)j * R + r0, pack4(dx));
      }
      if (do2) {  // layer-2 step t-1
        float acc[4][RT];
        init_bias<RT>(acc, b2, H, j);
        gate_products_bf16<KU>(acc, d_cur + r0, R, H, wx2, H, j);
        gate_products_bf16<KU>(acc, h2_cur + r0, R, H, wh2, H, j);
        bf16 h2x[RT];
#pragma unroll
        for (int e = 0; e < RT; ++e) {
          const int r = r0 + e;
          const int n = n0 + r;
          const int s = r * U + u;
          const float c_prev = c2_s[s];
          float cn, hn;
          lstm_cell(acc[0][e], acc[1][e], acc[2][e], acc[3][e], c_prev, &cn,
                    &hn);
          const bool active = n < N && mask[(size_t)(t - 1) * N + n] > 0.0f;
          c2_s[s] = active ? cn : c_prev;
          const float h = active ? hn : h2_s[s];
          h2_s[s] = h;
          const bf16 hb2 = __float2bfloat16_rn(h);
          h2x[e] = hb2;
          if (n < N) hs2_out[((size_t)(t - 1) * N + n) * H + j] = hb2;
        }
        push<C>(cluster, h2_nxt + (size_t)j * R + r0, pack4(h2x));
      }
    }
    // every CTA's pushes of this iteration land before any CTA reads them,
    // and every read of x_s and the current buffers is done before they
    // are written again
    cluster.sync();
    if (do1) cur1 ^= 1;
    if (do2) cur2 ^= 1;
  }
  // Each computing iteration ended in cluster.sync() after its pushes, so no
  // peer stores into this CTA's shared memory any more.
  for (int e = threadIdx.x; e < Uq * R; e += blockDim.x) {
    const int r = e / Uq;
    const int u = e - r * Uq;
    const int n = n0 + r;
    if (n < N) {
      const size_t o = (size_t)n * H + j0 + u;
      const int s = r * U + u;
      c1_out[o] = c1_s[s];
      h1_out[o] = h1_s[s];
      c2_out[o] = c2_s[s];
      h2_out[o] = h2_s[s];
    }
  }
}

// The kernel as launched (host code).
auto seq2_kernel() {
  return &lstm_seq2_kernel<kSeq2Cluster, kSeq2RowsPerThread, kSeq2Unroll>;
}

// The kernel's launch at (N, In, H): one cluster of kSeq2Cluster CTAs per
// tile of `rows` rows, and the clusters the card holds at once at that
// launch (cudaOccupancyMaxActiveClusters).
struct Seq2Plan {
  dim3 grid, block;
  size_t smem;
  int rows;
  int max_clusters;
};

cudaLaunchConfig_t seq2_config(const Seq2Plan& plan, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSeq2Cluster;
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
// dynamic shared memory the kernel has been allowed: a launch after the
// first at a shape makes no query.
std::mutex seq2_plans_mutex;
std::map<std::tuple<int, int, int, int>, Seq2Plan> seq2_plans;
std::map<int, size_t> seq2_smem_allowed;

// Allows the kernel `smem` bytes of dynamic shared memory on `dev`; a shape
// that needs more than the card offers fails here.
cudaError_t allow_seq2_smem(int dev, size_t smem) {
  size_t& allowed = seq2_smem_allowed[dev];
  if (smem <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      seq2_kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// R is the least multiple of kSeq2RowsPerThread whose ceil(N / R) clusters
// the card holds at once, within the threads a CTA may have (one per unit
// and row group) and the shared memory it may use; past those limits, the
// largest R that fits them.  Called with seq2_plans_mutex held.
cudaError_t make_seq2_plan(int dev, int N, int In, int H, Seq2Plan* plan) {
  constexpr int RT = kSeq2RowsPerThread;
  int smem_optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaDeviceGetAttribute(
      &smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, seq2_kernel());
  if (err != cudaSuccess) return err;
  const int max_threads = fa.maxThreadsPerBlock / 32 * 32;
  const int units = (H + kSeq2Cluster - 1) / kSeq2Cluster;
  const size_t row_bytes = (size_t)(In + 6 * H) * sizeof(bf16) +
                           (size_t)4 * units * sizeof(float);
  int r_max = (int)((size_t)smem_optin / row_bytes) / RT * RT;
  const int groups_max = max_threads / units;
  if (groups_max >= 1 && groups_max * RT < r_max) r_max = groups_max * RT;
  if (r_max < RT) r_max = RT;

  auto shape = [&](int R) {
    const int items = units * (R / RT);
    plan->rows = R;
    plan->grid = dim3(((N + R - 1) / R) * kSeq2Cluster);
    plan->block = dim3(items >= max_threads ? max_threads
                                            : (items + 31) / 32 * 32);
    plan->smem = row_bytes * R < kSeq2MinSmem ? kSeq2MinSmem : row_bytes * R;
    cudaError_t e = allow_seq2_smem(dev, plan->smem);
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = seq2_config(*plan, nullptr, &attr);
    return cudaOccupancyMaxActiveClusters(&plan->max_clusters, seq2_kernel(),
                                          &config);
  };
  // one CTA per SM (kSeq2MinSmem), so the count is the same for every R
  err = shape(RT);
  if (err != cudaSuccess) return err;
  int R = RT;
  while (R < r_max && (N + R - 1) / R > plan->max_clusters) R += RT;
  return shape(R);  // and the count again at the launch's own threads
}

cudaError_t seq2_plan(int N, int In, int H, Seq2Plan* plan) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(seq2_plans_mutex);
  const auto key = std::make_tuple(dev, N, In, H);
  const auto it = seq2_plans.find(key);
  if (it != seq2_plans.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  err = make_seq2_plan(dev, N, In, H, plan);
  if (err == cudaSuccess) seq2_plans[key] = *plan;
  return err;
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).  A shape that needs more dynamic shared
// memory than the card offers fails at cudaFuncSetAttribute, whose error is
// returned as well.
int nvqa_lstm_seq2_forward(const bf16* xs, const float* mask, const bf16* drop,
                           const bf16* wx1, const bf16* wh1, const bf16* b1,
                           const bf16* wx2, const bf16* wh2, const bf16* b2,
                           float* c1_out, float* h1_out, float* c2_out,
                           float* h2_out, bf16* hs1_out, bf16* hs2_out, int T,
                           int N, int In, int H, void* stream) {
  Seq2Plan plan;
  cudaError_t err = seq2_plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      seq2_config(plan, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&config, seq2_kernel(), xs, mask, drop, wx1, wh1,
                           b1, wx2, wh2, b2, c1_out, h1_out, c2_out, h2_out,
                           hs1_out, hs2_out, T, N, In, H, plan.rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's launch at (N, In, H), launching nothing: info[0..5] = CTAs
// per cluster, rows per cluster, CTAs in the grid, the clusters the card can
// hold at once (cudaOccupancyMaxActiveClusters), threads per CTA, dynamic
// shared memory per CTA in bytes.
int nvqa_lstm_seq2_launch_info(int N, int In, int H, int* info) {
  Seq2Plan plan;
  cudaError_t err = seq2_plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  const int out[6] = {kSeq2Cluster, plan.rows, (int)plan.grid.x,
                      plan.max_clusters, (int)plan.block.x, (int)plan.smem};
  for (int i = 0; i < 6; ++i) info[i] = out[i];
  return 0;
}

}  // extern "C"
