// LSTM kernels for Hopper (sm_90a), fp32, built with nvcc into a shared
// library with a plain C interface (see novel_vqa_torch/kernels/build.py).
//
// The seq and step kernels compute the fused-gate LSTM cell of the JAX
// package (the cell is in cell.cuh; b = bx + bh):
//
//     gates = x @ Wx + h @ Wh + b;  c', h' = cell(gates, c)
//
// A thread accumulates all four gate columns (j, H+j, 2H+j, 3H+j) of its
// hidden units for a few batch rows in registers, so the cell update runs
// in the epilogue and the (N, 4H) gate matrix never reaches device memory.
// Each output is summed as the bias, then x @ Wx over k = 0..In-1, then
// h @ Wh over k = 0..H-1, one fmaf each, in order.  The seq backward kernel
// runs the reverse scan of the seq kernel's gradient (training).  All
// arithmetic is fp32 FMA (no tensor cores, no TF32).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <map>
#include <mutex>
#include <set>
#include <utility>

#include "cell.cuh"
#include "cluster_plan.cuh"

namespace cg = cooperative_groups;

namespace {

// Seq kernel: CTAs per cluster, batch rows per thread, the unroll of its k
// loops, and threads per CTA at most (96 registers each).  The rows per
// cluster are chosen at launch (seq_planner, cluster_plan.cuh).
constexpr int kSeqCluster = 4;
constexpr int kSeqRowsPerThread = 4;
constexpr int kSeqUnroll = 8;
constexpr int kSeqMaxThreads = 640;
// More than half of an SM's 228 KB of shared memory, less the 1 KB the
// card reserves per block: an SM holds one seq CTA, so a cluster's CTAs
// land on as many SMs and the card holds a fixed number of clusters.
constexpr size_t kSeqMinSmem = 116 * 1024;
// Seq backward kernel: threads per CTA at most (the seq kernel's), the floats
// of one stage of its weight ring and the stages, and the widest H it takes
// (a multiple of 128: its threads own 4 units each of all H for 4 rows, and
// a stage holds at least 4 rows of Wh^T).  Its rows per cluster are chosen
// at launch (bwd_planner), as the seq kernel's.
constexpr int kBwdMaxThreads = kSeqMaxThreads;
constexpr int kBwdRowsPerThread = 4;
constexpr int kBwdStageFloats = 8192;
constexpr int kBwdStages = 3;
constexpr int kBwdMaxH = 2048;
// Step kernel: a CTA's tile of Rows batch rows by 32 hidden units (all four
// gates of each unit), RT batch rows per thread (which owns 2 units), BK k
// per pipeline stage, and Stages stages in its cp.async ring.
template <int Rows, int RT, int BK, int Stages>
struct StepTile {
  static constexpr int kRows = Rows, kRT = RT, kBK = BK, kStages = Stages;
  static constexpr int kUnits = 32;
  static constexpr int kCols = 4 * kUnits;  // gate columns
  static constexpr int kThreads = Rows / RT * (kUnits / 2);
  // floats between two rows of a stage's inputs: the two row groups of a
  // warp read neighbouring rows, which must lie in other banks
  static constexpr int kAStride = BK % 32 == 0 ? BK + 4 : BK;
  // one stage: the rows' inputs [row][k], then the weights [k][gate][unit]
  static constexpr int kStageFloats = Rows * kAStride + BK * kCols;
  static constexpr size_t kSmem = Stages * kStageFloats * sizeof(float);
};
// The tile when the grid of 64-row CTAs has more CTAs than the card has
// SMs; when it has not, half the rows per CTA, so SMs hold two (step_plan).
using StepWide = StepTile<64, 8, 16, 4>;
using StepNarrow = StepTile<32, 4, 32, 3>;

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

// acc[q][r] = b[q * H + j] for q = 0..3 and all R rows.
template <int R>
__device__ __forceinline__ void init_bias(float (&acc)[4][R],
                                          const float* __restrict__ b, int H,
                                          int j) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float bq = load_weight(b + q * H + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = bq;
  }
}

// acc[q][r] += sum_k a_s[k * S + r] * w[k * 4H + q * H + j], q = 0..3,
// for R rows, in order of k, one fmaf each.  The rows' inputs are staged in
// shared memory transposed with row stride S (a thread may take R of a
// tile's S rows), so one float4 load broadcasts four rows of column k to
// the whole warp; each thread reads its unit's four gate columns of weight
// row k, and neighbouring threads read neighbouring columns, so the reads
// coalesce.  The k loop is unrolled KU times: a thread has up to 4 * KU
// weight loads in flight.
template <int R, int KU>
__device__ __forceinline__ void gate_products_strided(
    float (&acc)[4][R], const float* a_s, int S, int K,
    const float* __restrict__ w, int H, int j) {
  static_assert(R % 4 == 0, "rows are read as float4");
  const size_t ld = 4 * (size_t)H;
  const float* wj = w + j;
#pragma unroll (KU)
  for (int k = 0; k < K; ++k) {
    const float* wk = wj + (size_t)k * ld;
    const float w0 = load_weight(wk);
    const float w1 = load_weight(wk + H);
    const float w2 = load_weight(wk + 2 * H);
    const float w3 = load_weight(wk + 3 * H);
    const float4* a4 = reinterpret_cast<const float4*>(a_s + k * S);
#pragma unroll
    for (int v = 0; v < R / 4; ++v) {
      const float4 a = a4[v];
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][4 * v + e] = fmaf(av[e], w0, acc[0][4 * v + e]);
        acc[1][4 * v + e] = fmaf(av[e], w1, acc[1][4 * v + e]);
        acc[2][4 * v + e] = fmaf(av[e], w2, acc[2][4 * v + e]);
        acc[3][4 * v + e] = fmaf(av[e], w3, acc[3][4 * v + e]);
      }
    }
  }
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
// on as many SMs as it can (seq_planner).  At N = 500 on an H100 that is
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
// Bound on the H100: fp32 operations.  At N=500, H=512 a stack step (In=200,
// then In=512) is 3.6 GFLOP of FMA, 0.053 ms at 67 TFLOP/s, against ~14 MB
// of traffic (0.004 ms).
//
// Design: a register-tiled fp32 product.  A CTA owns a tile of batch rows
// by 32 hidden units with all four gates of each (128 gate columns), 128
// threads; a thread owns RT rows x 2 adjacent units x 4 gates, so all four
// gates of its units meet in its registers and the cell runs in the
// epilogue.  Two tiles (StepTile), chosen at launch (step_plan):
// - wide, 64 rows, 8 rows per thread (64 accumulators), 16 k per stage, 4
//   stages: at N=1000, H=512 (the autoencoder) 256 CTAs, two per SM;
// - narrow, 32 rows, 4 rows per thread, 32 k per stage, 3 stages, when the
//   wide grid would hold no more CTAs than the card has SMs: at N=500,
//   H=512, 256 CTAs rather than 128, so each SM holds two CTAs whose warps
//   hide each other's stalls (one wide CTA per SM leaves each scheduler a
//   single warp: 7-8% slower there on an H100 SXM, and the narrow tile 8%
//   slower than the wide one at N=1000).
// - L2 traffic.  The kernel this replaced (a thread per unit, 8 rows per
//   block, weights read from global memory) read each weight from L2 for
//   every 8 rows (~0.9 GB per stack step).  Here both operands pass through shared
//   memory in a ring of stages, filled by 16-byte cp.async.cg copies
//   Stages - 1 stages ahead of use: each weight is fetched once per tile
//   of rows and each input once per 32 units (~0.1-0.2 GB per stack step).
//   The k loop runs over x @ Wx, then h @ Wh, two source pointers feeding
//   one ring; each thread's copy addresses are set up once per operand.
// - Issue slots.  fp32 FFMA at the SM's full rate takes every issue slot,
//   so each shared-memory load costs an FMA.  Inputs are staged [row][k]
//   (no transpose: cp.async copies rows as they lie) and a thread reads 4 k
//   of a row with one 16-byte load; weights are staged [k][gate][unit] and
//   it reads its 2 units of a gate with one 8-byte load.  Per 4 k that is
//   RT + 16 loads for 32 RT FMAs.  Within a load, the threads of a quarter
//   warp read one address (inputs) or neighbouring words (weights); the
//   two row groups of a warp read rows that lie in other banks.
// - Ragged edges.  Rows past N and units past H are zero-filled (cp.async
//   src-size 0) and never stored.  A stage past In or H is cut short: its
//   k loop stops at the edge, so no output takes an FMA beyond K.  When In
//   or H is not a multiple of 4, or an operand is not 16-byte aligned, the
//   copies are 4 bytes each (kVec false).
// Each output takes the bias, then x @ Wx for k = 0..In-1, then h @ Wh for
// k = 0..H-1, one fmaf each: the order of the kernel this replaced, so the
// outputs are its bits.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid, bool vec) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// A thread's copies into one stage of the ring from one operand pair: rows
// a (N, K) and weights w (K, 4H).  The stage holds
// a_s[r * kAStride + kk] = a[(n0 + r) * K + k0 + kk] and
// w_s[kk * 128 + q * 32 + u] = w[(k0 + kk) * 4H + q * H + j0 + u], zero past
// N, K and H.  A thread's copies keep their place in every stage: A copy i
// takes row ra + i * kARows at k = ka, W copy i weight row kw + i * kWKs at
// column (q, u).  So their sources are set up once per operand pair and a
// stage adds k0; a masked copy reads nothing (src-size 0) from the
// operand's first element.  With kVec each copy moves 4 floats, which lie
// all within or all past those edges (In, H and k0 are multiples of 4, j0
// of 32).
template <class T, bool kVec>
struct StepCopies {
  static constexpr int V = kVec ? 4 : 1;  // floats per copy
  static constexpr int kA = T::kRows * T::kBK / V / T::kThreads;
  static constexpr int kW = T::kBK * T::kCols / V / T::kThreads;
  static constexpr int kARows = T::kThreads * V / T::kBK;
  static constexpr int kWKs = T::kThreads * V / T::kCols;
  static_assert(kA * T::kThreads * V == T::kRows * T::kBK &&
                    kW * T::kThreads * V == T::kBK * T::kCols,
                "every thread makes the same number of copies");
  static_assert(T::kThreads * V % T::kBK == 0 &&
                    T::kThreads * V % T::kCols == 0,
                "a thread's copies share their k (A) and column (W)");

  const float* a;  // the operands' first elements
  const float* w;
  const float* a0;  // A copy 0's source at k0 = 0
  const float* w0;  // W copy 0's source at k0 = 0
  size_t a_ld, w_ld;  // floats between a thread's copies
  int K, ka, kw;
  int a_dst, w_dst;  // copy 0's place in a stage
  bool w_ok;         // its weight column lies within H
  unsigned a_ok;     // bit i: A copy i's row lies within N

  __device__ __forceinline__ StepCopies(const float* __restrict__ a_,
                                        const float* __restrict__ w_, int n0,
                                        int N, int K_, int j0, int H)
      : a(a_), w(w_), K(K_) {
    const int t = threadIdx.x;
    const int ra = t / (T::kBK / V);
    ka = (t - ra * (T::kBK / V)) * V;
    kw = t / (T::kCols / V);
    const int col = (t - kw * (T::kCols / V)) * V;
    const int q = col / T::kUnits;
    const int u = col - q * T::kUnits;
    a_ok = 0;
#pragma unroll
    for (int i = 0; i < kA; ++i)
      a_ok |= (unsigned)(n0 + ra + i * kARows < N) << i;
    w_ok = j0 + u < H;
    a_ld = (size_t)kARows * K;
    w_ld = (size_t)kWKs * 4 * H;
    a0 = a + (size_t)(n0 + ra) * K + ka;
    w0 = w + (size_t)kw * 4 * H + q * H + j0 + u;
    a_dst = ra * T::kAStride + ka;
    w_dst = kw * T::kCols + col;
  }

  __device__ __forceinline__ void load(float* a_s, float* w_s, int k0,
                                       int H) const {
    const bool k_ok = k0 + ka < K;
    const float* as = a0 + k0;
#pragma unroll
    for (int i = 0; i < kA; ++i) {
      const bool ok = k_ok && ((a_ok >> i) & 1u);
      cp_async(a_s + a_dst + i * kARows * T::kAStride, ok ? as + i * a_ld : a,
               ok, kVec);
    }
    const float* ws = w0 + (size_t)k0 * 4 * H;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const bool ok = w_ok && k0 + kw + i * kWKs < K;
      cp_async(w_s + w_dst + i * kWKs * T::kCols, ok ? ws + i * w_ld : w, ok,
               kVec);
    }
  }
};

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[q][u][e] += a_t[e * G * kAStride + kk] * w_t[kk * 128 + q * 32 + u]
// for the stage's first kn k, in order of kk.  a_t points at the thread's
// first row (its rows are G = kRows / kRT apart), w_t at its first unit.
template <class T>
__device__ __forceinline__ void step_products(float (&acc)[4][2][T::kRT],
                                              const float* a_t,
                                              const float* w_t, int kn) {
  constexpr int RT = T::kRT;
  constexpr int kRowStride = T::kRows / RT * T::kAStride;
  if (kn == T::kBK) {
#pragma unroll
    for (int k4 = 0; k4 < T::kBK; k4 += 4) {
      float4 av[RT];
#pragma unroll
      for (int e = 0; e < RT; ++e)
        av[e] = *reinterpret_cast<const float4*>(a_t + e * kRowStride + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float2 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = *reinterpret_cast<const float2*>(
              w_t + (k4 + kk) * T::kCols + q * T::kUnits);
#pragma unroll
        for (int e = 0; e < RT; ++e) {
          const float a = lane(av[e], kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q][0][e] = fmaf(a, wv[q].x, acc[q][0][e]);
            acc[q][1][e] = fmaf(a, wv[q].y, acc[q][1][e]);
          }
        }
      }
    }
    return;
  }
  for (int kk = 0; kk < kn; ++kk) {  // the last stage of In or H
    float2 wv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wv[q] = *reinterpret_cast<const float2*>(w_t + kk * T::kCols +
                                               q * T::kUnits);
#pragma unroll
    for (int e = 0; e < RT; ++e) {
      const float a = a_t[e * kRowStride + kk];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[q][0][e] = fmaf(a, wv[q].x, acc[q][0][e]);
        acc[q][1][e] = fmaf(a, wv[q].y, acc[q][1][e]);
      }
    }
  }
}

template <class T, bool kVec>
__global__ void __launch_bounds__(T::kThreads, 2)
    lstm_step_kernel(const float* __restrict__ x, const float* __restrict__ h,
                     const float* __restrict__ c,
                     const float* __restrict__ wx,
                     const float* __restrict__ wh,
                     const float* __restrict__ b, float* __restrict__ c_out,
                     float* __restrict__ h_out, int N, int In, int H) {
  constexpr int S = T::kStages, BK = T::kBK, RT = T::kRT;
  constexpr int kAFloats = T::kRows * T::kAStride;  // a stage's inputs
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n0 = blockIdx.x * T::kRows;
  const int j0 = blockIdx.y * T::kUnits;
  // the thread's rows rg + e * kRows / RT; a warp holds two row groups
  const int rg = threadIdx.x / (T::kUnits / 2);
  const int up = threadIdx.x - rg * (T::kUnits / 2);  // unit pair
  const int nx = (In + BK - 1) / BK;  // stages of x @ Wx
  const int ns = nx + (H + BK - 1) / BK;

  // stage s: x @ Wx over k = s * BK .. for s < nx, then h @ Wh; stages
  // are loaded in order, so the copies switch operands once, at s = nx
  StepCopies<T, kVec> copies(x, wx, n0, N, In, j0, H);
  auto load = [&](int s) {
    float* a_s = smem + (s % S) * T::kStageFloats;
    if (s == nx) copies = StepCopies<T, kVec>(h, wh, n0, N, H, j0, H);
    copies.load(a_s, a_s + kAFloats, (s < nx ? s : s - nx) * BK, H);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < ns) load(s);
    cp_async_commit();  // one group per stage, empty ones too
  }

  float acc[4][2][RT];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = j0 + 2 * up + u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float bq = j < H ? load_weight(b + q * H + j) : 0.0f;
#pragma unroll
      for (int e = 0; e < RT; ++e) acc[q][u][e] = bq;
    }
  }

  for (int s = 0; s < ns; ++s) {
    cp_async_wait<S - 2>();  // this thread's copies of stage s have landed
    // ... and every thread's; and every thread is done with stage s - 1,
    // whose buffer the next load refills
    __syncthreads();
    if (s + S - 1 < ns) load(s + S - 1);
    cp_async_commit();
    const float* a_s = smem + (s % S) * T::kStageFloats;
    const int kn = s < nx ? min(BK, In - s * BK) : min(BK, H - (s - nx) * BK);
    step_products<T>(acc, a_s + rg * T::kAStride, a_s + kAFloats + 2 * up, kn);
  }

#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int j = j0 + 2 * up + u;
    if (j >= H) continue;
#pragma unroll
    for (int e = 0; e < RT; ++e) {
      const int n = n0 + rg + e * (T::kRows / RT);
      if (n < N) {
        float cn, hn;
        lstm_cell(acc[0][u][e], acc[1][u][e], acc[2][u][e], acc[3][u][e],
                  c[(size_t)n * H + j], &cn, &hn);
        c_out[(size_t)n * H + j] = cn;
        h_out[(size_t)n * H + j] = hn;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Seq backward kernel.  Replaces no TPU kernel: it is the reverse half of the
// JAX package's _seq_bwd (novel_vqa_tpu/ops/pallas_lstm.py:279-374), a scan
// that XLA runs there; its plain version (kernels/lstm.py,
// lstm_seq_backward_plain) issues some 30 small operations a step from
// Python.  For a tile of batch rows it rebuilds the cell states from the gate
// pre-activations (T, N, 4H) and the mask, then carries (dh, dc) from the
// last step to the first, writing each step's gate derivatives dgates
// (T, N, 4H) over the pre-activations:
//
//     dh_t = dhs_t + dh;  dh' = m dh_t;  dc' = m dc + dh' o (1 - tanh(c_t)^2)
//     dgates_t = [dc' g i(1-i), dc' c_{t-1} f(1-f), dh' tanh(c_t) o(1-o),
//                 dc' i (1-g^2)]
//     dh <- dgates_t @ Wh^T + (1 - m) dh_t;  dc <- dc' f + (1 - m) dc
//
// The product of step 0 is skipped: it would give the gradient of the zero
// initial state, which nothing reads.
//
// Bound on the H100: operations.  At T=16, N=500, H=512 the products are up
// to 15.7 GFLOP of fp32 FMA (0.23 ms at 67 TFLOP/s) against ~150 MB of
// traffic (0.045 ms); the elementwise work is small beside them.
//
// Design: as the seq kernel, a cluster of C CTAs owns a tile of R rows for
// all steps, and CTA q owns hidden units [q U, (q + 1) U), U = H / C, with
// all four gate columns of each, so the cell's backward and the rebuild of
// c run thread-locally (four (row, unit) elements per thread, their carries
// in registers).  The product is split by CTA along its reduction: CTA q
// multiplies its own 4U gate derivatives, kept in shared memory, by the
// matching 4U rows of Wh^T, giving a partial dh for all H units of its
// rows; each thread owns RT rows by KT units of it.  Each CTA then pushes
// the partials of CTA p's units into p's shared memory (distributed shared
// memory), one barrier.cluster per step orders them, and each CTA sums the
// C partials of its own units in rank order.  Exchanging the gate
// derivatives instead would take 4H floats a row in every CTA, twice over
// for the double buffer: more than a CTA's shared memory at R = 20.
//
// - Weights.  A CTA's 4U rows of Wh^T (1 MB at H=512) do not fit in shared
//   memory, so they stream from L2 every step through a ring of S stages
//   of BK rows (BK H = 8192 floats, BK <= 32), filled by 16-byte cp.async
//   copies S - 1 stages ahead; a stage is one contiguous block of Wh^T.
//   Each weight is read from L2 once per tile and step, and once from
//   shared memory per row group (float4 reads of KT neighbouring units,
//   the rows' derivatives broadcast to the warp).  The weights are the
//   same every step, so the first stages of the next step's product are
//   fetched as soon as the ring is free, during the cell's backward and
//   the exchange.
// - Steps.  A step on which no row of the tile is active gives zero
//   dgates, and dh and dc pass through (dh gains dhs_t); its product and
//   exchange are skipped.  The CTAs of a cluster hold the same rows and
//   decide alike, so the barrier stays uniform.  Right-aligned masks skip
//   a tile's steps before its longest row.
// - Memory.  The rebuilt c_{t-1} goes to a (T, N, H) scratch in device
//   memory (written once, read once); the gate derivatives go over the
//   pre-activations, which the reverse scan has read by then.
//
// Each dh sums, over its CTA's 4U columns in order, one fmaf each; then the
// C partial sums in rank order, then (1 - m) dh_t.  All arithmetic is fp32
// (no tensor cores, no TF32), in a fixed order.
//
// Shared memory: S BK H floats for the ring, then per row 4U floats of
// gate derivatives ([column][row]) and 2 C U floats of partials (double
// buffered): 96 KB + 12 KB per row at H = 512, 216 KB at R = 20.
// ---------------------------------------------------------------------------
template <int C, int RT, int KT, int S>
__global__ void __launch_bounds__(kBwdMaxThreads, 1)
    lstm_seq_backward_kernel(float* gates, const float* __restrict__ mask,
                             const float* __restrict__ wh_t,
                             const float* __restrict__ dhs,
                             const float* __restrict__ dh_fin,
                             const float* __restrict__ dc_fin,
                             float* __restrict__ c_seq, int T, int N, int H,
                             int R, int BK) {
  static_assert(RT % 4 == 0 && KT == 4, "the tile is read and pushed as float4");
  static_assert(KT == C, "a thread's elements share their unit");
  constexpr int E = RT;  // (row, unit) elements per thread: R U / P
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int U = H / C;
  const int j0 = rank * U;
  const int n0 = (blockIdx.x / C) * R;
  const int tid = threadIdx.x;
  const int P = (H / KT) * (R / RT);  // threads that own a product tile
  const bool worker = tid < P;
  const int ns = H / BK;  // stages per product (4U = H rows of Wh^T)
  const size_t G4 = 4 * (size_t)H;

  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // S stages of BK x H
  float* dg_s = w_s + S * kBwdStageFloats;       // 4U x R, [column][row]
  float* x_s = dg_s + (size_t)H * R;  // 2 x C x R x U, [buffer][rank][row][unit]

  // stage s of the product: the Wh^T rows of local columns s BK .. (local
  // column q U + u is gate column q H + j0 + u) into its slot of the ring
  auto load_stage = [&](int s) {
    float* dst = w_s + (s % S) * kBwdStageFloats;
    const int lc0 = s * BK;
    const int q = lc0 / U;
    const float* src = wh_t + ((size_t)q * H + j0 + lc0 - q * U) * H;
    for (int e = 4 * tid; e < BK * H; e += 4 * blockDim.x)
      cp_async(dst + e, src + e, true, true);
  };
  auto prefetch = [&]() {
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < ns) load_stage(s);
      cp_async_commit();  // one group per stage, empty ones too
    }
  };
  auto tile_active = [&](int t) {
    bool any = false;
    for (int r = tid; r < R && n0 + r < N; r += blockDim.x)
      any |= mask[(size_t)t * N + n0 + r] > 0.0f;
    return __syncthreads_or(any) != 0;
  };

  // this thread's elements: (row er0 + i R / RT, own unit eu), i < E
  const int eu = tid % U;
  const int er0 = tid / U;
  const int rstep = R / RT;
  auto er = [&](int i) { return er0 + i * rstep; };
  auto ev = [&](int i) { return worker && n0 + er(i) < N; };
  prefetch();  // the first product's stages land during the rebuild

  // 1. the cell states: c_{t-1} of each computed step into c_seq
  float dh[E], dc[E], dhp[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dc[i] = dhp[i] = 0.0f;  // dc holds c here
  for (int t = 0; t < T; ++t) {
    if (!tile_active(t)) continue;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (!ev(i)) continue;
      const size_t o = (size_t)t * N + n0 + er(i);
      const int j = j0 + eu;
      const float* z = gates + o * G4 + j;
      const float ig = sigmoidf_(z[0]);
      const float fg = sigmoidf_(z[H]);
      const float gg = tanhf(z[3 * H]);
      const float cn = fg * dc[i] + ig * gg;
      c_seq[o * H + j] = dc[i];
      if (mask[o] > 0.0f) dc[i] = cn;
    }
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const size_t o = (size_t)(n0 + er(i)) * H + j0 + eu;
    dh[i] = ev(i) ? dh_fin[o] : 0.0f;
    dc[i] = ev(i) ? dc_fin[o] : 0.0f;
  }
  // every CTA of the cluster runs before a peer stores into its memory
  cluster.sync();

  // 2. the reverse scan
  int buf = 0;  // the partials' buffer the next computed step fills
  for (int t = T - 1; t >= 0; --t) {
    if (!tile_active(t)) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        if (!ev(i)) continue;
        const size_t o = (size_t)t * N + n0 + er(i);
        const int j = j0 + eu;
        dh[i] = dhs[o * H + j] + dh[i];
        float* z = gates + o * G4 + j;
        z[0] = z[H] = z[2 * H] = z[3 * H] = 0.0f;
      }
      continue;
    }
    // the cell's backward, thread-local
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (!worker) continue;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (ev(i)) {
        const size_t o = (size_t)t * N + n0 + er(i);
        const int j = j0 + eu;
        float* z = gates + o * G4 + j;
        const float m = mask[o];
        const float ig = sigmoidf_(z[0]);
        const float fg = sigmoidf_(z[H]);
        const float og = sigmoidf_(z[2 * H]);
        const float gg = tanhf(z[3 * H]);
        const float cp = c_seq[o * H + j];
        const float tc = tanhf(fg * cp + ig * gg);
        const float dh_t = dhs[o * H + j] + dh[i];
        const float dc_t = dc[i];
        const float dh_new = m * dh_t;
        const float dc_new = m * dc_t + dh_new * og * (1.0f - tc * tc);
        d[0] = dc_new * gg * ig * (1.0f - ig);
        d[1] = dc_new * cp * fg * (1.0f - fg);
        d[2] = dh_new * tc * og * (1.0f - og);
        d[3] = dc_new * ig * (1.0f - gg * gg);
        z[0] = d[0];
        z[H] = d[1];
        z[2 * H] = d[2];
        z[3 * H] = d[3];
        dhp[i] = (1.0f - m) * dh_t;
        dc[i] = dc_new * fg + (1.0f - m) * dc_t;
      }
      if (t > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) dg_s[(size_t)(q * U + eu) * R + er(i)] = d[q];
      }
    }
    if (t == 0) break;  // the initial state's gradient is not needed
    __syncthreads();    // the tile's gate derivatives are in dg_s

    // the partial product over this CTA's columns, for all H units
    const int kq = worker ? tid % (H / KT) : 0;
    const int r0 = worker ? tid / (H / KT) * RT : 0;
    float acc[RT][KT];
#pragma unroll
    for (int e = 0; e < RT; ++e)
#pragma unroll
      for (int k = 0; k < KT; ++k) acc[e][k] = 0.0f;
    for (int s = 0; s < ns; ++s) {
      cp_async_wait<S - 2>();  // this thread's copies of stage s landed
      __syncthreads();  // ... every thread's, and stage s - 1 is free
      if (s + S - 1 < ns) load_stage(s + S - 1);
      cp_async_commit();
      if (!worker) continue;
      const float* ws = w_s + (s % S) * kBwdStageFloats + kq * KT;
      const float* ds = dg_s + (size_t)s * BK * R + r0;
#pragma unroll 4
      for (int cc = 0; cc < BK; ++cc) {
        const float4 w = *reinterpret_cast<const float4*>(ws + cc * H);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int v = 0; v < RT / 4; ++v) {
          const float4 a = *reinterpret_cast<const float4*>(ds + cc * R + 4 * v);
          const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int k = 0; k < KT; ++k)
              acc[4 * v + e][k] = fmaf(av[e], wv[k], acc[4 * v + e][k]);
        }
      }
    }
    if (worker) {
      // units kq KT .. belong to CTA p; into its buffer's slot of this rank
      const int k0 = kq * KT;
      const int p = k0 / U;
      float* dst = x_s + (((size_t)buf * C + rank) * R + r0) * U + (k0 - p * U);
      float4* peer = reinterpret_cast<float4*>(cluster.map_shared_rank(dst, p));
#pragma unroll
      for (int e = 0; e < RT; ++e)
        peer[e * U / 4] = make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
    }
    // every CTA's partials land before any CTA sums them, and every read of
    // dg_s and of the ring is done before either is written again
    cluster.sync();
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (!worker) continue;
      const float* xb = x_s + (size_t)buf * C * R * U + er(i) * U + eu;
      float sum = xb[0];
#pragma unroll
      for (int p = 1; p < C; ++p) sum += xb[(size_t)p * R * U];
      dh[i] = sum + dhp[i];
    }
    buf ^= 1;
    if (t > 1) prefetch();
  }
  cp_async_wait<0>();  // no copy outlives the block
}

// The seq kernel as launched (host code).
auto seq_kernel() {
  return &lstm_seq_kernel<kSeqCluster, kSeqRowsPerThread, kSeqUnroll>;
}

// What a tile of the seq kernel costs a CTA at (In, H): the x_t, h
// (double-buffered) and c tiles in shared memory, no cap on the rows but
// the threads; one thread per unit and group of kSeqRowsPerThread rows.
TileCost seq_cost(int In, int H) {
  const int units = (H + kSeqCluster - 1) / kSeqCluster;
  TileCost c;
  c.granularity = kSeqRowsPerThread;
  c.rows_max = INT_MAX;
  c.row_bytes = (size_t)(In + 2 * H + units) * sizeof(float);
  c.min_smem = kSeqMinSmem;
  return c;
}

int seq_threads(int /*In*/, int H, int rows) {
  return (H + kSeqCluster - 1) / kSeqCluster * (rows / kSeqRowsPerThread);
}

ClusterPlanner<decltype(seq_kernel())> seq_planner(seq_kernel(), kSeqCluster,
                                                   seq_cost, seq_threads);

// The seq backward kernel as launched, its tile's cost at (In, H) (the ring,
// then per row the gate derivatives and the double-buffered partials; In
// does not enter) and its threads: one per kBwdRowsPerThread rows by 4
// units of all H.
auto bwd_kernel() {
  return &lstm_seq_backward_kernel<kSeqCluster, kBwdRowsPerThread, 4, kBwdStages>;
}

TileCost bwd_cost(int /*In*/, int H) {
  TileCost c;
  c.granularity = kBwdRowsPerThread;
  c.rows_max = INT_MAX;
  c.row_bytes = (size_t)3 * H * sizeof(float);
  c.min_smem = kSeqMinSmem;
  c.fixed_bytes = (size_t)kBwdStages * kBwdStageFloats * sizeof(float);
  return c;
}

// Wh^T rows per stage of the ring at H: a power of two, at most 32, so it
// divides U = H / 4 (a multiple of 32) and a stage's rows lie within one
// gate's block, contiguous.
int bwd_stage_rows(int H) {
  int bk = 32;
  while (bk * H > kBwdStageFloats) bk /= 2;
  return bk;
}

int bwd_threads(int /*In*/, int H, int rows) {
  return H / 4 * (rows / kBwdRowsPerThread);
}

ClusterPlanner<decltype(bwd_kernel())> bwd_planner(bwd_kernel(), kSeqCluster,
                                                   bwd_cost, bwd_threads);

// The step kernel's launch: the kernel (tile and copy width), grid, threads,
// dynamic shared memory, and the tile's shape and the card's SMs to report.
using StepKernel = void (*)(const float*, const float*, const float*,
                            const float*, const float*, const float*, float*,
                            float*, int, int, int);
struct StepLaunch {
  StepKernel kernel;
  dim3 grid;
  int threads, rows, rows_per_thread, stages, bk, sms;
  size_t smem;
};

template <class T>
StepLaunch step_launch(bool vec, int N, int H) {
  StepLaunch l;
  l.kernel = vec ? &lstm_step_kernel<T, true> : &lstm_step_kernel<T, false>;
  l.grid = dim3((N + T::kRows - 1) / T::kRows,
                (H + T::kUnits - 1) / T::kUnits);
  l.threads = T::kThreads;
  l.rows = T::kRows;
  l.rows_per_thread = T::kRT;
  l.stages = T::kStages;
  l.bk = T::kBK;
  l.smem = T::kSmem;
  return l;
}

// 16-byte copies need In and H multiples of 4 and the four operands the
// copies read 16-byte aligned.
bool step_vec(const void* x, const void* h, const void* wx, const void* wh,
              int In, int H) {
  const uintptr_t any = (uintptr_t)x | (uintptr_t)h | (uintptr_t)wx |
                        (uintptr_t)wh;
  return In % 4 == 0 && H % 4 == 0 && any % 16 == 0;
}

// Per device, its SMs and the kernels whose dynamic shared memory has been
// allowed: one query and one cudaFuncSetAttribute each, not one per launch.
std::mutex step_mutex;
std::map<int, int> step_sms;
std::set<std::pair<int, StepKernel>> step_smem_allowed;

// The launch at (N, H) on the current device.  The wide tile when its grid
// has more CTAs than the card has SMs; else the narrow tile, twice the CTAs,
// so that SMs hold two CTAs and their warps hide each other's stalls (at
// N=500, H=512: 256 CTAs of 32 rows, not 128 of 64).
cudaError_t step_plan(int N, int H, bool vec, StepLaunch* l) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(step_mutex);
  auto it = step_sms.find(dev);
  if (it == step_sms.end()) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    it = step_sms.emplace(dev, sms).first;
  }
  *l = step_launch<StepWide>(vec, N, H);
  if ((int)(l->grid.x * l->grid.y) <= it->second)
    *l = step_launch<StepNarrow>(vec, N, H);
  l->sms = it->second;
  if (step_smem_allowed.count({dev, l->kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(l->kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)l->smem);
  if (err == cudaSuccess) step_smem_allowed.insert({dev, l->kernel});
  return err;
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
  ClusterPlan plan;
  cudaError_t err = seq_planner.plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      seq_planner.config(plan, (cudaStream_t)stream, &attr);
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
  ClusterPlan plan;
  cudaError_t err = seq_planner.plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  const int out[6] = {kSeqCluster, plan.rows, (int)plan.grid.x,
                      plan.max_clusters, (int)plan.block.x, (int)plan.smem};
  for (int i = 0; i < 6; ++i) info[i] = out[i];
  return 0;
}

// The seq backward kernel over one layer: `gates` (T, N, 4H) holds the gate
// pre-activations on entry and the gate derivatives on return; `wh_t` is
// Wh^T (4H, H); `c_seq` (T, N, H) is scratch.  H must be a multiple of 128,
// at most kBwdMaxH (cudaErrorInvalidValue otherwise).
int nvqa_lstm_seq_backward(float* gates, const float* mask, const float* wh_t,
                           const float* dhs, const float* dh_fin,
                           const float* dc_fin, float* c_seq, int T, int N,
                           int H, void* stream) {
  if (H % 128 != 0 || H > kBwdMaxH) return (int)cudaErrorInvalidValue;
  ClusterPlan plan;
  cudaError_t err = bwd_planner.plan(N, 0, H, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      bwd_planner.config(plan, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&config, bwd_kernel(), gates, mask, wh_t, dhs,
                           dh_fin, dc_fin, c_seq, T, N, H, plan.rows,
                           bwd_stage_rows(H));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The seq backward kernel's launch at (N, H), launching nothing; In is not
// read.  info[0..5] as nvqa_lstm_seq_launch_info's.
int nvqa_lstm_seq_backward_launch_info(int N, int In, int H, int* info) {
  (void)In;
  if (H % 128 != 0 || H > kBwdMaxH) return (int)cudaErrorInvalidValue;
  ClusterPlan plan;
  cudaError_t err = bwd_planner.plan(N, 0, H, &plan);
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
  StepLaunch l;
  const cudaError_t err =
      step_plan(N, H, step_vec(x, h, wx, wh, In, H), &l);
  if (err != cudaSuccess) return (int)err;
  l.kernel<<<l.grid, l.threads, l.smem, (cudaStream_t)stream>>>(
      x, h, c, wx, wh, b, c_out, h_out, N, In, H);
  return (int)cudaGetLastError();
}

// The step kernel's launch at (N, In, H) for operands the PyTorch allocator
// placed (16-byte aligned), launching nothing: info[0..10] = rows and hidden
// units per CTA, batch rows per thread, CTAs in the grid, threads per CTA,
// dynamic shared memory per CTA in bytes, pipeline stages, k per stage, the
// CTAs an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// the card's SMs, and the bytes of each cp.async copy.
int nvqa_lstm_step_launch_info(int N, int In, int H, int* info) {
  const bool vec = In % 4 == 0 && H % 4 == 0;
  StepLaunch l;
  int per_sm = 0;
  cudaError_t err = step_plan(N, H, vec, &l);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel,
                                                        l.threads, l.smem);
  if (err != cudaSuccess) return (int)err;
  const int out[11] = {l.rows,      32,       l.rows_per_thread,
                       (int)(l.grid.x * l.grid.y),
                       l.threads,   (int)l.smem, l.stages,
                       l.bk,        per_sm,   l.sms,
                       vec ? 16 : 4};
  for (int i = 0; i < 11; ++i) info[i] = out[i];
  return 0;
}

}  // extern "C"
