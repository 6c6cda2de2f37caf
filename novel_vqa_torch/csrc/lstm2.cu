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
// The cell and gate order are cell.cuh's; b = bx + bh rounded to bf16.
// Outputs: the final c1, h1, c2, h2 (N, H) in f32 and hs1, hs2 (T, N, H) in
// bf16.
//
// Bound on the H100: operations.  At N=500, T=16, In=200, H=512 the
// products are 2 * (In + 3H) * 4H = 7.1 MFLOP per active (row, step); on
// the bf16 tensor cores (989 TFLOP/s) the active pairs of the kernel
// check's masks take 0.0301 ms, and its ~39 MB of traffic 0.012 ms.
//
// Design: the seq kernel's thread-block cluster (lstm.cu), for both layers.
// A cluster of C CTAs owns a tile of R rows for all T steps; clusters never
// synchronise with each other.  CTA q owns hidden units [q * U, (q + 1) * U),
// U = ceil(H / C), with all four gate columns of each in both layers, so
// each SM reads only its 1/C of the four weight matrices from L2 per step;
// the launch picks the fewest rows per tile, a multiple of 8, whose clusters
// fit one wave (cluster_plan.cuh): 21 clusters of 24 rows, 84 CTAs at
// N = 500.
//
// The products run on the tensor cores: mma.sync m16n8k16, bf16 operands,
// f32 accumulators initialised from f32(b).  The weights are the A operand
// (16 gate columns by 16 k), the rows of the tile the B operand (16 k by 8
// rows), so a warp owns 8 units of its CTA with all four gates: two m16
// tiles, the first with gates i and f of the 8 units, the second with o
// and g, times the tile's R / 8 n-tiles.  A lane's accumulators then hold
// i, f, o and g of one unit for two rows, and the cell, the saved states
// and the pushes run from registers.  The wrapper packs both layers' [Wx;
// Wh] once per launch in fragment order (kernels/lstm2.py:pack_weights: k
// padded to 16 per matrix, units to 8 per CTA, zeros in the padding), so a
// lane's A fragment of one k-chunk is one coalesced 16-byte load from L2,
// kSeq2Prefetch chunks in flight.  The activations stay in shared memory
// as [row][k] bf16 tiles whose row stride is 8 more than a multiple of 16,
// so a B fragment is two conflict-free 32-bit loads.  The k padding of the
// tiles is zero (it meets zero weights; what the memory held before could
// be a NaN).  Each output sums f32(b), then the input product's k-chunks of
// 16 in order, then the recurrent product's: every bf16 x bf16 product is
// exact in f32, so only the order of the f32 sums differs from the plain
// version (kernels/lstm2.py:lstm_seq2_plain).
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
// which has the same mask, so d shares layer 1's buffer index.  Shared
// memory: R * (2 * (SX + 6 * SH) + 16 * SC) bytes (Seq2Dims), 206 KB at
// In=200, H=512, R=24.
//
// A layer whose step no row of the tile takes (mask all zero) leaves c and h
// as they are, so its products are skipped, its buffers keep their index,
// and hs = bf16(h) is written from the current buffer.  The CTAs of a
// cluster hold the same rows and decide alike; an iteration with nothing to
// compute makes no barrier.  The skip is exact for any mask.
//
// What bounds it now: each CTA streams its quarter of both layers' packed
// weights from L2 on every computed step, (In + 3H) * 4H * 2 bytes per
// cluster (3.6 MB at In=200, H=512), while the products themselves take
// microseconds; staging the weights or multicasting them across the cluster
// is the way further down.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell.cuh"
#include "cluster_plan.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

// CTAs per cluster; rows per mma n-tile (rows per cluster are a multiple,
// chosen at launch); n-tiles per warp at most (so at most 24 rows per
// cluster); k-chunks of weight fragments a warp keeps in flight; threads
// per CTA at most (128 registers each).
constexpr int kSeq2Cluster = 4;
constexpr int kSeq2TileRows = 8;
constexpr int kSeq2MaxTiles = 3;
constexpr int kSeq2Prefetch = 4;
constexpr int kSeq2MaxThreads = 512;
// More than half of an SM's shared memory: one CTA per SM, so the clusters
// the card holds at once do not depend on the rows per cluster.
constexpr size_t kSeq2MinSmem = 116 * 1024;

// The kernel's tiles at (In, H), for host and device alike.
struct Seq2Dims {
  int U;   // units per CTA, ceil(H / C)
  int G;   // groups of 8 units per CTA: one warp's 32 gate columns
  int KX;  // In padded to 16: the input product's k-chunks
  int KH;  // H padded to 16: the recurrent product's
  int SX;  // row stride (bf16) of the x tile, KX + 8
  int SH;  // of the bf16(h1), d and bf16(h2) tiles, KH + 8
  int SC;  // of the f32 carries, [row][own unit], 8G + 4
};

__host__ __device__ inline Seq2Dims seq2_dims(int In, int H) {
  Seq2Dims d;
  d.U = (H + kSeq2Cluster - 1) / kSeq2Cluster;
  d.G = (d.U + 7) / 8;
  d.KX = (In + 15) / 16 * 16;
  d.KH = (H + 15) / 16 * 16;
  d.SX = d.KX + 8;
  d.SH = d.KH + 8;
  d.SC = 8 * d.G + 4;
  return d;
}

// d += a * b on the tensor cores: a the m16k16 A fragment (bf16 pairs),
// b0 and b1 the k16n8 B fragment, d the f32 m16n8 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// A warp's accumulators for one layer: acc[m][nt] is m16 tile m (0: gates i
// and f, 1: o and g) by n-tile nt; a lane holds unit g = lane / 4 of the
// warp's 8, rows 2t and 2t + 1 (t = lane % 4) of each n-tile: acc[m][nt][e]
// gate 2m, acc[m][nt][2 + e] gate 2m + 1, of row 2t + e.  Each starts at
// f32(b) of its gate column, zero for a unit past the CTA's.
template <int NT>
__device__ __forceinline__ void init_acc(float (&acc)[2][NT][4],
                                         const bf16* __restrict__ b, int H,
                                         int j, bool own) {
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = own ? load_weight(b + q * H + j) : 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][nt][0] = acc[m][nt][1] = bq[2 * m];
      acc[m][nt][2] = acc[m][nt][3] = bq[2 * m + 1];
    }
  }
}

// acc += one layer's products for a warp's unit group, over the layer's
// k-chunks of 16 in order.  `w` is this lane's A fragment of chunk 0 in the
// packed weights (chunk c at w + 64c, m tile 1 at + 32).  Chunks below `cx`
// take the activations from a0 (row stride s0), the rest from a1 (s1), both
// already offset to this lane's row (g) and k pair (2t).
template <int NT, int P>
__device__ __forceinline__ void products(float (&acc)[2][NT][4],
                                         const uint4* __restrict__ w,
                                         int chunks, int cx, const bf16* a0,
                                         int s0, const bf16* a1, int s1,
                                         int ntiles) {
  uint4 f[P][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p < chunks) {
      f[p][0] = __ldg(w + 64 * p);
      f[p][1] = __ldg(w + 64 * p + 32);
    }
  }
  for (int c0 = 0; c0 < chunks; c0 += P) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int c = c0 + p;
      if (c < chunks) {
        const uint4 fa = f[p][0], fb = f[p][1];
        if (c + P < chunks) {
          f[p][0] = __ldg(w + 64 * (c + P));
          f[p][1] = __ldg(w + 64 * (c + P) + 32);
        }
        const bool first = c < cx;
        const bf16* a = first ? a0 + 16 * c : a1 + 16 * (c - cx);
        const int s8 = 8 * (first ? s0 : s1);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt < ntiles) {
            const uint32_t* b = reinterpret_cast<const uint32_t*>(a + nt * s8);
            const uint32_t b0 = b[0], b1 = b[4];  // k 2t, 2t + 1; + 8
            mma_bf16(acc[0][nt], fa, b0, b1);
            mma_bf16(acc[1][nt], fb, b0, b1);
          }
        }
      }
    }
  }
}

// One unit's bf16 of rows r and r + 1 (row stride S) into `dst` of every
// CTA of the cluster.
template <int C>
__device__ __forceinline__ void push2(cg::cluster_group& cluster, bf16* dst,
                                      int S, const bf16 (&v)[2]) {
#pragma unroll
  for (int p = 0; p < C; ++p) {
    bf16* d = cluster.map_shared_rank(dst, p);
    d[0] = v[0];
    d[S] = v[1];
  }
}

// hs[t] = the current bf16 buffer for this CTA's units: a skipped step.
__device__ __forceinline__ void copy_state(bf16* __restrict__ hs_out,
                                           const bf16* buf, int t, int n0,
                                           int N, int H, int R, int SH,
                                           int j0, int Uq) {
  for (int e = threadIdx.x; e < Uq * R; e += blockDim.x) {
    const int r = e / Uq;
    const int j = j0 + (e - r * Uq);
    const int n = n0 + r;
    if (n < N) hs_out[((size_t)t * N + n) * H + j] = buf[(size_t)r * SH + j];
  }
}

template <int C, int NT, int P>
__global__ void __launch_bounds__(kSeq2MaxThreads, 1)
    lstm_seq2_kernel(const bf16* __restrict__ xs,
                     const float* __restrict__ mask,
                     const bf16* __restrict__ drop,
                     const uint4* __restrict__ w,
                     const bf16* __restrict__ b1,
                     const bf16* __restrict__ b2,
                     float* __restrict__ c1_out, float* __restrict__ h1_out,
                     float* __restrict__ c2_out, float* __restrict__ h2_out,
                     bf16* __restrict__ hs1_out, bf16* __restrict__ hs2_out,
                     int T, int N, int In, int H, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const Seq2Dims dm = seq2_dims(In, H);
  const int q = (int)cluster.block_rank();
  const int j0 = q * dm.U;
  const int Uq = max(0, min(dm.U, H - j0));  // this CTA's units
  const int n0 = (blockIdx.x / C) * R;
  const int ntiles = R / kSeq2TileRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma group, thread in group
  const int chunks1 = (dm.KX + dm.KH) / 16, chunks2 = 2 * dm.KH / 16;
  const size_t tile = (size_t)R * dm.SH;

  extern __shared__ float4 smem4[];
  // f32 carries of this CTA's units, [row][own unit]
  float* c1_s = reinterpret_cast<float*>(smem4);
  float* h1_s = c1_s + (size_t)R * dm.SC;
  float* c2_s = h1_s + (size_t)R * dm.SC;
  float* h2_s = c2_s + (size_t)R * dm.SC;
  // bf16 tiles, [row][unit or k]: bf16(h1), d and bf16(h2) double-buffered
  bf16* h1b = reinterpret_cast<bf16*>(h2_s + (size_t)R * dm.SC);
  bf16* d_b = h1b + 2 * tile;
  bf16* h2b = d_b + 2 * tile;
  bf16* x_s = h2b + 2 * tile;  // R * SX

  uint32_t* words = reinterpret_cast<uint32_t*>(smem4);
  const size_t n_words = (size_t)4 * R * dm.SC + (6 * tile + (size_t)R * dm.SX) / 2;
  for (size_t e = threadIdx.x; e < n_words; e += blockDim.x) words[e] = 0u;
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
      // Stage x_t's rows, [row][k]; x_s was last read before the last
      // barrier, and its k padding stays zero.
      const unsigned short* xt =
          reinterpret_cast<const unsigned short*>(xs) + ((size_t)t * N + n0) * In;
      unsigned short* xw = reinterpret_cast<unsigned short*>(x_s);
      for (int e = threadIdx.x; e < R * In; e += blockDim.x) {
        const int r = e / In;
        xw[r * dm.SX + (e - r * In)] = n0 + r < N ? xt[e] : (unsigned short)0;
      }
    }
    const bool do1 = __syncthreads_or(row_active);  // and x_t staged
    const bool do2 = prev1;
    prev1 = do1;
    const bf16* h1_cur = h1b + cur1 * tile;
    const bf16* d_cur = d_b + cur1 * tile;
    const bf16* h2_cur = h2b + cur2 * tile;
    if (!do1 && t < T)
      copy_state(hs1_out, h1_cur, t, n0, N, H, R, dm.SH, j0, Uq);
    if (!do2 && t > 0)
      copy_state(hs2_out, h2_cur, t - 1, n0, N, H, R, dm.SH, j0, Uq);
    if (!do1 && !do2) continue;
    bf16* h1_nxt = h1b + (cur1 ^ 1) * tile;
    bf16* d_nxt = d_b + (cur1 ^ 1) * tile;
    bf16* h2_nxt = h2b + (cur2 ^ 1) * tile;

    for (int ug = warp; ug < dm.G; ug += warps) {
      const int u = ug * 8 + g;  // this lane's unit of the CTA's
      const bool own = u < Uq;
      const int j = j0 + u;
      // this lane's A fragments: the packed weights are [q][ug][chunk][m
      // tile][lane], layer 1's chunks and then layer 2's
      const uint4* wg = w + (size_t)(q * dm.G + ug) * (chunks1 + chunks2) * 64 + lane;
      if (do1) {  // layer-1 step t
        float acc[2][NT][4];
        init_acc<NT>(acc, b1, H, j, own);
        products<NT, P>(acc, wg, chunks1, dm.KX / 16,
                        x_s + g * dm.SX + 2 * tg, dm.SX,
                        h1_cur + g * dm.SH + 2 * tg, dm.SH, ntiles);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (!own || nt >= ntiles) continue;
          bf16 h1x[2], dx[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = nt * kSeq2TileRows + 2 * tg + e;
            const int n = n0 + r;
            const int s = r * dm.SC + u;
            const float c_prev = c1_s[s];
            float cn, hn;
            lstm_cell(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                      acc[1][nt][2 + e], c_prev, &cn, &hn);
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
          const size_t p = (size_t)(nt * kSeq2TileRows + 2 * tg) * dm.SH + j;
          push2<C>(cluster, h1_nxt + p, dm.SH, h1x);
          push2<C>(cluster, d_nxt + p, dm.SH, dx);
        }
      }
      if (do2) {  // layer-2 step t-1
        float acc[2][NT][4];
        init_acc<NT>(acc, b2, H, j, own);
        products<NT, P>(acc, wg + 64 * chunks1, chunks2, dm.KH / 16,
                        d_cur + g * dm.SH + 2 * tg, dm.SH,
                        h2_cur + g * dm.SH + 2 * tg, dm.SH, ntiles);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (!own || nt >= ntiles) continue;
          bf16 h2x[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = nt * kSeq2TileRows + 2 * tg + e;
            const int n = n0 + r;
            const int s = r * dm.SC + u;
            const float c_prev = c2_s[s];
            float cn, hn;
            lstm_cell(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e],
                      acc[1][nt][2 + e], c_prev, &cn, &hn);
            const bool active = n < N && mask[(size_t)(t - 1) * N + n] > 0.0f;
            c2_s[s] = active ? cn : c_prev;
            const float h = active ? hn : h2_s[s];
            h2_s[s] = h;
            const bf16 hb2 = __float2bfloat16_rn(h);
            h2x[e] = hb2;
            if (n < N) hs2_out[((size_t)(t - 1) * N + n) * H + j] = hb2;
          }
          push2<C>(cluster, h2_nxt + (size_t)(nt * kSeq2TileRows + 2 * tg) * dm.SH + j,
                   dm.SH, h2x);
        }
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
      const int s = r * dm.SC + u;
      c1_out[o] = c1_s[s];
      h1_out[o] = h1_s[s];
      c2_out[o] = c2_s[s];
      h2_out[o] = h2_s[s];
    }
  }
}

// The kernel as launched (host code).
auto seq2_kernel() {
  return &lstm_seq2_kernel<kSeq2Cluster, kSeq2MaxTiles, kSeq2Prefetch>;
}

// What a tile of the seq2 kernel costs a CTA at (In, H): the carries and
// the bf16 tiles in shared memory, at most kSeq2MaxTiles n-tiles of rows;
// one warp per group of 8 units, whatever the rows.
TileCost seq2_cost(int In, int H) {
  const Seq2Dims d = seq2_dims(In, H);
  TileCost c;
  c.granularity = kSeq2TileRows;
  c.rows_max = kSeq2TileRows * kSeq2MaxTiles;
  c.row_bytes = (size_t)4 * d.SC * sizeof(float) +
                (size_t)(6 * d.SH + d.SX) * sizeof(bf16);
  c.min_smem = kSeq2MinSmem;
  return c;
}

int seq2_threads(int In, int H, int /*rows*/) {
  return 32 * seq2_dims(In, H).G;
}

ClusterPlanner<decltype(seq2_kernel())> seq2_planner(
    seq2_kernel(), kSeq2Cluster, seq2_cost, seq2_threads);

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).  w holds both layers' weights packed by
// kernels/lstm2.py:pack_weights.  A shape that needs more dynamic shared
// memory than the card offers fails at cudaFuncSetAttribute, whose error is
// returned as well.
int nvqa_lstm_seq2_forward(const bf16* xs, const float* mask, const bf16* drop,
                           const void* w, const bf16* b1, const bf16* b2,
                           float* c1_out, float* h1_out,
                           float* c2_out, float* h2_out, bf16* hs1_out,
                           bf16* hs2_out, int T, int N, int In, int H,
                           void* stream) {
  ClusterPlan plan;
  cudaError_t err = seq2_planner.plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      seq2_planner.config(plan, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&config, seq2_kernel(), xs, mask, drop,
                           static_cast<const uint4*>(w), b1, b2, c1_out,
                           h1_out, c2_out, h2_out, hs1_out, hs2_out, T, N, In,
                           H, plan.rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel's launch at (N, In, H), launching nothing: info[0..5] = CTAs
// per cluster, rows per cluster, CTAs in the grid, the clusters the card can
// hold at once (cudaOccupancyMaxActiveClusters), threads per CTA, dynamic
// shared memory per CTA in bytes.
int nvqa_lstm_seq2_launch_info(int N, int In, int H, int* info) {
  ClusterPlan plan;
  cudaError_t err = seq2_planner.plan(N, In, H, &plan);
  if (err != cudaSuccess) return (int)err;
  const int out[6] = {kSeq2Cluster, plan.rows, (int)plan.grid.x,
                      plan.max_clusters, (int)plan.block.x, (int)plan.smem};
  for (int i = 0; i < 6; ++i) info[i] = out[i];
  return 0;
}

// The layout of the packed weights kernels/lstm2.py:pack_weights writes at
// (In, H): dims[0..4] = CTAs per cluster, units per CTA (U), groups of 8
// units per CTA (G), In and H padded to 16 (KX, KH).
int nvqa_lstm_seq2_dims(int In, int H, int* dims) {
  const Seq2Dims d = seq2_dims(In, H);
  const int out[5] = {kSeq2Cluster, d.U, d.G, d.KX, d.KH};
  for (int i = 0; i < 5; ++i) dims[i] = out[i];
  return 0;
}

}  // extern "C"
