// LSTM kernels for Hopper (sm_90a), fp32, built with nvcc into a shared
// library with a plain C interface (see novel_vqa_torch/kernels/build.py).
//
// Both kernels compute the fused-gate LSTM cell of the JAX package (the cell
// and the gate products are in cell.cuh; b = bx + bh):
//
//     gates = x @ Wx + h @ Wh + b;  c', h' = cell(gates, c)
//
// A block owns a tile of R batch rows, staged in shared memory transposed.
// Each thread owns one hidden unit j and accumulates its four gate columns
// (j, H+j, 2H+j, 3H+j) for all R rows in registers (4 * R accumulators),
// reading one weight row slice per k from global memory; the weights stay
// hot in the 50 MB L2 cache.  The cell update then runs in the epilogue, so
// the (N, 4H) gate matrix never reaches device memory.  All arithmetic is
// fp32 FMA (no tensor cores, no TF32).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cell.cuh"

namespace {

constexpr int kSeqRows = 16;      // batch rows per block, seq kernel
constexpr int kSeqThreads = 512;  // max threads (hidden units) per block
constexpr int kStepRows = 8;      // batch rows per block, step kernel
constexpr int kStepUnits = 128;   // hidden units per block, step kernel

// dst[k * R + r] = src[(n0 + r) * K + k], zero for rows n0 + r >= N.
template <int R>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n0, int N, int K) {
  for (int e = threadIdx.x; e < R * K; e += blockDim.x) {
    const int r = e / K;
    const int k = e - r * K;
    const int n = n0 + r;
    dst[k * R + r] = n < N ? src[(size_t)n * K + k] : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Seq kernel.  Replaces novel_vqa_tpu/ops/pallas_lstm.py::_seq_kernel: one
// masked LSTM layer over all T steps for a tile of batch rows, from a zero
// state; outputs the final c, h and the (T, N, H) post-mask hidden sequence.
//
// Bound on the H100: operations.  At the eval shapes (N=500, T=16, In=200 or
// 512, H=512) a layer is 23-34 GFLOP of fp32 FMA against ~40 MB of traffic,
// so it sits far above the fp32 ridge point, and the two products per step
// are the whole cost.
//
// Design: as on the TPU, one block owns a tile of kSeqRows rows and runs
// the whole recurrence; rows are independent, so blocks never synchronise.
// The block's c and h live in shared memory, h double-buffered because
// every unit's new gates read the whole previous h; x_t is staged per step.
// Each step computes x_t @ Wx + h @ Wh itself in fp32 FMA, reading the
// weights from L2 (5.8 MB and 8.4 MB per layer).  At N = 500 that is only
// 32 blocks on 132 SMs, so most of the card idles: spreading Wh over
// several CTAs (clusters), wgmma and TMA are the next designs to try.
// Shared memory: (In + 3H) * kSeqRows * 4 bytes (128 KB at In = H = 512),
// so dynamic shared memory above 48 KB is enabled per launch.
// ---------------------------------------------------------------------------
template <int R>
__global__ void __launch_bounds__(kSeqThreads, 1)
    lstm_seq_kernel(const float* __restrict__ xs,
                    const float* __restrict__ mask,
                    const float* __restrict__ wx,
                    const float* __restrict__ wh,
                    const float* __restrict__ b, float* __restrict__ c_out,
                    float* __restrict__ h_out, float* __restrict__ hs_out,
                    int T, int N, int In, int H) {
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // In * R
  float* h_s = x_s + (size_t)In * R;             // 2 * H * R (double buffer)
  float* c_s = h_s + (size_t)2 * H * R;          // H * R
  const int n0 = blockIdx.x * R;

  for (int e = threadIdx.x; e < H * R; e += blockDim.x) {
    h_s[e] = 0.0f;
    c_s[e] = 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (size_t)(t & 1) * H * R;
    float* h_nxt = h_s + (size_t)((t + 1) & 1) * H * R;
    stage_rows<R>(x_s, xs + (size_t)t * N * In, n0, N, In);
    __syncthreads();  // x_t staged; previous step's h_nxt complete

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[4][R];
      init_bias<R>(acc, b, H, j);
      gate_products<R>(acc, x_s, In, wx, H, j);
      gate_products<R>(acc, h_cur, H, wh, H, j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = n0 + r;
        const float c_prev = c_s[j * R + r];
        const float h_prev = h_cur[j * R + r];
        float cn, hn;
        lstm_cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r], c_prev, &cn,
                  &hn);
        const bool active = n < N && mask[(size_t)t * N + n] > 0.0f;
        const float cv = active ? cn : c_prev;
        const float hv = active ? hn : h_prev;
        c_s[j * R + r] = cv;
        h_nxt[j * R + r] = hv;
        if (n < N) hs_out[((size_t)t * N + n) * H + j] = hv;
      }
    }
    __syncthreads();  // all reads of x_s and h_cur done before the next step
  }
  __syncthreads();  // T == 0: the zero fill above is complete

  const float* h_fin = h_s + (size_t)(T & 1) * H * R;
  for (int e = threadIdx.x; e < H * R; e += blockDim.x) {
    const int r = e / H;
    const int j = e - r * H;
    const int n = n0 + r;
    if (n < N) {
      c_out[(size_t)n * H + j] = c_s[j * R + r];
      h_out[(size_t)n * H + j] = h_fin[j * R + r];
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

size_t seq_smem_bytes(int In, int H) {
  return (size_t)(In + 3 * H) * kSeqRows * sizeof(float);
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
  const size_t smem = seq_smem_bytes(In, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq_kernel<kSeqRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = H >= kSeqThreads ? kSeqThreads : ((H + 31) / 32) * 32;
  const dim3 grid((N + kSeqRows - 1) / kSeqRows);
  lstm_seq_kernel<kSeqRows><<<grid, threads, smem, (cudaStream_t)stream>>>(
      xs, mask, wx, wh, b, c_out, h_out, hs_out, T, N, In, H);
  return (int)cudaGetLastError();
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
