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
// hs1, hs2 (T, N, H) in bf16.  The Pallas kernel runs layer-2 step t-1 beside
// layer-1 step t (a wavefront for the TPU's matrix unit); here layer-2 step
// t runs right after layer-1 step t in the same block, which gives the same
// numbers.
//
// Bound on the H100: operations.  At N=500, T=16, In=200, H=512 the products
// are 2 * (In + 3H) * 4H = 7.1 MFLOP per active (row, step), 57 GFLOP in all
// against about 39 MB of traffic; on the bf16 tensor cores (989 TFLOP/s)
// that is 0.058 ms, and the bytes 0.012 ms.
//
// Design: the seq kernel's (csrc/lstm.cu) for a first, simple kernel.  One
// block owns a tile of kRows batch rows for all T steps and both layers;
// rows are independent, so blocks never synchronise.  Each thread owns one
// hidden unit j (a loop covers H > threads) and accumulates its four gate
// columns for all rows in 4 * kRows registers, one set reused for layer 1
// and then layer 2.  Weights are read as bf16 from global memory each step
// (7.1 MB for all four, kept in the 50 MB L2), neighbouring threads on
// neighbouring columns.  The products are fp32 FMA, not tensor cores: a
// bf16 x bf16 product is exact in fp32, so the kernel and its plain version
// differ only in the order of the sums, and the design sits far above its
// tensor-core bound (wgmma over a cluster is the way down, not taken yet).
// Activations are staged in shared memory as f32 holding bf16-exact values
// (x_t, bf16(h1), d, bf16(h2)), so the inner loop converts only the weights;
// the f32 carries c1, h1, c2, h2 live there too, read and written only by
// the thread that owns the unit.  Shared memory: (In + 9H) * kRows * 4 bytes,
// 154 KB at In=200, H=512, kRows=8; 8 rows (not the seq kernel's 16) keep it
// under the 227 KB a block may use and give 63 blocks at N=500.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cell.cuh"

namespace {

constexpr int kRows = 8;       // batch rows per block
constexpr int kThreads = 512;  // max threads (hidden units) per block

// Round to bf16 (nearest, ties to even, as JAX's astype) and back to f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_seq2_kernel(const __nv_bfloat16* __restrict__ xs,
                     const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ drop,
                     const __nv_bfloat16* __restrict__ wx1,
                     const __nv_bfloat16* __restrict__ wh1,
                     const __nv_bfloat16* __restrict__ b1,
                     const __nv_bfloat16* __restrict__ wx2,
                     const __nv_bfloat16* __restrict__ wh2,
                     const __nv_bfloat16* __restrict__ b2,
                     float* __restrict__ c1_out, float* __restrict__ h1_out,
                     float* __restrict__ c2_out, float* __restrict__ h2_out,
                     __nv_bfloat16* __restrict__ hs1_out,
                     __nv_bfloat16* __restrict__ hs2_out, int T, int N,
                     int In, int H) {
  extern __shared__ float4 smem4[];
  const size_t HR = (size_t)H * R;
  float* x_s = reinterpret_cast<float*>(smem4);  // In * R, x_t
  float* h1b = x_s + (size_t)In * R;             // 2 * HR, bf16(h1), double
  float* h2b = h1b + 2 * HR;                     // 2 * HR, bf16(h2), double
  float* d_s = h2b + 2 * HR;                     // HR, layer-2 input
  float* c1_s = d_s + HR;                        // HR each: f32 carries
  float* h1_s = c1_s + HR;
  float* c2_s = h1_s + HR;
  float* h2_s = c2_s + HR;
  const int n0 = blockIdx.x * R;

  for (size_t e = threadIdx.x; e < HR; e += blockDim.x) {
    h1b[e] = 0.0f;
    h2b[e] = 0.0f;
    c1_s[e] = 0.0f;
    h1_s[e] = 0.0f;
    c2_s[e] = 0.0f;
    h2_s[e] = 0.0f;
  }

  for (int t = 0; t < T; ++t) {
    const float* h1_cur = h1b + (size_t)(t & 1) * HR;
    float* h1_nxt = h1b + (size_t)((t + 1) & 1) * HR;
    const float* h2_cur = h2b + (size_t)(t & 1) * HR;
    float* h2_nxt = h2b + (size_t)((t + 1) & 1) * HR;
    // Stage x_t transposed, x_s[k * R + r].  Safe without a barrier before
    // it: x_s was last read by layer 1 of step t-1, which ended at the
    // barrier between the two layers.
    const __nv_bfloat16* xt = xs + (size_t)t * N * In;
    for (int e = threadIdx.x; e < R * In; e += blockDim.x) {
      const int r = e / In;
      const int k = e - r * In;
      const int n = n0 + r;
      x_s[k * R + r] = n < N ? __bfloat162float(xt[(size_t)n * In + k]) : 0.0f;
    }
    __syncthreads();  // x_t staged; step t-1 (both layers) complete

    // layer 1
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[4][R];
      init_bias<R>(acc, b1, H, j);
      gate_products<R>(acc, x_s, In, wx1, H, j);
      gate_products<R>(acc, h1_cur, H, wh1, H, j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = n0 + r;
        const size_t s = (size_t)j * R + r;
        float cn, hn;
        lstm_cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r], c1_s[s], &cn,
                  &hn);
        const bool active = n < N && mask[(size_t)t * N + n] > 0.0f;
        if (active) {
          c1_s[s] = cn;
          h1_s[s] = hn;
        }
        const float hb = round_bf16(h1_s[s]);
        h1_nxt[s] = hb;
        if (n < N) {
          const size_t o = ((size_t)t * N + n) * H + j;
          hs1_out[o] = __float2bfloat16_rn(hb);
          d_s[s] = round_bf16(hb * __bfloat162float(drop[o]));
        } else {
          d_s[s] = 0.0f;
        }
      }
    }
    __syncthreads();  // bf16(h1) and d of step t complete

    // layer 2
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[4][R];
      init_bias<R>(acc, b2, H, j);
      gate_products<R>(acc, d_s, H, wx2, H, j);
      gate_products<R>(acc, h2_cur, H, wh2, H, j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = n0 + r;
        const size_t s = (size_t)j * R + r;
        float cn, hn;
        lstm_cell(acc[0][r], acc[1][r], acc[2][r], acc[3][r], c2_s[s], &cn,
                  &hn);
        const bool active = n < N && mask[(size_t)t * N + n] > 0.0f;
        if (active) {
          c2_s[s] = cn;
          h2_s[s] = hn;
        }
        const float hb = round_bf16(h2_s[s]);
        h2_nxt[s] = hb;
        if (n < N) hs2_out[((size_t)t * N + n) * H + j] = __float2bfloat16_rn(hb);
      }
    }
    // No barrier here: the next step's staging writes only x_s, which layer
    // 2 does not read, and its barrier orders everything else.
  }
  __syncthreads();  // T == 0: the zero fill above is complete

  // The carries are read back by the threads that own them (unit j); the
  // barrier above makes it safe for any thread regardless.
  for (size_t e = threadIdx.x; e < HR; e += blockDim.x) {
    const int r = (int)(e / H);
    const int j = (int)(e - (size_t)r * H);
    const int n = n0 + r;
    if (n < N) {
      const size_t s = (size_t)j * R + r;
      const size_t o = (size_t)n * H + j;
      c1_out[o] = c1_s[s];
      h1_out[o] = h1_s[s];
      c2_out[o] = c2_s[s];
      h2_out[o] = h2_s[s];
    }
  }
}

size_t seq2_smem_bytes(int In, int H) {
  return (size_t)(In + 9 * H) * kRows * sizeof(float);
}

}  // namespace

extern "C" {

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// after the launch (0 on success).  A shape that needs more dynamic shared
// memory than the card offers fails at cudaFuncSetAttribute, whose error is
// returned as well.
int nvqa_lstm_seq2_forward(const __nv_bfloat16* xs, const float* mask,
                           const __nv_bfloat16* drop,
                           const __nv_bfloat16* wx1, const __nv_bfloat16* wh1,
                           const __nv_bfloat16* b1, const __nv_bfloat16* wx2,
                           const __nv_bfloat16* wh2, const __nv_bfloat16* b2,
                           float* c1_out, float* h1_out, float* c2_out,
                           float* h2_out, __nv_bfloat16* hs1_out,
                           __nv_bfloat16* hs2_out, int T, int N, int In, int H,
                           void* stream) {
  const size_t smem = seq2_smem_bytes(In, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_seq2_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = H >= kThreads ? kThreads : ((H + 31) / 32) * 32;
  const dim3 grid((N + kRows - 1) / kRows);
  lstm_seq2_kernel<kRows><<<grid, threads, smem, (cudaStream_t)stream>>>(
      xs, mask, drop, wx1, wh1, b1, wx2, wh2, b2, c1_out, h1_out, c2_out,
      h2_out, hs1_out, hs2_out, T, N, In, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
