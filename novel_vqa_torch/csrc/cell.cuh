// Device code shared by the LSTM kernels (lstm.cu, lstm2.cu): the fused-gate
// cell, the per-unit gate products and the error-string export.  Each source
// includes this header once and builds into a library of its own, so the
// extern "C" definition below appears once per library.
//
// The cell (gate order i, f, o, g; weights stored (in, 4H)):
//
//     i, f, o = sigmoid(gates[0:H], [H:2H], [2H:3H]);  g = tanh(gates[3H:4H])
//     c' = f * c + i * g;  h' = o * tanh(c')
//
// computed with expf/tanhf rather than the fast intrinsics, to stay within
// 1e-5 of the plain PyTorch versions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void lstm_cell(float gi, float gf, float go,
                                          float gg, float c, float* c_new,
                                          float* h_new) {
  const float i = sigmoidf_(gi);
  const float f = sigmoidf_(gf);
  const float o = sigmoidf_(go);
  const float g = tanhf(gg);
  const float cn = f * c + i * g;
  *c_new = cn;
  *h_new = o * tanhf(cn);
}

// A weight or bias through the read-only cache, widened to f32 (exact for
// bf16: its bits are the high half of the f32's).
__device__ __forceinline__ float load_weight(const float* p) {
  return __ldg(p);
}

__device__ __forceinline__ float load_weight(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

// acc[q][r] = f32(b[q * H + j]) for q = 0..3 and all R rows.
template <int R, typename W>
__device__ __forceinline__ void init_bias(float (&acc)[4][R],
                                          const W* __restrict__ b, int H,
                                          int j) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float bq = load_weight(b + q * H + j);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = bq;
  }
}

// acc[q][r] += sum_k a_s[k * S + r] * f32(w[k * 4H + q * H + j]), q = 0..3,
// for R rows, in order of k, one fmaf each.  The rows' inputs are staged in
// shared memory transposed with row stride S (a thread may take R of a
// tile's S rows), so one float4 load broadcasts four rows of column k to
// the whole warp; each thread reads its unit's four gate columns of weight
// row k, and neighbouring threads read neighbouring columns, so the reads
// coalesce.  The k loop is unrolled KU times: a thread has up to 4 * KU
// weight loads in flight.
template <int R, int KU, typename W>
__device__ __forceinline__ void gate_products_strided(
    float (&acc)[4][R], const float* a_s, int S, int K,
    const W* __restrict__ w, int H, int j) {
  static_assert(R % 4 == 0, "rows are read as float4");
  const size_t ld = 4 * (size_t)H;
  const W* wj = w + j;
#pragma unroll (KU)
  for (int k = 0; k < K; ++k) {
    const W* wk = wj + (size_t)k * ld;
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

}  // namespace

extern "C" const char* nvqa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
