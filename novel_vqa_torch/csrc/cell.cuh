// Device code shared by the LSTM kernels (lstm.cu, lstm2.cu): the fused-gate
// cell, the weight loads and the error-string export.  Each source
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

}  // namespace

extern "C" const char* nvqa_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
