// The float32 epilogues of B1's float32-activation routes
// (field_eval_general.cu, field_eval_f32.cu): bias-added pre-activations to
// activations, op for op as `fused_field_plain` (ops/field_eval.py) and
// models/spnerf.py compute them. Every operation is an explicitly rounded
// intrinsic, so nvcc contracts none of them into an FMA.

#pragma once

#include <cuda_runtime.h>

// the kernels' epilogues and operand sources (ops/field_eval.py EPI, SRC)
enum { EPI_SIN30, EPI_SIN, EPI_RELU, EPI_NONE, EPI_SOFTPLUS, EPI_ALBEDO,
       EPI_SIGMOID };
enum { SRC_BUF0, SRC_BUF1, SRC_X, SRC_SUN, SRC_T };

#define INV_PI 0.318309886183790671538f  // float32(1 / pi)
#define PI_F 3.14159265358979323846f     // float32(pi)
#define SIN_C1 0.9999966f
#define SIN_C3 -0.16664824f
#define SIN_C5 0.00830629f
#define SIN_C7 -0.00018363f

// fast_sin as models/spnerf.py computes it, op for op: k = rint(x / pi)
// (half to even), r = x - k pi, sign from k's parity, the odd polynomial.
__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(__fmul_rn(x, INV_PI));
  const float r = __fsub_rn(x, __fmul_rn(k, PI_F));
  const float odd = __fsub_rn(k, __fmul_rn(2.0f, floorf(__fmul_rn(k, 0.5f))));
  const float sign = __fsub_rn(1.0f, __fmul_rn(2.0f, fabsf(odd)));
  const float r2 = __fmul_rn(r, r);
  float p = __fadd_rn(SIN_C5, __fmul_rn(r2, SIN_C7));
  p = __fadd_rn(SIN_C3, __fmul_rn(r2, p));
  p = __fadd_rn(SIN_C1, __fmul_rn(r2, p));
  return __fmul_rn(sign, __fmul_rn(r, p));
}

__device__ __forceinline__ float softplus(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <int EPI>
__device__ __forceinline__ float activate(float v) {
  if (EPI == EPI_SIN30) return fast_sin(__fmul_rn(30.0f, v));
  if (EPI == EPI_SIN) return fast_sin(v);
  if (EPI == EPI_RELU) return fmaxf(v, 0.0f);
  if (EPI == EPI_SOFTPLUS) return softplus(v);
  if (EPI == EPI_ALBEDO)
    return __fsub_rn(__fmul_rn(sigmoid(v), 1.002f), 0.001f);
  if (EPI == EPI_SIGMOID) return sigmoid(v);
  return v;
}

// activate<epi>(v) for an epilogue chosen at run time
__device__ __forceinline__ float activate_rt(int epi, float v) {
  switch (epi) {
    case EPI_SIN30: return activate<EPI_SIN30>(v);
    case EPI_SIN: return activate<EPI_SIN>(v);
    case EPI_RELU: return activate<EPI_RELU>(v);
    case EPI_SOFTPLUS: return activate<EPI_SOFTPLUS>(v);
    case EPI_ALBEDO: return activate<EPI_ALBEDO>(v);
    case EPI_SIGMOID: return activate<EPI_SIGMOID>(v);
    default: return v;
  }
}
