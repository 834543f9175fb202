// The epilogue of a Siren layer in the train step, forward and backward, on
// Hopper (sm_90a). A Siren layer of the port's field module
// (`spnerf_torch/models/spnerf.py`, `SineLayer`) is
//
//   y = x @ kernel                      float32 product (outside this file)
//   z = round_cd(w0 * round_cd(y + bias))   (w0 = 30 on trunk0, else 1)
//   s = round_cd(fast_sin(z))
//
// and its backward, from the gradient gs of s (compute dtype), is
//
//   gy = round_cd(w0 * round_cd(gs * fast_sin'(z)))   as float32,
//
// which is what the bias add receives; the bias gradient (gy summed over
// rows) and the products' gradients stay PyTorch's. round_cd rounds to the
// compute dtype: bf16 (round to nearest even) or, in float32, nothing. Both
// kernels are templates on it.
//
// It replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it. In eager PyTorch the same chain is ~20 float32 elementwise
// launches each way, each reading and writing every activation of the step.
//
// Bound: bytes. Per element the forward reads y (4 B) and writes s and z (2 B
// each in bf16), the backward reads gs and z (2 B each) and writes gy (4 B):
// 8 B each way in bf16, 12 B in float32, against ~30 float32 operations, far
// below the card's ridge. The design keeps the element's whole chain in
// registers: one read of each input and one write of each output, 16-byte
// loads of four float32 (and 8-byte loads of four bf16) where the width is a
// multiple of 4, a grid-stride loop over a grid that fills every SM, the
// bias column carried from step to step instead of a division per element.
//
// Exactness: the kernels give the bits of the plain composition (the same
// module's `fast_sin`, `_fast_sin_grad`, the bias add and the casts, one
// PyTorch kernel each). Every operation is an explicitly rounded intrinsic,
// so nvcc contracts nothing into an FMA, in the plain composition's order.
// The constants are the float32 values PyTorch uses: Python's doubles (and
// 3 C3, 5 C5, 7 C7 taken in double) rounded once to float, written here as
// double literals cast to float (a float literal rounds the decimal directly
// and may differ). `tests/test_torch_siren_act.py` holds these literals
// equal to the Python constants.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float INV_PI = static_cast<float>(1.0 / 3.141592653589793);
constexpr float PI = static_cast<float>(3.141592653589793);
constexpr float C1 = static_cast<float>(0.9999966);
constexpr float C3 = static_cast<float>(-0.16664824);
constexpr float C5 = static_cast<float>(0.00830629);
constexpr float C7 = static_cast<float>(-0.00018363);
constexpr float D3 = static_cast<float>(3.0 * -0.16664824);
constexpr float D5 = static_cast<float>(5.0 * 0.00830629);
constexpr float D7 = static_cast<float>(7.0 * -0.00018363);

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;  // 2,048 threads an SM
constexpr int VEC = 4;  // elements a thread a step on the vector path

// The compute dtype: to float, the rounding, from float.
template <typename T> struct Cd;
template <> struct Cd<float> {
  static __device__ __forceinline__ float up(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float down(float v) { return v; }
};
template <> struct Cd<__nv_bfloat16> {
  static __device__ __forceinline__ float up(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 down(float v) {
    return __float2bfloat16_rn(v);
  }
};

// V consecutive elements, loaded and stored as one access.
template <typename T, int V> struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// fast_sin's range split: x = k pi + r, and the sign (-1)^k.
__device__ __forceinline__ float2 split(float x) {
  const float k = rintf(__fmul_rn(x, INV_PI));  // torch.round: half to even
  const float r = __fsub_rn(x, __fmul_rn(k, PI));
  const float odd =
      __fsub_rn(k, __fmul_rn(2.0f, floorf(__fmul_rn(k, 0.5f))));
  return make_float2(r, __fsub_rn(1.0f, __fmul_rn(2.0f, fabsf(odd))));
}

__device__ __forceinline__ float fast_sin(float x) {
  const float2 rs = split(x);
  const float r2 = __fmul_rn(rs.x, rs.x);
  float p = __fadd_rn(C5, __fmul_rn(r2, C7));
  p = __fadd_rn(C3, __fmul_rn(r2, p));
  p = __fadd_rn(C1, __fmul_rn(r2, p));
  return __fmul_rn(rs.y, __fmul_rn(rs.x, p));
}

__device__ __forceinline__ float fast_sin_grad(float x) {
  const float2 rs = split(x);
  const float r2 = __fmul_rn(rs.x, rs.x);
  float p = __fadd_rn(D5, __fmul_rn(r2, D7));
  p = __fadd_rn(D3, __fmul_rn(r2, p));
  p = __fadd_rn(C1, __fmul_rn(r2, p));
  return __fmul_rn(rs.y, p);
}

// y (n_vec * V elements, rows of `width`), bias (width), s and z as y.
// V > 1 needs width % V == 0, so a pack never crosses a row.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    siren_act_forward_kernel(const float* __restrict__ y,
                             const float* __restrict__ bias, float w0,
                             T* __restrict__ s, T* __restrict__ z,
                             int64_t n_vec, int width) {
  using F = Cd<T>;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n_vec) return;
  int col = int((i * V) % width);
  const int step = int((stride * V) % width);
  for (; i < n_vec; i += stride) {
    const Pack<float, V> yv = reinterpret_cast<const Pack<float, V>*>(y)[i];
    const Pack<float, V> bv =
        *reinterpret_cast<const Pack<float, V>*>(bias + col);
    Pack<T, V> sv, zv;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = F::round(__fadd_rn(yv.v[j], bv.v[j]));
      if (w0 != 1.0f) v = F::round(__fmul_rn(w0, v));
      zv.v[j] = F::down(v);
      sv.v[j] = F::down(fast_sin(v));
    }
    reinterpret_cast<Pack<T, V>*>(s)[i] = sv;
    reinterpret_cast<Pack<T, V>*>(z)[i] = zv;
    col += step;
    if (col >= width) col -= width;
  }
}

// gs, z (n_vec * V elements, compute dtype) -> gy (float32).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    siren_act_backward_kernel(const T* __restrict__ gs,
                              const T* __restrict__ z, float w0,
                              float* __restrict__ gy, int64_t n_vec) {
  using F = Cd<T>;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  for (int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x; i < n_vec;
       i += stride) {
    const Pack<T, V> gv = reinterpret_cast<const Pack<T, V>*>(gs)[i];
    const Pack<T, V> zv = reinterpret_cast<const Pack<T, V>*>(z)[i];
    Pack<float, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = fast_sin_grad(F::up(zv.v[j]));
      float g = F::round(__fmul_rn(F::up(gv.v[j]), d));
      if (w0 != 1.0f) g = F::round(__fmul_rn(g, w0));
      out.v[j] = g;
    }
    reinterpret_cast<Pack<float, V>*>(gy)[i] = out;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int grid_for(int64_t n_vec) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks = (n_vec + THREADS - 1) / THREADS;
  const int64_t cap = int64_t(sms) * BLOCKS_PER_SM;
  return int(blocks < cap ? blocks : cap);
}

template <typename T>
int forward(const float* y, const float* bias, float w0, T* s, T* z,
             int64_t n, int width, cudaStream_t stream) {
  const int64_t total = n * width;
  if (total == 0) return 0;
  if (width % VEC == 0 && aligned(y, VEC * 4) && aligned(bias, VEC * 4) &&
      aligned(s, VEC * sizeof(T)) && aligned(z, VEC * sizeof(T))) {
    siren_act_forward_kernel<T, VEC>
        <<<grid_for(total / VEC), THREADS, 0, stream>>>(y, bias, w0, s, z,
                                                         total / VEC, width);
  } else {
    siren_act_forward_kernel<T, 1><<<grid_for(total), THREADS, 0, stream>>>(
        y, bias, w0, s, z, total, width);
  }
  return int(cudaGetLastError());
}

template <typename T>
int backward(const T* gs, const T* z, float w0, float* gy, int64_t total,
             cudaStream_t stream) {
  if (total == 0) return 0;
  if (total % VEC == 0 && aligned(gs, VEC * sizeof(T)) &&
      aligned(z, VEC * sizeof(T)) && aligned(gy, VEC * 4)) {
    siren_act_backward_kernel<T, VEC>
        <<<grid_for(total / VEC), THREADS, 0, stream>>>(gs, z, w0, gy,
                                                         total / VEC);
  } else {
    siren_act_backward_kernel<T, 1><<<grid_for(total), THREADS, 0, stream>>>(
        gs, z, w0, gy, total);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// y (n, width) float32 contiguous, bias (width) float32; s and z (n, width)
// of the compute dtype (bf16 != 0: bfloat16, else float32).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
int spnerf_siren_act_forward(const void* y, const void* bias, float w0,
                             void* s, void* z, long long n, int width,
                             int bf16, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto yf = static_cast<const float*>(y);
  auto bf = static_cast<const float*>(bias);
  if (bf16)
    return forward(yf, bf, w0, static_cast<__nv_bfloat16*>(s),
                   static_cast<__nv_bfloat16*>(z), n, width, st);
  return forward(yf, bf, w0, static_cast<float*>(s), static_cast<float*>(z),
                 n, width, st);
}

// gs and z (total elements, contiguous) of the compute dtype; gy float32.
int spnerf_siren_act_backward(const void* gs, const void* z, float w0,
                              void* gy, long long total, int bf16,
                              void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto g = static_cast<float*>(gy);
  if (bf16)
    return backward(static_cast<const __nv_bfloat16*>(gs),
                    static_cast<const __nv_bfloat16*>(z), w0, g, total, st);
  return backward(static_cast<const float*>(gs), static_cast<const float*>(z),
                  w0, g, total, st);
}

const char* spnerf_siren_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
