// Fused forward of the SP-NeRF field on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_make_kernel` / `_fused_apply` in
// spnerf_tpu/ops/pallas/field_eval.py. Computes, for every point, the Siren
// trunk sin(30 W0 x), seven sine layers with the input concatenated back in
// at the skip layer, then sigma = softplus, albedo = sigmoid * 1.002 - 0.001,
// sun visibility (feats || sun -> 3 sine layers -> sigmoid), sky (sun -> relu
// -> sigmoid), optional beta = softplus and semantic logits; any subset of
// the heads, chosen by a bitmask.
//
// Bound: compute. Each point costs 2 FLOP per weight it uses (5.38 MFLOP
// for all heads of the flagship 8x512 field, 4.85 MFLOP for the solar pass),
// against ~0.1 KB of input and output, far above the card's 295 FLOP/byte
// ridge. The bf16 weights (5.4 MB) stay in the 50 MB L2.
//
// Design (first, simple version): one block of 8 warps per tile of 64
// points. The tile's activations live in shared memory as bf16 in two
// ping-pong buffers of 64 x (width + 8) plus the input, sun and transient
// tiles; every layer is a 64 x K by K x N product on the tensor cores
// (wmma 16x16x16, bf16 operands, float32 accumulation), each warp owning
// 16-column slices of N for all 64 rows, its weight fragments read straight
// from global memory (L2). The accumulators go through a per-warp float32
// staging tile for the epilogue (bias, activation), which writes bf16 to the
// next layer's buffer or float32 to the head outputs. The TPU kernel keeps
// every weight resident in VMEM; a block here has 227 KB of shared memory,
// so the weights stream from L2 instead. wgmma, TMA and a weight ring in
// shared memory are left for later.
//
// Numerics match the TPU kernel: dot operands are bf16 (activations are
// rounded once, exactly where the TPU kernel casts them for the dot),
// accumulation, bias and epilogues are float32, fast_sin uses the same
// polynomial with round-half-to-even range reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define BM 64                 // points per block
#define NWARPS 8
#define NTHREADS (NWARPS * 32)
#define RT (BM / 16)          // 16-row tiles per block
#define PAD 8                 // shared-memory row padding (bf16 elements)
#define SEG 16                // padded width of the sun and transient tiles
#define MAX_LAYERS 32

enum { HEAD_RGB = 1, HEAD_SUN = 2, HEAD_SKY = 4, HEAD_BETA = 8, HEAD_SEM = 16 };
enum { EPI_SIN30, EPI_SIN, EPI_RELU, EPI_NONE, EPI_SOFTPLUS, EPI_ALBEDO,
       EPI_SIGMOID };

struct LayerDesc {
  int w_off, b_off, k1, k2, npad, nreal;
};

struct FieldDesc {
  int n_trunk, skip, width, k0pad, has_beta, has_sem, heads;
  LayerDesc layer[MAX_LAYERS];
};

__device__ __forceinline__ float fast_sin(float x) {
  const float inv_pi = 0.318309886183790671538f;
  const float pi = 3.14159265358979323846f;
  float k = rintf(x * inv_pi);  // round half to even, as jnp.round
  float r = __fsub_rn(x, __fmul_rn(k, pi));
  float sign = 1.0f - 2.0f * fabsf(k - 2.0f * floorf(k * 0.5f));
  float r2 = r * r;
  float p = r * (0.9999966f + r2 * (-0.16664824f + r2 * (0.00830629f
                 + r2 * -0.00018363f)));
  return sign * p;
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float epilogue(int epi, float v) {
  switch (epi) {
    case EPI_SIN30: return fast_sin(30.0f * v);
    case EPI_SIN: return fast_sin(v);
    case EPI_RELU: return fmaxf(v, 0.0f);
    case EPI_SOFTPLUS: return softplus(v);
    case EPI_ALBEDO: return sigmoid(v) * 1.002f - 0.001f;
    case EPI_SIGMOID: return sigmoid(v);
    default: return v;
  }
}

// rows [row0, row0 + BM) of a (n, cols) bf16 array into shared memory with
// leading dimension ldd; rows past n are zero. cols is a multiple of 8.
__device__ void load_tile(bf16* dst, int ldd, const bf16* __restrict__ src,
                          int cols, int row0, int n) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < BM * vec; i += NTHREADS) {
    const int r = i / vec, c = (i % vec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * cols + c);
    *reinterpret_cast<uint4*>(dst + r * ldd + c) = v;
  }
}

__device__ __forceinline__ void mma_segment(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[RT],
    const bf16* a, int lda, int k_len, const bf16* __restrict__ w, int ldw) {
#pragma unroll 2
  for (int k = 0; k < k_len; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
    wmma::load_matrix_sync(fb, w + (size_t)k * ldw, ldw);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, a + r * 16 * lda + k, lda);
      wmma::mma_sync(acc[r], fa, fb, acc[r]);
    }
  }
}

// One dense layer on the block's tile: [a1 | a2] (BM x (k1 + k2)) times the
// layer's (k1 + k2) x npad weight, plus bias, then the epilogue. The result
// goes to dst (bf16, shared memory) or, when dst is null, to the float32
// head output gout (n_points x nreal, rows past n_points dropped).
__device__ void dense(const LayerDesc& L, const bf16* __restrict__ W,
                      const float* __restrict__ B, const bf16* a1, int lda1,
                      const bf16* a2, int lda2, int epi, bf16* dst, int ldd,
                      float* __restrict__ gout, int row0, int n_points,
                      float* stage) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* w = W + L.w_off;
  const float* bias = B + L.b_off;
  const int ldw = L.npad;
  float* st = stage + warp * 256;
  for (int ct = warp; ct < L.npad / 16; ct += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.0f);
    mma_segment(acc, a1, lda1, L.k1, w + ct * 16, ldw);
    if (L.k2)
      mma_segment(acc, a2, lda2, L.k2, w + (size_t)L.k1 * ldw + ct * 16, ldw);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(st, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = j * 32 + lane;
        const int row = r * 16 + (e >> 4), n = ct * 16 + (e & 15);
        const float v = epilogue(epi, st[e] + bias[n]);
        if (dst) {
          dst[row * ldd + n] = __float2bfloat16(v);  // round to nearest even
        } else if (row0 + row < n_points && n < L.nreal) {
          gout[(size_t)(row0 + row) * L.nreal + n] = v;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NTHREADS)
field_eval_kernel(const __grid_constant__ FieldDesc d,
                  const bf16* __restrict__ xin,
                  const bf16* __restrict__ sun, const bf16* __restrict__ tin,
                  const bf16* __restrict__ W, const float* __restrict__ B,
                  int n_points, float* o_sigma, float* o_rgb, float* o_sun,
                  float* o_sky, float* o_beta, float* o_sem) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = d.width + PAD, ldx = d.k0pad + PAD, lds = SEG + PAD;
  const int half = d.width / 2;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = buf0 + BM * ldh;
  bf16* sx = buf1 + BM * ldh;
  bf16* ss = sx + BM * ldx;
  bf16* stt = ss + BM * lds;
  float* stage = reinterpret_cast<float*>(stt + BM * lds);
  const int row0 = blockIdx.x * BM;
  const int heads = d.heads;
  const bool beta = d.has_beta && (heads & HEAD_BETA);

  load_tile(sx, ldx, xin, d.k0pad, row0, n_points);
  load_tile(ss, lds, sun, SEG, row0, n_points);
  if (beta) load_tile(stt, lds, tin, SEG, row0, n_points);
  __syncthreads();

  const LayerDesc* L = d.layer;
  // trunk
  dense(L[0], W, B, sx, ldx, nullptr, 0, EPI_SIN30, buf0, ldh, nullptr, row0,
        n_points, stage);
  bf16* cur = buf0;
  bf16* nxt = buf1;
  for (int i = 1; i < d.n_trunk; ++i) {
    const bool skip = (i == d.skip);
    dense(L[i], W, B, cur, ldh, skip ? sx : nullptr, ldx, EPI_SIN, nxt, ldh,
          nullptr, row0, n_points, stage);
    bf16* t = cur; cur = nxt; nxt = t;
  }
  bf16* X = cur;  // shared trunk output
  bf16* Y = nxt;
  const int t0 = d.n_trunk;  // layer order: sigma, feats, rgb x2, sun x4,
                             // sky x2, [beta x2], [sem x2]
  const int i_beta = t0 + 10, i_sem = t0 + 10 + (d.has_beta ? 2 : 0);

  dense(L[t0], W, B, X, ldh, nullptr, 0, EPI_SOFTPLUS, nullptr, 0, o_sigma,
        row0, n_points, stage);
  if (d.has_sem && (heads & HEAD_SEM)) {
    dense(L[i_sem], W, B, X, ldh, nullptr, 0, EPI_SIN, Y, ldh, nullptr, row0,
          n_points, stage);
    dense(L[i_sem + 1], W, B, Y, ldh, nullptr, 0, EPI_NONE, nullptr, 0, o_sem,
          row0, n_points, stage);
  }
  if (heads & (HEAD_RGB | HEAD_SUN | HEAD_BETA)) {
    // feats into Y; the trunk output in X is no longer needed after this
    dense(L[t0 + 1], W, B, X, ldh, nullptr, 0, EPI_NONE, Y, ldh, nullptr,
          row0, n_points, stage);
    if (heads & HEAD_RGB) {
      dense(L[t0 + 2], W, B, Y, ldh, nullptr, 0, EPI_SIN, X, ldh, nullptr,
            row0, n_points, stage);
      dense(L[t0 + 3], W, B, X, ldh, nullptr, 0, EPI_ALBEDO, nullptr, 0, o_rgb,
            row0, n_points, stage);
    }
    if (heads & HEAD_SUN) {
      dense(L[t0 + 4], W, B, Y, ldh, ss, lds, EPI_SIN, X, ldh, nullptr, row0,
            n_points, stage);
      dense(L[t0 + 5], W, B, X, ldh, nullptr, 0, EPI_SIN, X + half, ldh,
            nullptr, row0, n_points, stage);
      dense(L[t0 + 6], W, B, X + half, ldh, nullptr, 0, EPI_SIN, X, ldh,
            nullptr, row0, n_points, stage);
      dense(L[t0 + 7], W, B, X, ldh, nullptr, 0, EPI_SIGMOID, nullptr, 0,
            o_sun, row0, n_points, stage);
    }
    if (beta) {
      dense(L[i_beta], W, B, Y, ldh, stt, lds, EPI_SIN, X, ldh, nullptr, row0,
            n_points, stage);
      dense(L[i_beta + 1], W, B, X, ldh, nullptr, 0, EPI_SOFTPLUS, nullptr, 0,
            o_beta, row0, n_points, stage);
    }
  }
  if (heads & HEAD_SKY) {
    dense(L[t0 + 8], W, B, ss, lds, nullptr, 0, EPI_RELU, X, ldh, nullptr,
          row0, n_points, stage);
    dense(L[t0 + 9], W, B, X, ldh, nullptr, 0, EPI_SIGMOID, nullptr, 0, o_sky,
          row0, n_points, stage);
  }
}

extern "C" {

// desc_rows: host array of n_layers x 6 ints (w_off, b_off, k1, k2, npad,
// nreal) in layer order. Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not synchronise.
int spnerf_field_eval(const void* xin, const void* sun, const void* tin,
                      const void* w, const void* b, const void* desc_rows,
                      int n_layers, int n_trunk, int skip, int width,
                      int k0pad, int has_beta, int has_sem, int heads,
                      int n_points, void* o_sigma, void* o_rgb, void* o_sun,
                      void* o_sky, void* o_beta, void* o_sem, void* stream) {
  if (n_layers > MAX_LAYERS || width % 32 || k0pad % 16 || n_points <= 0)
    return (int)cudaErrorInvalidValue;
  FieldDesc d;
  d.n_trunk = n_trunk;
  d.skip = skip;
  d.width = width;
  d.k0pad = k0pad;
  d.has_beta = has_beta;
  d.has_sem = has_sem;
  d.heads = heads;
  const int* rows = static_cast<const int*>(desc_rows);
  for (int i = 0; i < n_layers; ++i) {
    d.layer[i] = LayerDesc{rows[6 * i], rows[6 * i + 1], rows[6 * i + 2],
                           rows[6 * i + 3], rows[6 * i + 4], rows[6 * i + 5]};
  }
  const size_t smem =
      (size_t)(2 * BM * (width + PAD) + BM * (k0pad + PAD) +
               2 * BM * (SEG + PAD)) * sizeof(bf16) +
      NWARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      field_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_points + BM - 1) / BM;
  field_eval_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      d, (const bf16*)xin, (const bf16*)sun, (const bf16*)tin,
      (const bf16*)w, (const float*)b, n_points, (float*)o_sigma,
      (float*)o_rgb, (float*)o_sun, (float*)o_sky, (float*)o_beta,
      (float*)o_sem);
  return (int)cudaGetLastError();
}

const char* spnerf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
