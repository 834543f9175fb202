// Fused forward of the SP-NeRF field on Hopper (sm_90a): the general route.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `_fused_apply` in
// spnerf_tpu/ops/pallas/field_eval.py for what the wgmma kernel
// (field_eval.cu) does not take: float32 operands (the TPU kernel's
// compute_dtype "float32": float32 dots), and bf16 fields outside the wgmma
// kernel's envelope (fc_units above 704, or 640 with a beta head; fc_units
// not a multiple of 32; a transient code wider than 16). It computes what
// the wgmma kernel computes: for every point the Siren trunk sin(30 W0 x),
// the sine layers with the input concatenated back in at the skip, then
// any subset of the heads (sigma, albedo, sun visibility, sky, beta,
// semantic logits), walking the same layer program (`program` in
// ops/field_eval.py).
//
// Numerics. Activations stay float32 between layers, as the TPU kernel keeps
// them. The operand policy is a template parameter:
// - float32: float32 products summed in float32 by FFMA (TF32 would not be
//   exact for float32 operands);
// - bf16: each operand rounded to bf16 (the weights when packed, the inputs
//   when loaded, an activation when its layer writes it: every use of an
//   activation is a product operand), products exact in float32, summed in
//   float32 by FFMA, as `fused_field_plain` computes.
// Bias, pre-activations and epilogues are float32 and repeat the plain
// version op for op (`fast_sin` with round-half-to-even range reduction and
// separately rounded products, softplus, sigmoid, the albedo's affine map):
// every epilogue operation is an explicitly rounded intrinsic, so nvcc
// contracts none of them into an FMA.
//
// Bound. Each point costs 2 FLOP a weight it uses (5.38 MFLOP for all heads
// of the flagship 8x512 field) against ~0.3 KB of float32 input and output:
// the float32 units (67 TFLOP/s) bound it. Every tile of points also reads
// every weight it uses from L2 (4 bytes a weight): BM / 2 FLOP a weight byte,
// 16 at the flagship's 32-point tile, so L2 sits close behind at the widest
// fields (BM = 16).
//
// Design (simple; float32 fields up to 512 wide render through
// field_eval_f32.cu, 3xTF32 on wgmma, and this kernel keeps the wider ones
// and the bf16 fields outside the wgmma kernel's envelope).
// - A persistent grid, one CTA of 256 threads per SM, each CTA one tile of
//   BM points at a time. BM (64, 32 or 16) is the largest that lets the
//   tile's float32 activations (two ping-pong buffers, K-major: column k of
//   the tile's points is BM consecutive floats), its trunk input, sun and
//   transient inputs and two weight stages fit 232,448 bytes of shared
//   memory (`spnerf_field_eval_general_tile`).
// - Weights are float32, each layer a (K, N) row-major matrix, every input
//   segment and the output padded to multiples of KS = 16 (zero rows and
//   columns), so a padded column of one layer is an exact zero in the next
//   layer's padded input rows. A layer runs in passes of NC = 8,192 / BM
//   output columns; a pass sums its K in slabs of KS rows, each slab copied
//   by cp.async into one of two shared-memory stages while the other is
//   summed. The copy cursor walks the same program one slab ahead, across
//   passes, layers and tiles.
// - Each thread sums a register micro-tile of 4 points x 8 columns by FFMA,
//   reading 4 activations (one float4) and 8 weights (two float4) a k.
//   A warp whose columns all lie past a narrow head's padded width skips
//   the products.
// - The epilogue adds the bias and applies the activation to the micro-tile
//   in registers, writing the next layer's buffer (rounded to bf16 in the
//   bf16 policy) or the float32 head output (64-bit offsets).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "field_epilogue.cuh"

#define THREADS 256
#define KS 16        // rows of a weight slab; padding of every segment
#define MICRO_M 4    // points a thread sums
#define MICRO_N 8    // output columns a thread sums
#define SMEM_LIMIT 232448
#define MAX_OPS 32
#define OP_INTS 11
#define W_MAX 1024   // the widest field the route takes

// One dense layer of the program (ops/field_eval.py `program`), in the order
// the kernel runs them. w_off: float offset of its (k1 + k2, npad) weight
// matrix; b_off: float offset of its bias (zero-padded to npad); k1, k2: the
// input segments' padded depths (k2 = 0 for one segment); npad, nreal:
// padded and real output width; a1, a2: the segments' sources (SRC_*); dst:
// 0 or 1 for an activation buffer, -1 for a head output; epi: EPI_*; out:
// index of the head output (sigma, rgb, sun, sky, beta, sem), -1 for none.
struct Op {
  int w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out;
};

struct GeneralDesc {
  int n_ops, n_points, wbuf, k0, k0pad, tdim, tpad;
  const float* xin;  // (n_points, k0)
  const float* sun;  // (n_points, 3)
  const float* tin;  // (n_points, tdim) or null
  const float* w;
  const float* b;
  float* out[6];
  Op op[MAX_OPS];
};

// output columns of one pass of a layer at tile BM
__host__ __device__ constexpr int pass_cols(int bm) {
  return THREADS * MICRO_M * MICRO_N / bm;
}

template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// ------------------------------------------------------------ copies

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Slab s of layer o's pass at column n0 (KS rows x up to NC columns of its
// row-major weight matrix) into a stage of KS x NC floats; columns past
// npad are left as they are (the warps that own them skip the products or
// drop them in the epilogue).
template <int NC>
__device__ __forceinline__ void load_slab(const GeneralDesc& d, const Op& o,
                                          int n0, int s, float* stage) {
  const float* w = d.w + o.w_off + (size_t)(s * KS) * o.npad + n0;
  const int vec = min(NC, o.npad - n0) / 4;
  for (int i = threadIdx.x; i < KS * vec; i += THREADS) {
    const int r = i / vec, c = i - r * vec;
    cp_async16(stage + r * NC + 4 * c, w + (size_t)r * o.npad + 4 * c);
  }
}

// The copy cursor: (op, pass column, slab) after (i, n0, s) in the order
// the tile loop consumes them, wrapping to the program's start (the next
// tile's first slab).
template <int NC>
__device__ __forceinline__ void advance(const GeneralDesc& d, int& i,
                                        int& n0, int& s) {
  const Op& o = d.op[i];
  if (++s < (o.k1 + o.k2) / KS) return;
  s = 0;
  n0 += NC;
  if (n0 < o.npad) return;
  n0 = 0;
  if (++i == d.n_ops) i = 0;
}

// rows [row0, row0 + BM) of a (n, cols) float32 array into a K-major tile of
// cpad x BM floats; rows past n and columns past cols are zero.
template <int BM, bool BF16>
__device__ __forceinline__ void load_input(float* dst,
                                           const float* __restrict__ src,
                                           int cols, int cpad, int row0,
                                           int n) {
  for (int i = threadIdx.x; i < BM * cpad; i += THREADS) {
    const int m = i / cpad, k = i - m * cpad;
    float v = 0.0f;
    if (k < cols && row0 + m < n) v = __ldg(src + (size_t)(row0 + m) * cols + k);
    dst[k * BM + m] = operand<BF16>(v);
  }
}

// bias and activation of a thread's micro-tile: points row0 + m0 .. + 4,
// columns col0 .. + 8 (all below npad): into the K-major buffer dst, or the
// float32 head output (rows below n_points, columns below nreal).
template <int BM, bool BF16, int EPI>
__device__ __forceinline__ void epilogue(const GeneralDesc& d, const Op& o,
                                         const float (&acc)[MICRO_M][MICRO_N],
                                         int col0, int m0, float* dst,
                                         int row0) {
  const float4* bp = reinterpret_cast<const float4*>(d.b + o.b_off + col0);
  const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
  const float bias[MICRO_N] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  float v[MICRO_M][MICRO_N];
#pragma unroll
  for (int m = 0; m < MICRO_M; ++m)
#pragma unroll
    for (int j = 0; j < MICRO_N; ++j)
      v[m][j] = activate<EPI>(__fadd_rn(acc[m][j], bias[j]));
  if (dst) {
#pragma unroll
    for (int j = 0; j < MICRO_N; ++j)
      *reinterpret_cast<float4*>(dst + (col0 + j) * BM + m0) = make_float4(
          operand<BF16>(v[0][j]), operand<BF16>(v[1][j]),
          operand<BF16>(v[2][j]), operand<BF16>(v[3][j]));
    return;
  }
  float* out = d.out[o.out];
#pragma unroll
  for (int m = 0; m < MICRO_M; ++m) {
    const int row = row0 + m0 + m;
    if (row >= d.n_points) break;
#pragma unroll
    for (int j = 0; j < MICRO_N; ++j)
      if (col0 + j < o.nreal) out[(size_t)row * o.nreal + col0 + j] = v[m][j];
  }
}

template <int BM, bool BF16>
__device__ __forceinline__ void run_epilogue(
    const GeneralDesc& d, const Op& o, const float (&acc)[MICRO_M][MICRO_N],
    int col0, int m0, float* dst, int row0) {
  switch (o.epi) {
#define EPI_CASE(E)                                               \
  case E:                                                         \
    epilogue<BM, BF16, E>(d, o, acc, col0, m0, dst, row0); \
    break;
    EPI_CASE(EPI_SIN30)
    EPI_CASE(EPI_SIN)
    EPI_CASE(EPI_RELU)
    EPI_CASE(EPI_SOFTPLUS)
    EPI_CASE(EPI_ALBEDO)
    EPI_CASE(EPI_SIGMOID)
    default: epilogue<BM, BF16, EPI_NONE>(d, o, acc, col0, m0, dst, row0);
#undef EPI_CASE
  }
}

// ------------------------------------------------------------- the kernel

template <int BM, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
field_eval_general_kernel(const __grid_constant__ GeneralDesc d) {
  constexpr int NC = pass_cols(BM);
  constexpr int RG = BM / MICRO_M;  // row groups of a tile
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* buf0 = smem;
  float* buf1 = buf0 + d.wbuf * BM;
  float* sx = buf1 + d.wbuf * BM;
  float* ss = sx + d.k0pad * BM;
  float* st = ss + KS * BM;
  float* stages = st + d.tpad * BM;  // 2 x KS x NC
  float* const src[5] = {buf0, buf1, sx, ss, st};

  const int tid = threadIdx.x;
  const int m0 = (tid % RG) * MICRO_M;  // the thread's points in the tile
  const int c0 = (tid / RG) * MICRO_N;  // its columns in a pass
  const int warp_c0 = ((tid & ~31) / RG) * MICRO_N;  // its warp's first
  const int n_tiles = (d.n_points + BM - 1) / BM;

  // the first slab, then the cursor one slab ahead of the products
  load_slab<NC>(d, d.op[0], 0, 0, stages);
  cp_async_commit();
  int li = 0, ln0 = 0, ls = 0, slot = 0;
  advance<NC>(d, li, ln0, ls);

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * BM;
    __syncthreads();  // the previous tile is done with the inputs
    load_input<BM, BF16>(sx, d.xin, d.k0, d.k0pad, row0, d.n_points);
    load_input<BM, BF16>(ss, d.sun, 3, KS, row0, d.n_points);
    if (d.tpad)
      load_input<BM, BF16>(st, d.tin, d.tdim, d.tpad, row0, d.n_points);
    for (int i = 0; i < d.n_ops; ++i) {
      const Op& o = d.op[i];
      const float* a1 = src[o.a1];
      const float* a2 = src[o.a2 < 0 ? 0 : o.a2];
      float* dst = o.dst >= 0 ? src[o.dst] : nullptr;
      const int ns = (o.k1 + o.k2) / KS;
      for (int n0 = 0; n0 < o.npad; n0 += NC) {
        const bool active = n0 + warp_c0 < o.npad;
        float acc[MICRO_M][MICRO_N];
#pragma unroll
        for (int m = 0; m < MICRO_M; ++m)
#pragma unroll
          for (int j = 0; j < MICRO_N; ++j) acc[m][j] = 0.0f;
        for (int s = 0; s < ns; ++s) {
          // this slab has landed, and every thread is done with the other
          // stage (and with the inputs and buffers written before)
          cp_async_wait_all();
          __syncthreads();
          load_slab<NC>(d, d.op[li], ln0, ls, stages + (slot ^ 1) * KS * NC);
          cp_async_commit();
          advance<NC>(d, li, ln0, ls);
          if (active) {
            const int k = s * KS;
            const float* a =
                (k < o.k1 ? a1 + k * BM : a2 + (k - o.k1) * BM) + m0;
            const float* w = stages + slot * KS * NC + c0;
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) {
              const float4 av = *reinterpret_cast<const float4*>(a + kk * BM);
              const float4 w0 = *reinterpret_cast<const float4*>(w + kk * NC);
              const float4 w1 =
                  *reinterpret_cast<const float4*>(w + kk * NC + 4);
              const float am[MICRO_M] = {av.x, av.y, av.z, av.w};
              const float wn[MICRO_N] = {w0.x, w0.y, w0.z, w0.w,
                                         w1.x, w1.y, w1.z, w1.w};
#pragma unroll
              for (int m = 0; m < MICRO_M; ++m)
#pragma unroll
                for (int j = 0; j < MICRO_N; ++j)
                  acc[m][j] = fmaf(am[m], wn[j], acc[m][j]);
            }
          }
          slot ^= 1;
        }
        if (n0 + c0 < o.npad)
          run_epilogue<BM, BF16>(d, o, acc, n0 + c0, m0, dst, row0);
      }
    }
  }
  cp_async_wait_all();  // the cursor's last copy, never summed
}

// ------------------------------------------------------------------- host

static int ceil16(int x) { return (x + KS - 1) / KS * KS; }

// Dynamic shared memory of a launch at tile BM: the two activation buffers,
// the trunk input, sun and transient tiles, two weight stages.
static int smem_bytes(int bm, int width, int k0pad, int tpad) {
  return 4 * (bm * (2 * ceil16(width) + k0pad + KS + tpad)
              + 2 * KS * pass_cols(bm));
}

template <int BM, bool BF16>
static int launch(const GeneralDesc& d, int smem, cudaStream_t stream) {
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(field_eval_general_kernel<BM, BF16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  // the persistent grid: as many CTAs as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, field_eval_general_kernel<BM, BF16>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (d.n_points + BM - 1) / BM;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  field_eval_general_kernel<BM, BF16><<<grid, THREADS, smem, stream>>>(d);
  return (int)cudaGetLastError();
}

// whether op row r fits the buffers and padding of the launch
static bool op_ok(const Op& o, const GeneralDesc& d) {
  const int size[5] = {d.wbuf, d.wbuf, d.k0pad, KS, d.tpad};
  if (o.k1 <= 0 || o.k1 % KS || o.k2 < 0 || o.k2 % KS || o.npad <= 0
      || o.npad % KS || o.nreal <= 0 || o.nreal > o.npad || o.w_off < 0
      || o.w_off % 4 || o.b_off < 0 || o.b_off % 8 || o.epi < EPI_SIN30
      || o.epi > EPI_SIGMOID || o.a1 < 0 || o.a1 > SRC_T
      || o.k1 > size[o.a1])
    return false;
  if (o.k2 && (o.a2 < 0 || o.a2 > SRC_T || o.k2 > size[o.a2])) return false;
  if (o.dst >= 0) return o.dst <= SRC_BUF1 && o.npad <= d.wbuf;
  return o.out >= 0 && o.out < 6 && d.out[o.out] != nullptr;
}

extern "C" {

// The tile of a launch: 64, 32 or 16 points, the largest whose buffers and
// stages fit in shared memory; 0 where none fits or the field is wider than
// W_MAX, a configuration the route does not take.
int spnerf_field_eval_general_tile(int width, int k0pad, int tpad) {
  if (width < 1 || width > W_MAX) return 0;
  for (int bm = 64; bm >= 16; bm /= 2)
    if (smem_bytes(bm, width, k0pad, tpad) <= SMEM_LIMIT) return bm;
  return 0;
}

int spnerf_field_eval_general_smem(int bm, int width, int k0pad, int tpad) {
  return smem_bytes(bm, width, k0pad, tpad);
}

// op_rows: host array of n_ops x OP_INTS ints, the fields of Op in order.
// xin (n_points, k0), sun (n_points, 3), tin (n_points, tdim) float32,
// row-major; tpad = 0 without a transient input. Launches on `stream` and
// returns a cudaError_t (0 on success); does not synchronise.
int spnerf_field_eval_general(const void* xin, const void* sun,
                              const void* tin, const void* w, const void* b,
                              const void* op_rows, int n_ops, int width,
                              int k0, int k0pad, int tdim, int tpad,
                              int n_points, int bf16, void* o_sigma,
                              void* o_rgb, void* o_sun, void* o_sky,
                              void* o_beta, void* o_sem, void* stream) {
  const int bm = spnerf_field_eval_general_tile(width, k0pad, tpad);
  if (n_ops < 1 || n_ops > MAX_OPS || n_points <= 0 || bm == 0 || k0 < 1
      || k0 > k0pad || k0pad % KS || tpad % KS || tdim > tpad
      || (tpad && (tdim < 1 || tin == nullptr)))
    return (int)cudaErrorInvalidValue;
  GeneralDesc d;
  d.n_ops = n_ops;
  d.n_points = n_points;
  d.wbuf = ceil16(width);
  d.k0 = k0;
  d.k0pad = k0pad;
  d.tdim = tdim;
  d.tpad = tpad;
  d.xin = (const float*)xin;
  d.sun = (const float*)sun;
  d.tin = (const float*)tin;
  d.w = (const float*)w;
  d.b = (const float*)b;
  void* outs[6] = {o_sigma, o_rgb, o_sun, o_sky, o_beta, o_sem};
  for (int i = 0; i < 6; ++i) d.out[i] = (float*)outs[i];
  const int* rows = static_cast<const int*>(op_rows);
  for (int i = 0; i < n_ops; ++i) {
    const int* r = rows + OP_INTS * i;
    d.op[i] = Op{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9],
                 r[10]};
    if (!op_ok(d.op[i], d)) return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes(bm, width, k0pad, tpad);
  cudaStream_t s = (cudaStream_t)stream;
  if (bm == 64) return bf16 ? launch<64, true>(d, smem, s)
                            : launch<64, false>(d, smem, s);
  if (bm == 32) return bf16 ? launch<32, true>(d, smem, s)
                            : launch<32, false>(d, smem, s);
  return bf16 ? launch<16, true>(d, smem, s) : launch<16, false>(d, smem, s);
}

const char* spnerf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
