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
// Bound. Each point costs 2 FLOP per weight it uses (5.38 MFLOP for all
// heads of the flagship 8x512 field, 4.85 MFLOP for the solar pass) against
// ~0.1 KB of input and output: far above the card's 295 FLOP/byte ridge, so
// the tensor cores bound it. Two more limits sit close behind: every tile of
// points has to stream all 5.4 MB of bf16 weights from L2 (a 64-point tile
// does 344 MFLOP on them, 64 FLOP a weight byte, under the L2's rate at the
// tensor cores' pace), and every activation goes through a SIMT epilogue
// (bias and a 7th-order sine polynomial, ~6,150 activations a point).
//
// Design.
// - A persistent grid, one CTA per SM, each CTA one 64-point tile at a
//   time. A CTA holds the tile's activations in shared memory as bf16 in
//   two ping-pong buffers, K-major with the 128-byte swizzle that wgmma's
//   descriptors read, plus the input, sun and transient tiles in the same
//   layout.
// - Every layer is a 64 x K by K x N product on wgmma (m64n64k16, n32 or n8
//   for a narrow last chunk, A and B both from shared memory, float32
//   accumulators in registers).
// - Weights arrive through a ring of 16 KB stages, each one K-slab (64 deep)
//   of one 128-wide N-chunk, which pack_params (ops/field_eval.py) has
//   already laid out in the swizzled order, so one 1-D bulk copy
//   (cp.async.bulk) fills a stage. One producer thread walks the same layer
//   program as the consumers and keeps the ring full across layers and
//   tiles; each consumer warp releases a stage by an arrive on its `empty`
//   barrier. The ring is as deep as shared memory allows beside the tiles,
//   up to MAX_STAGES (2 at the widest fields the kernel takes).
// - Four consumer warpgroups work in two pairs: the two of a pair each take
//   half the columns of a chunk, so 8 warps run its epilogue, and the pairs
//   take a layer's chunks in turn, so one pair's epilogue runs beside the
//   other's products. The epilogue adds the bias
//   and applies the activation in registers straight from the accumulators
//   (the kind is fixed per layer: one branch a chunk), writing bf16 into the
//   next layer's buffer or float32 to the head output. Every warpgroup
//   waits for every stage and releases it (the other pair's as it passes
//   them), so none runs a round of the ring ahead of the barriers' parity.
//   A named barrier over the consumers ends each layer.
// - What bounds it now (measured on the H100, PERF.md): the products run at
//   a fifth of the tensor cores' rate with the epilogue taken out; each
//   n64 wgmma reads 4 KB of operands from shared memory for 32 clocks of
//   tensor work while the bulk copies write the next stages. Multicasting
//   each stage to a cluster of 2 CTAs halved the weights' L2 bytes and
//   gained nothing, so those bytes are not what holds it.
//
// Numerics match the TPU kernel: dot operands are bf16 (activations are
// rounded once, exactly where the TPU kernel casts them for the dot),
// accumulation, bias and epilogues are float32, fast_sin uses the same
// polynomial with round-half-to-even range reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

#define BM 64                    // points per tile
#define WGS 4                    // consumer warpgroups: two pairs
#define THREADS (WGS * 128 + 32)  // plus one producer warp
#define BLOCK_BYTES 8192         // 64 rows x 64 bf16 (128 B), swizzled
#define NCHUNK 128               // output columns of an N-chunk
#define STAGE_BYTES (NCHUNK * 128)  // one weight stage: NCHUNK rows x 64
#define MAX_STAGES 6             // the weight ring's depth where it fits
#define SMEM_LIMIT 232448        // dynamic shared memory a block may use
#define MAX_OPS 32
#define OP_INTS 11

enum { EPI_SIN30, EPI_SIN, EPI_RELU, EPI_NONE, EPI_SOFTPLUS, EPI_ALBEDO,
       EPI_SIGMOID };
enum { SRC_BUF0, SRC_BUF1, SRC_X, SRC_SUN, SRC_T };

// One dense layer of the program, in the order the kernel runs them.
// w_off: byte offset of its first weight stage; b_off: float offset of its
// bias (zero-padded to npad); k1, k2: the two input segments' depths,
// multiples of 16 (k2 = 0 for one segment); npad: output width, 16 or a
// multiple of 64; nreal: real output width; a1, a2: the segments' sources
// (SRC_*); dst: 0 or 1 for an activation buffer, -1 for a head output;
// epi: EPI_*; out: index of the head output (sigma, rgb, sun, sky, beta,
// sem), -1 for none.
struct Op {
  int w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out;
};

struct FieldDesc {
  int n_ops, n_points, stages, nb, xb, k0pad, has_t;
  const bf16* xin;
  const bf16* sun;
  const bf16* tin;
  const uint8_t* w;
  const float* b;
  float* out[6];
  Op op[MAX_OPS];
};

// sin(x) as the TPU kernel computes it: k = round-half-to-even(x / pi),
// r = x - k pi, a 7th-order odd polynomial of r, negated for odd k. The
// rounding adds and takes away 1.5 * 2^23, which rounds to even and leaves
// k's parity in the sum's last bit (exact for |x / pi| < 2^22, far beyond
// the field's pre-activations): FP32 adds and an integer flip of the sign
// bit instead of the conversion unit's rint and floor.
__device__ __forceinline__ float fast_sin(float x) {
  const float inv_pi = 0.318309886183790671538f;
  const float pi = 3.14159265358979323846f;
  const float magic = 12582912.0f;
  const float t = __fadd_rn(x * inv_pi, magic);
  const float k = __fsub_rn(t, magic);
  float r = __fsub_rn(x, __fmul_rn(k, pi));
  float r2 = r * r;
  float p = r * (0.9999966f + r2 * (-0.16664824f + r2 * (0.00830629f
                 + r2 * -0.00018363f)));
  return __int_as_float(__float_as_int(p) ^ (__float_as_int(t) << 31));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <int EPI>
__device__ __forceinline__ float activate(float v) {
  if (EPI == EPI_SIN30) return fast_sin(30.0f * v);
  if (EPI == EPI_SIN) return fast_sin(v);
  if (EPI == EPI_RELU) return fmaxf(v, 0.0f);
  if (EPI == EPI_SOFTPLUS) return softplus(v);
  if (EPI == EPI_ALBEDO) return sigmoid(v) * 1.002f - 0.001f;
  if (EPI == EPI_SIGMOID) return sigmoid(v);
  return v;
}

// byte offset of row r, 16-byte chunk c (8 bf16 along K) in a swizzled tile
// of 64-wide blocks of `rows` rows
__device__ __forceinline__ int swz(int r, int c, int block_bytes) {
  return (c >> 3) * block_bytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n32(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n8(float* d, uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------- the kernel

// rows [row0, row0 + BM) of a (n, cols) bf16 array into a swizzled tile;
// rows past n are zero. cols is a multiple of 8.
__device__ void load_tile(uint8_t* dst, const bf16* __restrict__ src,
                          int cols, int row0, int n, int tid, int threads) {
  const int vec = cols / 8;
  for (int i = tid; i < BM * vec; i += threads) {
    const int r = i / vec, c = i % vec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * cols)
                + c);
    *reinterpret_cast<uint4*>(dst + swz(r, c, BLOCK_BYTES)) = v;
  }
}

__device__ __forceinline__ int n_slabs(const Op& o) {
  return (o.k1 + 63) / 64 + (o.k2 + 63) / 64;
}

// The products of NC columns of one N-chunk over every K-slab of layer o:
// the chunk's stages are the next n_slabs(o) of the ring, from `it` on;
// `ring` points at the first weight row this warpgroup reads in a stage.
// A slab's stage is released once the next slab's products are issued and
// its own have completed.
template <int NC>
__device__ __forceinline__ void chunk_mma(float (&acc)[NC / 2], const Op& o,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t ring, uint32_t full,
                                          uint32_t empty, int& it,
                                          int stages, bool signal) {
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.0f;
  fence_operands(acc);
  wgmma_fence();
  const int ns1 = (o.k1 + 63) / 64, ns = ns1 + (o.k2 + 63) / 64;
  int prev = -1;  // the slot of the slab before, still held
  for (int s = 0; s < ns; ++s, ++it) {
    const int slot = it % stages;
    mbar_wait(full + 8 * slot, (it / stages) & 1);
    const bool seg2 = s >= ns1;
    const int ss = seg2 ? s - ns1 : s;
    const int steps = min(4, ((seg2 ? o.k2 : o.k1) - 64 * ss) / 16);
    const uint32_t a = (seg2 ? a2 : a1) + ss * BLOCK_BYTES;
    const uint32_t b = ring + slot * STAGE_BYTES;
    for (int kk = 0; kk < steps; ++kk) {
      const uint64_t da = sdesc(a + 32 * kk), db = sdesc(b + 32 * kk);
      if (NC == 64) wgmma_n64(acc, da, db, 1);
      if (NC == 32) wgmma_n32(acc, da, db, 1);
      if (NC == 8) wgmma_n8(acc, da, db, 1);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      if (signal) mbar_arrive(empty + 8 * prev);
    }
    prev = slot;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (signal) mbar_arrive(empty + 8 * prev);
}

// bias and activation of one chunk, from the accumulators: bf16 into the
// swizzled buffer dst, or float32 into the head output (rows below n_points,
// columns below nreal).
template <int NC, int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[NC / 2],
                                         const float* __restrict__ bias,
                                         int n0, uint8_t* dst, float* out,
                                         int nreal, int grow0, int n_points) {
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < NC / 8; ++i) {
    const int col = n0 + 8 * i + 2 * (lane & 3);
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      const float v0 = activate<EPI>(acc[4 * i + 2 * h] + bb.x);
      const float v1 = activate<EPI>(acc[4 * i + 2 * h + 1] + bb.y);
      if (dst) {
        *reinterpret_cast<__nv_bfloat162*>(
            dst + swz(r, col >> 3, BLOCK_BYTES) + (col & 7) * 2) =
            __floats2bfloat162_rn(v0, v1);
      } else if (grow0 + r < n_points) {
        float* o = out + (size_t)(grow0 + r) * nreal;
        if (col < nreal) o[col] = v0;
        if (col + 1 < nreal) o[col + 1] = v1;
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void run_chunk(const FieldDesc& d, const Op& o,
                                          int n0, uint32_t a1, uint32_t a2,
                                          uint8_t* dst, uint32_t ring,
                                          uint32_t full, uint32_t empty,
                                          int& it, int grow0) {
  float acc[NC / 2];
  chunk_mma<NC>(acc, o, a1, a2, ring, full, empty, it, d.stages,
                (threadIdx.x & 31) == 0);
  const float* bias = d.b + o.b_off;
  float* out = o.out >= 0 ? d.out[o.out] : nullptr;
  switch (o.epi) {
#define EPI_CASE(E)                                                       \
  case E:                                                                 \
    epilogue<NC, E>(acc, bias, n0, dst, out, o.nreal, grow0, d.n_points); \
    break;
    EPI_CASE(EPI_SIN30)
    EPI_CASE(EPI_SIN)
    EPI_CASE(EPI_RELU)
    EPI_CASE(EPI_SOFTPLUS)
    EPI_CASE(EPI_ALBEDO)
    EPI_CASE(EPI_SIGMOID)
    default: epilogue<NC, EPI_NONE>(acc, bias, n0, dst, out, o.nreal, grow0,
                                    d.n_points);
#undef EPI_CASE
  }
}

__global__ void __launch_bounds__(THREADS, 1)
field_eval_kernel(const __grid_constant__ FieldDesc d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int act_bytes = d.nb * BLOCK_BYTES;
  uint8_t* buf[2] = {smem, smem + act_bytes};
  uint8_t* sx = smem + 2 * act_bytes;
  uint8_t* ss = sx + d.xb * BLOCK_BYTES;
  uint8_t* st = ss + BLOCK_BYTES;
  // the ring of d.stages weight stages, then its barriers
  const uint32_t ring = smem_u32(st + (d.has_t ? BLOCK_BYTES : 0));
  const uint32_t full = ring + d.stages * STAGE_BYTES;
  const uint32_t empty = full + 8 * d.stages;

  const int n_tiles = (d.n_points + BM - 1) / BM;
  const int consumers = WGS * 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WGS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it: warpgroups 0 .. WGS - 1
  // consume, the warp after them produces
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == WGS) {
    // producer: one thread walks the program and fills the ring
    if (threadIdx.x == consumers) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        for (int i = 0; i < d.n_ops; ++i) {
          const Op& o = d.op[i];
          const int ns = n_slabs(o);
          for (int n0 = 0; n0 < o.npad; n0 += NCHUNK) {
            const int nc = min(NCHUNK, o.npad - n0);
            const uint32_t bytes = nc * 128;
            for (int s = 0; s < ns; ++s, ++it) {
              const int slot = it % d.stages;
              mbar_wait(empty + 8 * slot, ((it / d.stages) & 1) ^ 1);
              mbar_expect_tx(full + 8 * slot, bytes);
              bulk_copy(ring + slot * STAGE_BYTES,
                        d.w + o.w_off + ((size_t)n0 * ns + s * nc) * 128,
                        bytes, full + 8 * slot);
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: two pairs of warpgroups; pair j % 2 computes the N-chunk j
    // of a layer, each warpgroup of the pair a half of its columns, while
    // the other pair runs its epilogue. Every warpgroup waits for every
    // stage and releases it, its own after the products, the others' as it
    // passes them: so no warpgroup runs more than one round of the ring
    // ahead of another, and a barrier's parity always names the round its
    // waiter means.
    const bool signal = (threadIdx.x & 31) == 0;
    const int pair = wg / 2, part = wg % 2;
    const uint32_t src[5] = {smem_u32(buf[0]), smem_u32(buf[1]), smem_u32(sx),
                             smem_u32(ss), smem_u32(st)};
    int it = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int row0 = t * BM;
      load_tile(sx, d.xin, d.k0pad, row0, d.n_points, threadIdx.x, consumers);
      load_tile(ss, d.sun, 16, row0, d.n_points, threadIdx.x, consumers);
      if (d.has_t)
        load_tile(st, d.tin, 16, row0, d.n_points, threadIdx.x, consumers);
      fence_async_smem();
      named_sync(consumers);
      for (int i = 0; i < d.n_ops; ++i) {
        const Op& o = d.op[i];
        const uint32_t a1 = src[o.a1], a2 = src[o.a2 < 0 ? 0 : o.a2];
        uint8_t* dst = o.dst >= 0 ? buf[o.dst] : nullptr;
        const int ns = n_slabs(o);
        for (int n0 = 0, j = 0; n0 < o.npad; n0 += NCHUNK, ++j) {
          // this warpgroup's half: weight rows n0 + part * h .. + h of the
          // chunk's stages, h = nc / 2 (whole 8-row, 1,024-byte groups)
          const int h = min(NCHUNK, o.npad - n0) / 2;
          const int c0 = n0 + part * h;
          const uint32_t r = ring + part * h * 128;
          if (j % 2 != pair) {
            for (int s = 0; s < ns; ++s, ++it) {
              mbar_wait(full + 8 * (it % d.stages), (it / d.stages) & 1);
              if (signal) mbar_arrive(empty + 8 * (it % d.stages));
            }
          } else if (h == 64) {
            run_chunk<64>(d, o, c0, a1, a2, dst, r, full, empty, it, row0);
          } else if (h == 32) {
            run_chunk<32>(d, o, c0, a1, a2, dst, r, full, empty, it, row0);
          } else {
            run_chunk<8>(d, o, c0, a1, a2, dst, r, full, empty, it, row0);
          }
        }
        fence_async_smem();
        named_sync(consumers);
      }
    }
  }
}

// ------------------------------------------------------------------- host

// Dynamic shared memory of a launch, as the kernel lays it out (1 KB of
// slack for the 1,024-byte alignment of the swizzled tiles).
static int smem_bytes(int width, int k0pad, int has_t, int stages) {
  const int nb = (width + 63) / 64, xb = (k0pad + 63) / 64;
  return 1024 + (2 * nb + xb + 1 + (has_t ? 1 : 0)) * BLOCK_BYTES
         + stages * (STAGE_BYTES + 16);
}

extern "C" {

// The weight ring's depth of a launch: MAX_STAGES, or as many stages as fit
// in shared memory beside the tiles (wide fields); 0 where not even 2 fit,
// a width the kernel does not take.
int spnerf_field_eval_stages(int width, int k0pad, int has_t) {
  for (int s = MAX_STAGES; s >= 2; --s)
    if (smem_bytes(width, k0pad, has_t, s) <= SMEM_LIMIT) return s;
  return 0;
}

// op_rows: host array of n_ops x OP_INTS ints, the fields of Op in order.
// Launches on `stream` and returns a cudaError_t (0 on success); does not
// synchronise.
int spnerf_field_eval(const void* xin, const void* sun, const void* tin,
                      const void* w, const void* b, const void* op_rows,
                      int n_ops, int width, int k0pad, int has_t,
                      int n_points, void* o_sigma,
                      void* o_rgb, void* o_sun, void* o_sky, void* o_beta,
                      void* o_sem, void* stream) {
  const int stages = spnerf_field_eval_stages(width, k0pad, has_t);
  if (n_ops < 1 || n_ops > MAX_OPS || width % 32 || k0pad % 16
      || n_points <= 0 || stages == 0)
    return (int)cudaErrorInvalidValue;
  FieldDesc d;
  d.n_ops = n_ops;
  d.n_points = n_points;
  d.stages = stages;
  d.nb = (width + 63) / 64;
  d.xb = (k0pad + 63) / 64;
  d.k0pad = k0pad;
  d.has_t = has_t;
  d.xin = (const bf16*)xin;
  d.sun = (const bf16*)sun;
  d.tin = (const bf16*)tin;
  d.w = (const uint8_t*)w;
  d.b = (const float*)b;
  void* outs[6] = {o_sigma, o_rgb, o_sun, o_sky, o_beta, o_sem};
  for (int i = 0; i < 6; ++i) d.out[i] = (float*)outs[i];
  const int* rows = static_cast<const int*>(op_rows);
  for (int i = 0; i < n_ops; ++i) {
    const int* r = rows + OP_INTS * i;
    d.op[i] = Op{r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9],
                 r[10]};
  }
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(field_eval_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int smem = smem_bytes(width, k0pad, has_t, stages);
  // the persistent grid: as many CTAs as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, field_eval_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n_points + BM - 1) / BM;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  field_eval_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

const char* spnerf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
