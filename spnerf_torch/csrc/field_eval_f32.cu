// Fused forward of the SP-NeRF field on Hopper (sm_90a): the float32 route,
// float32-accurate products on the tensor cores by the 3xTF32 split.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `_fused_apply` in
// spnerf_tpu/ops/pallas/field_eval.py at compute_dtype "float32" (its dots
// take float32 operands, field_eval.py:125-126, and sum in float32), for
// fields up to W_MAX_F32 = 512 wide; wider float32 fields render through
// the FFMA kernel of field_eval_general.cu. For every point it computes the
// Siren trunk sin(30 W0 x), the sine layers with the input concatenated
// back in at the skip, then any subset of the heads (sigma, albedo, sun
// visibility, sky, beta, semantic logits), walking the layer program of
// `program` in ops/field_eval.py.
//
// Numerics. Activations stay float32 between layers. Every product of a
// layer of the trunk or a hidden head layer is split: each float32 operand
// a becomes hi = tf32_rna(a) and lo = tf32_rna(a - hi) (the weights when
// packed, the activations in registers as they are loaded), and a x b is
// summed as lo_a hi_b + hi_a lo_b + hi_a hi_b by TF32 wgmma into float32
// accumulators; lo_a lo_b (2^-22 of the product) is dropped. The head
// outputs (1 to 16 columns: sigma, albedo, sun visibility, sky, beta,
// semantic logits) are float32 FFMA sums, taken from the registers of the
// layer before them. Bias and epilogues repeat the plain version op for op
// (field_epilogue.cuh).
//
// Bound. 2 FLOP a weight a point uses (5.38 MFLOP for all heads of the
// flagship 8x512 field, 4.85 MFLOP for the solar pass) done as three TF32
// products: 16.1 MFLOP a point at 495 TFLOP/s, 6x the bf16 kernel's bound.
// Every tile of points also streams every weight it uses from L2 as hi and
// lo (8 bytes a weight, 21.5 MB a flagship tile for 1,032 MFLOP of tensor
// work, 48 FLOP a byte): at the tensor cores' full rate that is ~10 TB/s
// of L2 reads for the card, above what L2 gives, so L2 sits close behind
// the tensor cores.
//
// Design.
// - A persistent grid, one CTA per SM, each CTA one 64-point tile at a time.
//   The tile's activations are ONE float32 buffer of 64 rows x ceil32(width)
//   columns in shared memory (128 KB at 512), rows with their 8-column groups
//   XOR-swizzled by (row % 4) so that a warp's 8-byte loads and stores hit
//   32 banks. The trunk input, sun and transient code are read straight from
//   device memory at the layers that use them (trunk 0, the skip, sun0,
//   sky0, beta0).
// - Three consumer warpgroups each own 64-column chunks j = wg, wg + 3,
//   wg + 6 of a layer (up to 96 float32 accumulators a thread at 512) and
//   all run the whole K: for every 8-deep k step each thread splits its A
//   fragment (4 floats of its rows, loaded from the buffer while the slab
//   before runs its products) into hi and lo in registers, and issues the
//   three products m64nNk8 with A from registers and B (the weight's hi or
//   lo) from shared memory. pack_params orders each weight's
//   K rows within every group of 8 (0, 2, 4, 6, 1, 3, 5, 7) so that a
//   thread's two k values (t0, t0 + 4) are adjacent columns of the buffer:
//   one 8-byte load, and the accumulators of one layer are in the A fragment
//   order of the next.
// - When the products of a layer are done the warpgroups meet at a named
//   barrier, apply bias and activation in registers and overwrite the
//   single buffer in place; a layer whose output feeds only a head output
//   (sem0, rgb0, beta0, sun2, sky0) keeps it in registers. A head output
//   is summed from those registers: each thread's columns by FFMA, the four
//   lanes of a row by shuffles, the three warpgroups through 12 KB of shared
//   memory in a fixed order. The program orders the heads so that one buffer
//   does: the trunk's output X, then feats in place over X, sun0's hidden
//   over feats once nothing else reads it.
// - 512 threads: three consumer warpgroups at CONSUMER_REGS registers a
//   thread and a producer warpgroup at PRODUCER_REGS (setmaxnreg), so the
//   wgmmas of a warpgroup run back to back instead of one at a time.
// - Weights arrive through a ring of 8 KB stages, each one 16-deep K slab
//   of one 64-wide chunk: every 128-byte row is a column's 16 hi then 16 lo
//   values in the 128-byte swizzle wgmma reads (pack_params lays them out),
//   so one bulk copy (cp.async.bulk) fills a stage. One producer thread
//   walks the program and keeps the ring full across layers and tiles. A
//   warpgroup waits for every stage, releases the others' at once and its
//   own when its products on them are done, so no warpgroup runs a round of
//   the ring ahead of the barriers' parity; the ring (10 stages at 512) is
//   at least as deep as a slab has chunks.
// - What bounds it: about a quarter of the 3xTF32 bound at the flagship
//   (chip_smoke.py phase 5, PERF.md). Copies of this kernel that differ by
//   one choice, timed in turns with it on the card, showed: four consumer
//   warpgroups at 544
//   threads (96 registers) had ptxas serialise the wgmmas; setmaxnreg
//   removed most of the gap. Two, three or four consumer warpgroups ran
//   within a few percent of each other, and so did issuing a chunk's
//   products as its stage lands; loading the next slab's A under the
//   current products and three warpgroups gained a few percent. Loading
//   each A fragment once per chunk instead of once per slab (pass by pass
//   over the chunks, or as stages land), a second slab in flight per
//   warpgroup, one commit group a chunk, and A staged as hi|lo tiles in
//   shared memory for wgmmas with both operands there (two barriers a
//   slab) ran slower. The share of the bound rises with the width
//   (utils/time_field_f32.py), and a ring twice as deep at 256 changed
//   nothing: a cost fixed per 16-deep slab, not the ring's depth or the
//   L2's rate, holds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field_epilogue.cuh"
#include "hopper.cuh"

#define BM 64                      // points per tile
#define WGS 3                      // consumer warpgroups
#define CONSUMERS (WGS * 128)
#define THREADS (CONSUMERS + 128)  // plus one producer warpgroup
// registers a thread: the producer warpgroup gives its own back so that
// the consumers hold a layer's accumulators and A fragments without
// serialising the wgmmas; setmaxnreg moves registers within the CTA's
// launch allocation (512 threads x 128), so 128 x 24 + 384 x 160 fit it
#define PRODUCER_REGS 24
#define CONSUMER_REGS 160
#define KS 16                      // K rows of a weight stage: two k8 steps
#define NCH 64                     // output columns of a chunk
#define STAGE_BYTES (NCH * 128)    // 64 rows x (16 hi + 16 lo floats)
#define MAX_STAGES 12
#define CPW 3                      // chunks a warpgroup owns at most
#define W_MAX_F32 512              // the widest field it takes
static_assert(W_MAX_F32 <= CPW * WGS * NCH, "a layer's chunks fit");
#define TAIL_N 16                  // a head output's padded width
#define RED_FLOATS (WGS * BM * TAIL_N)
#define SMEM_LIMIT 232448
#define MAX_OPS 32
#define OP_INTS 11

// One dense layer of the program (ops/field_eval.py `program`), in the order
// the kernel runs them. A layer with out >= 0 is a head output: it runs on
// the registers of the layer before it. Otherwise: w_off, the byte offset of
// its first weight stage (stages follow slab by slab, each slab's chunks in
// order, stage (s, j) at w_off + (s * npad + 64 j) * 128); k1, k2: the
// input segments' padded depths, multiples of KS (k2 = 0 for one segment);
// npad: output width, a multiple of 32; a1, a2: the segments' sources
// (SRC_BUF0 or an input); dst: SRC_BUF0 to overwrite the buffer, -1 to keep
// the output in registers. A head output: w_off, the byte offset of its
// float32 (k1, TAIL_N) row-major weight, k1 the width of the layer before
// it; npad TAIL_N; out the index of the output (sigma, rgb, sun, sky, beta,
// sem). b_off: float offset of the bias (zero-padded to npad); nreal: the
// real output width; epi: EPI_*.
struct Op {
  int w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out;
};

struct F32Desc {
  int n_ops, n_points, stages, wa, k0, tdim;
  const float* xin;  // (n_points, k0)
  const float* sun;  // (n_points, 3)
  const float* tin;  // (n_points, tdim) or null
  const uint8_t* w;
  const float* b;
  float* out[6];
  Op op[MAX_OPS];
};

// ------------------------------------------------------------ PTX helpers

// float32 to TF32, round to nearest with ties away from zero (the low 13
// bits zero); the host's `tf32_rna` in ops/field_eval.py is the same
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// d (64 x 64, float32) += A (64 x 8, TF32 in registers) x B (8 x 64, TF32
// K-major in shared memory)
__device__ __forceinline__ void mma_n64(float* d, const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_n32(float* d, const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- the kernel

// A fragment of the k8 step at physical column kb of source src, for the
// thread's rows r and r + 8 of the tile, in wgmma's TF32 register order
// (a0: row r, k t0; a1: row r + 8, k t0; a2: row r, k t0 + 4; a3: row r + 8,
// k t0 + 4, t0 = lane % 4): physical columns kb + 2 t0 and kb + 2 t0 + 1,
// as pack_params orders the weights' K rows. Input rows past n_points and
// columns past an input's width are zero.
__device__ __forceinline__ void load_frag(const F32Desc& d, int src,
                                          const float* act, int kb, int r,
                                          int row0, float (&a)[4]) {
  const int c = kb + 2 * (threadIdx.x & 3);
  if (src == SRC_BUF0) {
    const int sc = c ^ ((r & 3) << 3);
    const float2 v0 = *reinterpret_cast<const float2*>(act + r * d.wa + sc);
    const float2 v1 =
        *reinterpret_cast<const float2*>(act + (r + 8) * d.wa + sc);
    a[0] = v0.x;
    a[1] = v1.x;
    a[2] = v0.y;
    a[3] = v1.y;
    return;
  }
  const float* g = src == SRC_X ? d.xin : src == SRC_SUN ? d.sun : d.tin;
  const int w = src == SRC_X ? d.k0 : src == SRC_SUN ? 3 : d.tdim;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    float x0 = 0.0f, x1 = 0.0f;
    if (row < d.n_points) {
      const float* p = g + (size_t)row * w;
      if (c < w) x0 = __ldg(p + c);
      if (c + 1 < w) x1 = __ldg(p + c + 1);
    }
    a[h] = x0;
    a[2 + h] = x1;
  }
}

// the fragment's hi and lo TF32 parts
__device__ __forceinline__ void split(const float (&a)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(a[i]);
    lo[i] = tf32_rna(__fsub_rn(a[i], __uint_as_float(hi[i])));
  }
}

// The three products of k8 step kk of a slab on one chunk of NC columns,
// the stage's hi half at bytes 0-63 of every row, lo at 64-127: the small
// terms first, then hi x hi.
template <int NC>
__device__ __forceinline__ void step_mma(float* acc, const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         uint32_t stage, int kk) {
  const uint64_t bh = sdesc(stage + 32 * kk);
  const uint64_t bl = sdesc(stage + 64 + 32 * kk);
  if (NC == 64) {
    mma_n64(acc, lo, bh);
    mma_n64(acc, hi, bl);
    mma_n64(acc, hi, bh);
  } else {
    mma_n32(acc, lo, bh);
    mma_n32(acc, hi, bl);
    mma_n32(acc, hi, bh);
  }
}

// bias and activation of the warpgroup's chunks in place: accumulator
// 4 i + 2 h + e is row r + 8 h, column (wg + 4 c) * 64 + 8 i + 2 t0 + e
template <int EPI>
__device__ __forceinline__ void apply(float (&acc)[CPW][32],
                                      const float* __restrict__ bias,
                                      int wg, const int (&nc)[CPW], int t0) {
#pragma unroll
  for (int c = 0; c < CPW; ++c) {
    const int cb = (wg + WGS * c) * NCH + 2 * t0;
#pragma unroll
    for (int i = 0; i < NCH / 8; ++i) {
      if (8 * i < nc[c]) {
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(bias + cb + 8 * i));
        acc[c][4 * i] = activate<EPI>(__fadd_rn(acc[c][4 * i], bb.x));
        acc[c][4 * i + 1] = activate<EPI>(__fadd_rn(acc[c][4 * i + 1], bb.y));
        acc[c][4 * i + 2] = activate<EPI>(__fadd_rn(acc[c][4 * i + 2], bb.x));
        acc[c][4 * i + 3] = activate<EPI>(__fadd_rn(acc[c][4 * i + 3], bb.y));
      }
    }
  }
}

__device__ __forceinline__ void apply_rt(int epi, float (&acc)[CPW][32],
                                         const float* __restrict__ bias,
                                         int wg, const int (&nc)[CPW],
                                         int t0) {
  switch (epi) {
#define EPI_CASE(E) \
  case E:           \
    apply<E>(acc, bias, wg, nc, t0); \
    break;
    EPI_CASE(EPI_SIN30)
    EPI_CASE(EPI_SIN)
    EPI_CASE(EPI_RELU)
    EPI_CASE(EPI_SOFTPLUS)
    EPI_CASE(EPI_ALBEDO)
    EPI_CASE(EPI_SIGMOID)
    default: apply<EPI_NONE>(acc, bias, wg, nc, t0);
#undef EPI_CASE
  }
}

__global__ void __launch_bounds__(THREADS, 1)
field_eval_f32_kernel(const __grid_constant__ F32Desc d) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  float* act = reinterpret_cast<float*>(smem + d.stages * STAGE_BYTES);
  float* red = act + BM * d.wa;
  const uint32_t full = smem_u32(red + RED_FLOATS);
  const uint32_t empty = full + 8 * d.stages;
  const int n_tiles = (d.n_points + BM - 1) / BM;

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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        for (int i = 0; i < d.n_ops; ++i) {
          const Op& o = d.op[i];
          if (o.out >= 0) continue;
          const int ns = (o.k1 + o.k2) / KS;
          for (int s = 0; s < ns; ++s) {
            for (int n0 = 0; n0 < o.npad; n0 += NCH, ++it) {
              const int slot = it % d.stages;
              const uint32_t bytes = min(NCH, o.npad - n0) * 128;
              mbar_wait(empty + 8 * slot, ((it / d.stages) & 1) ^ 1);
              mbar_expect_tx(full + 8 * slot, bytes);
              bulk_copy(ring + slot * STAGE_BYTES,
                        d.w + o.w_off + ((size_t)s * o.npad + n0) * 128,
                        bytes, full + 8 * slot);
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

  const int lane = threadIdx.x & 31;
  const int t0 = lane & 3;
  const int r = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int sw = (r & 3) << 3;  // the row's swizzle (r + 8 has the same)
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * BM;
    for (int i = 0; i < d.n_ops; ++i) {
      const Op& o = d.op[i];
      const int nch = (o.npad + NCH - 1) / NCH;
      const int ns = (o.k1 + o.k2) / KS;
      int nc[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int j = wg + WGS * c;
        nc[c] = j < nch ? min(NCH, o.npad - j * NCH) : 0;
      }
      float acc[CPW][32];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[c][k] = 0.0f;
        fence_operands(acc[c]);
      }
      // the slab's A fragments, raw; the next slab's are loaded while this
      // slab's products run (the wgmmas read the split registers only)
      float a[2][4];
      auto load_slab = [&](int s) {
        const bool seg2 = s * KS >= o.k1;
        const int src = seg2 ? o.a2 : o.a1;
        const int kb = seg2 ? s * KS - o.k1 : s * KS;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk)
          load_frag(d, src, act, kb + 8 * kk, r, row0, a[kk]);
      };
      if (nc[0]) load_slab(0);
      for (int s = 0; s < ns; ++s) {
        // every stage of the slab has landed; the others' go back at once
        int own[CPW];
#pragma unroll
        for (int c = 0; c < CPW; ++c) own[c] = -1;
        for (int j = 0; j < nch; ++j, ++it) {
          const int slot = it % d.stages;
          mbar_wait(full + 8 * slot, (it / d.stages) & 1);
          bool mine = false;
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            if (j == wg + WGS * c) {
              own[c] = slot;
              mine = true;
            }
          }
          if (!mine && lane == 0) mbar_arrive(empty + 8 * slot);
        }
        if (!nc[0]) continue;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t hi[4], lo[4];
          split(a[kk], hi, lo);
          wgmma_fence();
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            const uint32_t st = ring + max(own[c], 0) * STAGE_BYTES;
            if (nc[c] == NCH) step_mma<64>(acc[c], hi, lo, st, kk);
            else if (nc[c]) step_mma<32>(acc[c], hi, lo, st, kk);
          }
        }
        wgmma_commit();
        if (s + 1 < ns) load_slab(s + 1);
        wgmma_wait<0>();
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < CPW; ++c)
            if (own[c] >= 0) mbar_arrive(empty + 8 * own[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c) fence_operands(acc[c]);

      apply_rt(o.epi, acc, d.b + o.b_off, wg, nc, t0);
      named_sync(CONSUMERS);  // every warpgroup is done reading the buffer
      if (o.dst == SRC_BUF0) {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          const int cb = (wg + WGS * c) * NCH + 2 * t0;
#pragma unroll
          for (int k = 0; k < NCH / 8; ++k) {
            if (8 * k < nc[c]) {
              const int col = (cb + 8 * k) ^ sw;
              *reinterpret_cast<float2*>(act + r * d.wa + col) =
                  make_float2(acc[c][4 * k], acc[c][4 * k + 1]);
              *reinterpret_cast<float2*>(act + (r + 8) * d.wa + col) =
                  make_float2(acc[c][4 * k + 2], acc[c][4 * k + 3]);
            }
          }
        }
      }
      const bool tail = i + 1 < d.n_ops && d.op[i + 1].out >= 0;
      if (tail) {
        // the head output's partial sums over this warpgroup's columns
        const Op& h = d.op[i + 1];
        const float* tw = reinterpret_cast<const float*>(d.w + h.w_off);
        for (int q = 0; q < h.nreal; ++q) {
          float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            const int cb = (wg + WGS * c) * NCH + 2 * t0;
#pragma unroll
            for (int k = 0; k < NCH / 8; ++k) {
              if (8 * k < nc[c]) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float wv = __ldg(tw + (cb + 8 * k + e) * TAIL_N + q);
                  p0 = fmaf(acc[c][4 * k + e], wv, p0);
                  p1 = fmaf(acc[c][4 * k + 2 + e], wv, p1);
                }
              }
            }
          }
          p0 = __fadd_rn(p0, __shfl_xor_sync(0xffffffffu, p0, 1));
          p1 = __fadd_rn(p1, __shfl_xor_sync(0xffffffffu, p1, 1));
          p0 = __fadd_rn(p0, __shfl_xor_sync(0xffffffffu, p0, 2));
          p1 = __fadd_rn(p1, __shfl_xor_sync(0xffffffffu, p1, 2));
          if (t0 == 0) {
            red[(wg * BM + r) * TAIL_N + q] = p0;
            red[(wg * BM + r + 8) * TAIL_N + q] = p1;
          }
        }
      }
      named_sync(CONSUMERS);  // the buffer and the partial sums are written
      if (tail) {
        const Op& h = d.op[++i];
        float* out = d.out[h.out];
        for (int idx = threadIdx.x; idx < BM * h.nreal; idx += CONSUMERS) {
          const int row = idx / h.nreal, q = idx - row * h.nreal;
          float v = red[row * TAIL_N + q];
#pragma unroll
          for (int g = 1; g < WGS; ++g)
            v = __fadd_rn(v, red[(g * BM + row) * TAIL_N + q]);
          v = activate_rt(h.epi, __fadd_rn(v, d.b[h.b_off + q]));
          if (row0 + row < d.n_points)
            out[(size_t)(row0 + row) * h.nreal + q] = v;
        }
      }
    }
  }
}

// ------------------------------------------------------------------- host

static int ceil32(int x) { return (x + 31) / 32 * 32; }

// Dynamic shared memory of a launch: 1 KB of slack for the 1,024-byte
// alignment of the stages, the ring with its barriers, the activation
// buffer of 64 x ceil32(width) floats and the head outputs' partial sums.
static int smem_bytes(int width, int stages) {
  return 1024 + stages * (STAGE_BYTES + 16) + BM * ceil32(width) * 4
         + RED_FLOATS * 4;
}

// whether the program rows fit the launch's buffer, ring and inputs
static bool ops_ok(const F32Desc& d) {
  for (int i = 0; i < d.n_ops; ++i) {
    const Op& o = d.op[i];
    if (o.b_off < 0 || o.b_off % 2 || o.nreal <= 0 || o.nreal > o.npad
        || o.epi < EPI_SIN30 || o.epi > EPI_SIGMOID || o.w_off < 0)
      return false;
    if (o.out >= 0) {
      if (i == 0 || d.op[i - 1].out >= 0 || o.out > 5 || !d.out[o.out]
          || o.npad != TAIL_N || o.k1 != d.op[i - 1].npad || o.w_off % 4)
        return false;
      continue;
    }
    const int srcs[2] = {o.a1, o.a2};
    const int depth[2] = {o.k1, o.k2};
    for (int g = 0; g < 2; ++g) {
      if (g == 1 && depth[g] == 0) continue;
      const int s = srcs[g];
      if (depth[g] <= 0 || depth[g] % KS) return false;
      if (s == SRC_BUF0 ? depth[g] > d.wa
          : s == SRC_X ? d.k0 < 1
          : s == SRC_SUN ? false
          : s == SRC_T ? d.tdim < 1 || !d.tin : true)
        return false;
    }
    if (o.npad <= 0 || o.npad % 32 || o.npad > d.wa
        || (o.npad + NCH - 1) / NCH > d.stages || o.w_off % 16
        || (o.dst != SRC_BUF0 && o.dst != -1))
      return false;
  }
  return d.n_ops > 0 && d.op[0].out < 0;
}

extern "C" {

// The weight ring's depth of a launch at `width`: MAX_STAGES, or as many
// stages as fit in shared memory beside the buffer; 0 where fewer than a
// slab's chunks fit or the field is wider than W_MAX_F32, a width the
// route does not take.
int spnerf_field_eval_f32_stages(int width) {
  if (width < 1 || width > W_MAX_F32) return 0;
  const int least = (ceil32(width) + NCH - 1) / NCH;
  for (int s = MAX_STAGES; s >= 2 && s >= least; --s)
    if (smem_bytes(width, s) <= SMEM_LIMIT) return s;
  return 0;
}

int spnerf_field_eval_f32_smem(int width, int stages) {
  return smem_bytes(width, stages);
}

// op_rows: host array of n_ops x OP_INTS ints, the fields of Op in order.
// xin (n_points, k0), sun (n_points, 3), tin (n_points, tdim) float32,
// row-major; tdim = 0 without a transient input. Launches on `stream` and
// returns a cudaError_t (0 on success); does not synchronise.
int spnerf_field_eval_f32(const void* xin, const void* sun, const void* tin,
                          const void* w, const void* b, const void* op_rows,
                          int n_ops, int width, int k0, int tdim,
                          int n_points, void* o_sigma, void* o_rgb,
                          void* o_sun, void* o_sky, void* o_beta,
                          void* o_sem, void* stream) {
  const int stages = spnerf_field_eval_f32_stages(width);
  if (n_ops < 1 || n_ops > MAX_OPS || n_points <= 0 || stages == 0
      || k0 < 1 || tdim < 0)
    return (int)cudaErrorInvalidValue;
  F32Desc d;
  d.n_ops = n_ops;
  d.n_points = n_points;
  d.stages = stages;
  d.wa = ceil32(width);
  d.k0 = k0;
  d.tdim = tdim;
  d.xin = (const float*)xin;
  d.sun = (const float*)sun;
  d.tin = (const float*)tin;
  d.w = (const uint8_t*)w;
  d.b = (const float*)b;
  void* outs[6] = {o_sigma, o_rgb, o_sun, o_sky, o_beta, o_sem};
  for (int i = 0; i < 6; ++i) d.out[i] = (float*)outs[i];
  const int* rows = static_cast<const int*>(op_rows);
  for (int i = 0; i < n_ops; ++i) {
    const int* q = rows + OP_INTS * i;
    d.op[i] = Op{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7], q[8], q[9],
                 q[10]};
  }
  if (!ops_ok(d)) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;
  cudaError_t err;
  if (!opted_in) {
    err = cudaFuncSetAttribute(field_eval_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const int smem = smem_bytes(width, stages);
  // the persistent grid: as many CTAs as fit on the card at once
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, field_eval_f32_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n_points + BM - 1) / BM;
  const int grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  field_eval_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

const char* spnerf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
