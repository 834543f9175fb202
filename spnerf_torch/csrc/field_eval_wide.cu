// Fused forward of the SP-NeRF field on Hopper (sm_90a): the wide route,
// fields wider than one CTA holds, on wgmma through a cluster of 2, 4 or 8
// CTAs.
//
// Replaces the Pallas TPU kernel `_make_kernel` / `_fused_apply` in
// spnerf_tpu/ops/pallas/field_eval.py (its dots at field_eval.py:125-126:
// compute-dtype operands, float32 sums) for the fields the one-CTA tensor
// core kernels do not take: bf16 fields outside the wgmma kernel's envelope
// (field_eval.cu: wider than 704, or 640 with a beta head; fc_units not a
// multiple of 32; a transient code wider than 16), float32 fields wider
// than the wgmma_f32 kernel's 512 (field_eval_f32.cu), and fields of more
// than 16 semantic classes that those kernels refuse, up to W_MAX = 4096
// wide and any number of classes. For every point it computes the Siren
// trunk sin(30 W0 x), the sine layers with the input concatenated back in
// at the skip, then any subset of the heads (sigma, albedo, sun visibility,
// sky, beta, semantic logits), walking the layer program of `program` in
// ops/field_eval.py (the one-buffer program of the wgmma_f32 route).
//
// Numerics. Activations stay float32 between layers, in shared memory. The
// product policy is a template parameter:
// - float32: every product of a trunk or hidden head layer as three TF32
//   products, lo_a hi_b + hi_a lo_b + hi_a hi_b (hi = tf32_rna(a), lo =
//   tf32_rna(a - hi); the weights split when packed, the activations in
//   registers as they are loaded; lo_a lo_b, 2^-22 of the product, is
//   dropped), wgmma m64nNk8 into float32 accumulators, as
//   field_eval_f32.cu. The tensor cores round each wgmma's sum toward zero,
//   so one accumulator through the whole K drifts with the depth, 3 K / 8
//   roundings a column, all toward zero: against the plain float32 version
//   2.6e-5 at 1,024 wide, 5.5e-5 at 2,048 and 1.04e-4 at 4,096, past
//   F32_ATOL (1e-4). Past 1,024 wide (clusters of 4 and 8, SLAB_SUMS) a
//   chunk's six wgmmas of one 16-deep slab go to a fresh partial sum
//   instead, which is added to the accumulators rounded to nearest
//   (__fadd_rn): 2.7e-6 at 2,048, 3.9e-6 at 4,096. The partial takes 32
//   registers and a wait per chunk and slab, which cost the float32 launch
//   ~50% at 2,048 and 4,096 and ~60% at 1,024, where one accumulator keeps
//   0.26 of F32_ATOL and its time (utils/f32_sums.py emulates both forms
//   on the CPU and holds the kernel against a parent's on the card;
//   PERF.md section 6);
// - bf16: one bf16 product, wgmma m64nNk16, the activation rounded to bf16
//   (round to nearest even) as its A fragment is loaded and the weight when
//   packed: every use of an activation is a product operand, so this is the
//   TPU kernel's cast at the dot.
// The head outputs (1 to 3 columns, the semantic logits any number) are
// float32 FFMA sums of the same operands (rounded to bf16 in the bf16
// policy), taken from the registers of the layer before them. Bias and
// epilogues repeat the plain version op for op (field_epilogue.cuh).
//
// Bound. 2 FLOP a weight a point uses: 21.25 MFLOP for all heads of an
// 8x1024 field (19.14 for the solar pass), 12.00 at 768, 84.44 at 2048,
// 336.65 at 4096. On the tensor cores that is 8.06 ms (bf16, 989 TFLOP/s)
// or 48.3 ms (three TF32 products at 495 TFLOP/s) for the eval render's
// 374,976-point all-head launch at 1024, 32.0 / 191.9 ms at 2048 and
// 127.6 / 765.1 ms at 4096. Every 64-point tile also streams every weight
// it uses from L2 (2 bytes a weight in bf16, 8 as hi and lo in float32):
// 32 or 48 FLOP a byte, so L2 sits close behind the tensor cores, as in the
// one-CTA kernels.
//
// Design.
// - Why a cluster. A 64-point tile of a 1,024-wide field holds 256 KB of
//   float32 activations, and one layer's output is 65,536 accumulators: one
//   CTA (227 KB of shared memory, 64K registers) holds neither, and wgmma's
//   M of 64 does not let the tile shrink. C CTAs on SMs of one GPC, a
//   cluster (launched with cudaLaunchAttributeClusterDimension; C a
//   template parameter), share the tile: C is the smallest of 2, 4 and 8
//   with ceil64(width) / C <= SHARE_MAX (512), so 2 up to 1,024 wide, 4 up
//   to 2,048 and 8 up to 4,096; 8 is the H100's portable cluster size,
//   which caps the route at W_MAX. Every layer's output is padded to npad =
//   ceil(width, 32 C) columns, and CTA r (%cluster_ctarank) owns columns
//   [r h, (r + 1) h) of it, h = npad / C, whole chunks of 64 and 32, and
//   the same columns of the tile's activation buffer: at most 128 KB and 96
//   accumulators a thread, the budget of field_eval_f32.cu at 512.
// - A from registers, K from every CTA. For every k step a thread loads its
//   A fragment from the CTA that owns those K columns (a k step of 8 or 16
//   columns never straddles two CTAs' shares, which are multiples of 32):
//   its own buffer (ld.shared) or a peer's through distributed shared
//   memory (mapa.shared::cluster to that rank + ld.shared::cluster); the
//   owner is the same for the whole warp, found from the step's first
//   column by C - 1 compares. The next slab's fragments are loaded while
//   the current slab's products run. Each weight's K rows are reordered
//   within groups (`f32_k_order`, `bf16_k_order`) so that a thread's k
//   values are adjacent columns of the buffer: one 8-byte (float32) or
//   16-byte (bf16) load a row. The trunk input, sun and transient code are
//   read from device memory at the layers that use them.
// - Each CTA streams only its 1/C of every layer's weights through its own
//   ring of 8 KB stages, one bulk copy (cp.async.bulk) a stage, filled by
//   one producer thread that walks the program ahead across layers and
//   tiles: a stage is one K slab (16 rows as hi | lo in float32, 64 rows in
//   bf16) of one 64-wide chunk, each 128-byte row in the 128-byte swizzle
//   wgmma reads. Three consumer warpgroups own a layer's chunks j = wg,
//   wg + 3, wg + 6 and run the whole K, as field_eval_f32.cu.
// - Layer boundaries. A layer's output overwrites the buffer in place, so the
//   C CTAs meet twice a layer: once every thread of every CTA is done
//   reading the old activations (before any write), and once every share of
//   the new ones (and the head outputs' partial sums) is written (before the
//   next layer reads them). A meeting is the CTA's consumer barrier, then
//   one thread arrives on each of the C - 1 peers' mbarriers (release,
//   cluster scope) and waits on its own (acquire, cluster scope), then the
//   consumer barrier again (`meet`); the producer thread takes no part, so
//   the ring runs on across the boundary. The kernel opens with a cluster
//   barrier (the barriers are initialised) and the consumers close with a
//   meeting, so that no CTA exits while a peer can still read its shared
//   memory.
// - Why two meeting barriers a CTA. Each barrier expects C - 1 arrivals a
//   phase, one from each peer, and the waiter asks for the phase of one
//   parity. With one barrier a CTA, a peer can arrive for meeting k + 1 (it
//   needs only the arrivals for k on its own barrier, which come before
//   this CTA's wait) before this CTA's waiting thread has polled for k: the
//   phase then completes twice (at C = 2), or completes on a mix of
//   arrivals for k and k + 1 (C > 2), and the wait never ends or ends
//   early. The wide kernel's checks (utils/wide_checks.py) build that form
//   with a delay before the first poll, and it traps with the wait record
//   naming the meeting barrier. With two, meeting k takes barrier k % 2 at
//   parity k / 2 % 2, and every arrival for meeting k on a barrier precedes
//   every arrival for k + 2 on it: a peer y arrives for k + 2 only after
//   its wait for k + 1, which needs the arrival for k + 1 of every other
//   peer z (this CTA included), each of which follows z's arrivals for k in
//   program order; y's own arrival for k precedes it in program order. So
//   the barrier's phase for k completes on exactly the C - 1 arrivals for
//   k; and its phase for k + 2 needs this CTA's arrival for k + 1, which
//   comes after its wait for k, so each barrier completes at most one phase
//   ahead of its waiter (tests/test_torch_wide_meeting.py enumerates every
//   interleaving of a model of both forms at C = 2, 3 and 4).
// - Memory order across the cluster (PTX memory model). Consumer thread j
//   of a CTA reads the other CTAs' shares of the buffer
//   (ld.shared::cluster in `load_frag`) and, after the second meeting,
//   every CTA's head partials (`red`); a peer's consumer m overwrites them
//   after a later meeting. The chain from j's read to m's write, for every
//   j and m of any two CTAs: j's read precedes j's bar.sync in program
//   order; bar.sync synchronises j with thread 0 of its CTA (CTA scope);
//   thread 0's fence.acq_rel.cluster and its C - 1
//   mbarrier.arrive.release.cluster release at cluster scope, and a release
//   is cumulative, so it carries every operation that precedes it in
//   causality order, j's remote read included; the peer's thread 0
//   acquires every one of its C - 1 arrivals (try_wait.parity.acquire.
//   cluster completes after the last of them, then fence.acq_rel.cluster),
//   and its bar.sync synchronises it with m. Causality order is transitive,
//   so j's read happens before m's write, and the read cannot see it. The
//   same chain, writes first, orders each share's new activations and
//   partials before every read of them after the second meeting. The
//   partials of a head pass are read after the meeting that follows their
//   writes and written again only after a later meeting. The barriers: as
//   above, an arrival for k + 2 follows the acquire of every arrival for
//   k + 1, which follows the arrivals for k in program order; the cluster
//   barrier after mbarrier.init (fence.mbarrier_init.release.cluster,
//   barrier.cluster.arrive.release / wait.acquire) orders the
//   initialisation before any remote arrival. Besides, every remote load's
//   value is consumed (by a wgmma or a sum) before the thread reaches the
//   meeting's first bar.sync.
// - A timed wait. Every mbarrier wait that has polled for half of
//   WIDE_TRAP_CYCLES (~10 s) is taken for a deadlock: it writes which wait
//   it was (the meeting barrier, or the ring's full or empty barrier; its
//   CTA rank out of the cluster's C, cluster, thread, meeting or stage
//   index, parity and ring position) to a record in host memory that a
//   process can read after the trap
//   (`spnerf_field_eval_wide_wait_record`; without one nothing is
//   written), and traps once WIDE_TRAP_CYCLES (~20 s) have passed since it
//   began, so that the launch fails instead of holding the card and every
//   wait stuck with it has noted itself first (`stuck`). That code never
//   returns to the polling loop, so the loop's registers are the parent
//   form's (a record that returned to the loop cost the bf16 kernel spills
//   and 7-9% of its time).
// - Head outputs. Each CTA sums its K share from the registers of the
//   layer before: each thread's columns by FFMA, the four lanes of a row by
//   shuffles, the three warpgroups into shared memory; after the next
//   meeting CTA r writes rows [r 64 / C, (r + 1) 64 / C) of the tile, each
//   the 3 C partials added in a fixed order (rank 0's warpgroups 0, 1, 2,
//   then rank 1's, ...), so the result repeats. An output of more than
//   TAIL_N columns (the semantic logits of more than 16 classes) takes
//   ceil(n / TAIL_N) such passes of TAIL_N columns over the same registers,
//   with a meeting between two passes (every CTA is done reading the
//   partials before they are overwritten): the layer before keeps its
//   output in registers, so the activation buffer, which still holds the
//   trunk's output that feats reads next, is not needed, and the partials
//   stay at 12 KB a CTA. The alternative, the logits as one more chunked
//   wgmma layer, would need the hidden layer's output in a second buffer
//   (64 KB a CTA at 4,096 wide, which the ring could not give up). A layer
//   that feeds only a head output stays in registers.
// - A persistent grid of clusters, as many as fit on the card at once
//   (cudaOccupancyMaxActiveClusters for clusters of C), each one 64-point
//   tile at a time. 512 threads a CTA: three consumer warpgroups at
//   CONSUMER_REGS registers and a producer warpgroup at PRODUCER_REGS
//   (setmaxnreg within the CTA's launch allocation of 512 x 128; a copy
//   that moved 8 registers to the producer spilled more and ran slower).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "field_epilogue.cuh"
#include "hopper.cuh"

#define BM 64                      // points per tile
#define WGS 3                      // consumer warpgroups
#define CONSUMERS (WGS * 128)
#define THREADS (CONSUMERS + 128)  // plus one producer warpgroup
// registers a thread after setmaxnreg, within the launch allocation of
// 512 x 128: 128 x PRODUCER_REGS + 384 x CONSUMER_REGS <= 65,536
#define PRODUCER_REGS 24
#define CONSUMER_REGS 160
static_assert(128 * PRODUCER_REGS + CONSUMER_REGS * 384 <= 65536,
              "setmaxnreg stays within the launch allocation");
// WIDE_LOCAL_A 1 reads every A fragment from the CTA's own share of the
// buffer: a wrong answer, only a floor for what the peers' shares cost,
// built by utils/time_wide_variants.py alone; the route builds it 0
#ifndef WIDE_LOCAL_A
#define WIDE_LOCAL_A 0
#endif
// The meeting's stress switches, off in the route's build; built by
// utils/wide_checks.py alone. WIDE_MEET_DELAY_NS > 0: rank 0's meeting
// thread waits that long between its arrival and its first poll, at every
// meeting; WIDE_ONE_BARRIER 1: one meeting barrier a CTA, the form that can
// hang; WIDE_TRAP_CYCLES: how long a wait polls before it traps.
#ifndef WIDE_MEET_DELAY_NS
#define WIDE_MEET_DELAY_NS 0
#endif
#ifndef WIDE_ONE_BARRIER
#define WIDE_ONE_BARRIER 0
#endif
#ifndef WIDE_TRAP_CYCLES
#define WIDE_TRAP_CYCLES 40000000000LL
#endif
// The wait record: REC_KINDS counts, then REC_SLOTS records of REC_INTS ints
// a kind (WAIT_MEET, WAIT_FULL, WAIT_EMPTY); mirrored in utils/wide_checks.py
#define REC_KINDS 3
#define REC_SLOTS 16
#define REC_INTS 9
#define WAIT_MEET 0
#define WAIT_FULL 1
#define WAIT_EMPTY 2
#define NCH 64                     // output columns of a chunk
#define STAGE_BYTES (NCH * 128)    // 64 rows of 128 bytes
#define MAX_STAGES 12
#define CPW 3                      // chunks a warpgroup owns at most
#define SHARE_MAX 512              // columns a CTA owns at most
static_assert(SHARE_MAX <= CPW * WGS * NCH, "a CTA's chunks fit");
#define C_MAX 8                    // the H100's portable cluster size
#define W_MAX (SHARE_MAX * C_MAX)  // the widest field it takes
#define TAIL_N 16                  // the columns of one head output pass
#define RED_FLOATS (WGS * BM * TAIL_N)
#define SMEM_LIMIT 232448
#define MAX_OPS 32
#define OP_INTS 11

// One dense layer of the program (`_program_f32` in ops/field_eval.py), in
// the order the kernel runs them. A layer with out >= 0 is a head output: it
// runs on the registers of the layer before it; w_off: the byte offset of
// its float32 (k1, npad) row-major weight, k1 the padded width of the layer
// before (CTA r's rows [r k1 / C, (r + 1) k1 / C)), npad = ceil16(nreal)
// (TAIL_N up to 16 columns). Otherwise: npad = ceil(width, 32 C), each CTA
// h = npad / C columns; w_off: the byte offset of its weight stages, CTA
// r's at w_off + r * ns * h * 128 (ns = (k1 + k2) / KS slabs), stage (s, j)
// of a CTA at + (s * h + 64 j) * 128; k1, k2: the input segments' padded
// depths (k2 = 0 for one segment; the buffer's is the writing layer's npad,
// split between the CTAs as its output was, an input's a multiple of KS);
// a1, a2: the segments' sources (SRC_BUF0 or an input); dst: SRC_BUF0 to
// overwrite the buffer, -1 to keep the output in registers. b_off: float
// offset of the bias (zero-padded to npad); nreal: the real output width;
// epi: EPI_*.
struct Op {
  int w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out;
};

struct WideDesc {
  int n_ops, n_points, stages, share, k0, tdim;
  const float* xin;  // (n_points, k0)
  const float* sun;  // (n_points, 3)
  const float* tin;  // (n_points, tdim) or null
  const uint8_t* w;
  const float* b;
  float* out[6];
  Op op[MAX_OPS];
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// the shared::cluster address of shared::cta address `addr` in CTA `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// every thread of every CTA, once: the barriers each initialised are seen
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The record the timed waits write to (host memory mapped for the device),
// null unless `spnerf_field_eval_wide_wait_record` set it, and each kind's
// next free slot.
__device__ int* g_wait_record = nullptr;
__device__ int g_wait_slots[REC_KINDS];

// A wait past half of WIDE_TRAP_CYCLES is taken for a deadlock. It notes
// itself in the wait record (which barrier, the CTA's rank and cluster, the
// thread, the meeting or stage index, the parity it waits for, the ring
// position `it`, -1 at a meeting, and the cluster's CTAs, so that the rank
// reads as one out of C), holds still until WIDE_TRAP_CYCLES have
// passed since it began, so that every other wait stuck with it notes
// itself too, and traps. It never returns, so nothing of its caller is
// live across it: the polling loop keeps the registers it had.
__device__ __forceinline__ void stuck(int kind, int index, uint32_t parity,
                                      int it, long long start) {
  int* rec = g_wait_record;
  if (rec != nullptr) {
    const int slot = atomicAdd(&g_wait_slots[kind], 1);
    volatile int* count = rec + kind;
    *count = slot + 1;
    if (slot < REC_SLOTS) {
      uint32_t rank, cluster, ctas;
      asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
      asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(cluster));
      asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(ctas));
      volatile int* q =
          rec + REC_KINDS + (kind * REC_SLOTS + slot) * REC_INTS;
      q[0] = kind;
      q[1] = (int)rank;
      q[2] = (int)cluster;
      q[3] = (int)threadIdx.x;
      q[4] = index;
      q[5] = (int)parity;
      q[6] = it;
      q[7] = (int)ctas;
      q[8] = 1;  // written last: the record is whole
    }
    __threadfence_system();
  }
  while (clock64() - start <= WIDE_TRAP_CYCLES) __nanosleep(1000);
  __trap();
}

// Waits for the phase of parity `parity` of `bar` to complete: at cluster
// scope (a barrier the peer CTAs arrive on) or at the CTA's; past half of
// WIDE_TRAP_CYCLES, `stuck`.
template <bool CLUSTER>
__device__ __forceinline__ void wait_timed(uint32_t bar, uint32_t parity,
                                           int kind, int index, int it) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    if (CLUSTER)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > WIDE_TRAP_CYCLES / 2) {
      stuck(kind, index, parity, it, start);
    }
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The consumers of the cluster's C CTAs meet: every consumer thread's
// shared-memory reads and writes before it (its own CTA's and the peers')
// happen before every consumer thread's after it. `own_bar` is this CTA's
// pair of meeting barriers (each expecting C - 1 arrivals a phase), which
// the peers' pairs mirror; `k` counts meetings. Meeting k uses barrier
// k % 2 of the pair, at parity k / 2 % 2 (see "Why two meeting barriers a
// CTA" above); thread 0 arrives on that barrier of every peer, ranks
// rank + 1, ..., rank + C - 1 (mod C) in turn, then waits on its own.
template <int C>
__device__ __forceinline__ void meet(uint32_t own_bar, uint32_t rank,
                                     uint32_t& k) {
  named_sync(CONSUMERS);
  if (threadIdx.x == 0) {
#if WIDE_ONE_BARRIER
    const uint32_t off = 0, parity = k & 1;
#else
    const uint32_t off = 8 * (k & 1), parity = (k >> 1) & 1;
#endif
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
#pragma unroll
    for (int j = 1; j < C; ++j) {
      const uint32_t peer_bar = map_rank(own_bar + off, (rank + j) % C);
      asm volatile(
          "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
          :: "r"(peer_bar) : "memory");
    }
#if WIDE_MEET_DELAY_NS > 0
    if (rank == 0) {
      const unsigned long long t0 = global_ns();
      while (global_ns() - t0 < (unsigned long long)WIDE_MEET_DELAY_NS)
        __nanosleep(10000);
    }
#endif
    wait_timed<true>(own_bar + off, parity, WAIT_MEET, (int)k, -1);
    asm volatile("fence.acq_rel.cluster;" ::: "memory");
  }
  ++k;
  named_sync(CONSUMERS);
}

// float32 to TF32, round to nearest with ties away from zero (the host's
// `tf32_rna` in ops/field_eval.py is the same)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// two floats rounded to bf16 (nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// d (64 x N, float32) = A (64 x 8, TF32 in registers) x B (8 x N, TF32
// K-major in shared memory) + d where acc is 1, + 0 where it is 0 (the first
// product of a fresh partial sum); N = 64 or 32
__device__ __forceinline__ void tf32_n64(float* d, const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

__device__ __forceinline__ void tf32_n32(float* d, const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x N, float32) += A (64 x 16, bf16 in registers) x B (16 x N, bf16
// K-major in shared memory), N = 64 or 32
__device__ __forceinline__ void bf16_n64(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void bf16_n32(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------------- the kernel

// The product policy: a stage's K rows (KS), one wgmma's K (KSTEP) and the
// k steps of a stage (STEPS = KS / KSTEP).
template <bool BF16>
struct Policy {
  static constexpr int KS = BF16 ? 64 : 16;
  static constexpr int KSTEP = BF16 ? 16 : 8;
  static constexpr int STEPS = KS / KSTEP;
};

// Where the A fragments of a k step come from: the tile's buffer (a
// shared::cta pointer to this CTA's share and its shared::cta address,
// which mapa turns into any peer's share of the same columns; at C = 2 the
// one peer's, mapped once) or an input in device memory.
struct Src {
  const float* act;   // this CTA's share of the buffer
  uint32_t act_u32;   // its shared::cta address
  uint32_t peer_act;  // at C = 2, the peer's share (shared::cluster)
  uint32_t rank;
};

// The A fragment of the k step at column kb of source src (the segment's
// column, logical order = the weights' K order) for the thread's rows r
// and r + 8 of the tile, in wgmma's register order: float32 (TF32 k8: a0
// row r k t0, a1 row r + 8 k t0, a2 row r k t0 + 4, a3 row r + 8 k t0 + 4;
// `f32_k_order` puts k t0 and t0 + 4 at columns 2 t0 and 2 t0 + 1) as raw
// floats; bf16 (k16: a0 row r k 2 t0, 2 t0 + 1; a1 row r + 8; a2 row r k
// 2 t0 + 8, 2 t0 + 9; a3 row r + 8; `bf16_k_order` puts these at columns
// 4 t0 .. 4 t0 + 3) as bf16 pairs. Rows past n_points and columns past an
// input's width are zero. `share_in` is the columns of the buffer segment
// each CTA owns, a multiple of 32: the step's columns [kb, kb + KSTEP) lie
// in the share of one CTA, the owner, the same for every lane.
template <bool BF16, int C>
__device__ __forceinline__ void load_frag(const WideDesc& d, const Src& s,
                                          int src, int kb, int share_in,
                                          int r, int row0,
                                          uint32_t (&a)[4]) {
  const int t0 = threadIdx.x & 3;
  if (src == SRC_BUF0) {
    int owner = 0;
#pragma unroll
    for (int q = 1; q < C; ++q) owner += kb >= q * share_in;
    const int c = kb - owner * share_in + (BF16 ? 4 : 2) * t0;
    const int lc = c ^ ((r & 3) << 3);
    const int o0 = r * d.share + lc, o1 = (r + 8) * d.share + lc;
    const bool own = WIDE_LOCAL_A || owner == (int)s.rank;
    const uint32_t peer =
        C == 2 ? s.peer_act : own ? 0u : map_rank(s.act_u32, owner);
    if (BF16) {
      float4 v0, v1;
      if (own) {
        v0 = *reinterpret_cast<const float4*>(s.act + o0);
        v1 = *reinterpret_cast<const float4*>(s.act + o1);
      } else {
        v0 = ld_cluster4(peer + 4 * o0);
        v1 = ld_cluster4(peer + 4 * o1);
      }
      a[0] = pack_bf16(v0.x, v0.y);
      a[1] = pack_bf16(v1.x, v1.y);
      a[2] = pack_bf16(v0.z, v0.w);
      a[3] = pack_bf16(v1.z, v1.w);
    } else {
      float2 v0, v1;
      if (own) {
        v0 = *reinterpret_cast<const float2*>(s.act + o0);
        v1 = *reinterpret_cast<const float2*>(s.act + o1);
      } else {
        v0 = ld_cluster2(peer + 4 * o0);
        v1 = ld_cluster2(peer + 4 * o1);
      }
      a[0] = __float_as_uint(v0.x);
      a[1] = __float_as_uint(v1.x);
      a[2] = __float_as_uint(v0.y);
      a[3] = __float_as_uint(v1.y);
    }
    return;
  }
  const int c = kb + (BF16 ? 4 : 2) * t0;
  const float* g = src == SRC_X ? d.xin : src == SRC_SUN ? d.sun : d.tin;
  const int w = src == SRC_X ? d.k0 : src == SRC_SUN ? 3 : d.tdim;
  constexpr int NV = BF16 ? 4 : 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r + 8 * h;
    float x[NV];
#pragma unroll
    for (int e = 0; e < NV; ++e) x[e] = 0.0f;
    if (row < d.n_points) {
      const float* p = g + (size_t)row * w;
#pragma unroll
      for (int e = 0; e < NV; ++e)
        if (c + e < w) x[e] = __ldg(p + c + e);
    }
    if (BF16) {
      a[h] = pack_bf16(x[0], x[1]);
      a[2 + h] = pack_bf16(x[NV - 2], x[NV - 1]);
    } else {
      a[h] = __float_as_uint(x[0]);
      a[2 + h] = __float_as_uint(x[NV - 1]);
    }
  }
}

// The products of k step kk of a stage on one chunk of NC columns. float32:
// the fragment's hi and lo parts against the stage's hi half (bytes 0-63 of
// every row) and lo half (64-127), the small terms first, then hi x hi; the
// first adds to `acc`'s values where `keep` is 1 and overwrites them where it
// is 0. bf16: one product, the step's 32 bytes of every row, added.
template <bool BF16, int NC>
__device__ __forceinline__ void step_mma(float* acc, const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4],
                                         uint32_t stage, int kk, int keep) {
  if (BF16) {
    const uint64_t b = sdesc(stage + 32 * kk);
    if (NC == 64) bf16_n64(acc, hi, b);
    else bf16_n32(acc, hi, b);
  } else {
    const uint64_t bh = sdesc(stage + 32 * kk);
    const uint64_t bl = sdesc(stage + 64 + 32 * kk);
    if (NC == 64) {
      tf32_n64(acc, lo, bh, keep);
      tf32_n64(acc, hi, bl, 1);
      tf32_n64(acc, hi, bh, 1);
    } else {
      tf32_n32(acc, lo, bh, keep);
      tf32_n32(acc, hi, bl, 1);
      tf32_n32(acc, hi, bh, 1);
    }
  }
}

// bias and activation of the warpgroup's chunks in place: accumulator
// 4 i + 2 h + e is row r + 8 h, this CTA's column (wg + WGS c) * 64 + 8 i +
// 2 t0 + e; `bias` points at this CTA's first column's bias
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

template <bool BF16, int C>
__global__ void __launch_bounds__(THREADS, 1)
field_eval_wide_kernel(const __grid_constant__ WideDesc d) {
  using P = Policy<BF16>;
  // float32 past 1,024 wide: each slab's products into a fresh partial sum
  // ("Numerics" above)
  constexpr bool SLAB_SUMS = !BF16 && C > 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t ring = smem_u32(smem);
  float* act = reinterpret_cast<float*>(smem + d.stages * STAGE_BYTES);
  float* red = act + BM * d.share;
  const uint32_t full = smem_u32(red + RED_FLOATS);
  const uint32_t empty = full + 8 * d.stages;
  const uint32_t xbar = empty + 8 * d.stages;
  const uint32_t rank = cluster_rank();
  const int n_tiles = (d.n_points + BM - 1) / BM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < d.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * WGS);  // every consumer warp
    }
    mbar_init(xbar, C - 1);      // every peer's thread 0, at even meetings
    mbar_init(xbar + 8, C - 1);  // and at odd ones
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync_all();

  // the role, warp-uniform as the compiler sees it: warpgroups 0 .. WGS - 1
  // consume, the warp after them produces
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == WGS) {
    // producer: one thread walks the program and fills the ring with this
    // CTA's share of every layer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int t = cluster_id(); t < n_tiles; t += cluster_count()) {
        for (int i = 0; i < d.n_ops; ++i) {
          const Op& o = d.op[i];
          if (o.out >= 0) continue;
          const int ns = (o.k1 + o.k2) / P::KS;
          const int h = o.npad / C;
          const uint8_t* base =
              d.w + o.w_off + (size_t)rank * ns * h * 128;
          for (int s = 0; s < ns; ++s) {
            for (int n0 = 0; n0 < h; n0 += NCH, ++it) {
              const int slot = it % d.stages;
              const uint32_t bytes = min(NCH, h - n0) * 128;
              wait_timed<false>(empty + 8 * slot,
                                ((it / d.stages) & 1) ^ 1, WAIT_EMPTY, slot,
                                it);
              mbar_expect_tx(full + 8 * slot, bytes);
              bulk_copy(ring + slot * STAGE_BYTES,
                        base + ((size_t)s * h + n0) * 128, bytes,
                        full + 8 * slot);
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));

  const uint32_t act_u32 = smem_u32(act);
  const Src src_of{act, act_u32, map_rank(act_u32, rank ^ 1), rank};
  // the head outputs' partial sums, each rank's at this shared::cta address
  const uint32_t red_u32 = smem_u32(red);
  const int lane = threadIdx.x & 31;
  const int t0 = lane & 3;
  const int r = ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int sw = (r & 3) << 3;  // the row's swizzle (r + 8 has the same)
  uint32_t meetings = 0;
  int it = 0;
  for (int t = cluster_id(); t < n_tiles; t += cluster_count()) {
    const int row0 = t * BM;
    for (int i = 0; i < d.n_ops; ++i) {
      const Op& o = d.op[i];
      const int h = o.npad / C;  // this CTA's columns of the layer
      const int nch = (h + NCH - 1) / NCH;
      const int ns = (o.k1 + o.k2) / P::KS;
      int nc[CPW];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int j = wg + WGS * c;
        nc[c] = j < nch ? min(NCH, h - j * NCH) : 0;
      }
      float acc[CPW][32];
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
#pragma unroll
        for (int k = 0; k < 32; ++k) acc[c][k] = 0.0f;
        fence_operands(acc[c]);
      }
      // SLAB_SUMS: a chunk's partial sum over one slab
      float part[SLAB_SUMS ? 32 : 1];
#pragma unroll
      for (int k = 0; k < (SLAB_SUMS ? 32 : 1); ++k) part[k] = 0.0f;
      // the slab's A fragments; the next slab's are loaded while this
      // slab's products run. float32: raw floats, split at the products
      // (the wgmmas read the split registers only); bf16: the bf16 pairs
      // the wgmmas read, so the next slab's go to their own registers.
      uint32_t a[P::STEPS][4], an[P::STEPS][4];
      auto load_slab = [&](int s, uint32_t (&f)[P::STEPS][4]) {
#pragma unroll
        for (int kk = 0; kk < P::STEPS; ++kk) {
          const int kc = s * P::KS + kk * P::KSTEP;
          const bool seg2 = kc >= o.k1;
          load_frag<BF16, C>(d, src_of, seg2 ? o.a2 : o.a1,
                             seg2 ? kc - o.k1 : kc, o.k1 / C, r, row0,
                             f[kk]);
        }
      };
      if (nc[0]) load_slab(0, a);
      for (int s = 0; s < ns; ++s) {
        // every stage of the slab has landed; the others' go back at once
        int own[CPW];
#pragma unroll
        for (int c = 0; c < CPW; ++c) own[c] = -1;
        for (int j = 0; j < nch; ++j, ++it) {
          const int slot = it % d.stages;
          wait_timed<false>(full + 8 * slot, (it / d.stages) & 1, WAIT_FULL,
                            slot, it);
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
        if constexpr (!SLAB_SUMS) {
#pragma unroll
          for (int kk = 0; kk < P::STEPS; ++kk) {
            uint32_t hi[4], lo[4];
            if constexpr (BF16) {
#pragma unroll
              for (int e = 0; e < 4; ++e) hi[e] = lo[e] = a[kk][e];
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float v = __uint_as_float(a[kk][e]);
                hi[e] = tf32_rna(v);
                lo[e] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[e])));
              }
            }
            wgmma_fence();
#pragma unroll
            for (int c = 0; c < CPW; ++c) {
              const uint32_t st = ring + max(own[c], 0) * STAGE_BYTES;
              if (nc[c] == NCH) step_mma<BF16, 64>(acc[c], hi, lo, st, kk, 1);
              else if (nc[c]) step_mma<BF16, 32>(acc[c], hi, lo, st, kk, 1);
            }
          }
          wgmma_commit();
          if (s + 1 < ns) load_slab(s + 1, BF16 ? an : a);
          wgmma_wait<0>();
          if constexpr (BF16) {
#pragma unroll
            for (int kk = 0; kk < P::STEPS; ++kk)
#pragma unroll
              for (int e = 0; e < 4; ++e) a[kk][e] = an[kk][e];
          }
        } else {
          // float32: a chunk's 3 x STEPS products of the slab go to the
          // fresh partial sum `part` (the first overwrites it), which is
          // then added to the chunk's accumulators with one rounding to
          // nearest ("Numerics" above); the next slab's fragments load
          // while the first chunk's products run
          uint32_t hi[P::STEPS][4], lo[P::STEPS][4];
#pragma unroll
          for (int kk = 0; kk < P::STEPS; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = __uint_as_float(a[kk][e]);
              hi[kk][e] = tf32_rna(v);
              lo[kk][e] = tf32_rna(__fsub_rn(v, __uint_as_float(hi[kk][e])));
            }
          }
#pragma unroll
          for (int c = 0; c < CPW; ++c) {
            if (!nc[c]) continue;
            const uint32_t st = ring + max(own[c], 0) * STAGE_BYTES;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < P::STEPS; ++kk) {
              if (nc[c] == NCH)
                step_mma<BF16, 64>(part, hi[kk], lo[kk], st, kk, kk > 0);
              else
                step_mma<BF16, 32>(part, hi[kk], lo[kk], st, kk, kk > 0);
            }
            wgmma_commit();
            if (c == 0 && s + 1 < ns) load_slab(s + 1, a);
            wgmma_wait<0>();
            fence_operands(part);
#pragma unroll
            for (int k = 0; k < 32; ++k)
              if (k < 16 || nc[c] == NCH)
                acc[c][k] = __fadd_rn(acc[c][k], part[k]);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < CPW; ++c)
            if (own[c] >= 0) mbar_arrive(empty + 8 * own[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c) fence_operands(acc[c]);

      apply_rt(o.epi, acc, d.b + o.b_off + rank * h, wg, nc, t0);
      // every thread of every CTA is done reading the buffer's shares and
      // the last head output's partial sums
      meet<C>(xbar, rank, meetings);
      if (o.dst == SRC_BUF0) {
#pragma unroll
        for (int c = 0; c < CPW; ++c) {
          const int cb = (wg + WGS * c) * NCH + 2 * t0;
#pragma unroll
          for (int k = 0; k < NCH / 8; ++k) {
            if (8 * k < nc[c]) {
              const int col = (cb + 8 * k) ^ sw;
              *reinterpret_cast<float2*>(act + r * d.share + col) =
                  make_float2(acc[c][4 * k], acc[c][4 * k + 1]);
              *reinterpret_cast<float2*>(act + (r + 8) * d.share + col) =
                  make_float2(acc[c][4 * k + 2], acc[c][4 * k + 3]);
            }
          }
        }
      }
      // a head output after this layer: its passes of TAIL_N columns
      const bool tail = i + 1 < d.n_ops && d.op[i + 1].out >= 0;
      const Op& hd = d.op[tail ? i + 1 : i];
      const int passes = tail ? (hd.nreal + TAIL_N - 1) / TAIL_N : 1;
      for (int pass = 0; pass < passes; ++pass) {
        const int q0 = pass * TAIL_N;
        const int nq = tail ? min(TAIL_N, hd.nreal - q0) : 0;
        // every CTA is done reading the last pass's partial sums
        if (pass > 0) meet<C>(xbar, rank, meetings);
        if (tail) {
          // the pass's partial sums over this warpgroup's columns; CTA r's
          // rows of the (k1, npad) weight start at row r h
          const float* tw = reinterpret_cast<const float*>(d.w + hd.w_off)
                            + (size_t)rank * h * hd.npad + q0;
          for (int q = 0; q < nq; ++q) {
            float p0 = 0.0f, p1 = 0.0f;
#pragma unroll
            for (int c = 0; c < CPW; ++c) {
              const int cb = (wg + WGS * c) * NCH + 2 * t0;
#pragma unroll
              for (int k = 0; k < NCH / 8; ++k) {
                if (8 * k < nc[c]) {
#pragma unroll
                  for (int e = 0; e < 2; ++e) {
                    const float wv =
                        __ldg(tw + (size_t)(cb + 8 * k + e) * hd.npad + q);
                    float x0 = acc[c][4 * k + e], x1 = acc[c][4 * k + 2 + e];
                    if (BF16) {
                      x0 = round_bf16(x0);
                      x1 = round_bf16(x1);
                    }
                    p0 = fmaf(x0, wv, p0);
                    p1 = fmaf(x1, wv, p1);
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
        // every share of the buffer and every CTA's partial sums are
        // written
        meet<C>(xbar, rank, meetings);
        if (tail) {
          // rows [rank rows, (rank + 1) rows) of the tile, the partials of
          // rank 0, 1, ..., C - 1, each CTA's warpgroups in order
          float* out = d.out[hd.out];
          constexpr int rows = BM / C;
          for (int idx = threadIdx.x; idx < rows * nq; idx += CONSUMERS) {
            const int row = rank * rows + idx / nq;
            const int q = idx % nq;
            float v = 0.0f;
#pragma unroll
            for (int g = 0; g < C * WGS; ++g) {
              const uint32_t off =
                  4 * (((g % WGS) * BM + row) * TAIL_N + q);
              const float p = ld_cluster(map_rank(red_u32, g / WGS) + off);
              v = g ? __fadd_rn(v, p) : p;
            }
            v = activate_rt(hd.epi, __fadd_rn(v, d.b[hd.b_off + q0 + q]));
            if (row0 + row < d.n_points)
              out[(size_t)(row0 + row) * hd.nreal + q0 + q] = v;
          }
        }
      }
      if (tail) ++i;
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  meet<C>(xbar, rank, meetings);
}

// ------------------------------------------------------------------- host

static int ceil_to(int x, int m) { return (x + m - 1) / m * m; }

// The cluster's CTAs at `width`: the smallest of 2, 4 and 8 with
// ceil64(width) / C <= SHARE_MAX; 0 outside 2 .. W_MAX.
static int cluster_of(int width) {
  if (width < 2 || width > W_MAX) return 0;
  for (int c = 2; c <= C_MAX; c *= 2)
    if (ceil_to(width, 64) <= SHARE_MAX * c) return c;
  return 0;
}

// The buffer columns a CTA of a cluster of `c` owns at `width`: the
// width padded to 32 c, over c.
static int share_cols(int width, int c) {
  return ceil_to(width, 32 * c) / c;
}

// Dynamic shared memory of a launch: 1 KB of slack for the 1,024-byte
// alignment of the stages, the ring with its barriers, the two meeting
// barriers (16 bytes), the CTA's share of the activation buffer (64 x
// ceil(width, 32 C) / C floats) and the head outputs' partial sums.
static int smem_bytes(int width, int stages, int c) {
  return 1024 + stages * (STAGE_BYTES + 16) + 16
         + BM * share_cols(width, c) * 4 + RED_FLOATS * 4;
}

static bool cluster_ok(int c) { return c == 2 || c == 4 || c == 8; }

// The weight ring's depth of a launch at `width` on clusters of `c`:
// MAX_STAGES, or as many stages as fit in shared memory beside the buffer
// share; 0 where fewer than a CTA's chunks of a layer fit, the field is
// outside 2 .. W_MAX, c is not 2, 4 or 8, or a CTA's share would exceed
// SHARE_MAX: a launch the route does not take.
static int stages_of(int width, int c) {
  if (width < 2 || width > W_MAX || !cluster_ok(c)
      || share_cols(width, c) > SHARE_MAX)
    return 0;
  const int least = (share_cols(width, c) + NCH - 1) / NCH;
  for (int s = MAX_STAGES; s >= 2 && s >= least; --s)
    if (smem_bytes(width, s, c) <= SMEM_LIMIT) return s;
  return 0;
}

// whether the program rows fit the launch's buffer, ring and inputs
template <bool BF16, int C>
static bool ops_ok(const WideDesc& d) {
  const int ks = Policy<BF16>::KS;
  for (int i = 0; i < d.n_ops; ++i) {
    const Op& o = d.op[i];
    if (o.b_off < 0 || o.b_off % 2 || o.nreal <= 0 || o.nreal > o.npad
        || o.epi < EPI_SIN30 || o.epi > EPI_SIGMOID || o.w_off < 0)
      return false;
    if (o.out >= 0) {
      if (i == 0 || d.op[i - 1].out >= 0 || o.out > 5 || !d.out[o.out]
          || o.npad != ceil_to(o.nreal, TAIL_N)
          || o.k1 != d.op[i - 1].npad || o.w_off % 16)
        return false;
      continue;
    }
    const int srcs[2] = {o.a1, o.a2};
    const int depth[2] = {o.k1, o.k2};
    for (int g = 0; g < 2; ++g) {
      if (g == 1 && depth[g] == 0) continue;
      const int s = srcs[g];
      if (depth[g] <= 0 || depth[g] % ks) return false;
      if (s == SRC_BUF0 ? g == 1 || depth[g] % (32 * C)
                              || depth[g] / C > d.share
          : s == SRC_X ? d.k0 < 1
          : s == SRC_SUN ? false
          : s == SRC_T ? d.tdim < 1 || !d.tin : true)
        return false;
    }
    if (o.npad <= 0 || o.npad % (32 * C) || o.npad / C > d.share
        || (o.npad / C + NCH - 1) / NCH > d.stages || o.w_off % 16
        || (o.dst != SRC_BUF0 && o.dst != -1))
      return false;
  }
  return d.n_ops > 0 && d.op[0].out < 0;
}

template <bool BF16, int C>
static cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      field_eval_wide_kernel<BF16, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (err == cudaSuccess) done = true;
  return err;
}

// A launch configuration of `clusters` clusters of C CTAs at `smem` bytes;
// `attr` holds its cluster dimension.
template <int C>
static cudaLaunchConfig_t launch_config(int clusters, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * clusters, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// clusters of C CTAs of the kernel that fit on the card at once at `smem`
// bytes
template <bool BF16, int C>
static cudaError_t max_clusters(int smem, int* n) {
  cudaError_t err = opt_in<BF16, C>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(1, smem, 0, &attr);
  return cudaOccupancyMaxActiveClusters(n, field_eval_wide_kernel<BF16, C>,
                                        &cfg);
}

// The persistent grid (as many clusters as fit, at most one a tile) on
// `stream`.
template <bool BF16, int C>
static cudaError_t launch(const WideDesc& d, int smem, cudaStream_t stream) {
  if (!ops_ok<BF16, C>(d)) return cudaErrorInvalidValue;
  int clusters = 0;
  cudaError_t err = max_clusters<BF16, C>(smem, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const int n_tiles = (d.n_points + BM - 1) / BM;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<C>(
      n_tiles < clusters ? n_tiles : clusters, smem, stream, &attr);
  void* args[] = {const_cast<WideDesc*>(&d)};
  err = cudaLaunchKernelExC(
      &cfg, reinterpret_cast<const void*>(field_eval_wide_kernel<BF16, C>),
      args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// `launch` or `max_clusters` at the run-time policy and cluster size
#define WIDE_DISPATCH(FN, bf16, c, ...)                                   \
  ((bf16) ? ((c) == 2   ? FN<true, 2>(__VA_ARGS__)                        \
             : (c) == 4 ? FN<true, 4>(__VA_ARGS__)                        \
                        : FN<true, 8>(__VA_ARGS__))                       \
          : ((c) == 2   ? FN<false, 2>(__VA_ARGS__)                       \
             : (c) == 4 ? FN<false, 4>(__VA_ARGS__)                       \
                        : FN<false, 8>(__VA_ARGS__)))

extern "C" {

// The cluster's CTAs the route takes at `width` (2, 4 or 8), or 0 where it
// takes no field of that width.
int spnerf_field_eval_wide_cluster(int width) { return cluster_of(width); }

// The weight ring's depth of a launch at `width` on clusters of `cluster`
// CTAs (`stages_of`); 0 where the route takes no such launch.
int spnerf_field_eval_wide_stages(int width, int cluster) {
  return stages_of(width, cluster);
}

int spnerf_field_eval_wide_smem(int width, int stages, int cluster) {
  return smem_bytes(width, stages, cluster);
}

// Clusters of `cluster` CTAs that fit on the card at once at `width` in the
// policy (cudaOccupancyMaxActiveClusters), or -(cudaError_t) on an error.
int spnerf_field_eval_wide_clusters(int width, int bf16, int cluster) {
  const int stages = stages_of(width, cluster);
  if (stages == 0) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = WIDE_DISPATCH(
      max_clusters, bf16, cluster, smem_bytes(width, stages, cluster), &n);
  return err == cudaSuccess ? n : -(int)err;
}

// op_rows: host array of n_ops x OP_INTS ints, the fields of Op in order.
// xin (n_points, k0), sun (n_points, 3), tin (n_points, tdim) float32,
// row-major; tdim = 0 without a transient input; bf16 selects the bf16
// policy (else 3xTF32); cluster: the CTAs of a cluster (2, 4 or 8), as the
// weights were packed for. Launches on `stream` and returns a cudaError_t
// (0 on success); does not synchronise.
int spnerf_field_eval_wide(const void* xin, const void* sun, const void* tin,
                           const void* w, const void* b, const void* op_rows,
                           int n_ops, int width, int k0, int tdim,
                           int n_points, int bf16, int cluster,
                           void* o_sigma, void* o_rgb, void* o_sun,
                           void* o_sky, void* o_beta, void* o_sem,
                           void* stream) {
  const int stages = stages_of(width, cluster);
  if (n_ops < 1 || n_ops > MAX_OPS || n_points <= 0 || stages == 0
      || k0 < 1 || tdim < 0)
    return (int)cudaErrorInvalidValue;
  WideDesc d;
  d.n_ops = n_ops;
  d.n_points = n_points;
  d.stages = stages;
  d.share = share_cols(width, cluster);
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
  return (int)WIDE_DISPATCH(launch, bf16, cluster, d,
                            smem_bytes(width, stages, cluster),
                            (cudaStream_t)stream);
}

// The wait record of this library's launches: (REC_KINDS + REC_KINDS *
// REC_SLOTS * REC_INTS) ints of host memory mapped for the device, zeroed,
// which the timed waits of later launches write to and a process can read
// after a trap. Returns its host address (the same one, zeroed again, on
// every call), or null on an error.
void* spnerf_field_eval_wide_wait_record() {
  static int* host = nullptr;
  const size_t bytes =
      (REC_KINDS + REC_KINDS * REC_SLOTS * REC_INTS) * sizeof(int);
  if (host == nullptr
      && cudaHostAlloc((void**)&host, bytes, cudaHostAllocMapped)
             != cudaSuccess) {
    host = nullptr;
    return nullptr;
  }
  memset(host, 0, bytes);
  int* dev = nullptr;
  const int zeros[REC_KINDS] = {0};
  if (cudaHostGetDevicePointer((void**)&dev, host, 0) != cudaSuccess
      || cudaMemcpyToSymbol(g_wait_record, &dev, sizeof(dev)) != cudaSuccess
      || cudaMemcpyToSymbol(g_wait_slots, zeros, sizeof(zeros))
             != cudaSuccess)
    return nullptr;
  return host;
}

const char* spnerf_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
