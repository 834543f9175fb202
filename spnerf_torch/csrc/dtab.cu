// Hash-table gradient on Hopper (sm_90a):
//   dtab[t, f] = sum_m [ids_m == t] * ct[m, f]
// for ids (M,) in [0, t_eff) (int32 or int64, read at their own width) and
// a cotangent of M rows of F float32 values, into a float32 table of t_eff
// rows of F. Ids outside [0, t_eff) are dropped, as an XLA scatter drops
// them.
//
// Layouts. Every entry point takes `tmajor`: 0 is the feature-major layout
// of the flat table (ct (F, M), out (F, t_eff)), 1 the t-major layout of the
// (L, T, F) table (ct (M, F), out (t_eff, F)). The arithmetic is the same;
// only the two index functions below differ.
//
// B2 and B4, `spnerf_dtab_scatter`, replace the Pallas kernel `dtab_pallas`
// (spnerf_tpu/ops/pallas/dtab.py, `_kernel_cols` / `_kernel`) and the
// batched cross-level form `dtab_sorted_window_batched` (same file,
// `_win_kernel_b`). B3, `spnerf_dtab_owner`, replaces the accumulating
// branch of `dtab_sorted_window` (`_win_kernel_acc_cols` /
// `_win_kernel_acc`), B3', `spnerf_dtab_tile_agg`, its non-accumulating
// branch (`_win_kernel` and the tile scatter after it). The TPU kernels
// compute the scatter-add as factorized one-hot matmuls because the TPU has
// no fast scatter; Hopper has float atomics in shared and global memory and
// fast shared-memory warp primitives, so no kernel here builds a one-hot.
//
// Bound: bytes. The function reads M * (id bytes + 4F) bytes and writes
// 4 F t_eff bytes and does M * F additions, far below the card's 295
// FLOP/byte ridge. What limits the kernels in practice is contention: the
// hash ids of the coarse levels repeat thousands of times (every ray crosses
// the cells near the scene's centre), and additions to one address
// serialise.
//
// B2 and B4, `spnerf_dtab_scatter`: one pass over the rows, in their order,
// with warp-merged rows and float atomics; no sort, no private table. One C
// call zeroes the table (`cudaMemsetAsync`) and makes one launch. B4 takes
// all L levels of an (L, T, F) table at once: the rows come level by level,
// (L, M) row-major, and row m of level l adds to table row l * T + id. B2
// is the same kernel with L = 1, in either layout. An id is compared with
// [0, T) at its own width and dropped outside it, so nothing wraps and
// nothing spills into the next level. A warp takes 32 consecutive rows: in
// the hash step, the 8 corners of 4 consecutive samples of a ray, which
// share cells on the coarse levels. Where some row's key equals the key 8
// lanes back (one shuffle and one ballot), the warp groups its equal keys
// (`__match_any_sync`), sums each group by pointer jumping, and only the
// group's last member adds; a warp without such a repeat (the hashed fine
// levels, nearly always) adds every row as it is, one atomic a row and
// nothing else. The atomics resolve in the 50 MB L2, which holds B2's whole
// table (128 KB at t_eff 8,192, F 4) and the 8 MB level of B4's table that
// the rows are on: one 16-byte `red.global.add.v4.f32` a row in the t-major
// layout at F = 4 (where `index_add_` makes four), a float2 one at F = 2, F
// scalar ones otherwise. Each row is read once, 16 bytes a lane where the
// layout allows; the bound is the bytes above. This replaces, in B4, a keys
// kernel, a library sort of the L * M keys and a keyed chunk scan, and in
// B2 a private copy of the table in every block's shared memory (one 8-warp
// block an SM); the host pays one ctypes call and one `torch.empty`. The
// order of the additions follows the atomics, so the last bits vary from
// run to run, as the JAX package lets them vary among equal ids with its
// unstable sorts (spnerf_tpu/ops/pallas/dtab.py:46-58).
//
// B3, `spnerf_dtab_owner`: owner-computes, deterministic, no sort. It
// replaces the accumulating branch of `dtab_sorted_window`
// (spnerf_tpu/ops/pallas/dtab.py:434-473, `pallas_call` :439), which
// accumulates in the kernel into one output tile per window of table rows.
// Here a block owns a window of S table rows (S * F floats, 32 KB at most,
// in shared memory; S from F and the card's opt-in shared memory) and writes
// each of them exactly once, zeros included, so the output needs no zero
// fill. A slice is the wps windows of table rows [s * span, (s + 1) * span),
// span = wps * S, with wps as small as keeps the slices at 1,024 or fewer
// (1 up to t_eff = 2^21 at F = 4). Five launches in one C call, every call:
//   1. count: per tile of 2,048 rows, the rows of each slice (id / span);
//   2. scan: one block per slice turns its per-tile counts into offsets;
//   3. scatter: a stable partition of the rows by slice. A row's rank in its
//      tile is its rank among its warp's rows of the slice plus the earlier
//      warps' and rounds' counts, so the order is the rows' own. The
//      cotangent rides along as payload, read coalesced in either layout,
//      the int64 or int32 ids read as they are; ids outside [0, t_eff) are
//      dropped here. The tile is grouped by slice in shared memory first, so
//      the writes to each slice's region are coalesced;
//   4. accumulate: a block per part of at most 4,096 rows of a slice walks
//      them in partition order, once per window of the slice, in chunks of
//      512 staged by 16-byte `cp.async` into a two-buffer ring (each slice's
//      region starts 16-byte aligned). Table row t of the window belongs to
//      warp t % 8: a stable ballot pass bins the chunk's rows by owner, then
//      each warp sums its bin 32 rows at a time, equal ids found by one
//      ballot per id bit, each group summed in lane order by pointer jumping
//      and added to the shared-memory window by its last member. No atomics:
//      the order of additions follows the rows, so the result is the same
//      bits from run to run. The part of a slice in one part writes `out`;
//      a part of a split slice leaves its sums in scratch;
//   5. merge: block p of a split slice adds stripe p of its parts' sums in
//      the parts' order and writes it; the blocks of the other slices return
//      at once. The launch is made on every call: whether a slice is split
//      is known on the card only.
// The plan (S, wps, slices, scratch) is `owner_plan`, one function that the
// wrapper reads through `spnerf_dtab_owner_plan` to size the scratch.
//
// B3', `spnerf_dtab_tile_agg`: per-tile aggregation, then float atomics, no
// sort. It replaces the non-accumulating branch (same file, :474-501,
// `pallas_call` :475): partials per block of rows, then a scatter of the
// partials into the table. Here one block takes 1,024 consecutive rows,
// merges equal ids in a shared-memory open-addressing table of (id, F sums)
// with shared atomics, and adds each distinct id's sums to the table with
// global float atomics (one float2 / float4 atomic per id in the t-major
// layout at F = 2 / 4). The zero fill is a `cudaMemsetAsync` in the same C
// call. The last bits vary from run to run, as in B2.
//
// B3 and B3': the bound is bytes, M * (id bytes + 4F) read and 4 F t_eff
// written. What they do about the host: one C call per wrapper call carries
// every launch, the wrapper allocates with `torch.empty` only and converts
// nothing (B3's scratch size is asked of the C side once per shape and
// kept).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#define MAXF 8
#define FULL_MASK 0xffffffffu
// B2 and B4
#define SCATTER_THREADS 256  // rows per block, one a thread
// B3
#define B3_THREADS 256                 // every B3 kernel's block
#define B3_WARPS (B3_THREADS / 32)     // a power of two: table row t -> warp t % 8
#define PART_ROUNDS 8
#define PART_TILE (B3_THREADS * PART_ROUNDS)  // rows per partition block
#define MAX_SLICES 1024
#define SLICES_PER_THREAD (MAX_SLICES / B3_THREADS)
#define ACC_CHUNK 512  // rows staged per chunk: 16 steps of 32, 4 per quarter
#define ACC_RING 2     // chunk buffers: ACC_RING - 1 chunks in flight
#define ACC_CAP 4096   // rows per summing block: a slice with more is split
#define SLICE_BYTES (32 * 1024)  // a summing block's window of the table
#define ACC_STEPS_PER_WARP (ACC_CHUNK / 32 / B3_WARPS)  // binning steps
#define ACC_QSTEPS (ACC_CHUNK / 32 / 4)  // steps per quarter of a chunk
// B3'
#define AGG_THREADS 256
#define AGG_TILE 1024   // rows per block
#define AGG_SLOTS 2048  // hash slots per block: twice the rows, a power of two
#define AGG_ROWS (AGG_TILE / AGG_THREADS)  // rows per thread

// element f of cotangent row m
__device__ __forceinline__ size_t ct_index(int m, int f, int M, int F,
                                           int tmajor) {
  return tmajor ? (size_t)m * F + f : (size_t)f * M + m;
}

// element f of table row t
__device__ __forceinline__ size_t out_index(int t, int f, int F, int t_eff,
                                            int tmajor) {
  return tmajor ? (size_t)t * F + f : (size_t)f * t_eff + t;
}

// ------------------------------------------------ B2 and B4: one pass

// v[0, F) becomes the sum of v over the members of this lane's group
// (`peers`, this lane included) at or below this lane, by pointer jumping:
// after round k a lane holds the sum of the 2^(k+1) members ending at it.
// The group's last member ends with the group's total. Every lane of the
// warp calls it. (B3's summing pass keeps its own loop, which shuffles all
// MAXF values without a branch: through this one it took 2-4% more device
// time.)
__device__ __forceinline__ void group_sum(unsigned peers, float* v, int F) {
  const int lane = threadIdx.x & 31;
  int prev = 31 - __clz(peers & ((1u << lane) - 1));  // the member below, or -1
  while (__any_sync(FULL_MASK, prev >= 0)) {
    const int src = prev >= 0 ? prev : lane;
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      if (f < F) {  // F is the same in every lane
        const float u = __shfl_sync(FULL_MASK, v[f], src);
        if (prev >= 0) v[f] += u;
      }
    }
    const int pp = __shfl_sync(FULL_MASK, prev, src);
    if (prev >= 0) prev = pp;
  }
}

// Rows [0, L * M) of ids (L, M) and ct (L * M rows of F): row i, of level
// l = i / M, adds to table row l * T + id of out (L * T rows of F), zeroed
// before; ids outside [0, T) are dropped. One row a thread, so a warp holds
// 32 consecutive rows. vec 4 (2): the t-major layout at F = 4 (2) with ct
// and out aligned for float4 (float2) loads and atomics.
template <typename Id>
__global__ void __launch_bounds__(SCATTER_THREADS)
    dtab_scatter_kernel(const Id* __restrict__ ids,
                        const float* __restrict__ ct, int L, int M, int F,
                        int T, int tmajor, int vec, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = L * M;
  const int i = blockIdx.x * SCATTER_THREADS + threadIdx.x;
  int key = -1;  // l * T + id, or -1 for a row that is dropped
  float v[MAXF] = {};
  if (i < n) {
    const Id id = ids[i];
    if (id >= 0 && id < (Id)T) key = i / M * T + (int)id;
    if (vec == 4) {
      const float4 u = __ldg((const float4*)ct + i);
      v[0] = u.x;
      v[1] = u.y;
      v[2] = u.z;
      v[3] = u.w;
    } else if (vec == 2) {
      const float2 u = __ldg((const float2*)ct + i);
      v[0] = u.x;
      v[1] = u.y;
    } else {
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) v[f] = __ldg(ct + ct_index(i, f, n, F, tmajor));
    }
  }
  // merge the warp's equal keys only where a row repeats the key 8 lanes
  // back: in the hash step, the same corner of the previous sample of a ray
  const int back = __shfl_up_sync(FULL_MASK, key, 8);
  bool adds = key >= 0;
  if (__any_sync(FULL_MASK, adds && lane >= 8 && back == key)) {
    const unsigned peers = __match_any_sync(FULL_MASK, key);
    group_sum(peers, v, F);
    adds = adds && (peers >> lane) == 1u;  // the group's last member
  }
  if (!adds) return;
  if (vec == 4) {
    atomicAdd((float4*)out + key, make_float4(v[0], v[1], v[2], v[3]));
  } else if (vec == 2) {
    atomicAdd((float2*)out + key, make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) atomicAdd(&out[out_index(key, f, F, L * T, tmajor)], v[f]);
  }
}

// ------------------------------------------------- B3: owner-computes slices

// the slice of an id, or -1 for an id outside [0, t_eff)
template <typename Id>
__device__ __forceinline__ int slice_of(Id id, int t_eff, int span) {
  return (id >= 0 && id < (Id)t_eff) ? (int)id / span : -1;
}

// The lanes of the warp whose valid keys agree with this lane's in bits
// [lo, hi), by one ballot per bit (`__match_any_sync` takes an iteration
// per distinct key, and a warp of hashed ids holds 32 of them). An invalid
// lane matches only itself.
__device__ __forceinline__ unsigned match_bits(int key, bool valid, int lo,
                                               int hi) {
  unsigned peers = __ballot_sync(FULL_MASK, valid);
  for (int b = lo; b < hi; ++b) {
    const bool bit = (key >> b) & 1;
    const unsigned m = __ballot_sync(FULL_MASK, bit);
    peers &= bit ? m : ~m;
  }
  return valid ? peers : 1u << (threadIdx.x & 31);
}

// Exclusive scan of x over a block of B3_THREADS threads; *total gets the
// sum. Every thread of the block calls it; warp_sums holds B3_WARPS + 1 ints
// of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int x, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int ws = lane < B3_WARPS ? warp_sums[lane] : 0;
    int wi = ws;
#pragma unroll
    for (int o = 1; o < B3_WARPS; o <<= 1) {
      const int u = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += u;
    }
    if (lane < B3_WARPS) warp_sums[lane] = wi - ws;
    if (lane == B3_WARPS - 1) warp_sums[B3_WARPS] = wi;
  }
  __syncthreads();
  const int excl = warp_sums[warp] + incl - x;
  *total = warp_sums[B3_WARPS];
  __syncthreads();  // warp_sums may be reused
  return excl;
}

// Where each slice's rows lie in the partitioned arrays, from the slices'
// row totals: start[s], regions padded to 4 rows so that every region and
// every chunk of one begins 16-byte aligned, start[n_slices] the end. With
// pstart: the parts before slice s (a slice of n rows is summed in
// max(1, ceil(n / ACC_CAP)) parts), pstart[n_slices] all of them. Every
// thread of a B3_THREADS block calls it.
__device__ void slice_layout(const int* __restrict__ total, int n_slices,
                             int* start, int* pstart, int* warp_sums) {
  const int s0 = threadIdx.x * SLICES_PER_THREAD;
  int rows[SLICES_PER_THREAD], parts[SLICES_PER_THREAD], rsum = 0, psum = 0;
#pragma unroll
  for (int k = 0; k < SLICES_PER_THREAD; ++k) {
    const int s = s0 + k;
    const int n = s < n_slices ? total[s] : 0;
    rows[k] = (n + 3) & ~3;
    parts[k] = s < n_slices ? max(1, (n + ACC_CAP - 1) / ACC_CAP) : 0;
    rsum += rows[k];
    psum += parts[k];
  }
  int all;
  int r = block_exclusive_scan(rsum, warp_sums, &all);
  int p = block_exclusive_scan(psum, warp_sums, &all);
#pragma unroll
  for (int k = 0; k < SLICES_PER_THREAD; ++k) {
    if (s0 + k < n_slices) {
      start[s0 + k] = r;
      if (pstart) pstart[s0 + k] = p;
    }
    r += rows[k];
    p += parts[k];
  }
  if (threadIdx.x == B3_THREADS - 1) {
    start[n_slices] = r;
    if (pstart) pstart[n_slices] = p;
  }
  __syncthreads();
}

// B3 launch 1: counts[tile * n_slices + s], the rows of slice s in the tile.
template <typename Id>
__global__ void __launch_bounds__(B3_THREADS)
    slice_count_kernel(const Id* __restrict__ ids, int M, int t_eff,
                       int span, int n_slices, int* __restrict__ counts) {
  __shared__ int cnt[MAX_SLICES];
  for (int s = threadIdx.x; s < n_slices; s += B3_THREADS) cnt[s] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int sl[PART_ROUNDS];  // every load in flight at once
#pragma unroll
  for (int r = 0; r < PART_ROUNDS; ++r) {
    const int m = blockIdx.x * PART_TILE + r * B3_THREADS + threadIdx.x;
    sl[r] = m < M ? slice_of(ids[m], t_eff, span) : -1;
  }
  const int bits = 32 - __clz(n_slices - 1);  // of a slice index
#pragma unroll
  for (int r = 0; r < PART_ROUNDS; ++r) {  // one shared atomic per slice a warp
    const unsigned peers = match_bits(sl[r], sl[r] >= 0, 0, bits);
    if (sl[r] >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[sl[r]], __popc(peers));
  }
  __syncthreads();
  for (int s = threadIdx.x; s < n_slices; s += B3_THREADS)
    counts[(size_t)blockIdx.x * n_slices + s] = cnt[s];
}

// B3 launch 2, block s: toff[tile * n_slices + s], the rows of slice s in the
// tiles before `tile`; total[s], all of them.
__global__ void __launch_bounds__(B3_THREADS)
    slice_tile_scan_kernel(const int* __restrict__ counts, int n_slices,
                           int n_tiles, int* __restrict__ toff,
                           int* __restrict__ total) {
  __shared__ int warp_sums[B3_WARPS + 1];
  const int s = blockIdx.x;
  int carry = 0, all;
  for (int t0 = 0; t0 < n_tiles; t0 += B3_THREADS) {
    const int t = t0 + threadIdx.x;
    const int c = t < n_tiles ? counts[(size_t)t * n_slices + s] : 0;
    const int e = block_exclusive_scan(c, warp_sums, &all);
    if (t < n_tiles) toff[(size_t)t * n_slices + s] = carry + e;
    carry += all;
  }
  if (threadIdx.x == 0) total[s] = carry;
}

// B3 launch 3: the rows of tile blockIdx.x grouped by slice in shared
// memory, in their own order (round, then warp, then lane), then written to
// their slices' regions, coalesced: pid (Mp,) gets the id, pval (F, Mp) the
// cotangent.
template <typename Id>
__global__ void __launch_bounds__(B3_THREADS)
    slice_scatter_kernel(const Id* __restrict__ ids,
                         const float* __restrict__ ct, int M, int F,
                         int t_eff, int tmajor, int span, int n_slices,
                         const int* __restrict__ counts,
                         const int* __restrict__ toff,
                         const int* __restrict__ total, int Mp,
                         int* __restrict__ pid, float* __restrict__ pval) {
  extern __shared__ int tile_rows[];  // [PART_TILE] ids, [F][PART_TILE] values
  float* tile_vals = (float*)(tile_rows + PART_TILE);
  __shared__ int start[MAX_SLICES + 1];  // slice regions, then row deltas
  __shared__ int run[MAX_SLICES];        // next row of slice s in the tile
  __shared__ unsigned short wcnt[B3_WARPS][MAX_SLICES];  // a round's counts
  __shared__ int warp_sums[B3_WARPS + 1];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int bits = 32 - __clz(n_slices - 1);  // of a slice index

  // round r + 1's row is loaded while the layout is computed and round r is
  // placed
  Id id_next = 0;
  float v_next[MAXF] = {};
  auto load = [&](int r) {
    const int m = tile * PART_TILE + r * B3_THREADS + threadIdx.x;
    if (m >= M) return;
    id_next = ids[m];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) v_next[f] = ct[ct_index(m, f, M, F, tmajor)];
  };
  load(0);

  slice_layout(total, n_slices, start, nullptr, warp_sums);
  // the tile's slices in order: run[s] = the rows of slices before s;
  // start[s] becomes the offset from a row's place in the tile to its place
  // in the partitioned arrays
  const int s0 = threadIdx.x * SLICES_PER_THREAD;
  int c[SLICES_PER_THREAD], csum = 0;
#pragma unroll
  for (int k = 0; k < SLICES_PER_THREAD; ++k) {
    c[k] = s0 + k < n_slices ? counts[(size_t)tile * n_slices + s0 + k] : 0;
    csum += c[k];
  }
  int kept;
  int l = block_exclusive_scan(csum, warp_sums, &kept);
#pragma unroll
  for (int k = 0; k < SLICES_PER_THREAD; ++k) {
    const int s = s0 + k;
    if (s < n_slices) {
      run[s] = l;
      start[s] += toff[(size_t)tile * n_slices + s] - l;
#pragma unroll
      for (int w = 0; w < B3_WARPS; ++w) wcnt[w][s] = 0;
    }
    l += c[k];
  }
  __syncthreads();

  for (int r = 0; r < PART_ROUNDS; ++r) {
    const int m = tile * PART_TILE + r * B3_THREADS + threadIdx.x;
    const Id id = id_next;
    float v[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f) v[f] = v_next[f];
    const int s = m < M ? slice_of(id, t_eff, span) : -1;
    if (r + 1 < PART_ROUNDS) load(r + 1);
    const unsigned peers = match_bits(s, s >= 0, 0, bits);
    const bool leader = lane == __ffs(peers) - 1;
    if (s >= 0 && leader) wcnt[warp][s] = (unsigned short)__popc(peers);
    __syncthreads();
    if (s >= 0) {
      int pos = run[s] + __popc(peers & lower);
      for (int w = 0; w < warp; ++w) pos += wcnt[w][s];
      tile_rows[pos] = (int)id;
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) tile_vals[f * PART_TILE + pos] = v[f];
    }
    __syncthreads();  // every row of the round has read run and wcnt
    if (s >= 0 && leader) {
      atomicAdd(&run[s], __popc(peers));  // integer: any order, same sum
      wcnt[warp][s] = 0;
    }
    __syncwarp();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kept; i += B3_THREADS) {
    const int id = tile_rows[i];
    const int d = start[id / span] + i;
    pid[d] = id;
    for (int f = 0; f < F; ++f)
      pval[(size_t)f * Mp + d] = tile_vals[f * PART_TILE + i];
  }
}

// The slice of part q: pstart[s] <= q < pstart[s + 1].
__device__ __forceinline__ int slice_of_part(const int* pstart, int n_slices,
                                             int q) {
  int s = 0;
  for (int step = MAX_SLICES; step > 0; step >>= 1)
    if (s + step < n_slices && pstart[s + step] <= q) s += step;
  return s;
}

// B3 launch 4: block q sums part p of slice s (q = pstart[s] + p), one
// window of S table rows at a time: rows [base, base + n_t) of window w,
// base = s * S * wps + w * S. A slice in one part is written to `out` whole,
// zeros included; a part of a split slice leaves its sums in
// part_buf[q][w] for launch 5.
__global__ void __launch_bounds__(B3_THREADS)
    slice_acc_kernel(const int* __restrict__ pid,
                     const float* __restrict__ pval, int Mp,
                     const int* __restrict__ total, int n_slices, int wps,
                     int S, int F, int t_eff, int tmajor,
                     float* __restrict__ part_buf, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                              // S * F, the output's layout
  int* sid = (int*)(acc + (size_t)S * F);  // [ACC_RING][ACC_CHUNK] ids
  float* sval = (float*)(sid + ACC_RING * ACC_CHUNK);  // [ACC_RING][F][ACC_CHUNK]
  __shared__ int start[MAX_SLICES + 1], pstart[MAX_SLICES + 1];
  __shared__ int warp_sums[B3_WARPS + 1];
  __shared__ int order[ACC_CHUNK];                     // chunk rows, binned
  __shared__ int step_cnt[ACC_CHUNK / 32][B3_WARPS];  // rows per step and bin
  __shared__ int bin_start[B3_WARPS + 1];
  slice_layout(total, n_slices, start, pstart, warp_sums);
  const int q = blockIdx.x;
  if (q >= pstart[n_slices]) return;
  const int s = slice_of_part(pstart, n_slices, q);
  const int p = q - pstart[s];
  const int parts = pstart[s + 1] - pstart[s];
  const int lo = start[s] + p * ACC_CAP;
  const int hi = p == parts - 1 ? start[s] + total[s] : lo + ACC_CAP;
  const int n_chunks = (hi - lo + ACC_CHUNK - 1) / ACC_CHUNK;

  // chunk c into buffer c % ACC_RING in 16-byte copies; a region's rows start
  // aligned and its padding, past hi, is never read
  auto stage = [&](int c) {
    const int r0 = lo + c * ACC_CHUNK;
    const int n4 = (min(ACC_CHUNK, hi - r0) + 3) / 4;
    int* di = sid + (c % ACC_RING) * ACC_CHUNK;
    float* dv = sval + (size_t)(c % ACC_RING) * F * ACC_CHUNK;
    for (int u = threadIdx.x; u < (F + 1) * n4; u += B3_THREADS) {
      const int a = u / n4, j = 4 * (u - a * n4);
      if (a == 0)
        __pipeline_memcpy_async(di + j, pid + r0 + j, 16);
      else
        __pipeline_memcpy_async(dv + (a - 1) * ACC_CHUNK + j,
                                pval + (size_t)(a - 1) * Mp + r0 + j, 16);
    }
    __pipeline_commit();
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1;
  const int lid_bits = 32 - __clz(S - 1);  // of a row of the window
  for (int w = 0; w < wps; ++w) {
    const long long base_ll = ((long long)s * wps + w) * S;
    if (base_ll >= t_eff) break;
    const int base = (int)base_ll;
    const int n_t = min(S, t_eff - base);
    __syncthreads();  // the previous window is written out
    for (int i = threadIdx.x; i < S * F; i += B3_THREADS) acc[i] = 0.0f;
    for (int c = 0; c < ACC_RING - 1; ++c) {  // the ring's first chunks
      if (c < n_chunks)
        stage(c);
      else
        __pipeline_commit();
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (c + ACC_RING - 1 < n_chunks)
        stage(c + ACC_RING - 1);
      else
        __pipeline_commit();  // an empty group keeps the wait below uniform
      __pipeline_wait_prior(ACC_RING - 1);
      __syncthreads();  // chunk c staged by every thread; acc zeroed
      const int n = min(ACC_CHUNK, hi - lo - c * ACC_CHUNK);
      const int* ci = sid + (c % ACC_RING) * ACC_CHUNK;
      const float* cv = sval + (size_t)(c % ACC_RING) * F * ACC_CHUNK;
      // bin the chunk's rows by owner warp (table row t -> warp t % 8), in
      // row order: each warp ranks two 32-row steps with one ballot per bin
      int bin[ACC_STEPS_PER_WARP], rank[ACC_STEPS_PER_WARP];
#pragma unroll
      for (int k2 = 0; k2 < ACC_STEPS_PER_WARP; ++k2) {
        const int k = warp * ACC_STEPS_PER_WARP + k2;
        const int j = k * 32 + lane;
        const int lid = j < n ? ci[j] - base : -1;
        bin[k2] = lid >= 0 && lid < n_t ? lid & (B3_WARPS - 1) : B3_WARPS;
        rank[k2] = 0;
#pragma unroll
        for (int b = 0; b < B3_WARPS; ++b) {
          const unsigned m = __ballot_sync(FULL_MASK, bin[k2] == b);
          if (bin[k2] == b) rank[k2] = __popc(m & lower);
          if (lane == b) step_cnt[k][b] = __popc(m);
        }
      }
      __syncthreads();
      if (warp == 0) {  // lane 8q + b: bin b's offsets in quarter q's steps
        const int b = lane & (B3_WARPS - 1), q = lane >> 3;
        int own = 0;
#pragma unroll
        for (int k = ACC_QSTEPS * q; k < ACC_QSTEPS * (q + 1); ++k) own += step_cnt[k][b];
        int incl = own;  // over the quarters of bin b
#pragma unroll
        for (int o = B3_WARPS; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(FULL_MASK, incl, o);
          if (lane >= o) incl += u;
        }
        int run = incl - own;
#pragma unroll
        for (int k = ACC_QSTEPS * q; k < ACC_QSTEPS * (q + 1); ++k) {
          const int t = step_cnt[k][b];
          step_cnt[k][b] = run;
          run += t;
        }
        // bin totals sit in lanes 24 .. 31; their inclusive scan in lanes 0..7
        int tot = __shfl_sync(FULL_MASK, incl, 24 + b);
#pragma unroll
        for (int o = 1; o < B3_WARPS; o <<= 1) {
          const int u = __shfl_up_sync(FULL_MASK, tot, o);
          if (lane >= o) tot += u;
        }
        if (lane < B3_WARPS) bin_start[lane + 1] = tot;
        if (lane == 0) bin_start[0] = 0;
      }
      __syncthreads();
#pragma unroll
      for (int k2 = 0; k2 < ACC_STEPS_PER_WARP; ++k2) {
        const int k = warp * ACC_STEPS_PER_WARP + k2;
        if (bin[k2] < B3_WARPS)
          order[bin_start[bin[k2]] + step_cnt[k][bin[k2]] + rank[k2]] =
              k * 32 + lane;
      }
      __syncthreads();
      // warp w sums its bin in row order: per 32 rows, groups of equal ids
      // (`match_bits`), each summed in lane order by pointer jumping
      // (after round k a lane holds the sum of the 2^(k+1) members ending at
      // it), the group's last member adding the sum to the slice
      const int i1 = bin_start[warp + 1];
      for (int i0 = bin_start[warp]; i0 < i1; i0 += 32) {
        const int i = i0 + lane;
        const int j = i < i1 ? order[i] : -1;
        const int lid = j >= 0 ? ci[j] - base : -1;
        // a bin's ids agree in their low 3 bits
        const unsigned peers = match_bits(lid, j >= 0, 3, lid_bits);
        int prev = 31 - __clz(peers & lower);  // the member below, or -1
        float v[MAXF];
#pragma unroll
        for (int f = 0; f < MAXF; ++f)
          v[f] = f < F && j >= 0 ? cv[f * ACC_CHUNK + j] : 0.0f;
        while (__any_sync(FULL_MASK, prev >= 0)) {
          const int src = prev >= 0 ? prev : lane;
#pragma unroll
          for (int f = 0; f < MAXF; ++f) {
            const float u = __shfl_sync(FULL_MASK, v[f], src);
            if (prev >= 0 && f < F) v[f] += u;
          }
          const int pp = __shfl_sync(FULL_MASK, prev, src);
          if (prev >= 0) prev = pp;
        }
        if (j >= 0 && (peers >> lane) == 1u) {  // the group's last member
#pragma unroll
          for (int f = 0; f < MAXF; ++f)
            if (f < F) acc[tmajor ? lid * F + f : f * S + lid] += v[f];
        }
      }
      __syncthreads();  // buffer c % ACC_RING is restaged by iteration c + 1
    }
    __syncthreads();
    if (parts > 1) {  // this part's sums of window w, for launch 5
      float* mine = part_buf + ((size_t)q * wps + w) * S * F;
      for (int i = threadIdx.x; i < S * F; i += B3_THREADS) mine[i] = acc[i];
    } else if (tmajor) {  // rows [base, base + n_t) are contiguous in `out`
      float* o = out + (size_t)base * F;
      for (int i = threadIdx.x; i < n_t * F; i += B3_THREADS) o[i] = acc[i];
    } else {
      for (int f = 0; f < F; ++f) {
        float* o = out + (size_t)f * t_eff + base;
        for (int i = threadIdx.x; i < n_t; i += B3_THREADS) o[i] = acc[f * S + i];
      }
    }
  }
}

// B3 launch 5: block q, part p of slice s, adds up stripe p of the slice's
// wps * S * F sums over all its parts, in the parts' order, and writes it
// to `out`. Slices in one part return at once.
__global__ void __launch_bounds__(B3_THREADS)
    slice_merge_kernel(const int* __restrict__ total, int n_slices, int wps,
                       int S, int F, int t_eff, int tmajor,
                       const float* __restrict__ part_buf,
                       float* __restrict__ out) {
  __shared__ int start[MAX_SLICES + 1], pstart[MAX_SLICES + 1];
  __shared__ int warp_sums[B3_WARPS + 1];
  slice_layout(total, n_slices, start, pstart, warp_sums);
  const int q = blockIdx.x;
  if (q >= pstart[n_slices]) return;
  const int s = slice_of_part(pstart, n_slices, q);
  const int p = q - pstart[s];
  const int parts = pstart[s + 1] - pstart[s];
  if (parts == 1) return;
  const int n_win = S * F;  // a multiple of 4: S is a power of two >= 4
  const int n_all = n_win * wps;
  const int per = (n_all / 4 + parts - 1) / parts * 4;
  const int i1 = min(n_all, (p + 1) * per);
  const long long base = (long long)s * wps * S;
  const float4* part0 = (const float4*)(part_buf + (size_t)pstart[s] * n_all);
  for (int i = p * per + 4 * threadIdx.x; i < i1; i += 4 * B3_THREADS) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int k = 0; k < parts; ++k) {
      const float4 u = __ldcg(part0 + ((size_t)k * n_all + i) / 4);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // entry r of window w, in its layout
      const int w = (i + c) / n_win, r = (i + c) - w * n_win;
      const int f = tmajor ? r % F : r / S;
      const long long t = base + (long long)w * S + (tmajor ? r / F : r % S);
      if (t < t_eff) out[out_index((int)t, f, F, t_eff, tmajor)] = e[c];
    }
  }
}

// --------------------------------------------- B3': per-tile aggregation

__device__ __forceinline__ unsigned slot_of(int id) {
  return ((unsigned)id * 2654435761u) >> 21;  // 11 bits: AGG_SLOTS = 2048
}

// One block per AGG_TILE rows: equal ids merged in a shared-memory hash
// table, then one global atomic add per distinct id and feature, in the
// order the ids first came (near the rows' order, which keeps the atomics of
// neighbouring cells in the same cache lines).
template <typename Id>
__global__ void __launch_bounds__(AGG_THREADS)
    tile_agg_kernel(const Id* __restrict__ ids, const float* __restrict__ ct,
                    int M, int F, int t_eff, int tmajor,
                    float* __restrict__ out) {
  extern __shared__ int hsm[];
  int* key = hsm;                          // AGG_SLOTS ids, -1 empty
  float* val = (float*)(key + AGG_SLOTS);  // [AGG_SLOTS][F] sums
  __shared__ int used[AGG_TILE];           // the filled slots
  __shared__ int n_used;
  const int m0 = blockIdx.x * AGG_TILE;
  int id[AGG_ROWS];  // every row's loads in flight at once
  float v[AGG_ROWS][MAXF];
#pragma unroll
  for (int k = 0; k < AGG_ROWS; ++k) {
    const int m = m0 + k * AGG_THREADS + threadIdx.x;
    id[k] = -1;
    if (m < M) {
      const Id raw = ids[m];
      if (raw >= 0 && raw < (Id)t_eff) id[k] = (int)raw;
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) v[k][f] = ct[ct_index(m, f, M, F, tmajor)];
    }
  }
  for (int i = threadIdx.x; i < AGG_SLOTS; i += AGG_THREADS) key[i] = -1;
  for (int i = threadIdx.x; i < AGG_SLOTS * F; i += AGG_THREADS) val[i] = 0.0f;
  if (threadIdx.x == 0) n_used = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < AGG_ROWS; ++k) {
    if (id[k] < 0) continue;
    unsigned h = slot_of(id[k]);
    for (;;) {  // at most AGG_TILE ids in twice as many slots: it ends
      const int prev = atomicCAS(&key[h], -1, id[k]);
      if (prev == -1) used[atomicAdd(&n_used, 1)] = h;
      if (prev == -1 || prev == id[k]) break;
      h = (h + 1) & (AGG_SLOTS - 1);
    }
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) atomicAdd(&val[h * F + f], v[k][f]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_used; i += AGG_THREADS) {
    const int h = used[i];
    const int t = key[h];
    const float* s = val + h * F;
    if (tmajor && F == 4) {
      atomicAdd((float4*)(out + (size_t)t * 4),
                make_float4(s[0], s[1], s[2], s[3]));
    } else if (tmajor && F == 2) {
      atomicAdd((float2*)(out + (size_t)t * 2), make_float2(s[0], s[1]));
    } else {
      for (int f = 0; f < F; ++f)
        atomicAdd(&out[out_index(t, f, F, t_eff, tmajor)], s[f]);
    }
  }
}

static bool bad_args(int M, int F, int t_eff, int tmajor) {
  return M < 0 || F < 1 || F > MAXF || t_eff < 1 || (tmajor != 0 && tmajor != 1);
}

// A kernel's dynamic shared memory above what `*allowed` records (0 at
// first) needs its opt-in: static plus dynamic above 48 KB is refused
// without it. One setting per kernel and size, not per call.
template <typename Kernel>
static cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

static size_t owner_smem(int S, int F) {
  return (size_t)S * F * sizeof(float) +
         ACC_RING * ACC_CHUNK * (sizeof(int) + F * sizeof(float));
}

static long long align4(long long n) { return (n + 3) & ~3ll; }

// B3's plan for M rows of F features into t_eff table rows on device `dev`.
struct OwnerPlan {
  int S;          // table rows of a window: a power of two, S * F floats in
                  // SLICE_BYTES and, with the staging ring and the summing
                  // kernel's static shared memory, in the card's opt-in
  int wps;        // windows a slice: the fewest that keep n_slices in
                  // MAX_SLICES
  int n_slices;   // ceil(t_eff / (wps * S))
  int n_tiles;    // partition tiles of PART_TILE rows
  int max_parts;  // summing blocks: every slice, and one more for every
                  // ACC_CAP rows a split can add
  int Mp;         // partitioned rows, each slice's region padded to 4 rows
  long long words;  // 32-bit words of scratch, every array 16-byte aligned
};

static cudaError_t owner_plan(int M, int F, int t_eff, int dev, OwnerPlan* p) {
  static int optin[64];  // per device, 0 until read
  static size_t acc_static = 0;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!optin[dev]) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &optin[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  if (!acc_static) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, slice_acc_kernel);
    if (err != cudaSuccess) return err;
    acc_static = attr.sharedSizeBytes;
  }
  const long long room =
      std::min<long long>(SLICE_BYTES, (long long)optin[dev] -
                                           (long long)acc_static -
                                           (long long)owner_smem(0, F)) /
      ((long long)sizeof(float) * F);
  if (room < 4) return cudaErrorInvalidConfiguration;  // merge: float4s
  int S = 4;
  while (2ll * S <= room) S *= 2;
  const long long windows = ((long long)t_eff + S - 1) / S;
  p->S = S;
  p->wps = (int)((windows + MAX_SLICES - 1) / MAX_SLICES);
  const long long span = (long long)S * p->wps;
  p->n_slices = (int)((t_eff + span - 1) / span);
  p->n_tiles = (M + PART_TILE - 1) / PART_TILE;
  p->max_parts = p->n_slices + (M + ACC_CAP - 1) / ACC_CAP;
  p->Mp = (int)(align4(M) + 4ll * p->n_slices);
  p->words = 2 * align4((long long)p->n_tiles * p->n_slices) +
             align4(p->n_slices) + (1ll + F) * p->Mp +
             (long long)p->max_parts * span * F;
  return cudaSuccess;
}

template <typename Id>
static int launch_owner(const Id* ids, const float* ct, int M, int F,
                        int t_eff, int tmajor, const OwnerPlan& pl,
                        float* out, int* scratch, cudaStream_t st) {
  const int S = pl.S, wps = pl.wps, n_slices = pl.n_slices;
  const long long n = align4((long long)pl.n_tiles * n_slices);
  int* counts = scratch;
  int* toff = counts + n;
  int* total = toff + n;
  int* pid = total + align4(n_slices);
  float* pval = (float*)(pid + pl.Mp);
  float* part_buf = pval + (size_t)F * pl.Mp;
  const size_t tile_smem = (size_t)PART_TILE * (1 + F) * sizeof(float);
  const size_t acc_smem = owner_smem(S, F);
  static size_t tile_allowed = 0, acc_allowed = 0;
  cudaError_t err =
      allow_smem(slice_scatter_kernel<Id>, tile_smem, &tile_allowed);
  if (err == cudaSuccess)
    err = allow_smem(slice_acc_kernel, acc_smem, &acc_allowed);
  if (err != cudaSuccess) return (int)err;
  slice_count_kernel<Id><<<pl.n_tiles, B3_THREADS, 0, st>>>(
      ids, M, t_eff, S * wps, n_slices, counts);
  slice_tile_scan_kernel<<<n_slices, B3_THREADS, 0, st>>>(
      counts, n_slices, pl.n_tiles, toff, total);
  slice_scatter_kernel<Id><<<pl.n_tiles, B3_THREADS, tile_smem, st>>>(
      ids, ct, M, F, t_eff, tmajor, S * wps, n_slices, counts, toff, total,
      pl.Mp, pid, pval);
  slice_acc_kernel<<<pl.max_parts, B3_THREADS, acc_smem, st>>>(
      pid, pval, pl.Mp, total, n_slices, wps, S, F, t_eff, tmajor, part_buf,
      out);
  slice_merge_kernel<<<pl.max_parts, B3_THREADS, 0, st>>>(
      total, n_slices, wps, S, F, t_eff, tmajor, part_buf, out);
  return (int)cudaGetLastError();
}

template <typename Id>
static int launch_tile_agg(const Id* ids, const float* ct, int M, int F,
                           int t_eff, int tmajor, float* out,
                           cudaStream_t st) {
  const size_t smem = AGG_SLOTS * (sizeof(int) + F * sizeof(float));
  static size_t allowed = 0;
  cudaError_t err = allow_smem(tile_agg_kernel<Id>, smem, &allowed);
  if (err != cudaSuccess) return (int)err;
  tile_agg_kernel<Id><<<(M + AGG_TILE - 1) / AGG_TILE, AGG_THREADS, smem,
                        st>>>(ids, ct, M, F, t_eff, tmajor, out);
  return (int)cudaGetLastError();
}

template <typename Id>
static int launch_scatter(const Id* ids, const float* ct, int L, int M, int F,
                          int T, int tmajor, float* out, cudaStream_t st) {
  const uintptr_t a = (uintptr_t)ct | (uintptr_t)out;
  const int vec = !tmajor ? 1 : F == 4 && a % 16 == 0 ? 4
                          : F == 2 && a % 8 == 0 ? 2 : 1;
  const long long blocks =
      ((long long)L * M + SCATTER_THREADS - 1) / SCATTER_THREADS;
  dtab_scatter_kernel<Id><<<(unsigned)blocks, SCATTER_THREADS, 0, st>>>(
      ids, ct, L, M, F, T, tmajor, vec, out);
  return (int)cudaGetLastError();
}

extern "C" {

// ids (M,) int32 or int64 (ids64), ct (F, M) or (M, F) float32 as `tmajor`
// says, out (F, t_eff) or (t_eff, F) float32. Every entry point launches on
// `stream` and returns cudaGetLastError() (0 on success).

// B2 and B4: ids (L, M) and ct (L * M rows of F, in the layout `tmajor`
// says), out (L * T rows of F), zeroed here, on the stream; row m of level l
// adds to table row l * T + id, and an id outside [0, T) is dropped. B2 is
// L = 1, T = t_eff.
int spnerf_dtab_scatter(const void* ids, int ids64, const void* ct, int L,
                        int M, int F, int T, int tmajor, void* out,
                        void* stream) {
  if (L < 1 || bad_args(M, F, T, tmajor) ||
      (long long)L * M > INT_MAX - SCATTER_THREADS ||
      (long long)L * T * F > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)L * T * F * sizeof(float), st);
  if (err != cudaSuccess || M == 0) return (int)err;
  return ids64 ? launch_scatter((const long long*)ids, (const float*)ct, L, M,
                                F, T, tmajor, (float*)out, st)
               : launch_scatter((const int*)ids, (const float*)ct, L, M, F,
                                T, tmajor, (float*)out, st);
}

// B3's plan on `device` (spnerf_torch/ops/dtab.py `owner_plan`): plan[0]
// S, plan[1] wps, plan[2] n_slices, plan[3] the 32-bit words of scratch that
// spnerf_dtab_owner needs for these shapes.
int spnerf_dtab_owner_plan(int M, int F, int t_eff, int device,
                           long long* plan) {
  if (bad_args(M, F, t_eff, 0)) return (int)cudaErrorInvalidValue;
  OwnerPlan p;
  const cudaError_t err = owner_plan(M, F, t_eff, device, &p);
  if (err != cudaSuccess) return (int)err;
  plan[0] = p.S;
  plan[1] = p.wps;
  plan[2] = p.n_slices;
  plan[3] = p.words;
  return 0;
}

// B3: ids (M,) int32 or int64 (ids64), ct and out as above, out written
// whole (it needs no zero fill). scratch holds scratch_words 32-bit words,
// at least what spnerf_dtab_owner_plan gives for these shapes on the current
// device.
int spnerf_dtab_owner(const void* ids, int ids64, const void* ct, int M,
                      int F, int t_eff, int tmajor, void* out, void* scratch,
                      long long scratch_words, void* stream) {
  if (bad_args(M, F, t_eff, tmajor)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  OwnerPlan p;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = owner_plan(M, F, t_eff, dev, &p);
  if (err != cudaSuccess) return (int)err;
  if (scratch_words < p.words) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)F * t_eff * sizeof(float), st);
  return ids64 ? launch_owner((const long long*)ids, (const float*)ct, M, F,
                              t_eff, tmajor, p, (float*)out, (int*)scratch, st)
               : launch_owner((const int*)ids, (const float*)ct, M, F, t_eff,
                              tmajor, p, (float*)out, (int*)scratch, st);
}

// B3': ids (M,) int32 or int64 (ids64), ct and out as above; out is zeroed
// here, on the stream.
int spnerf_dtab_tile_agg(const void* ids, int ids64, const void* ct, int M,
                         int F, int t_eff, int tmajor, void* out,
                         void* stream) {
  if (bad_args(M, F, t_eff, tmajor)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)F * t_eff * sizeof(float), st);
  if (err != cudaSuccess || M == 0) return (int)err;
  return ids64 ? launch_tile_agg((const long long*)ids, (const float*)ct, M,
                                 F, t_eff, tmajor, (float*)out, st)
               : launch_tile_agg((const int*)ids, (const float*)ct, M, F,
                                 t_eff, tmajor, (float*)out, st);
}

const char* spnerf_dtab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
