// Hash-table gradient on Hopper (sm_90a):
//   dtab[t, f] = sum_m [ids_m == t] * ct[m, f]
// for ids (M,) int32 in [0, t_eff) and a cotangent of M rows of F float32
// values, into a zeroed float32 table of t_eff rows of F. Ids outside
// [0, t_eff) are dropped, as an XLA scatter drops them.
//
// Layouts. Every entry point takes `tmajor`: 0 is the feature-major layout
// of the flat table (ct (F, M), out (F, t_eff)), 1 the t-major layout of the
// (L, T, F) table (ct (M, F), out (t_eff, F)). The arithmetic is the same;
// only the two index functions below differ.
//
// B2, `spnerf_dtab_dense`, replaces the Pallas kernel `dtab_pallas`
// (spnerf_tpu/ops/pallas/dtab.py, `_kernel_cols` / `_kernel`). B3,
// `spnerf_dtab_sorted`, replaces the accumulating branch of
// `dtab_sorted_window` (same file, `_win_kernel_acc_cols` /
// `_win_kernel_acc`), B3', `spnerf_dtab_sorted_partials`, its
// non-accumulating branch (`_win_kernel` and the tile scatter after it), and
// B4, `spnerf_dtab_batched_keys` + `spnerf_dtab_sorted_batched`, the batched
// cross-level form `dtab_sorted_window_batched` (`_win_kernel_b`). The TPU
// kernels compute the scatter-add as factorized one-hot matmuls because the
// TPU has no fast scatter; Hopper has float atomics in shared and global
// memory and a fast library sort, so no kernel here builds a one-hot.
//
// Bound: bytes. The function reads M * (4 + 4F) bytes and writes 4 F t_eff
// bytes and does M * F additions, far below the card's 295 FLOP/byte ridge.
// What limits the kernels in practice is contention: the hash ids of the
// coarse levels repeat thousands of times (every ray crosses the cells near
// the scene's centre), and additions to one address serialise.
//
// B2 design: when the table fits a block's shared memory (128 KB at F = 4,
// t_eff = 8,192, the only dense level of the hash step), every block
// accumulates a grid-stride share of the rows into a private copy in shared
// memory with shared-memory atomics, then adds each nonzero entry to the
// output with one global atomic. Larger tables take the simple form: one
// global atomic per row and feature. Float atomics make the summation order,
// and so the last bits, change from run to run.
//
// B3 design: the deterministic sibling. The caller sorts the ids (the stable
// library sort stands where `lax.sort` stands in the JAX package) and passes
// the sort permutation; the kernel gathers the cotangent through it and
// writes each run of equal ids to its output row exactly once, without
// atomics, so the result is bitwise the same from run to run. Pass 1: one
// block per chunk of 256 sorted rows runs a segmented inclusive scan (keyed
// Hillis-Steele in shared memory, a fixed order of additions); a run that
// begins and ends inside the chunk is written by the thread at its end. A
// run that crosses into the next chunk leaves the chunk's partial sums of
// its first and last segments in scratch. Pass 2: one thread per chunk in
// which such a run begins adds the following chunks' first-segment partials
// in order and writes the total. There is no window, hence no tail fallback:
// the function is the exact sum for any distribution of ids.
//
// B3' design: the TPU branch's structure, partials per block and then a
// separate scatter. Pass 1 is B3's chunk scan, but it writes no table entry:
// the thread at the end of each run segment of its chunk writes the
// segment's sum and id to a partials buffer of one slot per sorted row
// (the other slots get id -1). Pass 2 adds every filled slot to the zeroed
// table with float atomics, so a run that crosses chunks gets one add per
// chunk. There is no carry pass; the float atomics make the last bits vary
// from run to run, as in B2.
//
// B4 design: one call for all L levels of an (L, T, F) table. The keys
// kernel maps level l's id to the key l * T + id (int32; the caller refuses
// L * T >= 2^31) and an id outside [0, T) to INT_MAX, a key that is never
// written, so it cannot spill into the next level. After one stable library
// sort of the L * M keys, B3's two passes run once over all rows into the
// (L * T, F) t-major output. Deterministic like B3, exact for any ids.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#define MAXF 8
#define DENSE_THREADS 256
#define DENSE_ROWS_PER_BLOCK 4096  // fewer rows than this per block: fewer blocks
#define SEG 256                    // sorted rows per chunk (threads per block)
#define CARRY_THREADS 256
#define FLAT_THREADS 256

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

// ---------------------------------------------------------------- B2 dense

__global__ void dtab_dense_smem_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ ct, int M,
                                       int F, int t_eff, int tmajor,
                                       float* __restrict__ out) {
  extern __shared__ float acc[];  // the table in the output's layout
  const int n_out = F * t_eff;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < M; m += stride) {
    const int id = ids[m];
    if ((unsigned)id >= (unsigned)t_eff) continue;
    for (int f = 0; f < F; ++f)
      atomicAdd(&acc[out_index(id, f, F, t_eff, tmajor)],
                ct[ct_index(m, f, M, F, tmajor)]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

__global__ void dtab_dense_global_kernel(const int* __restrict__ ids,
                                         const float* __restrict__ ct, int M,
                                         int F, int t_eff, int tmajor,
                                         float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < M; m += stride) {
    const int id = ids[m];
    if ((unsigned)id >= (unsigned)t_eff) continue;
    for (int f = 0; f < F; ++f)
      atomicAdd(&out[out_index(id, f, F, t_eff, tmajor)],
                ct[ct_index(m, f, M, F, tmajor)]);
  }
}

// ------------------------------------------------- B3, B3', B4: chunk scan

// Keyed inclusive scan of chunk c = blockIdx.x, sorted rows [c * SEG,
// c * SEG + n): on return val[f][t] holds the sum of row t's run segment up
// to row t, key[t] its id (INT_MAX past the chunk's rows). Returns n.
__device__ __forceinline__ int chunk_scan(const int* __restrict__ ids_s,
                                          const int64_t* __restrict__ perm,
                                          const float* __restrict__ ct, int M,
                                          int F, int tmajor, int* key,
                                          float (*val)[SEG]) {
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * SEG;
  const int n = min(SEG, M - m0);
  int id = INT_MAX;  // rows past M: a key no real id takes, sorted last
  if (t < n) {
    id = ids_s[m0 + t];
    const int src = (int)perm[m0 + t];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      val[f][t] = f < F ? ct[ct_index(src, f, M, F, tmajor)] : 0.0f;
  } else {
#pragma unroll
    for (int f = 0; f < MAXF; ++f) val[f][t] = 0.0f;
  }
  key[t] = id;
  __syncthreads();
  // the ids are sorted, so equal keys at t - off and t mean no run boundary
  // lies between them
  for (int off = 1; off < SEG; off <<= 1) {
    const bool same = t >= off && key[t - off] == id;
    float add[MAXF];
#pragma unroll
    for (int f = 0; f < MAXF; ++f) add[f] = same ? val[f][t - off] : 0.0f;
    __syncthreads();
    if (same) {
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) val[f][t] += add[f];
    }
    __syncthreads();
  }
  return n;
}

// B3 pass 1: runs inside the chunk are written; crossing runs leave partials.
__global__ void seg_sum_chunk_kernel(const int* __restrict__ ids_s,
                                     const int64_t* __restrict__ perm,
                                     const float* __restrict__ ct, int M,
                                     int F, int t_eff, int tmajor,
                                     float* __restrict__ out,
                                     float* __restrict__ part_first,
                                     float* __restrict__ part_last) {
  __shared__ int key[SEG];
  __shared__ float val[MAXF][SEG];
  const int n = chunk_scan(ids_s, perm, ct, M, F, tmajor, key, val);
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int m0 = c * SEG;
  if (t >= n) return;
  const int id = key[t];
  const bool seg_end = t == n - 1 || key[t + 1] != id;
  if (!seg_end) return;
  const bool first_seg = key[0] == id;
  const bool last_seg = t == n - 1;
  const bool starts_here = !first_seg || m0 == 0 || ids_s[m0 - 1] != id;
  const bool continues = last_seg && m0 + n < M && ids_s[m0 + n] == id;
  for (int f = 0; f < F; ++f) {
    const float v = val[f][t];
    if (first_seg) part_first[c * F + f] = v;
    if (last_seg) part_last[c * F + f] = v;
    if (starts_here && !continues && (unsigned)id < (unsigned)t_eff)
      out[out_index(id, f, F, t_eff, tmajor)] = v;
  }
}

// B3 pass 2: the runs that begin in chunk c and continue past it.
__global__ void seg_sum_carry_kernel(const int* __restrict__ ids_s, int M,
                                     int F, int t_eff, int tmajor,
                                     int n_chunks,
                                     const float* __restrict__ part_first,
                                     const float* __restrict__ part_last,
                                     float* __restrict__ out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_chunks - 1) return;  // the last chunk's runs end in it
  const int m0 = c * SEG;
  const int end = m0 + SEG;  // first row of chunk c + 1, < M
  const int id = ids_s[end - 1];
  if (ids_s[end] != id) return;  // the chunk's last run ends in it
  // a chunk that the run fills, begun in an earlier chunk: not its writer
  if (m0 > 0 && ids_s[m0] == id && ids_s[m0 - 1] == id) return;
  float acc[MAXF];
#pragma unroll
  for (int f = 0; f < MAXF; ++f) acc[f] = f < F ? part_last[c * F + f] : 0.0f;
  for (int k = c + 1; k < n_chunks; ++k) {
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) acc[f] += part_first[k * F + f];
    const int kend = min((k + 1) * SEG, M);
    if (kend >= M || ids_s[kend - 1] != id || ids_s[kend] != id) break;
  }
  if ((unsigned)id >= (unsigned)t_eff) return;
  for (int f = 0; f < F; ++f) out[out_index(id, f, F, t_eff, tmajor)] = acc[f];
}

// B3' pass 1: every run segment's sum and id to its end row's slot.
__global__ void seg_partials_kernel(const int* __restrict__ ids_s,
                                    const int64_t* __restrict__ perm,
                                    const float* __restrict__ ct, int M,
                                    int F, int tmajor,
                                    int* __restrict__ part_ids,
                                    float* __restrict__ part_vals) {
  __shared__ int key[SEG];
  __shared__ float val[MAXF][SEG];
  const int n = chunk_scan(ids_s, perm, ct, M, F, tmajor, key, val);
  const int t = threadIdx.x;
  if (t >= n) return;
  const int m = blockIdx.x * SEG + t;
  const int id = key[t];
  const bool seg_end = t == n - 1 || key[t + 1] != id;
  part_ids[m] = seg_end ? id : -1;
  if (!seg_end) return;
  for (int f = 0; f < F; ++f) part_vals[(size_t)m * F + f] = val[f][t];
}

// B3' pass 2: the filled slots into the table, one float atomic per value.
__global__ void scatter_partials_kernel(const int* __restrict__ part_ids,
                                        const float* __restrict__ part_vals,
                                        int M, int F, int t_eff, int tmajor,
                                        float* __restrict__ out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int id = part_ids[m];
  if ((unsigned)id >= (unsigned)t_eff) return;  // -1: not a segment's end
  for (int f = 0; f < F; ++f)
    atomicAdd(&out[out_index(id, f, F, t_eff, tmajor)],
              part_vals[(size_t)m * F + f]);
}

// B4 keys: row m of level l -> l * T + id, or INT_MAX for an id outside
// [0, T).
__global__ void batched_keys_kernel(const int* __restrict__ ids, int L, int M,
                                    int T, int* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)L * M) return;
  const int l = (int)(i / M);
  const int id = ids[i];
  keys[i] = (unsigned)id < (unsigned)T ? l * T + id : INT_MAX;
}

static int launch_sorted(const int* ids_s, const int64_t* perm,
                         const float* ct, int M, int F, int t_eff, int tmajor,
                         float* out, float* scratch, cudaStream_t s) {
  const int n_chunks = (M + SEG - 1) / SEG;
  float* part_first = scratch;
  float* part_last = part_first + (size_t)n_chunks * F;
  seg_sum_chunk_kernel<<<n_chunks, SEG, 0, s>>>(
      ids_s, perm, ct, M, F, t_eff, tmajor, out, part_first, part_last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  seg_sum_carry_kernel<<<(n_chunks + CARRY_THREADS - 1) / CARRY_THREADS,
                         CARRY_THREADS, 0, s>>>(
      ids_s, M, F, t_eff, tmajor, n_chunks, part_first, part_last, out);
  return (int)cudaGetLastError();
}

static bool bad_args(int M, int F, int t_eff, int tmajor) {
  return M < 0 || F < 1 || F > MAXF || t_eff < 1 || (tmajor != 0 && tmajor != 1);
}

extern "C" {

// ids (M,) int32, ct (F, M) or (M, F) float32 as `tmajor` says, out
// (F, t_eff) or (t_eff, F) float32 zeroed by the caller. Every entry point
// launches on `stream` and returns cudaGetLastError() (0 on success).
int spnerf_dtab_dense(const void* ids, const void* ct, int M, int F,
                      int t_eff, int tmajor, void* out, void* stream) {
  if (bad_args(M, F, t_eff, tmajor)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  int dev = 0, n_sm = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = (size_t)F * t_eff * sizeof(float);
  int blocks = (M + DENSE_ROWS_PER_BLOCK - 1) / DENSE_ROWS_PER_BLOCK;
  if (smem <= (size_t)max_smem) {
    err = cudaFuncSetAttribute(dtab_dense_smem_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    // every block zeroes and flushes the whole private table: at most as
    // many blocks as fit on the card at once
    const int per_sm = std::max(1, (int)((size_t)max_smem / smem));
    blocks = std::max(1, std::min(blocks, n_sm * per_sm));
    dtab_dense_smem_kernel<<<blocks, DENSE_THREADS, smem, s>>>(
        (const int*)ids, (const float*)ct, M, F, t_eff, tmajor, (float*)out);
  } else {
    blocks = std::max(1, std::min(blocks * 4, n_sm * 16));
    dtab_dense_global_kernel<<<blocks, DENSE_THREADS, 0, s>>>(
        (const int*)ids, (const float*)ct, M, F, t_eff, tmajor, (float*)out);
  }
  return (int)cudaGetLastError();
}

// ids_s (M,) int32 sorted ascending, perm (M,) int64 with ids_s[i] =
// ids[perm[i]], ct in the unsorted order, out zeroed by the caller, scratch
// 2 * ceil(M / 256) * F floats.
int spnerf_dtab_sorted(const void* ids_s, const void* perm, const void* ct,
                       int M, int F, int t_eff, int tmajor, void* out,
                       void* scratch, void* stream) {
  if (bad_args(M, F, t_eff, tmajor)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_sorted((const int*)ids_s, (const int64_t*)perm,
                       (const float*)ct, M, F, t_eff, tmajor, (float*)out,
                       (float*)scratch, (cudaStream_t)stream);
}

// B3': the arguments of spnerf_dtab_sorted, with partials buffers part_ids
// (M,) int32 and part_vals (M, F) float32 in place of its scratch.
int spnerf_dtab_sorted_partials(const void* ids_s, const void* perm,
                                const void* ct, int M, int F, int t_eff,
                                int tmajor, void* out, void* part_ids,
                                void* part_vals, void* stream) {
  if (bad_args(M, F, t_eff, tmajor)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (M + SEG - 1) / SEG;
  seg_partials_kernel<<<n_chunks, SEG, 0, s>>>(
      (const int*)ids_s, (const int64_t*)perm, (const float*)ct, M, F, tmajor,
      (int*)part_ids, (float*)part_vals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_partials_kernel<<<(M + FLAT_THREADS - 1) / FLAT_THREADS,
                            FLAT_THREADS, 0, s>>>(
      (const int*)part_ids, (const float*)part_vals, M, F, t_eff, tmajor,
      (float*)out);
  return (int)cudaGetLastError();
}

// B4, before the sort: ids (L, M) int32 -> keys (L, M) int32.
int spnerf_dtab_batched_keys(const void* ids, int L, int M, int T,
                             void* keys, void* stream) {
  if (L < 1 || M < 0 || T < 1 || (int64_t)L * T > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)L * M;
  if (n == 0) return 0;
  batched_keys_kernel<<<(unsigned)((n + FLAT_THREADS - 1) / FLAT_THREADS),
                        FLAT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)ids, L, M, T, (int*)keys);
  return (int)cudaGetLastError();
}

// B4, after the sort: keys_s (L * M,) int32 sorted ascending, perm (L * M,)
// int64, ct (L, M, F) float32, out (L, T, F) float32 zeroed by the caller,
// scratch 2 * ceil(L * M / 256) * F floats.
int spnerf_dtab_sorted_batched(const void* keys_s, const void* perm,
                               const void* ct, int L, int M, int F, int T,
                               void* out, void* scratch, void* stream) {
  if (L < 1 || (int64_t)L * M >= INT_MAX || (int64_t)L * T > INT_MAX ||
      bad_args(M, F, T, 1))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return launch_sorted((const int*)keys_s, (const int64_t*)perm,
                       (const float*)ct, L * M, F, L * T, 1, (float*)out,
                       (float*)scratch, (cudaStream_t)stream);
}

const char* spnerf_dtab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
