// Hash-table gradient on Hopper (sm_90a):
//   dtab[f, t] = sum_m [ids_m == t] * ct[f, m]
// for ids (M,) int32 in [0, t_eff) and a feature-major cotangent ct (F, M)
// float32, into a zeroed (F, t_eff) float32 output. Ids outside [0, t_eff)
// are dropped, as an XLA scatter drops them.
//
// B2, `spnerf_dtab_dense`, replaces the Pallas kernel `dtab_pallas`
// (spnerf_tpu/ops/pallas/dtab.py, `_kernel_cols` / `_kernel`). B3,
// `spnerf_dtab_sorted`, replaces the accumulating branch of
// `dtab_sorted_window` (same file, `_win_kernel_acc_cols` /
// `_win_kernel_acc`). Both TPU kernels compute the scatter-add as a
// factorized one-hot matmul because the TPU has no fast scatter; Hopper has
// float atomics in shared and global memory, so neither kernel here builds a
// one-hot.
//
// Bound: bytes. The function reads M * (4 + 4F) bytes and writes 4 F t_eff
// bytes and does M * F additions, far below the card's 295 FLOP/byte ridge.
// What limits both kernels in practice is contention: the hash ids of the
// coarse levels repeat thousands of times (every ray crosses the cells near
// the scene's centre), and additions to one address serialise.
//
// B2 design: when the (F, t_eff) output fits a block's shared memory (128 KB
// at F = 4, t_eff = 8,192, the only dense level of the hash step), every
// block accumulates a grid-stride share of the rows into a private copy in
// shared memory with shared-memory atomics, then adds each nonzero entry to
// the output with one global atomic. Larger tables take the simple form: one
// global atomic per row and feature. Float atomics make the summation order,
// and so the last bits, change from run to run.
//
// B3 design: the deterministic sibling. The caller sorts the ids (the stable
// library sort stands where `lax.sort` stands in the JAX package) and passes
// the sort permutation; the kernel gathers the cotangent through it and
// writes each run of equal ids to its output column exactly once, without
// atomics, so the result is bitwise the same from run to run. Pass 1: one
// block per chunk of 256 sorted rows runs a segmented inclusive scan (keyed
// Hillis-Steele in shared memory, a fixed order of additions); a run that
// begins and ends inside the chunk is written by the thread at its end. A
// run that crosses into the next chunk leaves the chunk's partial sums of
// its first and last segments in scratch. Pass 2: one thread per chunk in
// which such a run begins adds the following chunks' first-segment partials
// in order and writes the total. There is no window, hence no tail fallback:
// the function is the exact sum for any distribution of ids.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#define MAXF 8
#define DENSE_THREADS 256
#define DENSE_ROWS_PER_BLOCK 4096  // fewer rows than this per block: fewer blocks
#define SEG 256                    // sorted rows per chunk (threads per block)
#define CARRY_THREADS 256

// ---------------------------------------------------------------- B2 dense

__global__ void dtab_dense_smem_kernel(const int* __restrict__ ids,
                                       const float* __restrict__ ct, int M,
                                       int F, int t_eff,
                                       float* __restrict__ out) {
  extern __shared__ float acc[];
  const int n_out = F * t_eff;
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < M; m += stride) {
    const int id = ids[m];
    if ((unsigned)id >= (unsigned)t_eff) continue;
    for (int f = 0; f < F; ++f)
      atomicAdd(&acc[f * t_eff + id], ct[(size_t)f * M + m]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

__global__ void dtab_dense_global_kernel(const int* __restrict__ ids,
                                         const float* __restrict__ ct, int M,
                                         int F, int t_eff,
                                         float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int m = blockIdx.x * blockDim.x + threadIdx.x; m < M; m += stride) {
    const int id = ids[m];
    if ((unsigned)id >= (unsigned)t_eff) continue;
    for (int f = 0; f < F; ++f)
      atomicAdd(&out[(size_t)f * t_eff + id], ct[(size_t)f * M + m]);
  }
}

// --------------------------------------------------------------- B3 sorted

// Pass 1: chunk c holds sorted rows [c * SEG, c * SEG + n).
__global__ void seg_sum_chunk_kernel(const int* __restrict__ ids_s,
                                     const int64_t* __restrict__ perm,
                                     const float* __restrict__ ct, int M,
                                     int F, int t_eff,
                                     float* __restrict__ out,
                                     float* __restrict__ part_first,
                                     float* __restrict__ part_last) {
  __shared__ int key[SEG];
  __shared__ float val[MAXF][SEG];
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  const int m0 = c * SEG;
  const int n = min(SEG, M - m0);
  int id = INT_MAX;  // rows past M: a key no real id takes, sorted last
  if (t < n) {
    id = ids_s[m0 + t];
    const int64_t src = perm[m0 + t];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      val[f][t] = f < F ? ct[(size_t)f * M + src] : 0.0f;
  } else {
#pragma unroll
    for (int f = 0; f < MAXF; ++f) val[f][t] = 0.0f;
  }
  key[t] = id;
  __syncthreads();
  // keyed inclusive scan: the ids are sorted, so equal keys at t - off and t
  // mean no run boundary lies between them
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
  if (t >= n) return;
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
      out[(size_t)f * t_eff + id] = v;
  }
}

// Pass 2: the runs that begin in chunk c and continue past it.
__global__ void seg_sum_carry_kernel(const int* __restrict__ ids_s, int M,
                                     int F, int t_eff, int n_chunks,
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
  for (int f = 0; f < F; ++f) out[(size_t)f * t_eff + id] = acc[f];
}

extern "C" {

// ids (M,) int32, ct (F, M) float32, out (F, t_eff) float32 zeroed by the
// caller. Launches on `stream`; returns cudaGetLastError() (0 on success).
int spnerf_dtab_dense(const void* ids, const void* ct, int M, int F,
                      int t_eff, void* out, void* stream) {
  if (M < 0 || F < 1 || F > MAXF || t_eff < 1)
    return (int)cudaErrorInvalidValue;
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
        (const int*)ids, (const float*)ct, M, F, t_eff, (float*)out);
  } else {
    blocks = std::max(1, std::min(blocks * 4, n_sm * 16));
    dtab_dense_global_kernel<<<blocks, DENSE_THREADS, 0, s>>>(
        (const int*)ids, (const float*)ct, M, F, t_eff, (float*)out);
  }
  return (int)cudaGetLastError();
}

// ids_s (M,) int32 sorted ascending, perm (M,) int64 with ids_s[i] =
// ids[perm[i]], ct (F, M) float32 in the unsorted order, out (F, t_eff)
// float32 zeroed by the caller, scratch 2 * ceil(M / 256) * F floats.
int spnerf_dtab_sorted(const void* ids_s, const void* perm, const void* ct,
                       int M, int F, int t_eff, void* out, void* scratch,
                       void* stream) {
  if (M < 0 || F < 1 || F > MAXF || t_eff < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = (M + SEG - 1) / SEG;
  float* part_first = (float*)scratch;
  float* part_last = part_first + (size_t)n_chunks * F;
  seg_sum_chunk_kernel<<<n_chunks, SEG, 0, s>>>(
      (const int*)ids_s, (const int64_t*)perm, (const float*)ct, M, F, t_eff,
      (float*)out, part_first, part_last);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
  seg_sum_carry_kernel<<<(n_chunks + CARRY_THREADS - 1) / CARRY_THREADS,
                         CARRY_THREADS, 0, s>>>(
      (const int*)ids_s, M, F, t_eff, n_chunks, part_first, part_last,
      (float*)out);
  return (int)cudaGetLastError();
}

const char* spnerf_dtab_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
