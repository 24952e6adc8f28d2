// Small dense solves shared by the ES3C kernels (sssc_lpj.cuh,
// sssc_suffstat.cuh): the unpivoted Gauss-Jordan inverse of an n x n
// system, in one thread's registers (n <= SPARSE_N) or by a warp in shared
// memory, and the warp, layout and copy helpers around them.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SPARSE_N = 8;  // states with up to this many units: a thread each

__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o = (o + bytes + 15) & ~size_t(15);
  return at;
}

// floats of a dense state's scratch: an n x n system, two vectors, the units
__host__ __device__ inline int dense_floats(int n) { return n * n + 3 * n; }

// 16 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 4 bytes from device memory to shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait for all but the most recent group of copies
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.f; }

// In-place inverse of A by unpivoted Gauss-Jordan on the leading n x n
// block (entries past n are scratch and never reach it): the steps of the
// plain version, ops/linalg.py:pd_inverse_logdet, so that a zero pivot
// leaves the same non-finite entries.  With LD it returns log|det A|, the
// sum of log|pivot| in the elimination's order; without, 0 and the same
// steps on A.
template <int N, bool LD = false>
__device__ __forceinline__ float gauss_jordan_regs(float (&A)[N][N], int n) {
  float ld = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      const float piv = A[k][k];
      const float ip = 1.f / piv;
      if (LD) ld += logf(fabsf(piv));
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j != k) A[k][j] *= ip;
#pragma unroll
      for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j)
          if (i != k && j != k) A[i][j] -= A[i][k] * A[k][j];
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i != k) A[i][k] *= -ip;
      A[k][k] = ip;
    }
  }
  return ld;
}

// The same inverse of A (row-major n x n in a warp's shared memory), a
// warp, n <= 64: lane j takes columns j and j + 32, the rows in turn.  With
// LD every lane returns log|det A|.
template <bool LD = false>
__device__ float gauss_jordan_cols(float* A, int n, int lane) {
  const int j0 = lane, j1 = lane + 32;
  float ld = 0.f;
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    const float piv = A[k * n + k];
    const float ip = 1.f / piv;
    if (LD) ld += logf(fabsf(piv));
    float r0 = 0.f, r1 = 0.f;  // this lane's entries of the scaled row k
    if (j0 < n && j0 != k) r0 = (A[k * n + j0] *= ip);
    if (j1 < n && j1 != k) r1 = (A[k * n + j1] *= ip);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {  // row k and column k stay as they are
      const float aik = A[i * n + k];
      if (i != k && j0 < n && j0 != k) A[i * n + j0] -= aik * r0;
      if (i != k && j1 < n && j1 != k) A[i * n + j1] -= aik * r1;
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32) A[i * n + k] = i != k ? A[i * n + k] * -ip : ip;
    __syncwarp();
  }
  return ld;
}

// One row of a warp's register columns (lane j holds c[i] = A[i][j]) in:
// rows 1 .. R - 1 move up by one and x becomes row R - 1, so R pushes fill
// c in order.
template <int R>
__device__ __forceinline__ void push_row(float (&c)[R], float x) {
#pragma unroll
  for (int i = 0; i < R - 1; ++i) c[i] = c[i + 1];
  c[R - 1] = x;
}

// The inverse of A, n <= R <= 32, by a warp in registers: lane j holds
// column j (c[i] = A[i][j], lanes R and up a column of their own), A is the
// identity past n, and column k's entries come from lane k by shuffles.
// Each step runs over all R rows with no test of n (past n a row adds
// nothing to the leading n x n block), so that block ends as
// gauss_jordan_regs leaves it.  The rows move up by one after each step, so
// the pivot row is always c[0]; after the n steps R - n more moves bring
// them back to their order.  With LD every lane returns log|det A|.
template <bool LD = false, int R>
__device__ __forceinline__ float gauss_jordan_warp(float (&c)[R], int n, int lane) {
  float ld = 0.f;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const float piv = __shfl_sync(FULL, c[0], k);
    const float ip = 1.f / piv;
    if (LD) ld += logf(fabsf(piv));
    const float r = c[0] * ip;  // this lane's entry of the scaled row k
    const bool mine = lane == k;
    float a[R];  // column k
#pragma unroll
    for (int i = 1; i < R; ++i) a[i] = __shfl_sync(FULL, c[i], k);
#pragma unroll
    for (int i = 1; i < R; ++i) c[i] = mine ? c[i] * -ip : c[i] - a[i] * r;
    push_row(c, mine ? ip : r);
  }
#pragma unroll 1
  for (int k = n; k < R; ++k) push_row(c, c[0]);
  return ld;
}

}  // namespace
