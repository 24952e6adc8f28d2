// Warp helpers shared by the SSSC kernels (sssc_lpj.cu, sssc_lpj_masked.cu,
// sssc_suffstat.cuh), where one warp works on one binary state.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The active units of a state row, ascending, into idx; returns their
// number.  Ballots and prefix popcounts: the GPU form of the TPU kernels'
// one-hot projection _build_P.
__device__ __forceinline__ int active_set(const int8_t* row, int H, int* idx, int lane) {
  int n = 0;
  for (int base = 0; base < H; base += 32) {
    const int h = base + lane;
    const bool on = h < H && row[h] != 0;
    const unsigned m = __ballot_sync(FULL, on);
    if (on) idx[n + __popc(m & ((1u << lane) - 1u))] = h;
    n += __popc(m);
  }
  __syncwarp();
  return n;
}

// In-place inverse of the n x n matrix A (row-major, in the warp's shared
// memory) by unpivoted Gauss-Jordan: the same function as the TPU kernels'
// Schur recursion wherever every leading block is invertible.  Returns
// log|det A|, the sum of log|pivot|, on every lane.  A zero pivot leaves
// non-finite entries.  The plain version, ops/linalg.py:pd_inverse_logdet,
// takes the same steps.
__device__ float gauss_jordan_inverse(float* A, int n, int lane) {
  float ld = 0.f;
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    const float piv = A[k * n + k];
    const float ip = 1.f / piv;
    ld += logf(fabsf(piv));
    __syncwarp();
    for (int j = lane; j < n; j += 32)
      if (j != k) A[k * n + j] *= ip;
    __syncwarp();
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - (e / n) * n;
      if (i != k && j != k) A[e] -= A[i * n + k] * A[k * n + j];
    }
    __syncwarp();
    for (int i = lane; i < n; i += 32)
      if (i != k) A[i * n + k] *= -ip;
    if (lane == 0) A[k * n + k] = ip;
    __syncwarp();
  }
  return ld;
}

__device__ __forceinline__ float finite_or_zero(float x) { return isfinite(x) ? x : 0.f; }

}  // namespace
