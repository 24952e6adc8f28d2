// Warp helpers shared by the SSSC kernels (sssc_lpj.cu, sssc_suffstat.cu),
// where one warp works on one binary state.

#pragma once

#include <cuda_runtime.h>
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

}  // namespace
