// BSC log-pseudo-joint of binary candidate states, with optional dedup keys.
//
// Replaces: evo_tpu/ops/pallas_lpj.py:bsc_lpj_pallas (body _make_kernel),
// int8 states and lane-major packed uint8 states (EAConfig.packed_states),
// both emit_keys modes.  For every state row (b, k):
//
//   lpj[b,k] = pre1 * (y2[b] - 2 s.Wty[b] + s^T G s) + pil_bar * |s|
//
// and, in keys mode, the dedup keys of ops.bitpack.dedup_keys: the exact
// packed words for H <= 64, the 2-word halfword hash above.
//
// What bounds it on an H100: reading the int8 states once (67 MB at
// B*K = 262,144 states, H = 256: 0.02 ms at 3.35 TB/s; packed, 8.4 MB).
// For a binary s, s^T G s is a sum of G over the active pairs, |s|^2 adds,
// which at the EA's sparsity of about 2 bits per state is far below the
// byte time.
// This kernel does the dense product instead, 2 H^2 f32 operations per
// state (3.4e10 here, 0.5 ms at 67 TFLOP/s), so it runs well above that
// bound; skipping the zero bits is later work.
//
// Design: a block stages ROWS state rows in shared memory as int8 and
// streams the Gram matrix through shared memory in CJ-column chunks (at
// H = 256 the whole of G is 256 KB, more than a block may hold).  Each
// thread owns a 2-row x 8-column tile of t = s G, accumulated in plain f32
// FMAs (no TF32), and folds it into s^T G s at the end of each chunk; the
// row sums are finished with warp shuffles.  The epilogue adds -2 s.Wty,
// y2 and pil_bar |s|.  In keys mode the same staged rows yield the final
// uint32 keys directly (the TPU kernel's transposed halfword output was a
// Mosaic layout device that Hopper does not need).  Rows past H are zero
// in shared memory, so a ragged H needs no padding by the caller.
//
// Packed input (PACKED): a state row is W8 = ceil(H/8) bytes, latent h in
// bit h / W8 of byte h % W8 (the TPU kernel's pltpu.repeat was a Mosaic
// lane device and is not carried over).  Only the staging changes: each
// latent is read from its byte into the same int8 tile, zero past H, so
// the lpj and the keys are bit-identical to the int8 kernel's on the same
// states (the keys are those of the unpacked states, as the TPU kernel's).
// The state bytes to read shrink 8x (8.4 MB instead of 67 MB at the main
// path's block); the dense product stays, so the time should not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;      // state rows per block
constexpr int CJ = 32;        // Gram columns per shared-memory chunk
constexpr int THREADS = 128;  // 32 row pairs x 4 column octets
constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return k;
}

// byte k of a word of 0/1 bytes as 0.0f / 1.0f, without an int->float convert
__device__ __forceinline__ float byte_as_unit(uint32_t w, int k) {
  return __uint_as_float(((w >> (8 * k)) & 1u) * 0x3f800000u);
}

// little-endian 16-bit halfword v of a staged row: bit b <=> byte 16v+b != 0
__device__ __forceinline__ uint32_t halfword(const int8_t* row, int v) {
  uint32_t hw = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 16 * v + 4 * q);
#pragma unroll
    for (int k = 0; k < 4; ++k) hw |= (((w >> (8 * k)) & 0xffu) != 0u) << (4 * q + k);
  }
  return hw;
}

// latent h of state row `row`: an int8 0/1 byte, or bit h / W8 of byte h % W8
template <bool PACKED>
__device__ __forceinline__ int8_t state_bit(const uint8_t* ss, size_t row, int h, int H,
                                            int W8) {
  if (PACKED) return int8_t((ss[row * W8 + h % W8] >> (h / W8)) & 1u);
  return int8_t(ss[row * H + h]);
}

template <bool KEYS, bool PACKED>
__global__ void __launch_bounds__(THREADS)
bsc_lpj_kernel(const uint8_t* __restrict__ ss, const float* __restrict__ wty,
               const float* __restrict__ y2, const float* __restrict__ G,
               const float* __restrict__ scal, float* __restrict__ lpj,
               uint32_t* __restrict__ keys, int n_rows, int K, int H, int Hq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int srow = Hq + 4;  // padded row stride: spreads rows over the banks
  int8_t* s_t = reinterpret_cast<int8_t*>(smem);                // [ROWS][srow]
  float* g_c = reinterpret_cast<float*>(smem + ROWS * srow);    // [Hq][CJ]

  const int tid = threadIdx.x;
  const int tx = tid & 3;   // columns 8*tx .. 8*tx+7 of a chunk
  const int ty = tid >> 2;  // rows 2*ty, 2*ty+1 of the tile
  const int r0 = blockIdx.x * ROWS;
  const int W8 = (H + 7) / 8;

  for (int e = tid; e < ROWS * Hq; e += THREADS) {
    const int r = e / Hq, h = e - r * Hq;
    const int row = r0 + r;
    s_t[r * srow + h] = (row < n_rows && h < H) ? state_bit<PACKED>(ss, row, h, H, W8)
                                                : int8_t(0);
  }

  float sgs[2] = {0.f, 0.f};
  for (int j0 = 0; j0 < Hq; j0 += CJ) {
    __syncthreads();  // staging done / previous chunk consumed
    for (int e = tid; e < Hq * CJ; e += THREADS) {
      const int i = e / CJ, j = j0 + (e - i * CJ);
      g_c[e] = (i < H && j < H) ? G[(size_t)i * H + j] : 0.f;
    }
    __syncthreads();

    float acc[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int i = 0; i < Hq; i += 4) {
      uint32_t w[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(s_t + (2 * ty + r) * srow + i);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 ga = *reinterpret_cast<const float4*>(g_c + (i + k) * CJ + 8 * tx);
        const float4 gb = *reinterpret_cast<const float4*>(g_c + (i + k) * CJ + 8 * tx + 4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float s = byte_as_unit(w[r], k);
          acc[r][0] = fmaf(s, ga.x, acc[r][0]);
          acc[r][1] = fmaf(s, ga.y, acc[r][1]);
          acc[r][2] = fmaf(s, ga.z, acc[r][2]);
          acc[r][3] = fmaf(s, ga.w, acc[r][3]);
          acc[r][4] = fmaf(s, gb.x, acc[r][4]);
          acc[r][5] = fmaf(s, gb.y, acc[r][5]);
          acc[r][6] = fmaf(s, gb.z, acc[r][6]);
          acc[r][7] = fmaf(s, gb.w, acc[r][7]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        sgs[r] = fmaf(acc[r][c], float(s_t[(2 * ty + r) * srow + j0 + 8 * tx + c]), sgs[r]);
  }

  // s.Wty and |s|: the four lanes of a row pair split the latent axis
  float sw[2] = {0.f, 0.f}, sa[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 2 * ty + r;
    if (row < n_rows) {
      const float* wrow = wty + (size_t)(row / K) * H;
      for (int i = tx; i < H; i += 4) {
        const float s = float(s_t[(2 * ty + r) * srow + i]);
        sw[r] = fmaf(s, wrow[i], sw[r]);
        sa[r] += s;
      }
    }
  }
#pragma unroll
  for (int off = 2; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sgs[r] += __shfl_xor_sync(0xffffffffu, sgs[r], off);
      sw[r] += __shfl_xor_sync(0xffffffffu, sw[r], off);
      sa[r] += __shfl_xor_sync(0xffffffffu, sa[r], off);
    }
  }
  if (tx == 0) {
    const float pre1 = scal[0], pil_bar = scal[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 2 * ty + r;
      if (row < n_rows)
        lpj[row] = pre1 * (y2[row / K] - 2.f * sw[r] + sgs[r]) + pil_bar * sa[r];
    }
  }

  if (KEYS) {
    for (int r = tid; r < ROWS; r += THREADS) {
      const int row = r0 + r;
      if (row >= n_rows) continue;
      const int8_t* srow_p = s_t + r * srow;
      const int W16 = Hq / 16;
      if (H <= 64) {  // exact pack_states words
        for (int w = 0; w < W16 / 2; ++w)
          keys[(size_t)row * (W16 / 2) + w] =
              halfword(srow_p, 2 * w) | (halfword(srow_p, 2 * w + 1) << 16);
      } else {  // ops.bitpack.hash_halfwords over the 2*ceil(H/32) halfwords
        uint32_t k1 = 0u, k2 = 0u;
        for (int v = 0; v < W16; ++v) {
          const uint32_t hw = halfword(srow_p, v);
          k1 += hw * (fmix32(uint32_t(v + 1) * GOLDEN) | 1u);
          k2 += hw * (fmix32(uint32_t(v + 1 + W16) * GOLDEN) | 1u);
        }
        keys[(size_t)row * 2] = fmix32(k1);
        keys[(size_t)row * 2 + 1] = fmix32(k2);
      }
    }
  }
}

template <bool KEYS, bool PACKED>
int launch(const void* ss, const void* wty, const void* y2, const void* G, const void* scal,
           void* lpj, void* keys, int B, int K, int H, void* stream) {
  const int n_rows = B * K;
  const int Hq = (H + 31) / 32 * 32;
  const size_t smem = size_t(ROWS) * (Hq + 4) + size_t(Hq) * CJ * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bsc_lpj_kernel<KEYS, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  bsc_lpj_kernel<KEYS, PACKED>
      <<<(n_rows + ROWS - 1) / ROWS, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(ss), static_cast<const float*>(wty),
          static_cast<const float*>(y2), static_cast<const float*>(G),
          static_cast<const float*>(scal), static_cast<float*>(lpj),
          static_cast<uint32_t*>(keys), n_rows, K, H, Hq);
  return int(cudaGetLastError());
}

}  // namespace

// ss: int8 0/1 [B, K, H]
extern "C" int evo_bsc_lpj(const void* ss, const void* wty, const void* y2, const void* G,
                           const void* scal, void* lpj, void* keys, int B, int K, int H,
                           void* stream) {
  return keys != nullptr ? launch<true, false>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream)
                         : launch<false, false>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream);
}

// ss: lane-major packed uint8 [B, K, ceil(H/8)]
extern "C" int evo_bsc_lpj_packed(const void* ss, const void* wty, const void* y2, const void* G,
                                  const void* scal, void* lpj, void* keys, int B, int K, int H,
                                  void* stream) {
  return keys != nullptr ? launch<true, true>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream)
                         : launch<false, true>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream);
}
