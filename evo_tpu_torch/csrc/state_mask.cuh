// Reading binary state rows into bitmasks, shared by the EBSC kernels
// (bsc_lpj.cu, bsc_suffstat.cu).  A state row is H int8 bytes, or W8 =
// ceil(H/8) lane-major packed bytes with latent h in bit h / W8 of byte
// h % W8; its mask is ceil(H/32) words, bit i of word w for latent 32w + i.
// Integer ORs commute, so a mask does not depend on the order of the ORs,
// and the int8 and packed rows of one state give the same mask.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// bit k of the result <=> byte k of w is nonzero (k < 4)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// the 16 bytes at p, or the `avail` of them that exist and zeros after
__device__ __forceinline__ uint4 load16(const uint8_t* p, int avail, bool aligned) {
  if (aligned && avail >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int k = 0; k < 16 && k < avail; ++k) w[k >> 2] |= uint32_t(__ldg(p + k)) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 8 x 8 bit matrix x transposed: bit q of byte b <- bit b of byte q
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x ^= t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// OR the latents of the 16 state bytes v, at byte p0 of consecutive rows
// of H int8 bytes or W8 packed bytes, into the rows' masks (MS words apart).
// Packed bytes with more than 8 bits on are taken by bit plane: the bits b
// of the bytes j .. j + len - 1 of one row are the latents b W8 + j ..
// b W8 + j + len - 1, so each plane of such a run is one or two ORs.
template <bool PACKED>
__device__ __forceinline__ void or_chunk(uint32_t* mask, int MS, uint4 v, int p0, int H, int W8) {
  const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
  if (!PACKED) {
    uint32_t m = nonzero_bytes(w4[0]) | nonzero_bytes(w4[1]) << 4 | nonzero_bytes(w4[2]) << 8 |
                 nonzero_bytes(w4[3]) << 12;
    if (m == 0u) return;
    if (H % 16 == 0) {  // the chunk is one aligned halfword of one row
      const int r = p0 / H, h = p0 - r * H;
      atomicOr(&mask[r * MS + (h >> 5)], m << (h & 16));
    } else {
      for (; m != 0u; m &= m - 1u) {
        const int p = p0 + __ffs(m) - 1, r = p / H, h = p - r * H;
        atomicOr(&mask[r * MS + (h >> 5)], 1u << (h & 31));
      }
    }
  } else if (__popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w) > 8) {
    const uint64_t t0 = transpose8(uint64_t(v.x) | uint64_t(v.y) << 32);
    const uint64_t t1 = transpose8(uint64_t(v.z) | uint64_t(v.w) << 32);
    for (int q = 0; q < 16;) {
      const int p = p0 + q, r = p / W8, j = p - r * W8;
      const int len = min(16 - q, W8 - j);
      for (int b = 0; b < 8; ++b) {
        const int L = b * W8 + j;  // the run's first latent in plane b
        if (L >= H) break;
        const uint32_t plane = uint32_t((t0 >> (8 * b)) & 0xffu) | uint32_t((t1 >> (8 * b)) & 0xffu) << 8;
        uint32_t bits = (plane >> q) & ((1u << len) - 1u);
        if (L + len > H) bits &= (1u << (H - L)) - 1u;
        if (bits == 0u) continue;
        const int w = L >> 5, sh = L & 31;
        atomicOr(&mask[r * MS + w], bits << sh);
        if (sh + len > 32) atomicOr(&mask[r * MS + w + 1], bits >> (32 - sh));
      }
      q += len;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (uint32_t nz = nonzero_bytes(w4[q]); nz != 0u; nz &= nz - 1u) {
        const int k = __ffs(nz) - 1;
        const int p = p0 + 4 * q + k, r = p / W8, j = p - r * W8;
        for (uint32_t byte = (w4[q] >> (8 * k)) & 0xffu; byte != 0u; byte &= byte - 1u) {
          const int h = (__ffs(byte) - 1) * W8 + j;
          if (h < H) atomicOr(&mask[r * MS + (h >> 5)], 1u << (h & 31));
        }
      }
    }
  }
}

}  // namespace
