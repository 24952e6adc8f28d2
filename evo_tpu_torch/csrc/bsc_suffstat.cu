// BSC M-step sufficient statistics of the merged state sets.
//
// Replaces: evo_tpu/ops/pallas_suffstat.py:bsc_suffstat_pallas, int8 states
// and lane-major packed uint8 states (EAConfig.packed_states):
//
//   rho[b,h]  = sum_s rs[b,s] ss[b,s,h]
//   sabs[b,s] = sum_h ss[b,s,h]
//   Wq[h,k]   = sum_{b,s} rs[b,s] ss[b,s,h] ss[b,s,k]
//
// What bounds it on an H100: reading the int8 states once (67 MB at
// B = 4096, S = 64, H = 256: 0.02 ms at 3.35 TB/s; packed, 8.4 MB).  For binary s, Wq adds
// rs to the |s|^2 active pairs of each row, far below the byte time at the
// EA's sparsity.  This kernel does the dense product, 2 B S H^2 f32
// operations (3.4e10, 0.5 ms at 67 TFLOP/s), so it runs well above that
// bound; skipping the zero bits is later work.
//
// Design: the TPU kernel carried Wq across its sequential grid in VMEM.
// Hopper's blocks run in no fixed order, so pass 1 gives each block one
// chunk of whole datapoints and one 64 x 64 tile of Wq; it stages the
// chunk's rows through shared memory in f32 (rs * s_h and s_k), keeps its
// partial tile in registers (a 4 x 4 tile per thread, plain f32 FMAs, no
// TF32) and writes it to partial[chunk].  Pass 2 sums the partials in chunk
// order, so Wq is the same from run to run (atomics would make it vary).
// The blocks of the first k tile also write rho for their h range, and the
// blocks of tile (0, 0) write sabs, one warp per state row.
//
// Packed input (PACKED): a state row is W8 = ceil(H/8) bytes, latent h in
// bit h / W8 of byte h % W8, with H passed explicitly.  Every read of a
// state goes through state_at, which takes the bit instead of the byte at
// a position found once per thread (each thread stages one tile column);
// sabs counts the valid bits of each byte.  The chunks, the tiles, the
// summation order of rho and Wq and pass 2 are unchanged, and sabs sums
// small integers, so rho, sabs and Wq are bit-identical to the int8
// kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 64;        // Wq tile edge
constexpr int R = 32;         // state rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 Wq tile each
static_assert(THREADS % TH == 0, "a thread stages one tile column");

// where latent h sits in a state row: its byte and, packed, its bit
struct Slot {
  int off, bit;
};

template <bool PACKED>
__device__ __forceinline__ Slot slot_of(int h, int W8) {
  return PACKED ? Slot{h % W8, h / W8} : Slot{h, 0};
}

// the latent at `at` of state row `row` (rows `stride` bytes apart) as 0.f / 1.f
template <bool PACKED>
__device__ __forceinline__ float state_at(const uint8_t* ss, size_t row, Slot at, int stride) {
  const uint8_t v = ss[row * stride + at.off];
  return PACKED ? float((v >> at.bit) & 1u) : float(int8_t(v));
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
suffstat_partial(const uint8_t* __restrict__ ss, const float* __restrict__ rs,
                 float* __restrict__ rho, float* __restrict__ sabs,
                 float* __restrict__ partial, int B, int S, int H, int chunk) {
  __shared__ __align__(16) float a_s[R][TH];  // rs * s_h
  __shared__ __align__(16) float b_s[R][TH];  // s_k
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int p = blockIdx.x;
  const int h0 = blockIdx.y * TH, k0 = blockIdx.z * TH;
  const int b_lo = p * chunk;
  const int b_hi = min(B, b_lo + chunk);
  const size_t row_lo = size_t(b_lo) * S, row_hi = size_t(b_hi) * S;
  const int W8 = (H + 7) / 8;
  const int stride = PACKED ? W8 : H;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (size_t base = row_lo; base < row_hi; base += R) {
    __syncthreads();
    if constexpr (PACKED) {
      // this thread's tile column, the same in every step; its bit positions
      const int c = tid % TH, h = h0 + c, k = k0 + c;
      const Slot h_at = slot_of<true>(h, W8), k_at = slot_of<true>(k, W8);
#pragma unroll
      for (int j = 0; j < R * TH / THREADS; ++j) {  // rows tid / TH, + THREADS / TH, ...
        const int r = tid / TH + j * (THREADS / TH);
        const size_t row = base + r;
        const bool ok = row < row_hi;
        const float sh = (ok && h < H) ? state_at<PACKED>(ss, row, h_at, stride) : 0.f;
        a_s[r][c] = ok ? sh * rs[row] : 0.f;
        b_s[r][c] = (ok && k < H) ? state_at<PACKED>(ss, row, k_at, stride) : 0.f;
      }
    } else {  // int8: one byte a latent, the kernel's original staging loop
      for (int e = tid; e < R * TH; e += THREADS) {
        const int r = e / TH, ce = e - r * TH;
        const size_t row = base + r;
        const bool ok = row < row_hi;
        const int he = h0 + ce, ke = k0 + ce;
        const float sh = (ok && he < H) ? float(int8_t(ss[row * H + he])) : 0.f;
        a_s[r][ce] = ok ? sh * rs[row] : 0.f;
        b_s[r][ce] = (ok && ke < H) ? float(int8_t(ss[row * H + ke])) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < R; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[r][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[r][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  float* out = partial + size_t(p) * H * H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int hi = h0 + 4 * ty + i;
    if (hi >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + 4 * tx + j;
      if (kj < H) out[size_t(hi) * H + kj] = acc[i][j];
    }
  }

  if (blockIdx.z == 0) {  // rho for this chunk's datapoints and h range
    for (int e = tid; e < (b_hi - b_lo) * TH; e += THREADS) {
      const int b = b_lo + e / TH, h = h0 + e % TH;
      if (h >= H) continue;
      const Slot h_at = slot_of<PACKED>(h, W8);
      float v = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t row = size_t(b) * S + s;
        v = fmaf(rs[row], state_at<PACKED>(ss, row, h_at, stride), v);
      }
      rho[size_t(b) * H + h] = v;
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0) {  // sabs, one warp per state row
    const int lane = tid & 31, warp = tid >> 5;
    for (size_t row = row_lo + warp; row < row_hi; row += THREADS / 32) {
      float v = 0.f;
      if (PACKED) {  // byte w holds latents w, w + W8, ...: ceil((H - w) / W8) of them
        for (int w = lane; w < W8; w += 32)
          v += float(__popc(ss[row * W8 + w] & ((1u << ((H - w + W8 - 1) / W8)) - 1u)));
      } else {
        for (int hh = lane; hh < H; hh += 32) v += float(int8_t(ss[row * H + hh]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) sabs[row] = v;
    }
  }
}

__global__ void suffstat_reduce(const float* __restrict__ partial, float* __restrict__ wq,
                                int n_chunks, int HH) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= HH) return;
  float v = 0.f;
  for (int p = 0; p < n_chunks; ++p) v += partial[size_t(p) * HH + e];
  wq[e] = v;
}

template <bool PACKED>
int launch(const void* ss, const void* rs, void* rho, void* sabs, void* wq, void* partial, int B,
           int S, int H, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (B + chunk - 1) / chunk;
  const int nt = (H + TH - 1) / TH;
  suffstat_partial<PACKED><<<dim3(n_chunks, nt, nt), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(ss), static_cast<const float*>(rs), static_cast<float*>(rho),
      static_cast<float*>(sabs), static_cast<float*>(partial), B, S, H, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int HH = H * H;
  suffstat_reduce<<<(HH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                     static_cast<float*>(wq), n_chunks, HH);
  return int(cudaGetLastError());
}

}  // namespace

// ss: int8 0/1 [B, S, H]
extern "C" int evo_bsc_suffstat(const void* ss, const void* rs, void* rho, void* sabs, void* wq,
                                void* partial, int B, int S, int H, int chunk, void* stream) {
  return launch<false>(ss, rs, rho, sabs, wq, partial, B, S, H, chunk, stream);
}

// ss: lane-major packed uint8 [B, S, ceil(H/8)]
extern "C" int evo_bsc_suffstat_packed(const void* ss, const void* rs, void* rho, void* sabs,
                                       void* wq, void* partial, int B, int S, int H, int chunk,
                                       void* stream) {
  return launch<true>(ss, rs, rho, sabs, wq, partial, B, S, H, chunk, stream);
}
