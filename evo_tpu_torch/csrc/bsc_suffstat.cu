// BSC M-step sufficient statistics of the merged state sets.
//
// Replaces: evo_tpu/ops/pallas_suffstat.py:bsc_suffstat_pallas (int8 states):
//
//   rho[b,h]  = sum_s rs[b,s] ss[b,s,h]
//   sabs[b,s] = sum_h ss[b,s,h]
//   Wq[h,k]   = sum_{b,s} rs[b,s] ss[b,s,h] ss[b,s,k]
//
// What bounds it on an H100: reading the int8 states once (67 MB at
// B = 4096, S = 64, H = 256: 0.02 ms at 3.35 TB/s).  For binary s, Wq adds
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 64;        // Wq tile edge
constexpr int R = 32;         // state rows staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 Wq tile each

__global__ void __launch_bounds__(THREADS)
suffstat_partial(const int8_t* __restrict__ ss, const float* __restrict__ rs,
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

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (size_t base = row_lo; base < row_hi; base += R) {
    __syncthreads();
    for (int e = tid; e < R * TH; e += THREADS) {
      const int r = e / TH, c = e - r * TH;
      const size_t row = base + r;
      const bool ok = row < row_hi;
      const int h = h0 + c, k = k0 + c;
      const float sh = (ok && h < H) ? float(ss[row * H + h]) : 0.f;
      a_s[r][c] = ok ? sh * rs[row] : 0.f;
      b_s[r][c] = (ok && k < H) ? float(ss[row * H + k]) : 0.f;
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
    const int h = h0 + 4 * ty + i;
    if (h >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + 4 * tx + j;
      if (k < H) out[size_t(h) * H + k] = acc[i][j];
    }
  }

  if (blockIdx.z == 0) {  // rho for this chunk's datapoints and h range
    for (int e = tid; e < (b_hi - b_lo) * TH; e += THREADS) {
      const int b = b_lo + e / TH, h = h0 + e % TH;
      if (h >= H) continue;
      float v = 0.f;
      for (int s = 0; s < S; ++s) {
        const size_t row = size_t(b) * S + s;
        v = fmaf(rs[row], float(ss[row * H + h]), v);
      }
      rho[size_t(b) * H + h] = v;
    }
  }
  if (blockIdx.y == 0 && blockIdx.z == 0) {  // sabs, one warp per state row
    const int lane = tid & 31, warp = tid >> 5;
    for (size_t row = row_lo + warp; row < row_hi; row += THREADS / 32) {
      float v = 0.f;
      for (int h = lane; h < H; h += 32) v += float(ss[row * H + h]);
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

}  // namespace

extern "C" int evo_bsc_suffstat(const void* ss, const void* rs, void* rho, void* sabs, void* wq,
                                void* partial, int B, int S, int H, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (B + chunk - 1) / chunk;
  const int nt = (H + TH - 1) / TH;
  suffstat_partial<<<dim3(n_chunks, nt, nt), THREADS, 0, st>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(rs), static_cast<float*>(rho),
      static_cast<float*>(sabs), static_cast<float*>(partial), B, S, H, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int HH = H * H;
  suffstat_reduce<<<(HH + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                     static_cast<float*>(wq), n_chunks, HH);
  return int(cudaGetLastError());
}
