// ES3C log-pseudo-joint of binary candidate states under a per-datapoint
// Gram G_b = W^T diag(m_b) W [B, H, H] (incomplete data), slab marginalized.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:_lpj_pallas_masked (body
// _make_lpj_kernel_masked, solves _solve_core with _pd_inv_logdet).  For
// every state row (b, k) with active set A (n units, ascending), a = mus_A,
// Ga = G_b,AA a and u = Wty[b]_A - Ga, the kernel takes the TPU kernel's two
// inverses:
//
//   P = Psi_AA^-1,  ldP = log|det Psi_AA|         (unpivoted Gauss-Jordan)
//   L = M^-1,       ldM = log|det M|,   M = s2inv G_b,AA + P   (the same)
//   lpj = -1/2 s2inv (y2[b] - 2 a.Wty[b]_A + a.Ga) + sum_A pil_bar
//         - 1/2 (ldM + ldP) + 1/2 s2inv^2 u^T L u
//
// The flag rule is the TPU kernel's, not sssc_lpj.cu's pivot test: bad = 1
// where P has a non-finite entry (a singular Psi_AA) or the assembled lpj is
// non-finite, and such a state's lpj is NaN.  A small but finite pivot is
// not flagged.  Every state is solved exactly, at H <= 64.
//
// What bounds it on an H100: the bytes, reading the int8 states once
// (B K H bytes) and, for each datapoint, the G_b entries on the union of
// its states' active units (a few hundred bytes at the EA's sparsity, 16 KB
// at most at H = 64); the solves are a few dozen flops a state there.  The
// kernel is latency-bound instead, like sssc_lpj.cu: one warp works through
// one state's two small inversions with a __syncwarp between the steps.
//
// Design: one warp per state, each block the states of DPB whole
// datapoints (DPB = ceil(32 / K), so a block has at least 32 states), so the
// K states of a datapoint read their G_b entries through the same SM's L1
// instead of from device memory once a state.  The TPU kernel was given
// Ga = G_b a from an XLA einsum because Mosaic could not build it; here the
// warp forms it from the same G_b entries.  A warp's slice of shared memory
// holds an H x H system (16 KB at H = 64, past the 48 KB default for a
// block, hence the attribute, as in sssc_lpj.cu): Psi_AA is inverted in
// place, s2inv G_b,AA added, and the sum inverted in place again.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

constexpr int WARPS = 8;  // warps per block

__global__ void __launch_bounds__(WARPS * 32)
sssc_lpj_masked_kernel(const int8_t* __restrict__ ss, const float* __restrict__ wty,
                       const float* __restrict__ y2, const float* __restrict__ G_all,
                       const float* __restrict__ Psi, const float* __restrict__ mus,
                       const float* __restrict__ pil, const float* __restrict__ s2inv_p,
                       float* __restrict__ lpj, float* __restrict__ bad, int B, int K, int H,
                       int dpb) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* L = smem + size_t(warp) * (H * H + 2 * H);  // n x n system
  float* u = L + H * H;                               // u_A
  int* idx = reinterpret_cast<int*>(u + H);           // A
  const float s2inv = *s2inv_p;
  const size_t HH = size_t(H) * H;
  const long long row_lo = (long long)blockIdx.x * dpb * K;
  const long long row_hi = min((long long)(blockIdx.x + 1) * dpb, (long long)B) * K;

  for (long long row = row_lo + warp; row < row_hi; row += WARPS) {
    const int b = int(row / K);
    const float* G = G_all + size_t(b) * HH;
    const int n = active_set(ss + size_t(row) * H, H, idx, lane);

    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - (e / n) * n;
      L[e] = Psi[idx[i] * H + idx[j]];
    }
    const float ldP = gauss_jordan_inverse(L, n, lane);
    bool nonfinite = false;
    for (int e = lane; e < n * n; e += 32) nonfinite |= !isfinite(L[e]);
    const bool psi_bad = __any_sync(FULL, nonfinite);
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - (e / n) * n;
      L[e] += s2inv * __ldg(G + idx[i] * H + idx[j]);
    }

    // base terms and u
    const float* wrow = wty + size_t(b) * H;
    float s_aw = 0.f, s_aga = 0.f, s_pil = 0.f;
    for (int i = lane; i < n; i += 32) {
      const int hi = idx[i];
      float ga = 0.f;
      for (int j = 0; j < n; ++j) ga = fmaf(__ldg(G + hi * H + idx[j]), mus[idx[j]], ga);
      const float ai = mus[hi], wi = wrow[hi];
      u[i] = wi - ga;
      s_aw = fmaf(ai, wi, s_aw);
      s_aga = fmaf(ai, ga, s_aga);
      s_pil += pil[hi];
    }
    s_aw = warp_sum(s_aw);
    s_aga = warp_sum(s_aga);
    s_pil = warp_sum(s_pil);

    const float ldM = gauss_jordan_inverse(L, n, lane);  // begins with a __syncwarp
    float quad = 0.f;
    for (int i = lane; i < n; i += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(L[i * n + j], u[j], acc);
      quad = fmaf(u[i], acc, quad);
    }
    quad = warp_sum(quad);

    if (lane == 0) {
      const float base = -0.5f * s2inv * (y2[b] - 2.f * s_aw + s_aga) + s_pil;
      const float val = base - 0.5f * (ldM + ldP) + 0.5f * s2inv * s2inv * quad;
      const bool flagged = psi_bad || !isfinite(val);
      lpj[row] = flagged ? __int_as_float(0x7fc00000) : val;  // NaN
      bad[row] = flagged ? 1.f : 0.f;
    }
    __syncwarp();  // idx, u and L are rewritten for the next state
  }
}

}  // namespace

extern "C" int evo_sssc_lpj_masked(const void* ss, const void* wty, const void* y2,
                                   const void* G, const void* Psi, const void* mus,
                                   const void* pil, const void* s2inv, void* lpj, void* bad,
                                   int B, int K, int H, void* stream) {
  const int dpb = (32 + K - 1) / K;
  const int n_blocks = (B + dpb - 1) / dpb;
  const size_t smem = size_t(WARPS) * (H * H + 2 * H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sssc_lpj_masked_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  sssc_lpj_masked_kernel<<<n_blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(wty),
      static_cast<const float*>(y2), static_cast<const float*>(G),
      static_cast<const float*>(Psi), static_cast<const float*>(mus),
      static_cast<const float*>(pil), static_cast<const float*>(s2inv),
      static_cast<float*>(lpj), static_cast<float*>(bad), B, K, H, dpb);
  return int(cudaGetLastError());
}
