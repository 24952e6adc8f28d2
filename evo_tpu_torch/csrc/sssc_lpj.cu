// ES3C log-pseudo-joint of binary candidate states, slab marginalized.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:sssc_lpj_pallas (body _make_lpj_kernel,
// with _lu_logdet_solve and _build_P), complete data.  For every state row
// (b, k) with active set A (n units, ascending), a = mus_A, Ga = G_AA a and
// u = Wty[b]_A - Ga:
//
//   M'  = I + s2inv Psi_AA G_AA,   x = M'^-1 Psi_AA u   (unpivoted LU)
//   lpj = -1/2 s2inv (y2[b] - 2 a.Wty[b]_A + a.Ga) + sum_A pil_bar
//         - 1/2 sum log|pivot| + 1/2 s2inv^2 u.x
//
// bad = 1 where a pivot is non-finite or below 1e-6 in magnitude, or where
// n exceeds `cap` (cap > 0 only for 64 < H <= 128: the TPU kernel's
// popcount buckets end at Hp/8 = 16); a flagged state's lpj is NaN.
//
// What bounds it on an H100: the bytes, reading the int8 states once
// (B K H bytes, 1.6 MB at B = 4096, K = 20, H = 32: under a microsecond at
// 3.35 TB/s).  At the EA's sparsity (n of about 1-3) the solves are a few
// dozen flops a state.  This kernel is latency-bound instead: one warp
// works through one state's small dense solve, with a __syncwarp between
// the LU's steps, and reads G and Psi entries through the cache.
//
// Design: one warp per state.  The warp reads the state's H bytes, finds
// the active units with ballots and prefix popcounts (the GPU form of the
// TPU kernel's one-hot projection _build_P) and builds the n x n system in
// its own slice of shared memory from the G and Psi entries of A (G and Psi
// are at most 64 KB each and stay in L1/L2).  At H <= 64 a state may be
// dense and must stay exact, so a warp's slice holds an H x H system
// (16 KB at H = 64, past the 48 KB default for a block, hence the
// attribute); above 64 it holds a cap x cap one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

constexpr int WARPS = 8;  // states per block

__global__ void __launch_bounds__(WARPS * 32)
sssc_lpj_kernel(const int8_t* __restrict__ ss, const float* __restrict__ wty,
                const float* __restrict__ y2, const float* __restrict__ G,
                const float* __restrict__ Psi, const float* __restrict__ mus,
                const float* __restrict__ pil, const float* __restrict__ s2inv_p,
                float* __restrict__ lpj, float* __restrict__ bad, int n_rows, int K, int H,
                int nmax, int cap) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= n_rows) return;  // the whole warp: no block-wide barrier below
  float* M = smem + size_t(warp) * (nmax * nmax + 2 * nmax + H);  // n x n system
  float* u = M + nmax * nmax;                                      // u_A
  float* v = u + nmax;                                             // rhs, then x
  int* idx = reinterpret_cast<int*>(v + nmax);                     // A
  const float s2inv = *s2inv_p;
  const int b = row / K;

  const int n = active_set(ss + size_t(row) * H, H, idx, lane);
  if (cap > 0 && n > cap) {
    if (lane == 0) {
      lpj[row] = __int_as_float(0x7fc00000);  // NaN
      bad[row] = 1.f;
    }
    return;
  }

  // base terms and u
  const float* wrow = wty + size_t(b) * H;
  float s_aw = 0.f, s_aga = 0.f, s_pil = 0.f;
  for (int i = lane; i < n; i += 32) {
    const int hi = idx[i];
    float ga = 0.f;
    for (int j = 0; j < n; ++j) ga = fmaf(G[hi * H + idx[j]], mus[idx[j]], ga);
    const float ai = mus[hi], wi = wrow[hi];
    u[i] = wi - ga;
    s_aw = fmaf(ai, wi, s_aw);
    s_aga = fmaf(ai, ga, s_aga);
    s_pil += pil[hi];
  }
  s_aw = warp_sum(s_aw);
  s_aga = warp_sum(s_aga);
  s_pil = warp_sum(s_pil);
  __syncwarp();

  // rhs Psi_AA u and M' = I + s2inv Psi_AA G_AA
  for (int i = lane; i < n; i += 32) {
    const float* prow = Psi + idx[i] * H;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(prow[idx[j]], u[j], acc);
    v[i] = acc;
  }
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e - (e / n) * n;
    const float* prow = Psi + idx[i] * H;
    const int gj = idx[j];
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(prow[idx[k]], G[idx[k] * H + gj], acc);
    M[e] = (i == j ? 1.f : 0.f) + s2inv * acc;
  }
  __syncwarp();

  // unpivoted LU in place, pivots checked as the TPU kernel checks them
  float ld = 0.f;
  bool flagged = false;
  for (int k = 0; k < n; ++k) {
    const float piv = M[k * n + k];
    flagged |= !(fabsf(piv) >= 1e-6f) || isinf(piv);
    ld += logf(fabsf(piv));
    const float ip = 1.f / piv;
    for (int i = k + 1 + lane; i < n; i += 32) M[i * n + k] *= ip;
    __syncwarp();
    const int m = n - k - 1;
    for (int e = lane; e < m * m; e += 32) {
      const int i = k + 1 + e / m, j = k + 1 + e % m;
      M[i * n + j] -= M[i * n + k] * M[k * n + j];
    }
    __syncwarp();
  }
  // forward substitution (unit L), then back substitution (U), in v
  for (int k = 0; k < n; ++k) {
    const float yk = v[k];
    for (int i = k + 1 + lane; i < n; i += 32) v[i] -= M[i * n + k] * yk;
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    const float xk = v[k] / M[k * n + k];
    __syncwarp();
    if (lane == 0) v[k] = xk;
    for (int i = lane; i < k; i += 32) v[i] -= M[i * n + k] * xk;
    __syncwarp();
  }
  float quad = 0.f;
  for (int i = lane; i < n; i += 32) quad = fmaf(u[i], v[i], quad);
  quad = warp_sum(quad);

  if (lane == 0) {
    const float base = -0.5f * s2inv * (y2[b] - 2.f * s_aw + s_aga) + s_pil;
    const float val = base - 0.5f * ld + 0.5f * s2inv * s2inv * quad;
    lpj[row] = flagged ? __int_as_float(0x7fc00000) : val;
    bad[row] = flagged ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int evo_sssc_lpj(const void* ss, const void* wty, const void* y2, const void* G,
                            const void* Psi, const void* mus, const void* pil,
                            const void* s2inv, void* lpj, void* bad, int B, int K, int H,
                            int cap, void* stream) {
  const int n_rows = B * K;
  const int nmax = cap > 0 ? cap : H;
  const size_t smem = size_t(WARPS) * (nmax * nmax + 2 * nmax + H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sssc_lpj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  sssc_lpj_kernel<<<(n_rows + WARPS - 1) / WARPS, WARPS * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(wty),
      static_cast<const float*>(y2), static_cast<const float*>(G),
      static_cast<const float*>(Psi), static_cast<const float*>(mus),
      static_cast<const float*>(pil), static_cast<const float*>(s2inv),
      static_cast<float*>(lpj), static_cast<float*>(bad), n_rows, K, H, nmax, cap);
  return int(cudaGetLastError());
}
