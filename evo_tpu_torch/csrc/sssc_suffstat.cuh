// ES3C M-step sufficient statistics of the merged state sets: the kernels of
// sssc_suffstat.cu (shared Gram, complete data) and sssc_suffstat_masked.cu
// (per-datapoint Gram, incomplete data), one template with MASKED as its
// parameter.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:sssc_suffstat_pallas (body
// _make_suffstat_kernel) and, with MASKED, _suffstat_pallas_masked (the same
// body with masked=True).  Every merged state (b, k) with responsibility r
// and active set A (n units, ascending) is solved again under the Gram G of
// its datapoint (G shared, or G_b = W^T diag(m_b) W [B, H, H] with MASKED):
//
//   lambda_A = (s2inv G_AA + Psi_AA^-1)^-1,  kappa_A = s2inv lambda_A u_A + mus_A
//
// (u = Wty[b]_A - G_AA mus_A; non-finite kappa and lambda entries become 0)
// and the kernel returns
//
//   xpt_sz[b] = sum_k r kappa,  xpt_s[b] = sum_k r s                   [B, H]
//   out[0] = xpt_ss   = sum r s s^T
//   out[1] = xpt_szsz = sum r (lambda + kappa kappa^T)                  [H, H]
//   out[2] = s_sz_outer  = sum_b xpt_s[b] xpt_sz[b]^T
//   out[3] = sz_sz_outer = sum_b xpt_sz[b] xpt_sz[b]^T
//
// With cap > 0 (64 < H <= 128, shared Gram only) a state with n > cap gets
// kappa = 0 and no lambda, while its r still counts in xpt_s and xpt_ss, as
// in the TPU kernel's popcount buckets (w_s uses the unmasked
// responsibilities).  The masked kernel runs at H <= 64 with cap = 0: every
// state is solved exactly, as the TPU's masked kernel (no compaction, no
// overflow rule).
//
// What bounds it on an H100: the bytes, reading the int8 states once
// (B S H bytes, 1.6 MB at B = 4096, S = 20, H = 32) and, with MASKED, the
// G_b entries on the union of each datapoint's active units; the solves
// need two n x n inversions a state, a few dozen flops at the EA's
// sparsity.  Like the lpj kernels it is latency-bound: a warp inverts one
// state's small system with a __syncwarp between the Gauss-Jordan steps.
//
// Design: one warp per state.  Pass 1 gives each block a chunk of whole
// datapoints; warp w takes the chunk's datapoints w, w + WARPS, ... and
// their slots in turn, so the per-datapoint sums build up in the warp's own
// rows of shared memory and the S states of a datapoint read its G_b
// through the same warp's L1.  The active units come from ballots, the
// inversions are unpivoted Gauss-Jordan in the warp's slice of shared
// memory (H x H at H <= 64, where a dense state must stay exact).  The
// chunk's partial xpt_ss and xpt_szsz live in shared memory; after each
// round of states the warps add their states' shares to them one warp after
// the other, in warp order, so the sums come out the same in every run.
// At the end the block forms the chunk's two outer-product sums from the
// finished per-datapoint vectors and writes all four partials; pass 2 sums
// the partials in chunk order.  No float atomics anywhere.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

constexpr int SS_WARPS = 8;  // warps per block

template <bool MASKED>
__global__ void __launch_bounds__(SS_WARPS * 32)
sssc_suffstat_partial(const int8_t* __restrict__ ss, const float* __restrict__ rs,
                      const float* __restrict__ wty, const float* __restrict__ G_all,
                      const float* __restrict__ Psi, const float* __restrict__ mus,
                      const float* __restrict__ s2inv_p, float* __restrict__ xpt_sz,
                      float* __restrict__ xpt_s, float* __restrict__ partial, int B, int S,
                      int H, int nmax, int cap, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int HH = H * H;
  float* ss_p = smem;             // [H, H] partial xpt_ss
  float* szsz_p = ss_p + HH;      // [H, H] partial xpt_szsz
  float* xs = szsz_p + HH;        // [chunk, H] xpt_s of the chunk
  float* xz = xs + chunk * H;     // [chunk, H] xpt_sz of the chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* lam = xz + chunk * H + size_t(warp) * (nmax * nmax + 2 * nmax + H);
  float* u = lam + nmax * nmax;
  float* kap = u + nmax;
  int* idx = reinterpret_cast<int*>(kap + nmax);
  const float s2inv = *s2inv_p;
  const int b_lo = blockIdx.x * chunk;
  const int nb = min(chunk, B - b_lo);

  for (int e = tid; e < 2 * HH + 2 * chunk * H; e += blockDim.x) smem[e] = 0.f;
  __syncthreads();

  const int rounds = (chunk + SS_WARPS - 1) / SS_WARPS * S;
  for (int round = 0; round < rounds; ++round) {
    const int dl = warp + SS_WARPS * (round / S), k = round % S;
    const bool has = dl < nb;  // the same for the whole warp
    int n = 0;
    bool over = false;
    float r = 0.f;
    if (has) {
      const int b = b_lo + dl;
      const float* G = MASKED ? G_all + size_t(b) * HH : G_all;
      const size_t row = size_t(b) * S + k;
      r = rs[row];
      n = active_set(ss + row * H, H, idx, lane);
      over = cap > 0 && n > cap;
      if (!over && n > 0) {
        for (int e = lane; e < n * n; e += 32) {
          const int i = e / n, j = e - (e / n) * n;
          lam[e] = Psi[idx[i] * H + idx[j]];
        }
        gauss_jordan_inverse(lam, n, lane);
        for (int e = lane; e < n * n; e += 32) {
          const int i = e / n, j = e - (e / n) * n;
          lam[e] += s2inv * __ldg(G + idx[i] * H + idx[j]);
        }
        for (int i = lane; i < n; i += 32) {
          const int hi = idx[i];
          float ga = 0.f;
          for (int j = 0; j < n; ++j) ga = fmaf(__ldg(G + hi * H + idx[j]), mus[idx[j]], ga);
          u[i] = wty[size_t(b) * H + hi] - ga;
        }
        gauss_jordan_inverse(lam, n, lane);
        for (int i = lane; i < n; i += 32) {
          float acc = 0.f;
          for (int j = 0; j < n; ++j) acc = fmaf(lam[i * n + j], u[j], acc);
          kap[i] = finite_or_zero(s2inv * acc + mus[idx[i]]);
        }
        __syncwarp();
      }
    }
    // the warps add their states' shares one after the other, in warp order
    for (int t = 0; t < SS_WARPS; ++t) {
      __syncthreads();
      if (warp != t || !has) continue;
      for (int i = lane; i < n; i += 32) {
        xs[dl * H + idx[i]] += r;
        if (!over) xz[dl * H + idx[i]] += r * kap[i];
      }
      for (int e = lane; e < n * n; e += 32) {
        const int i = e / n, j = e - (e / n) * n;
        const int o = idx[i] * H + idx[j];
        ss_p[o] += r;
        if (!over) szsz_p[o] += r * (finite_or_zero(lam[e]) + kap[i] * kap[j]);
      }
    }
    __syncthreads();
  }

  float* out = partial + size_t(blockIdx.x) * 4 * HH;
  for (int e = tid; e < HH; e += blockDim.x) {
    const int i = e / H, j = e - (e / H) * H;
    float a1 = 0.f, a2 = 0.f;
    for (int d = 0; d < nb; ++d) {
      const float zj = xz[d * H + j];
      a1 = fmaf(xs[d * H + i], zj, a1);
      a2 = fmaf(xz[d * H + i], zj, a2);
    }
    out[e] = ss_p[e];
    out[HH + e] = szsz_p[e];
    out[2 * HH + e] = a1;
    out[3 * HH + e] = a2;
  }
  for (int e = tid; e < nb * H; e += blockDim.x) {
    xpt_s[size_t(b_lo) * H + e] = xs[e];
    xpt_sz[size_t(b_lo) * H + e] = xz[e];
  }
}

// Pass 2: the partials summed in chunk order, in double (a block of
// 151,552 datapoints has 9,472 chunks; an f32 running sum would lose
// digits to the length of the chain).
__global__ void suffstat_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                int n_chunks, int n4) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  double v = 0.0;
  for (int p = 0; p < n_chunks; ++p) v += partial[size_t(p) * n4 + e];
  out[e] = float(v);
}

// Both passes on `stream`; returns the first launch error (0 if none).
template <bool MASKED>
int launch_sssc_suffstat(const void* ss, const void* rs, const void* wty, const void* G,
                         const void* Psi, const void* mus, const void* s2inv, void* xpt_sz,
                         void* xpt_s, void* out, void* partial, int B, int S, int H, int cap,
                         int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nmax = cap > 0 ? cap : H;
  const int n_chunks = (B + chunk - 1) / chunk;
  const size_t smem = (size_t(2) * H * H + size_t(2) * chunk * H +
                       size_t(SS_WARPS) * (nmax * nmax + 2 * nmax + H)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(sssc_suffstat_partial<MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  sssc_suffstat_partial<MASKED><<<n_chunks, SS_WARPS * 32, smem, st>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(rs),
      static_cast<const float*>(wty), static_cast<const float*>(G),
      static_cast<const float*>(Psi), static_cast<const float*>(mus),
      static_cast<const float*>(s2inv), static_cast<float*>(xpt_sz),
      static_cast<float*>(xpt_s), static_cast<float*>(partial), B, S, H, nmax, cap, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  const int n4 = 4 * H * H;
  suffstat_reduce<<<(n4 + 255) / 256, 256, 0, st>>>(static_cast<const float*>(partial),
                                                    static_cast<float*>(out), n_chunks, n4);
  return int(cudaGetLastError());
}

}  // namespace
