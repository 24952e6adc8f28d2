// ES3C log-pseudo-joint of binary candidate states, slab marginalized: the
// kernels of sssc_lpj.cu (shared Gram, complete data) and sssc_lpj_masked.cu
// (per-datapoint Gram G_b = W^T diag(m_b) W [B, H, H], incomplete data), one
// template with MASKED as its parameter.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:sssc_lpj_pallas (body
// _make_lpj_kernel, with _lu_logdet_solve and _build_P) and, with MASKED,
// _lpj_pallas_masked (body _make_lpj_kernel_masked, solves _solve_core with
// _pd_inv_logdet).  For every state row (b, k) with active set A (n units,
// ascending), a = mus_A, Ga = G_AA a and u = Wty[b]_A - Ga (G = G_b with
// MASKED):
//
//   base = -1/2 s2inv (y2[b] - 2 a.Wty[b]_A + a.Ga) + sum_A pil_bar
//
// Shared Gram: M' = I + s2inv Psi_AA G_AA by an unpivoted LU, x = M'^-1
// Psi_AA u by a forward (unit L) and a back substitution, and
//
//   lpj = base - 1/2 sum log|pivot| + 1/2 s2inv^2 u.x
//
// bad = 1 where a pivot is non-finite or below 1e-6 in magnitude, or where
// n exceeds `cap` (cap > 0 only for 64 < H <= 128: the TPU kernel's
// popcount buckets end at Hp/8 = 16; such a state is not solved).
//
// MASKED: the TPU kernel's two inverses, by unpivoted Gauss-Jordan
// (small_solve.cuh, the steps of ops/linalg.py:pd_inverse_logdet):
//
//   P = Psi_AA^-1, ldP = log|det Psi_AA|;  L = M^-1, ldM = log|det M|,
//   M = s2inv G_b,AA + P;   lpj = base - 1/2 (ldM + ldP) + 1/2 s2inv^2 u^T L u
//
// with the TPU kernel's flag rule: bad = 1 where P has a non-finite entry (a
// singular Psi_AA) or the assembled lpj is non-finite; a small but finite
// pivot is not flagged.  Every state is solved exactly, at H <= 64.  In both
// kernels a flagged state's lpj is NaN, never +-inf, and the empty state
// (n = 0) has lpj = -1/2 s2inv y2[b] and is never flagged.
//
// What bounds it on an H100: the bytes.  At the EA's sparsity (n of about
// 1-3) a state's solve is a few dozen flops; the int8 states are B K H bytes
// (2.6 MB at B = 4096, K = 20, H = 32: under a microsecond at 3.35 TB/s)
// and, with MASKED, the G_b entries on the union of each datapoint's active
// units add u^2 floats a datapoint (the inpainting block, B = 151,209:
// 0.13 ms in all; chip_smoke.py's sssc_lpj_bound and masked_lpj_bound count
// both from the data).  What keeps a kernel from that bound is latency: a
// state's work is a short chain of dependent steps, so the design gives
// every thread a state of its own and no barrier per state.
//
// Design.  A block of 128 threads takes at most R <= 128 consecutive rows
// (R and the dense scratch from lp_plan, for the block's shared memory):
// without MASKED any R rows; with MASKED U whole datapoints (U K <= R
// rows), or one piece of R rows of a datapoint when K > R.
//  1. Masks.  Each thread reads one row's H bytes (16 at a time where the
//     row is aligned, state_mask.cuh) into a 128-bit mask in registers and
//     counts n.  A row is sparse (n <= SPARSE_N = 8, the empty row too),
//     dense, or over the cap; a dense row's thread puts its mask and its
//     place in the block's list.
//  2. Staging.  Without MASKED the block copies G and Psi into shared
//     memory (cp.async, in flight while the rows are read), 16 bytes a
//     thread, or, where H is a multiple of 32, a warp a row, 4 bytes a lane,
//     with a row stride of H + 1, so that the lanes of a dense state's
//     warp, a unit each, read a column in distinct banks (at stride 32 they
//     would all read one; 4-byte copies of all of it made the width-100
//     call slower than the old kernel on the card): 8 KB at
//     H = 32, 80 KB at H = 100 and 128 KB at H = 128, where one block an SM
//     is left (the width-100 path runs in one wave of two blocks an SM; the
//     alternative, __ldg reads of scattered entries through L1 at every
//     step, was not taken).  With MASKED each thread ORs its mask into its
//     datapoint's union, and the block copies the G_b rows of that union
//     only (cp.async, 16 bytes a thread): the rows of the units its states
//     touch, not the whole H x H block (at the inpainting block 0.13 ms of
//     reads against 0.19 ms for every G_b whole, and far fewer where the
//     EA's states of a datapoint share their units).  Psi, mus, pil_bar and
//     Wty are read through L1.  The sparse rows are counted by n and put in
//     order of n (a counting sort in shared memory).
//  3. Sparse states, a thread each in that order, in a register tile of 2,
//     4 or 8 units, the smallest that holds the warp's largest n: the
//     elimination's steps are unrolled over the tile and taken only while
//     k < n, so a warp's time is that of its densest state, and the sort
//     keeps that near the others' (the 8-unit tile costs a warp several
//     times the 2-unit one).  Shared Gram: u and base, then M' a row at a time
//     (the row's Psi_AA entries in registers, G_AA from shared memory,
//     products summed over units ascending, as the TPU kernel and the old
//     warp kernel summed them) with the row of Psi_AA u; the LU, pivots
//     checked as they come; the two substitutions.  M' = I + s2inv
//     (Psi_AA G_AA) and each update of the LU are rounded as the plain
//     version's (ops/sssc_lpj.py:_lu_unpivoted) are, a product and then a
//     sum, not fused: the flags follow pivots near 1e-6, and a pivot of a
//     single unit then is the plain version's to the bit.
//     MASKED: Psi_AA -> gauss_jordan_regs -> P and ldP; P + s2inv G_b,AA
//     -> gauss_jordan_regs -> L and ldM; u^T L u.  Over the cap: NaN, no
//     solve.  Each thread writes its own lpj and bad.
//  4. Dense states (8 < n <= H at H <= 64, 8 < n <= 16 above), rare at the
//     EA's sparsity: a warp each, the first DQ warps of the block in turn
//     over the list, each with its own scratch in shared memory, in
//     functions kept out of line so that their registers do not crowd the
//     sparse path's.  A lane holds a column of the system in registers,
//     column k's entries come from lane k by shuffles, and every step runs
//     over all 32 rows (the identity past n) with no test of n, which the
//     compiler would turn into a branch per row: the shared Gram's LU up
//     to 31 units (lu_warp, with Psi_AA u as a 32nd column, so that the
//     LU's own steps do the forward substitution, and u.x from U's
//     transpose), MASKED's two inversions up to 32 (gauss_jordan_warp).
//     Denser states take the same steps in shared memory (lu_shared,
//     gauss_jordan_cols), which for a 31-unit state take several times as
//     long.  The check inputs of chip_smoke.py put six 26- to 31-unit
//     states in one block, whose two rounds of lu_warp set that call's
//     time.
// Each state's lpj and bad depend only on its own inputs, with no float
// atomics, so the outputs are the same from run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "small_solve.cuh"
#include "state_mask.cuh"

namespace {

constexpr int LP_THREADS = 128;
constexpr int LP_NW = LP_THREADS / 32;  // warps
constexpr int LP_ROWS = 128;            // rows of a block at most: a thread each

enum LpKind { LP_NONE = 0, LP_SPARSE = 1, LP_DENSE = 2, LP_OVER = 3 };

__device__ __forceinline__ float lp_nan() { return __int_as_float(0x7fc00000); }

// Byte offsets of a block's shared memory for width H, K states a datapoint,
// at most R rows and DQ warps with dense scratch.
struct LpLayout {
  int U;   // datapoints of a block with MASKED (1 when a datapoint comes in pieces)
  int GS;  // row stride of the staged matrices: H, or H + 1 for G and Psi where H
           // is a multiple of 32 (stride H would put a column in one bank)
  size_t g, psi, uni, cnt, order, smask, dmask, dlist, pool, total;
};

__host__ __device__ inline LpLayout lp_layout(int H, int K, bool masked, int cap, int R, int DQ) {
  LpLayout L;
  L.U = masked ? (K > R ? 1 : R / K) : 0;
  L.GS = !masked && H % 32 == 0 ? H + 1 : H;
  size_t o = 0;
  L.g = take(o, 4 * size_t(masked ? L.U : 1) * H * L.GS);  // the G_b rows of the unions, or G
  L.psi = take(o, masked ? 0 : 4 * size_t(H) * L.GS);       // Psi
  L.uni = take(o, masked ? 8 * size_t(L.U) : 0);            // each datapoint's union of units
  L.cnt = take(o, 4 * size_t(SPARSE_N + 1));                // the sparse rows of each n
  L.order = take(o, 4 * size_t(R));                         // the sparse rows by n
  L.smask = take(o, 16 * size_t(R));                        // and their masks
  L.dmask = take(o, 16 * size_t(R));                        // the dense rows' masks
  L.dlist = take(o, 4 * size_t(R + 1));                     // the dense rows, then their count
  L.pool = take(o, 4 * size_t(DQ) * dense_floats(cap > 0 ? cap : H));
  L.total = o;
  return L;
}

// bit h of (lo, hi) <=> byte h of the state row at p (H <= 128 int8 bytes) is
// nonzero
__device__ __forceinline__ void row_mask(const uint8_t* p, int H, uint64_t& lo, uint64_t& hi) {
  const bool aligned = (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  lo = hi = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (16 * c < H) {
      const uint4 v = load16(p + 16 * c, H - 16 * c, aligned);
      const uint64_t bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
                            nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
      if (c < 4)
        lo |= bits << (16 * c);
      else
        hi |= bits << (16 * (c - 4));
    }
  }
}

// the lowest N units of the mask (lo, hi), ascending (0 past its last)
template <int N>
__device__ __forceinline__ void units_of(uint64_t lo, uint64_t hi, int (&idx)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (lo) {
      idx[i] = __ffsll(static_cast<long long>(lo)) - 1;
      lo &= lo - 1;
    } else if (hi) {
      idx[i] = 64 + __ffsll(static_cast<long long>(hi)) - 1;
      hi &= hi - 1;
    } else {
      idx[i] = 0;
    }
  }
}

// the units of a dense row's mask m[2] into idx, ascending, by a warp
__device__ __forceinline__ void dense_units(const uint64_t* m, int* idx, int lane) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const uint32_t word = static_cast<uint32_t>(m[w >> 1] >> (32 * (w & 1)));
    if ((word >> lane) & 1u) idx[c + __popc(word & ((1u << lane) - 1u))] = 32 * w + lane;
    c += __popc(word);
  }
  __syncwarp();
}

// A sparse state under the shared Gram, a thread, in an N x N register tile
// (n <= N): Gs and Ps are G and Psi in shared memory, rows GS apart.
// Returns the flag; val is the lpj.
template <int N>
__device__ __forceinline__ bool lpj_sparse(uint64_t lo, uint64_t hi, int n, const float* wty_b,
                                           float y2b, const float* Gs, const float* Ps,
                                           const float* __restrict__ mus,
                                           const float* __restrict__ pil, float s2inv, int GS,
                                           float& val) {
  int idx[N];
  units_of(lo, hi, idx);
  float mu[N], u[N], v[N], M[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) mu[i] = i < n ? __ldg(mus + idx[i]) : 0.f;
  float s_aw = 0.f, s_aga = 0.f, s_pil = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u[i] = 0.f;
    if (i < n) {
      float ga = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) ga = fmaf(Gs[idx[i] * GS + idx[j]], mu[j], ga);
      const float w = __ldg(wty_b + idx[i]);
      u[i] = w - ga;
      s_aw = fmaf(mu[i], w, s_aw);
      s_aga = fmaf(mu[i], ga, s_aga);
      s_pil += __ldg(pil + idx[i]);
    }
  }
  // M' = I + s2inv Psi_AA G_AA and v = Psi_AA u, a row at a time
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) M[i][j] = i == j ? 1.f : 0.f;
    if (i < n) {
      float p[N];
#pragma unroll
      for (int k = 0; k < N; ++k) p[k] = k < n ? Ps[idx[i] * GS + idx[k]] : 0.f;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) acc = fmaf(p[j], u[j], acc);
      v[i] = acc;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < n) {
          float a = 0.f;
#pragma unroll
          for (int k = 0; k < N; ++k)
            if (k < n) a = fmaf(p[k], Gs[idx[k] * GS + idx[j]], a);
          M[i][j] += __fmul_rn(s2inv, a);
        }
      }
    }
  }
  // unpivoted LU in place, pivots checked as the TPU kernel checks them
  float ld = 0.f;
  bool flagged = false;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k < n) {
      const float piv = M[k][k];
      flagged |= !(fabsf(piv) >= 1e-6f) || isinf(piv);
      ld += logf(fabsf(piv));
      const float ip = 1.f / piv;
#pragma unroll
      for (int i = k + 1; i < N; ++i)
        if (i < n) M[i][k] *= ip;
#pragma unroll
      for (int i = k + 1; i < N; ++i)
#pragma unroll
        for (int j = k + 1; j < N; ++j)
          if (i < n && j < n) M[i][j] = __fsub_rn(M[i][j], __fmul_rn(M[i][k], M[k][j]));
    }
  }
  // forward substitution (unit L), then back substitution (U), in v
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < n)
#pragma unroll
      for (int i = k + 1; i < N; ++i)
        if (i < n) v[i] -= M[i][k] * v[k];
#pragma unroll
  for (int k = N - 1; k >= 0; --k) {
    if (k < n) {
      const float xk = v[k] / M[k][k];
      v[k] = xk;
#pragma unroll
      for (int i = 0; i < k; ++i) v[i] -= M[i][k] * xk;
    }
  }
  float quad = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) quad = fmaf(u[i], v[i], quad);
  const float base = -0.5f * s2inv * (y2b - 2.f * s_aw + s_aga) + s_pil;
  val = base - 0.5f * ld + 0.5f * s2inv * s2inv * quad;
  return flagged;
}

// A sparse state under its datapoint's Gram Gd (the staged G_b rows, GS
// apart), a thread, in an N x N register tile (n <= N).  Returns the flag;
// val is the lpj.
template <int N>
__device__ __forceinline__ bool lpj_sparse_masked(uint64_t m, int n, const float* wty_b, float y2b,
                                                  const float* Gd, const float* __restrict__ Psi,
                                                  const float* __restrict__ mus,
                                                  const float* __restrict__ pil, float s2inv,
                                                  int H, int GS, float& val) {
  int idx[N];
  units_of(m, uint64_t(0), idx);
  float A[N][N], mu[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = i < n ? __ldg(mus + idx[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      A[i][j] = (i < n && j < n) ? __ldg(Psi + idx[i] * H + idx[j]) : (i == j ? 1.f : 0.f);
  }
  const float ldP = gauss_jordan_regs<N, true>(A, n);
  bool psi_bad = false;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (i < n && j < n) psi_bad |= !isfinite(A[i][j]);
  float s_aw = 0.f, s_aga = 0.f, s_pil = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    u[i] = 0.f;
    if (i < n) {
      float ga = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j < n) {
          const float g = Gd[idx[i] * GS + idx[j]];
          A[i][j] += s2inv * g;
          ga = fmaf(g, mu[j], ga);
        }
      }
      const float w = __ldg(wty_b + idx[i]);
      u[i] = w - ga;
      s_aw = fmaf(mu[i], w, s_aw);
      s_aga = fmaf(mu[i], ga, s_aga);
      s_pil += __ldg(pil + idx[i]);
    }
  }
  const float ldM = gauss_jordan_regs<N, true>(A, n);
  float quad = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < n) acc = fmaf(A[i][j], u[j], acc);
      quad = fmaf(u[i], acc, quad);
    }
  }
  const float base = -0.5f * s2inv * (y2b - 2.f * s_aw + s_aga) + s_pil;
  val = base - 0.5f * (ldM + ldP) + 0.5f * s2inv * s2inv * quad;
  return psi_bad || !isfinite(val);
}

// u = Wty[b]_A - G_AA a, a = mus_A, into u[n] by a warp, a lane a unit, and
// base (every lane).  G holds the rows of the units, GS apart.
__device__ __forceinline__ float dense_base(const int* idx, int n, const float* wty_b, float y2b,
                                            const float* G, const float* __restrict__ mus,
                                            const float* __restrict__ pil, float s2inv, int GS,
                                            float* u, int lane) {
  float s_aw = 0.f, s_aga = 0.f, s_pil = 0.f;
  for (int i = lane; i < n; i += 32) {
    const int hi = idx[i];
    float ga = 0.f;
    for (int j = 0; j < n; ++j) ga = fmaf(G[hi * GS + idx[j]], __ldg(mus + idx[j]), ga);
    const float ai = __ldg(mus + hi), wi = __ldg(wty_b + hi);
    u[i] = wi - ga;
    s_aw = fmaf(ai, wi, s_aw);
    s_aga = fmaf(ai, ga, s_aga);
    s_pil += __ldg(pil + hi);
  }
  s_aw = warp_sum(s_aw);
  s_aga = warp_sum(s_aga);
  s_pil = warp_sum(s_pil);
  __syncwarp();
  return -0.5f * s2inv * (y2b - 2.f * s_aw + s_aga) + s_pil;
}

// M' = I + s2inv Psi_AA G_AA, its unpivoted LU and u.x, x = M'^-1 Psi_AA u,
// by a warp in registers, n <= 31: lane j < n holds column j of M', lane n
// the right-hand side v = Psi_AA u, the lanes past n and the rows past n the
// identity's.  The columns are built a unit k at a time (the products of
// each entry summed over k ascending, as lu_shared sums them); the LU's
// steps are lu_shared's, column k's entries from lane k by shuffles, on all
// 32 rows (past n a row adds nothing), the rows moved up by one after each
// step so that the pivot row is c[0], and moved back after the n steps.
// Lane n's column ends as y = L^-1 v (the forward substitution), and
// u.x = w.y with w = U^-T u, which each lane j gets from its own column of
// U and the w_i before it (shuffles).  Every lane returns the flag, ld (the
// sum of log|pivot|) and u.x.
__device__ __forceinline__ bool lu_warp(const int* idx, const float* u, int n, const float* Gs,
                                        const float* Ps, float s2inv, int GS, int lane, float& ld,
                                        float& quad) {
  float c[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
  const int jj = idx[lane < n ? lane : 0];
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const int hk = idx[k];
    const float gk = Gs[hk * GS + jj], uk = u[k];
    const float x = lane < n ? gk : (lane == n ? uk : 0.f);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = Ps[idx[i < n ? i : 0] * GS + hk];
      c[i] = fmaf(i < n ? p : 0.f, x, c[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (lane < n)
      c[i] = (i == lane ? 1.f : 0.f) + __fmul_rn(s2inv, c[i]);
    else if (lane > n)
      c[i] = i == lane ? 1.f : 0.f;
  }
  bool flagged = false;
  ld = 0.f;
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    const float piv = __shfl_sync(FULL, c[0], k);
    flagged |= !(fabsf(piv) >= 1e-6f) || isinf(piv);
    ld += logf(fabsf(piv));
    const float ip = 1.f / piv;
    const bool mine = lane == k, right = lane > k;
#pragma unroll
    for (int i = 1; i < 32; ++i) {  // rows k + 1 .. 31 at 1 .. 31 - k
      if (mine && i < 32 - k) c[i] *= ip;
      const float aik = __shfl_sync(FULL, c[i], k);
      if (right && i < 32 - k) c[i] = __fsub_rn(c[i], __fmul_rn(aik, c[0]));
    }
    push_row(c, c[0]);
  }
#pragma unroll 1
  for (int k = n; k < 32; ++k) push_row(c, c[0]);
  float diag = 1.f;  // U[j][j] of this lane's column
#pragma unroll
  for (int i = 0; i < 32; ++i) diag = lane == i ? c[i] : diag;
  const float rd = 1.f / diag, ul = lane < n ? u[lane] : 0.f;
  float s = 0.f, q = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float wi = __shfl_sync(FULL, (ul - s) * rd, i);
    if (lane > i) s = fmaf(c[i], wi, s);
    if (i < n) q = fmaf(wi, c[i], q);
  }
  quad = __shfl_sync(FULL, q, n);
  return flagged;
}

// The same in a warp's shared memory, n <= 64: M' into M a lane a column,
// the LU in place (column k scaled, then a lane a column of the trailing
// block, its rows 8 at a time, loads ahead of stores), then v = Psi_AA u
// and the two substitutions.  Every lane returns the flag, ld and u.x.
__device__ bool lu_shared(const int* idx, const float* u, int n, const float* Gs, const float* Ps,
                          float s2inv, int GS, float* M, float* v, int lane, float& ld,
                          float& quad) {
  for (int j = lane; j < n; j += 32) {
    const int gj = idx[j];
    for (int i = 0; i < n; ++i) {
      const float* prow = Ps + idx[i] * GS;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(prow[idx[k]], Gs[idx[k] * GS + gj], acc);
      M[i * n + j] = (i == j ? 1.f : 0.f) + __fmul_rn(s2inv, acc);
    }
  }
  for (int i = lane; i < n; i += 32) {
    const float* prow = Ps + idx[i] * GS;
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(prow[idx[j]], u[j], acc);
    v[i] = acc;
  }
  __syncwarp();
  bool flagged = false;
  ld = 0.f;
  for (int k = 0; k < n; ++k) {
    const float piv = M[k * n + k];
    flagged |= !(fabsf(piv) >= 1e-6f) || isinf(piv);
    ld += logf(fabsf(piv));
    const float ip = 1.f / piv;
    for (int i = k + 1 + lane; i < n; i += 32) M[i * n + k] *= ip;
    __syncwarp();
    for (int j = k + 1 + lane; j < n; j += 32) {
      const float r = M[k * n + j];
      for (int i0 = k + 1; i0 < n; i0 += 8) {
        float mik[8], a[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int i = i0 + t < n ? i0 + t : k;
          mik[t] = M[i * n + k];
          a[t] = M[i * n + j];
        }
#pragma unroll
        for (int t = 0; t < 8; ++t)
          if (i0 + t < n) M[(i0 + t) * n + j] = __fsub_rn(a[t], __fmul_rn(mik[t], r));
      }
    }
    __syncwarp();
  }
  for (int k = 0; k < n; ++k) {  // forward substitution (unit L), then back (U)
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
  float q = 0.f;
  for (int i = lane; i < n; i += 32) q = fmaf(u[i], v[i], q);
  quad = warp_sum(q);
  return flagged;
}

// A dense state under the shared Gram, a warp, in its scratch sc (the
// system, u, the right-hand side and the units): lu_warp up to 31 units,
// lu_shared above.  Every lane returns the flag and the lpj.
__device__ __noinline__ bool lpj_dense(const uint64_t* m, int n, const float* wty_b, float y2b,
                                       const float* Gs, const float* Ps,
                                       const float* __restrict__ mus,
                                       const float* __restrict__ pil, float s2inv, int GS,
                                       float* sc, int lane, float& val) {
  float* M = sc;
  float* u = M + n * n;
  float* v = u + n;
  int* idx = reinterpret_cast<int*>(v + n);
  dense_units(m, idx, lane);
  const float base = dense_base(idx, n, wty_b, y2b, Gs, mus, pil, s2inv, GS, u, lane);
  float ld, quad;
  const bool flagged = n < 32 ? lu_warp(idx, u, n, Gs, Ps, s2inv, GS, lane, ld, quad)
                              : lu_shared(idx, u, n, Gs, Ps, s2inv, GS, M, v, lane, ld, quad);
  val = base - 0.5f * ld + 0.5f * s2inv * s2inv * quad;
  return flagged;
}

// A dense state under its datapoint's Gram Gd (GS apart), a warp, in its
// scratch sc (the system, u and the units): two inversions, by
// gauss_jordan_warp in registers up to 32 units (lane j holds column j, the
// identity past n), by gauss_jordan_cols in sc above.  Every lane returns
// the flag and the lpj.
__device__ __noinline__ bool lpj_dense_masked(const uint64_t* m, int n, const float* wty_b,
                                              float y2b, const float* Gd,
                                              const float* __restrict__ Psi,
                                              const float* __restrict__ mus,
                                              const float* __restrict__ pil, float s2inv, int H,
                                              int GS, float* sc, int lane, float& val) {
  float* A = sc;
  float* u = A + n * n;
  int* idx = reinterpret_cast<int*>(u + n);
  dense_units(m, idx, lane);
  const bool regs = n <= 32;
  float c[32];
  float ld;
  bool nonfinite = false;
  if (regs) {
    const int jj = idx[lane < n ? lane : 0];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = __ldg(Psi + idx[i < n ? i : 0] * H + jj);
      c[i] = i < n && lane < n ? x : (i == lane ? 1.f : 0.f);
    }
    ld = gauss_jordan_warp<true>(c, n, lane);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool in = i < n && lane < n;
      nonfinite |= in && !isfinite(c[i]);
      const float g = Gd[idx[i < n ? i : 0] * GS + jj];
      if (in) c[i] += s2inv * g;
    }
  } else {
    for (int j = lane; j < n; j += 32)  // a lane a column
      for (int i = 0; i < n; ++i) A[i * n + j] = __ldg(Psi + idx[i] * H + idx[j]);
    ld = gauss_jordan_cols<true>(A, n, lane);
    for (int j = lane; j < n; j += 32) {
      for (int i = 0; i < n; ++i) {
        nonfinite |= !isfinite(A[i * n + j]);
        A[i * n + j] += s2inv * Gd[idx[i] * GS + idx[j]];
      }
    }
  }
  const bool psi_bad = __any_sync(FULL, nonfinite);
  const float base = dense_base(idx, n, wty_b, y2b, Gd, mus, pil, s2inv, GS, u, lane);
  float quad = 0.f;
  if (regs) {
    ld += gauss_jordan_warp<true>(c, n, lane);
    float acc = 0.f;  // column j of L against u
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ui = u[i < n ? i : 0];
      acc = fmaf(c[i], i < n ? ui : 0.f, acc);
    }
    quad = warp_sum(lane < n ? u[lane] * acc : 0.f);
  } else {
    ld += gauss_jordan_cols<true>(A, n, lane);  // begins with a __syncwarp
    for (int i = lane; i < n; i += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(A[i * n + j], u[j], acc);
      quad = fmaf(u[i], acc, quad);
    }
    quad = warp_sum(quad);
  }
  val = base - 0.5f * ld + 0.5f * s2inv * s2inv * quad;
  return psi_bad || !isfinite(val);
}

// A sparse state's lpj in the smallest register tile that holds wmax, the
// largest n among the warp's states (the block's sparse rows are sorted by
// n, so a warp's are alike).
template <bool MASKED>
__device__ __forceinline__ bool lpj_sparse_tile(int wmax, uint64_t lo, uint64_t hi, int n,
                                                const float* wty_b, float y2b, const float* Gd,
                                                const float* Ps, const float* __restrict__ Psi,
                                                const float* __restrict__ mus,
                                                const float* __restrict__ pil, float s2inv,
                                                int H, int GS, float& val) {
  if (MASKED) {
    if (wmax <= 2)
      return lpj_sparse_masked<2>(lo, n, wty_b, y2b, Gd, Psi, mus, pil, s2inv, H, GS, val);
    if (wmax <= 4)
      return lpj_sparse_masked<4>(lo, n, wty_b, y2b, Gd, Psi, mus, pil, s2inv, H, GS, val);
    return lpj_sparse_masked<SPARSE_N>(lo, n, wty_b, y2b, Gd, Psi, mus, pil, s2inv, H, GS, val);
  }
  if (wmax <= 2) return lpj_sparse<2>(lo, hi, n, wty_b, y2b, Gd, Ps, mus, pil, s2inv, GS, val);
  if (wmax <= 4) return lpj_sparse<4>(lo, hi, n, wty_b, y2b, Gd, Ps, mus, pil, s2inv, GS, val);
  return lpj_sparse<SPARSE_N>(lo, hi, n, wty_b, y2b, Gd, Ps, mus, pil, s2inv, GS, val);
}

template <bool MASKED>
__global__ void __launch_bounds__(LP_THREADS, 4)
sssc_lpj_kernel(const int8_t* __restrict__ ss, const float* __restrict__ wty,
                const float* __restrict__ y2, const float* __restrict__ G,
                const float* __restrict__ Psi, const float* __restrict__ mus,
                const float* __restrict__ pil, const float* __restrict__ s2inv_p,
                float* __restrict__ lpj, float* __restrict__ bad, int B, int K, int H, int cap,
                int R, int DQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LpLayout L = lp_layout(H, K, MASKED, cap, R, DQ);
  float* gs = reinterpret_cast<float*>(smem + L.g);
  float* ps = reinterpret_cast<float*>(smem + L.psi);
  unsigned long long* uni = reinterpret_cast<unsigned long long*>(smem + L.uni);
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);
  int* order = reinterpret_cast<int*>(smem + L.order);
  uint64_t* smask = reinterpret_cast<uint64_t*>(smem + L.smask);
  uint64_t* dmask = reinterpret_cast<uint64_t*>(smem + L.dmask);
  int* dlist = reinterpret_cast<int*>(smem + L.dlist);
  float* pool = reinterpret_cast<float*>(smem + L.pool);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int GS = L.GS, GH = H * GS;  // a staged matrix's floats
  const float s2inv = *s2inv_p;

  // the block's rows [row0, row0 + nr) and, with MASKED, datapoints [b0, b0 + nd)
  long long row0, b0 = 0;
  int nr, nd = 0;
  if (!MASKED) {
    row0 = (long long)blockIdx.x * R;
    nr = int(min((long long)R, (long long)B * K - row0));
  } else if (K > R) {
    const int np = (K + R - 1) / R, pc = blockIdx.x % np;
    b0 = blockIdx.x / np;
    nd = 1;
    row0 = b0 * K + (long long)pc * R;
    nr = min(R, K - pc * R);
  } else {
    b0 = (long long)blockIdx.x * L.U;
    nd = int(min((long long)L.U, B - b0));
    row0 = b0 * K;
    nr = nd * K;
  }

  if (tid <= SPARSE_N) cnt[tid] = 0;
  if (tid == 0) dlist[R] = 0;
  if (MASKED) {
    for (int d = tid; d < nd; d += LP_THREADS) uni[d] = 0ull;
  } else if (GS == H && H % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(Psi) % 16 == 0) {
    // G and Psi, 16 bytes a thread, in flight while the rows are read
    for (int e = tid; e < H * H / 4; e += LP_THREADS) {
      cp_async16(gs + 4 * e, G + 4 * e);
      cp_async16(ps + 4 * e, Psi + 4 * e);
    }
  } else {  // the same a warp a row, 4 bytes a lane
    for (int r = warp; r < H; r += LP_NW)
      for (int c = lane; c < H; c += 32) {
        cp_async4(gs + r * GS + c, G + r * H + c);
        cp_async4(ps + r * GS + c, Psi + r * H + c);
      }
  }
  // 1. this thread's row: its mask, n and kind
  const long long row = row0 + tid;
  uint64_t lo = 0, hi = 0;
  int n = 0;
  if (tid < nr) {
    row_mask(reinterpret_cast<const uint8_t*>(ss) + row * H, H, lo, hi);
    n = __popcll(lo) + __popcll(hi);
  }
  const int kind = tid >= nr                ? LP_NONE
                   : (cap > 0 && n > cap)  ? LP_OVER
                   : n <= SPARSE_N         ? LP_SPARSE
                                           : LP_DENSE;
  __syncthreads();  // the counts, the list's count and the unions are zero
  const int rank = kind == LP_SPARSE ? atomicAdd(&cnt[n], 1) : 0;
  if (kind == LP_DENSE) {
    const int q = atomicAdd(&dlist[R], 1);
    dlist[q] = tid;
    dmask[2 * tid] = lo;
    dmask[2 * tid + 1] = hi;
  }
  if (MASKED && n > 0) atomicOr(&uni[int(row / K - b0)], static_cast<unsigned long long>(lo));
  __syncthreads();
  // 2. the sparse rows sorted by n, and with MASKED the G_b rows of each
  // datapoint's union of units
  int n_sparse = 0, below = 0;
#pragma unroll
  for (int c = 0; c <= SPARSE_N; ++c) {
    below += c < n ? cnt[c] : 0;
    n_sparse += cnt[c];
  }
  if (kind == LP_SPARSE) {
    order[below + rank] = tid;
    smask[2 * (below + rank)] = lo;
    smask[2 * (below + rank) + 1] = hi;
  }
  if (MASKED) {
    const float* src = G + size_t(b0) * H * H;
    if (H % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0) {
      const int H4 = H / 4;
      for (int e = tid; e < nd * H * H4; e += LP_THREADS) {
        const int r = e / H4, d = r / H;  // row h = r - d H of G_b
        if ((uni[d] >> (r - d * H)) & 1ull) cp_async16(gs + 4 * e, src + 4 * e);
      }
    } else {
      for (int e = tid; e < nd * H * H; e += LP_THREADS) {
        const int d = e / (H * H), h = (e - d * H * H) / H;
        if ((uni[d] >> h) & 1ull) gs[e] = __ldg(src + e);
      }
    }
  }
  cp_async_wait();
  __syncthreads();
  // 3. sparse states in order of n, a thread each, in registers; the
  // states over the cap
  {
    uint64_t slo = 0, shi = 0;
    int sn = 0;
    long long srow = 0;
    if (tid < n_sparse) {
      srow = row0 + order[tid];
      slo = smask[2 * tid];
      shi = smask[2 * tid + 1];
      sn = __popcll(slo) + __popcll(shi);
    }
    const int wmax = __reduce_max_sync(FULL, sn);
    if (tid < n_sparse) {
      const long long b = srow / K;
      float val;
      const bool flagged = lpj_sparse_tile<MASKED>(
          wmax, slo, shi, sn, wty + b * H, __ldg(y2 + b), MASKED ? gs + size_t(b - b0) * GH : gs,
          ps, Psi, mus, pil, s2inv, H, GS, val);
      lpj[srow] = flagged ? lp_nan() : val;
      bad[srow] = flagged ? 1.f : 0.f;
    }
  }
  if (kind == LP_OVER) {
    lpj[row] = lp_nan();
    bad[row] = 1.f;
  }
  // 4. dense states, a warp each
  if (warp < DQ) {
    float* sc = pool + size_t(warp) * dense_floats(cap > 0 ? cap : H);
    const int n_dense = dlist[R];
    for (int q = warp; q < n_dense; q += DQ) {
      const int t = dlist[q];
      const long long r = row0 + t, bq = r / K;
      const uint64_t* m = dmask + 2 * t;
      const int nq = __popcll(m[0]) + __popcll(m[1]);
      float val;
      const bool flagged =
          MASKED ? lpj_dense_masked(m, nq, wty + bq * H, __ldg(y2 + bq),
                                    gs + size_t(bq - b0) * GH, Psi, mus, pil, s2inv, H, GS, sc,
                                    lane, val)
                 : lpj_dense(m, nq, wty + bq * H, __ldg(y2 + bq), gs, ps, mus, pil, s2inv, GS, sc,
                             lane, val);
      if (lane == 0) {
        lpj[r] = flagged ? lp_nan() : val;
        bad[r] = flagged ? 1.f : 0.f;
      }
      __syncwarp();  // the scratch is rewritten for the next state
    }
  }
}

// Rows R and DQ warps with dense scratch for (H, K): the most rows whose
// layout fits a quarter of the block's shared memory limit smem (four
// blocks an SM), else half, else all of it, with as many dense warps as
// fit there (R = 0 if even 32 rows and one dense state do not fit).
struct LpPlan {
  int R, DQ;
  size_t smem;
};

inline LpPlan lp_plan(int H, int K, bool masked, int cap, size_t smem) {
  for (int R = LP_ROWS; R >= 32; R /= 2)
    for (const size_t lim : {smem / 4 - 1024, smem / 2 - 1024, smem})
      for (int DQ = LP_NW; DQ >= 1; DQ /= 2) {
        const LpLayout L = lp_layout(H, K, masked, cap, R, DQ);
        if (L.total <= lim) return LpPlan{R, DQ, L.total};
      }
  return LpPlan{0, 0, 0};
}

// The kernel's shared memory limit on the current device, with the
// attribute that allows it set once a device.
template <bool MASKED>
int lp_smem(size_t* out) {
  static std::atomic<uint64_t> ready{0};
  static size_t limits[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && (ready.load() >> dev & 1u)) {
    *out = limits[dev];
    return 0;
  }
  int smem = 0;
  e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sssc_lpj_kernel<MASKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return int(e);
  *out = size_t(smem);
  if (dev < 64) {
    limits[dev] = *out;
    ready.fetch_or(uint64_t(1) << dev);
  }
  return 0;
}

// One launch on `stream`; returns the launch error (0 if none).
template <bool MASKED>
int launch_sssc_lpj(const void* ss, const void* wty, const void* y2, const void* G,
                    const void* Psi, const void* mus, const void* pil, const void* s2inv,
                    void* lpj, void* bad, int B, int K, int H, int cap, void* stream) {
  size_t smem = 0;
  const int e = lp_smem<MASKED>(&smem);
  if (e != 0) return e;
  const LpPlan p = lp_plan(H, K, MASKED, cap, smem);
  if (p.R == 0 || H > (MASKED ? 64 : 128)) return int(cudaErrorInvalidValue);
  long long blocks;
  if (!MASKED)
    blocks = ((long long)B * K + p.R - 1) / p.R;
  else if (K > p.R)
    blocks = (long long)B * ((K + p.R - 1) / p.R);
  else
    blocks = (B + p.R / K - 1) / (p.R / K);
  if (blocks < 1 || blocks > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  sssc_lpj_kernel<MASKED><<<unsigned(blocks), LP_THREADS, p.smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(wty),
      static_cast<const float*>(y2), static_cast<const float*>(G),
      static_cast<const float*>(Psi), static_cast<const float*>(mus),
      static_cast<const float*>(pil), static_cast<const float*>(s2inv),
      static_cast<float*>(lpj), static_cast<float*>(bad), B, K, H, cap, p.R, p.DQ);
  return int(cudaGetLastError());
}

}  // namespace
