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
// What bounds it on an H100: the bytes.  At the EA's sparsity (about 2 of
// H = 32 units on) a state's solve is two n x n inversions of a few dozen
// flops; the int8 states are B S H bytes (1.6 MB at B = 4096, S = 20,
// H = 32: 0.0014 ms at 3.35 TB/s) and, with MASKED, the G_b entries on the
// union of each datapoint's active units add u^2 floats a datapoint (the
// inpainting block, B = 151,209: 0.14 ms in all; chip_smoke.py's
// sssc_suffstat_bound and masked_suffstat_bound count both from the data).
// What keeps it from that bound is latency: a state's work is small and
// data-dependent, so the design keeps every thread busy on independent
// states and sums them without a barrier per state.
//
// Design.  A persistent grid: as many blocks as fit on the card (two an SM
// at H = 32).  Block x takes the units x, x + G, x + 2G, ... (a unit is U
// whole datapoints, U S <= 128 rows, or, when S > 128, one datapoint whose
// rows come in pieces), so a datapoint's sums stay in one block.  With
// MASKED the unit's G_b is copied into shared memory (cp.async) at its
// start, while its rows are read, and all its states use that copy.  For
// each sub-batch of rows:
//  1. Masks.  The int8 rows are read 16 bytes a thread into per-row
//     bitmasks (state_mask.cuh, integer ORs).  A thread a row counts n and
//     sorts its row: none (n = 0 or r = 0: it would add exact zeros), sparse
//     (n <= SPARSE_N = 8), dense, or over the cap; each warp turns its
//     rows' masks into per-latent bitmasks of rows (ballots).
//  2. Sparse states, a thread each, in an 8 x 8 register tile.  The two
//     inversions are the unpivoted Gauss-Jordan steps of small_solve.cuh and
//     of the plain version (ops/linalg.py:pd_inverse_logdet), each step
//     taken only while k < n, so a zero pivot leaves the same non-finite
//     entries (then 0).  The thread leaves r kappa and the upper triangle of
//     r (lambda + kappa kappa^T) in the row's record.
//  3. Sums with no barrier per state.  The owner of a pair h < k walks the
//     rows that hold both (the AND of two bitmasks of rows) in row order and
//     adds their shares to xpt_ss and xpt_szsz; the owner of (d, h) walks
//     the rows of datapoint d that hold h and adds to xpt_s, xpt_sz and a
//     per-datapoint share of the diagonal, which the diagonal takes at the
//     unit's end in datapoint order.  A latent's place in a record is the
//     popcount of the row's mask below it.
//  4. Dense states (n > SPARSE_N), rare at the EA's sparsity: a warp each,
//     as many at a time as the scratch holds, in shared memory (lane j takes
//     column j, the same elimination), then summed by the pair owners in
//     row order.
//  After a unit's last rows its xpt_s and xpt_sz are written out and the
//  owners of s_sz_outer and the sz_sz_outer triangle add its outer products.
// Every sum has an order fixed by the data, with no float atomics, so the
// outputs are the same from run to run.  At the end each block writes its
// triangles and s_sz_outer once; sssc_suffstat_reduce adds the G block
// partials in f64 and mirrors the triangles.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "state_mask.cuh"
#include "small_solve.cuh"

namespace {

constexpr int SS_THREADS = 256;
constexpr int SS_NW = SS_THREADS / 32;  // warps
// rows of a sub-batch at most: at B = 4096, S = 20 units of 256 rows gave
// the card's 264 blocks one or two units each, units of 128 rows two or three
constexpr int SS_ROWS = 128;
constexpr int REC = (SPARSE_N + SPARSE_N * (SPARSE_N + 1) / 2) | 1;  // a sparse state's record
constexpr int UMAX = 32;  // datapoints of a unit at most

// Byte offsets of a block's shared memory for width H, S slots, sub-batches
// of at most RB rows and a pool that holds DQ of the densest states.
struct SsLayout {
  int U, R, RW, MW, MS, TRI, POOL;
  size_t sst, zzt, szt, ssz, xs, xz, zd, pairs, masks, rrs, rn, rms, rmz, dlist, doff, gs, pool,
      total;
};

__host__ __device__ inline SsLayout ss_layout(int H, int S, bool masked, int cap, int RB, int DQ) {
  SsLayout L;
  L.U = S > RB ? 1 : (RB / S < UMAX ? RB / S : UMAX);
  L.R = S > RB ? RB : L.U * S;  // rows of a sub-batch at most
  L.RW = (L.R + 31) / 32;
  L.MW = (H + 31) / 32;
  L.MS = L.MW | 1;  // odd row stride: a thread a row reads without bank conflicts
  L.TRI = H * (H + 1) / 2;
  const int recs = L.R * REC, dense = DQ * dense_floats(cap > 0 ? cap : H);
  L.POOL = recs > dense ? recs : dense;
  size_t o = 0;
  L.sst = take(o, 4 * size_t(L.TRI));  // xpt_ss, upper triangle
  L.zzt = take(o, 4 * size_t(L.TRI));  // xpt_szsz
  L.szt = take(o, 4 * size_t(L.TRI));  // sz_sz_outer
  L.ssz = take(o, 4 * size_t(H) * H);  // s_sz_outer
  L.xs = take(o, 4 * size_t(L.U) * H);  // the unit's xpt_s
  L.xz = take(o, 4 * size_t(L.U) * H);  // and xpt_sz
  L.zd = take(o, 4 * size_t(L.U) * H);  // and the sparse rows' xpt_szsz[h, h]
  L.pairs = take(o, 2 * size_t(L.TRI));  // the pairs h < k, then h = k: h << 8 | k
  L.masks = take(o, 4 * size_t(L.R) * L.MS);
  L.rrs = take(o, 4 * size_t(L.R));  // r per row
  L.rn = take(o, 4 * size_t(L.R));   // n per row
  L.rms = take(o, 4 * size_t(H) * L.RW);  // [RW, H]: the rows with r != 0 that hold h
  L.rmz = take(o, 4 * size_t(H) * L.RW);  // [RW, H]: the sparse rows that hold h
  L.dlist = take(o, 4 * size_t(L.R + 1));  // the dense rows, ascending, then their count
  L.doff = take(o, 4 * size_t(L.R + 1));   // their scratch offsets, cumulative
  L.gs = take(o, masked ? 4 * size_t(L.U) * H * H : 0);  // the unit's G_b
  L.pool = take(o, 4 * size_t(L.POOL));  // sparse records, then dense scratch
  L.total = o;
  return L;
}

enum RowKind { ROW_NONE = 0, ROW_SPARSE = 1, ROW_DENSE = 2, ROW_OVER = 3 };

// A row with n units and responsibility r: none (n = 0 or r = 0 adds exact
// zeros), sparse, dense, or over the cap (r s only).
__device__ __forceinline__ int row_kind(int n, float r, int cap) {
  if (n == 0 || r == 0.f) return ROW_NONE;
  if (cap > 0 && n > cap) return ROW_OVER;
  return n <= SPARSE_N ? ROW_SPARSE : ROW_DENSE;
}

// the place of latent h among the units of mask m (h must be in m)
__device__ __forceinline__ int compact(const uint32_t* m, int h) {
  int c = __popc(m[h >> 5] & ((1u << (h & 31)) - 1u));
  for (int w = 0; w < (h >> 5); ++w) c += __popc(m[w]);
  return c;
}

__device__ __forceinline__ bool has(const uint32_t* m, int h) {
  return (m[h >> 5] >> (h & 31)) & 1u;
}

// entry (h, k), h <= k, of an H x H upper triangle in row order
__device__ __forceinline__ int tri_index(int h, int k, int H) {
  return h * H - h * (h - 1) / 2 + (k - h);
}

// entry (i, j), i <= j, of a record's upper triangle of SPARSE_N
__host__ __device__ constexpr int rec_tri(int i, int j) {
  return i * SPARSE_N - i * (i - 1) / 2 + (j - i);
}

// 16 state bytes at chunk c of a run of `bytes` (zeros past its end)
__device__ __forceinline__ uint4 load_chunk(const uint8_t* base, int c, int bytes, bool aligned) {
  const int avail = bytes - 16 * c;
  return avail > 0 ? load16(base + 16 * c, avail, aligned) : make_uint4(0u, 0u, 0u, 0u);
}

template <bool MASKED>
__device__ __forceinline__ float load_g(const float* p) {
  return MASKED ? *p : __ldg(p);
}

// A sparse state's solve, a thread, in registers: units from the row mask
// m (MW words), datapoint row wty_b, Gram Gd (shared memory with MASKED);
// writes r kappa and the triangle of r (lambda + kappa kappa^T) to rec.
template <bool MASKED>
__device__ __forceinline__ void solve_sparse(const uint32_t* m, int MW, int n, float r,
                                             const float* wty_b, const float* Gd,
                                             const float* __restrict__ Psi,
                                             const float* __restrict__ mus, float s2inv, int H,
                                             float* rec) {
  constexpr int N = SPARSE_N;
  int idx[N];
  {
    int w = 0;
    uint32_t word = m[0];
#pragma unroll
    for (int i = 0; i < N; ++i) {  // the lowest unit left (0 past n)
      while (word == 0u && w + 1 < MW) word = m[++w];
      idx[i] = word ? 32 * w + __ffs(word) - 1 : 0;
      word &= word - 1u;
    }
  }
  float A[N][N], mu[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = i < n ? __ldg(mus + idx[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      A[i][j] = (i < n && j < n) ? __ldg(Psi + idx[i] * H + idx[j]) : (i == j ? 1.f : 0.f);
  }
  gauss_jordan_regs(A, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ga = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i < n && j < n) {
        const float g = load_g<MASKED>(Gd + idx[i] * H + idx[j]);
        A[i][j] += s2inv * g;
        ga = fmaf(g, mu[j], ga);
      }
    }
    u[i] = i < n ? wty_b[idx[i]] - ga : 0.f;
  }
  gauss_jordan_regs(A, n);
  float kap[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) acc = fmaf(A[i][j], u[j], acc);
    kap[i] = finite_or_zero(s2inv * acc + mu[i]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) rec[i] = r * kap[i];
#pragma unroll
    for (int j = i; j < N; ++j)
      if (j < n) rec[N + rec_tri(i, j)] = r * (finite_or_zero(A[i][j]) + kap[i] * kap[j]);
  }
}

// A dense state's solve, a warp: lambda (n x n, raw), then u, kappa
// (finite) and the units, in the scratch sc.
template <bool MASKED>
__device__ void solve_dense(const uint32_t* m, int MW, int n, const float* wty_b,
                            const float* Gd, const float* __restrict__ Psi,
                            const float* __restrict__ mus, float s2inv, int H, float* sc,
                            int lane) {
  float* lam = sc;
  float* u = lam + n * n;
  float* kap = u + n;
  int* idx = reinterpret_cast<int*>(kap + n);
  int c = 0;
  for (int w = 0; w < MW; ++w) {
    const uint32_t word = m[w];
    if ((word >> lane) & 1u) idx[c + __popc(word & ((1u << lane) - 1u))] = 32 * w + lane;
    c += __popc(word);
  }
  __syncwarp();
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    for (int j = lane; j < n; j += 32) lam[i * n + j] = __ldg(Psi + idx[i] * H + idx[j]);
  }
  gauss_jordan_cols(lam, n, lane);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    for (int j = lane; j < n; j += 32)
      lam[i * n + j] += s2inv * load_g<MASKED>(Gd + idx[i] * H + idx[j]);
  }
  for (int i = lane; i < n; i += 32) {
    const int hi = idx[i];
    float ga = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j)
      ga = fmaf(load_g<MASKED>(Gd + hi * H + idx[j]), __ldg(mus + idx[j]), ga);
    u[i] = wty_b[hi] - ga;
  }
  gauss_jordan_cols(lam, n, lane);
  for (int i = lane; i < n; i += 32) {
    float acc = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) acc = fmaf(lam[i * n + j], u[j], acc);
    kap[i] = finite_or_zero(s2inv * acc + __ldg(mus + idx[i]));
  }
  __syncwarp();
}

template <bool MASKED>
__global__ void __launch_bounds__(SS_THREADS, 2)
sssc_suffstat_partial(const int8_t* __restrict__ ss, const float* __restrict__ rs,
                      const float* __restrict__ wty, const float* __restrict__ G,
                      const float* __restrict__ Psi, const float* __restrict__ mus,
                      const float* __restrict__ s2inv_p, float* __restrict__ xpt_sz,
                      float* __restrict__ xpt_s, float* __restrict__ partial, int B, int S,
                      int H, int cap, int RB, int DQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SsLayout L = ss_layout(H, S, MASKED, cap, RB, DQ);
  float* sst = reinterpret_cast<float*>(smem + L.sst);
  float* zzt = reinterpret_cast<float*>(smem + L.zzt);
  float* szt = reinterpret_cast<float*>(smem + L.szt);
  float* ssz = reinterpret_cast<float*>(smem + L.ssz);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* xz = reinterpret_cast<float*>(smem + L.xz);
  float* zd = reinterpret_cast<float*>(smem + L.zd);
  uint16_t* pairs = reinterpret_cast<uint16_t*>(smem + L.pairs);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.masks);
  float* rrs = reinterpret_cast<float*>(smem + L.rrs);
  int* rn = reinterpret_cast<int*>(smem + L.rn);
  uint32_t* rms = reinterpret_cast<uint32_t*>(smem + L.rms);
  uint32_t* rmz = reinterpret_cast<uint32_t*>(smem + L.rmz);
  int* dlist = reinterpret_cast<int*>(smem + L.dlist);
  int* doff = reinterpret_cast<int*>(smem + L.doff);
  float* gs = reinterpret_cast<float*>(smem + L.gs);
  float* pool = reinterpret_cast<float*>(smem + L.pool);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TRI = L.TRI, MW = L.MW, MS = L.MS, RW = L.RW, U = L.U, HH = H * H;
  const float s2inv = *s2inv_p;

  for (int e = tid; e < TRI; e += SS_THREADS) sst[e] = zzt[e] = szt[e] = 0.f;
  for (int e = tid; e < HH; e += SS_THREADS) ssz[e] = 0.f;
  const int OFF = TRI - H;  // pairs h < k
  for (int h = tid; h < H; h += SS_THREADS) {
    const int base = h * (H - 1) - h * (h - 1) / 2;
    for (int k = h + 1; k < H; ++k) pairs[base + k - h - 1] = uint16_t(h << 8 | k);
    pairs[OFF + h] = uint16_t(h << 8 | h);
  }

  const bool pieces = S > RB;  // then U = 1 and a datapoint's rows come in pieces
  const int n_pieces = pieces ? (S + RB - 1) / RB : 1;
  const long long n_units = (B + U - 1) / U;
  // G_b of consecutive datapoints is one run of floats: 16-byte copies when aligned
  const bool g_async = MASKED && HH % 4 == 0 && reinterpret_cast<uintptr_t>(G) % 16 == 0;
  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long b0 = unit * U;
    const int nd = int(B - b0 < U ? B - b0 : U);  // datapoints of the unit
    for (int e = tid; e < nd * H; e += SS_THREADS) xs[e] = xz[e] = zd[e] = 0.f;
    if (MASKED) {  // the unit's G_b, in flight while its rows are read
      const float* src = G + size_t(b0) * HH;
      if (g_async)
        for (int e = tid; e < nd * HH / 4; e += SS_THREADS) cp_async16(gs + 4 * e, src + 4 * e);
      else
        for (int e = tid; e < nd * HH; e += SS_THREADS) gs[e] = __ldg(src + e);
    }
    for (int pc = 0; pc < n_pieces; ++pc) {
      const int s0 = pc * RB;
      const int nr = pieces ? min(RB, S - s0) : nd * S;  // rows of this sub-batch
      const long long row0 = b0 * S + s0;
      // 1. masks (the first two chunks a thread in flight across the barrier)
      const uint8_t* base = reinterpret_cast<const uint8_t*>(ss) + row0 * H;
      const int bytes = nr * H, nc = (bytes + 15) / 16;
      const bool aligned = reinterpret_cast<uintptr_t>(base) % 16 == 0;
      const uint4 v0 = load_chunk(base, tid, bytes, aligned);
      const uint4 v1 = load_chunk(base, tid + SS_THREADS, bytes, aligned);
      const float my_r = tid < nr ? rs[row0 + tid] : 0.f;
      for (int e = tid; e < nr * MS; e += SS_THREADS) masks[e] = 0u;
      __syncthreads();
      for (int c = tid, it = 0; c < nc; c += SS_THREADS, ++it) {
        const uint4 v = it == 0 ? v0 : (it == 1 ? v1 : load_chunk(base, c, bytes, aligned));
        or_chunk<false>(masks, MS, v, 16 * c, H, 0);
      }
      __syncthreads();
      // 2. a thread a row: n, kind, the per-latent row bitmasks (ballots)
      int n = 0;
      if (tid < nr) {
        for (int w = 0; w < MW; ++w) n += __popc(masks[tid * MS + w]);
        rrs[tid] = my_r;
        rn[tid] = n;
      }
      const int kind = tid < nr ? row_kind(n, my_r, cap) : ROW_NONE;
      if (warp < RW) {
        for (int w = 0; w < MW; ++w) {
          const uint32_t word = kind != ROW_NONE ? masks[tid * MS + w] : 0u;
          for (int l = 0; l < 32 && 32 * w + l < H; ++l) {
            const bool on = (word >> l) & 1u;
            const uint32_t b1 = __ballot_sync(FULL, on);
            const uint32_t b2 = __ballot_sync(FULL, on && kind == ROW_SPARSE);
            if (lane == l) {
              rms[warp * H + 32 * w + l] = b1;
              rmz[warp * H + 32 * w + l] = b2;
            }
          }
        }
      }
      if (MASKED && g_async && pc == 0) cp_async_wait();
      __syncthreads();
      // 3. sparse states, a thread each, in registers; warp 0 lists the dense
      // rows in row order with their scratch offsets
      if (kind == ROW_SPARSE) {
        const int dl = pieces ? 0 : tid / S;
        solve_sparse<MASKED>(masks + tid * MS, MW, n, my_r, wty + (b0 + dl) * H,
                             MASKED ? gs + size_t(dl) * HH : G, Psi, mus, s2inv, H,
                             pool + tid * REC);
      }
      if (warp == 0) {
        int count = 0, off = 0;
        for (int g = 0; g < nr; g += 32) {
          const int r = g + lane;
          const bool d = r < nr && row_kind(rn[r], rrs[r], cap) == ROW_DENSE;
          const uint32_t bal = __ballot_sync(FULL, d);
          int sz = d ? dense_floats(rn[r]) : 0;
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(FULL, sz, o);
            if (lane >= o) sz += t;
          }
          if (d) {
            const int q = count + __popc(bal & ((1u << lane) - 1u));
            dlist[q] = r;
            doff[q + 1] = off + sz;
          }
          off += __shfl_sync(FULL, sz, 31);
          count += __popc(bal);
        }
        if (lane == 0) {
          dlist[L.R] = count;
          doff[0] = 0;
        }
      }
      __syncthreads();
      // 4. the owners' sums, in row order: of a pair h < k the rows that hold
      // both, of (d, h) the rows of datapoint d that hold h (xpt_s, xpt_sz
      // and the sparse rows' xpt_szsz[h, h], added to the diagonal at the
      // unit's end)
      for (int t = tid; t < OFF; t += SS_THREADS) {
        const int h = pairs[t] >> 8, k = pairs[t] & 255, p = tri_index(h, k, H);
        float as = sst[p], az = zzt[p];
        for (int w = 0; w < RW; ++w) {
          for (uint32_t bits = rms[w * H + h] & rms[w * H + k]; bits; bits &= bits - 1u)
            as += rrs[32 * w + __ffs(bits) - 1];
          for (uint32_t bits = rmz[w * H + h] & rmz[w * H + k]; bits; bits &= bits - 1u) {
            const int r = 32 * w + __ffs(bits) - 1;
            const uint32_t* m = masks + r * MS;
            az += pool[r * REC + SPARSE_N + rec_tri(compact(m, h), compact(m, k))];
          }
        }
        sst[p] = as;
        zzt[p] = az;
      }
      for (int e = tid; e < (pieces ? 1 : nd) * H; e += SS_THREADS) {
        const int d = e / H, h = e - d * H;
        const int lo = pieces ? 0 : d * S, hi = pieces ? nr : lo + S;
        float as = xs[e], az = xz[e], ad = zd[e];
        for (int w = lo >> 5; w <= (hi - 1) >> 5; ++w) {
          const int a = lo - 32 * w, b = hi - 32 * w;  // the rows of d in word w
          const uint32_t range = (b >= 32 ? 0xffffffffu : (1u << b) - 1u) &
                                 (a <= 0 ? 0xffffffffu : ~((1u << a) - 1u));
          for (uint32_t bits = rms[w * H + h] & range; bits; bits &= bits - 1u)
            as += rrs[32 * w + __ffs(bits) - 1];
          for (uint32_t bits = rmz[w * H + h] & range; bits; bits &= bits - 1u) {
            const int r = 32 * w + __ffs(bits) - 1;
            const int i = compact(masks + r * MS, h);
            az += pool[r * REC + i];
            ad += pool[r * REC + SPARSE_N + rec_tri(i, i)];
          }
        }
        xs[e] = as;
        xz[e] = az;
        zd[e] = ad;
      }
      __syncthreads();
      // 5. dense states, a warp each, as many at a time as the pool holds
      // (their scratch takes the records' place), summed by the same owners
      const int n_dense = dlist[L.R];
      for (int q0 = 0; q0 < n_dense;) {
        int q1 = q0 + 1;
        while (q1 < n_dense && doff[q1 + 1] - doff[q0] <= L.POOL) ++q1;
        for (int q = q0 + warp; q < q1; q += SS_NW) {
          const int r = dlist[q], dl = pieces ? 0 : r / S;
          solve_dense<MASKED>(masks + r * MS, MW, rn[r], wty + (b0 + dl) * H,
                              MASKED ? gs + size_t(dl) * HH : G, Psi, mus, s2inv, H,
                              pool + doff[q] - doff[q0], lane);
        }
        __syncthreads();
        for (int t = tid; t < TRI; t += SS_THREADS) {
          const int h = pairs[t] >> 8, k = pairs[t] & 255, p = tri_index(h, k, H);
          float az = zzt[p];
          for (int q = q0; q < q1; ++q) {
            const int r = dlist[q];
            const uint32_t* m = masks + r * MS;
            if (!has(m, h) || !has(m, k)) continue;
            const int nq = rn[r], i = compact(m, h), j = compact(m, k);
            const float* lam = pool + doff[q] - doff[q0];
            const float* kap = lam + nq * nq + nq;
            az += rrs[r] * (finite_or_zero(lam[i * nq + j]) + kap[i] * kap[j]);
            if (h == k) xz[(pieces ? 0 : r / S) * H + h] += rrs[r] * kap[i];
          }
          zzt[p] = az;
        }
        __syncthreads();
        q0 = q1;
      }
    }
    // the unit's rows are summed: write them out, add their outer products
    for (int e = tid; e < nd * H; e += SS_THREADS) {
      xpt_s[b0 * H + e] = xs[e];
      xpt_sz[b0 * H + e] = xz[e];
    }
    for (int e = tid; e < HH + TRI; e += SS_THREADS) {
      if (e < HH) {
        const int i = e / H, j = e - i * H;
        float a = ssz[e];
#pragma unroll 4
        for (int d = 0; d < nd; ++d) a = fmaf(xs[d * H + i], xz[d * H + j], a);
        ssz[e] = a;
      } else {
        const int t = e - HH, h = pairs[t] >> 8, k = pairs[t] & 255, p = tri_index(h, k, H);
        float a = szt[p];
#pragma unroll 4
        for (int d = 0; d < nd; ++d) a = fmaf(xz[d * H + h], xz[d * H + k], a);
        szt[p] = a;
        if (h == k) {  // the unit's diagonal of xpt_ss and the sparse rows' of xpt_szsz
          float as = sst[p], az = zzt[p];
          for (int d = 0; d < nd; ++d) {
            as += xs[d * H + h];
            az += zd[d * H + h];
          }
          sst[p] = as;
          zzt[p] = az;
        }
      }
    }
    __syncthreads();
  }

  float* out = partial + size_t(blockIdx.x) * (3 * TRI + HH);
  for (int e = tid; e < TRI; e += SS_THREADS) {
    out[e] = sst[e];
    out[TRI + e] = zzt[e];
    out[2 * TRI + HH + e] = szt[e];
  }
  for (int e = tid; e < HH; e += SS_THREADS) out[2 * TRI + e] = ssz[e];
}

// the t-th entry (i, j), j >= i, of an n x n upper triangle in row order
__device__ inline void tri_at(int t, int n, int& i, int& j) {
  const float d = 2.f * n + 1.f;
  i = int((d - sqrtf(fmaxf(d * d - 8.f * float(t), 0.f))) * 0.5f);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  auto off = [n](int r) { return r * n - r * (r - 1) / 2; };
  while (i > 0 && off(i) > t) --i;
  while (i + 1 < n && off(i + 1) <= t) ++i;
  j = i + (t - off(i));
}

// Pass 2: each entry of the block partials [G, 3 TRI + H^2] (the xpt_ss,
// xpt_szsz triangles, s_sz_outer, the sz_sz_outer triangle) summed in f64,
// 32 fixed slices of blocks and then the slices in order; the triangles
// mirrored into out [4, H, H].
__global__ void __launch_bounds__(1024)
sssc_suffstat_reduce(const float* __restrict__ partial, float* __restrict__ out, int G, int H) {
  __shared__ double part[32][33];
  const int TRI = H * (H + 1) / 2, HH = H * H, E = 3 * TRI + HH;
  const int e = blockIdx.x * 32 + threadIdx.x;
  double v = 0.0;
  if (e < E)
    for (int p = threadIdx.y; p < G; p += 32) v += double(partial[size_t(p) * E + e]);
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y != 0 || e >= E) return;
  double t = 0.0;
  for (int q = 0; q < 32; ++q) t += part[q][threadIdx.x];
  const float f = float(t);
  if (e >= 2 * TRI && e < 2 * TRI + HH) {
    out[2 * HH + e - 2 * TRI] = f;
    return;
  }
  const int o = e < TRI ? 0 : (e < 2 * TRI ? 1 : 3);
  int h, k;
  tri_at(o == 3 ? e - 2 * TRI - HH : e - o * TRI, H, h, k);
  out[o * HH + h * H + k] = f;
  out[o * HH + k * H + h] = f;
}

// Sub-batch rows RB and a pool of DQ of the densest states for width H
// within smem bytes of shared memory, and within half of it where that
// fits two blocks an SM (RB = 0 if even 32 rows and one state do not fit).
struct SsPlan {
  int RB, DQ;
  size_t smem;
};

inline SsPlan ss_plan(int H, int S, bool masked, int cap, size_t smem) {
  for (const size_t lim : {smem / 2 - 1024, smem})
    for (int RB = SS_ROWS; RB >= 32; RB /= 2)
      for (int DQ = SS_NW; DQ >= 1; DQ /= 2) {
        const SsLayout L = ss_layout(H, S, masked, cap, RB, DQ);
        if (L.total <= lim) return SsPlan{RB, DQ, L.total};
      }
  return SsPlan{0, 0, 0};
}

// The card's SM count and the kernel's shared memory limit, once a device.
struct SsCard {
  int n_sm;
  size_t smem;
};

template <bool MASKED>
int ss_card(SsCard* out) {
  static std::atomic<uint64_t> ready{0};
  static SsCard cards[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && (ready.load() >> dev & 1u)) {
    *out = cards[dev];
    return 0;
  }
  int n_sm = 0, smem = 0;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(sssc_suffstat_partial<MASKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  *out = SsCard{n_sm, size_t(smem)};
  if (dev < 64) {
    cards[dev] = *out;
    ready.fetch_or(uint64_t(1) << dev);
  }
  return 0;
}

// The number of blocks G for (B, S, H) on the current device: as many as
// fit on the card at once, at most one a unit.  Negative: a CUDA error, or
// H too wide for shared memory.
template <bool MASKED>
int sssc_suffstat_blocks(int B, int S, int H, int cap) {
  SsCard c;
  const int e = ss_card<MASKED>(&c);
  if (e != 0) return -e;
  const SsPlan p = ss_plan(H, S, MASKED, cap, c.smem);
  if (p.RB == 0) return -int(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sssc_suffstat_partial<MASKED>, SS_THREADS, p.smem);
  if (oe != cudaSuccess) return -int(oe);
  const SsLayout L = ss_layout(H, S, MASKED, cap, p.RB, p.DQ);
  const long long n_units = (B + L.U - 1) / L.U;
  const long long fill = (long long)c.n_sm * (per_sm > 1 ? per_sm : 1);
  return int(n_units < fill ? n_units : fill);
}

// Both passes on `stream` with G blocks (from sssc_suffstat_blocks) and
// partial [G, 3 H(H+1)/2 + H^2] f32; returns the first launch error (0 if
// none).
template <bool MASKED>
int launch_sssc_suffstat(const void* ss, const void* rs, const void* wty, const void* G,
                         const void* Psi, const void* mus, const void* s2inv, void* xpt_sz,
                         void* xpt_s, void* out, void* partial, int B, int S, int H, int cap,
                         int n_blocks, void* stream) {
  SsCard c;
  const int e = ss_card<MASKED>(&c);
  if (e != 0) return e;
  const SsPlan p = ss_plan(H, S, MASKED, cap, c.smem);
  if (p.RB == 0 || n_blocks < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  sssc_suffstat_partial<MASKED><<<n_blocks, SS_THREADS, p.smem, st>>>(
      static_cast<const int8_t*>(ss), static_cast<const float*>(rs),
      static_cast<const float*>(wty), static_cast<const float*>(G),
      static_cast<const float*>(Psi), static_cast<const float*>(mus),
      static_cast<const float*>(s2inv), static_cast<float*>(xpt_sz),
      static_cast<float*>(xpt_s), static_cast<float*>(partial), B, S, H, cap, p.RB, p.DQ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int E = 3 * (H * (H + 1) / 2) + H * H;
  sssc_suffstat_reduce<<<(E + 31) / 32, dim3(32, 32), 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_blocks, H);
  return int(cudaGetLastError());
}

}  // namespace
