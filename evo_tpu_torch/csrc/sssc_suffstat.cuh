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
// What keeps it from that bound is the work around each small solve: a
// state's work is small and data-dependent, so the design keeps many
// independent states in flight on each SM and sums them without a barrier
// per state or per phase.
//
// Design at H <= 64 (sssc_suffstat_partial, every masked launch and the
// complete-data ones up to that width): a warp owns whole datapoints.  A
// persistent grid of blocks of NW warps (wp_plan: 8 warps and two blocks an
// SM at H = 32); in round m warp w of block x takes datapoint
// (m G + x) NW + w, and asks L2 for its next one's rows and G_b.  The
// warps of a block meet once a round (one barrier per NW datapoints, where
// the units body takes six or more per unit of six): on an H100 the round's
// barrier saved more than it cost (1.33 against 1.40 ms on the inpainting
// cell's trained states, 1.38 against 1.49 ms on chip_smoke.py's row-8
// states), which we take to be warps of a block kept in step sharing the
// instruction fetches of this long kernel.  A datapoint's rows come 32 at a
// time, a lane a row:
//  1. Masks.  The lane reads its row's H bytes, 16 at a time where aligned,
//     into a 64-bit mask and counts n: none (n = 0 or r = 0 adds exact
//     zeros), sparse (n <= SPARSE_N = 8) or dense.  The warp ORs the masks
//     of the rows that count into the union of units and, for each unit of
//     the union, ballots the rows that hold it (all, and the sparse ones)
//     and notes its place among each row's units.  With MASKED the
//     datapoint's G_b is copied into the warp's scratch (cp.async) while
//     this goes on.
//  2. Sparse states, a lane each, in a 4 x 4, 6 x 6 or 8 x 8 register tile
//     (the smallest that holds the warp's largest n): the unpivoted
//     Gauss-Jordan steps of small_solve.cuh and of the plain version
//     (ops/linalg.py:pd_inverse_logdet), each step taken only while k < n,
//     so a zero pivot leaves the same non-finite entries (then 0).  Psi_AA
//     and G_AA come from shared memory (Psi and the shared G staged a
//     block, G_b a warp, rows GS apart).  Once every sparse lane has read
//     its G_AA, the lane writes r kappa and the upper triangle of
//     r (lambda + kappa kappa^T) as its record, over the G_b copy.
//  3. Sums.  The lane of each unit h of the union adds the datapoint's
//     xpt_s[h] and xpt_sz[h] over the rows that hold h, in row order; the
//     owner of a pair of the union's units walks the rows that hold both,
//     in row order, and adds their shares to the warp's own xpt_ss and
//     xpt_szsz triangles.
//  4. Dense states (n > SPARSE_N), rare at the EA's sparsity: the warp
//     solves each in turn, in row order, in registers up to 32 units (lane
//     j holds column j, gauss_jordan_warp over 16 or 32 rows) and in its
//     shared memory above (solve_dense, lane j takes column j), and its
//     lanes add the state's distinct shares to the triangles and to xpt_sz.
// After a datapoint's last rows the warp writes its xpt_s and xpt_sz.  When
// the rounds are done, the block adds the warps' triangles in warp order,
// and the two outer products over its datapoints (read back from xpt_s and
// xpt_sz, 32 at a time, in a fixed order, the next 32 in flight) into its
// partial.  So every sum has an order fixed by the data and the grid, with
// no float atomics, and the outputs are the same from run to run.  With a
// counter buffer the warps add the rows they solved, by a lane and by the
// warp, by integer atomics.
//
// Design at 64 < H <= 128 (sssc_suffstat_partial_units, complete data
// only): per-warp triangles do not fit in shared memory there, so a block
// takes units of whole datapoints.  A persistent grid: as many blocks as fit
// on the card.  Block x takes the units x, x + G, x + 2G, ... (a unit is U
// whole datapoints, U S <= 128 rows, or, when S > 128, one datapoint whose
// rows come in pieces), so a datapoint's sums stay in one block.  For each
// sub-batch of rows:
//  1. Masks.  The int8 rows are read 16 bytes a thread into per-row
//     bitmasks (state_mask.cuh, integer ORs).  A thread a row counts n and
//     sorts its row: none, sparse, dense, or over the cap; each warp turns
//     its rows' masks into per-latent bitmasks of rows (ballots).
//  2. Sparse states, a thread each, in the register tile above.
//  3. Sums with no barrier per state.  The owner of a pair h < k walks the
//     rows that hold both (the AND of two bitmasks of rows) in row order and
//     adds their shares to xpt_ss and xpt_szsz; the owner of (d, h) walks
//     the rows of datapoint d that hold h and adds to xpt_s, xpt_sz and a
//     per-datapoint share of the diagonal, which the diagonal takes at the
//     unit's end in datapoint order.  A latent's place in a record is the
//     popcount of the row's mask below it.
//  4. Dense states (n > SPARSE_N): a warp each, as many at a time as the
//     scratch holds, in shared memory, then summed by the pair owners in
//     row order.
//  After a unit's last rows its xpt_s and xpt_sz are written out and the
//  owners of s_sz_outer and the sz_sz_outer triangle add its outer products.
// At the end each block writes its triangles and s_sz_outer once.
//
// Both bodies leave a partial [G, 3 TRI + H^2] a block; sssc_suffstat_reduce
// adds the G block partials in f64 and mirrors the triangles.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "state_mask.cuh"
#include "small_solve.cuh"

namespace {

constexpr int REC = (SPARSE_N + SPARSE_N * (SPARSE_N + 1) / 2) | 1;  // a sparse state's record

// entry (h, k), h <= k, of an H x H upper triangle in row order
__device__ __forceinline__ int tri_index(int h, int k, int H) {
  return h * H - h * (h - 1) / 2 + (k - h);
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

// entry (i, j), i <= j, of a record's upper triangle of SPARSE_N
__host__ __device__ constexpr int rec_tri(int i, int j) {
  return i * SPARSE_N - i * (i - 1) / 2 + (j - i);
}

enum RowKind { ROW_NONE = 0, ROW_SPARSE = 1, ROW_DENSE = 2, ROW_OVER = 3 };

// A row with n units and responsibility r: none (n = 0 or r = 0 adds exact
// zeros), sparse, dense, or over the cap (r s only).
__device__ __forceinline__ int row_kind(int n, float r, int cap) {
  if (n == 0 || r == 0.f) return ROW_NONE;
  if (cap > 0 && n > cap) return ROW_OVER;
  return n <= SPARSE_N ? ROW_SPARSE : ROW_DENSE;
}

// The units of a state, ascending, in idx (0 past its n): from a mask of MW
// words, or of 64 bits.
template <int N>
__device__ __forceinline__ void units_of(const uint32_t* m, int MW, int (&idx)[N]) {
  int w = 0;
  uint32_t word = m[0];
#pragma unroll
  for (int i = 0; i < N; ++i) {  // the lowest unit left (0 past n)
    while (word == 0u && w + 1 < MW) word = m[++w];
    idx[i] = word ? 32 * w + __ffs(word) - 1 : 0;
    word &= word - 1u;
  }
}

template <int N>
__device__ __forceinline__ void units_of(uint64_t m, int (&idx)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    idx[i] = m ? __ffsll((long long)m) - 1 : 0;
    m &= m - 1ull;
  }
}

// An entry of Psi or G: from shared memory (SH, plain loads) or through the
// read-only path of device memory.
template <bool SH>
__device__ __forceinline__ float ld(const float* p) {
  return SH ? *p : __ldg(p);
}

// A sparse state's solve, a thread, in an N x N register tile (n <= N <=
// SPARSE_N): units idx (n of them), datapoint row wty_b, Gram Gd with rows
// gs apart and Psi with rows ps apart; leaves lambda (raw) in A and kappa
// (finite) in kap.
template <int N, bool SH>
__device__ __forceinline__ void solve_sparse(const int (&idx)[N], int n, const float* wty_b,
                                             const float* Gd, int gs, const float* Psi, int ps,
                                             const float* __restrict__ mus, float s2inv,
                                             float (&A)[N][N], float (&kap)[N]) {
  float mu[N], u[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mu[i] = i < n ? __ldg(mus + idx[i]) : 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      A[i][j] = (i < n && j < n) ? ld<SH>(Psi + idx[i] * ps + idx[j]) : (i == j ? 1.f : 0.f);
  }
  gauss_jordan_regs(A, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float ga = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i < n && j < n) {
        const float g = ld<SH>(Gd + idx[i] * gs + idx[j]);
        A[i][j] += s2inv * g;
        ga = fmaf(g, mu[j], ga);
      }
    }
    u[i] = i < n ? wty_b[idx[i]] - ga : 0.f;
  }
  gauss_jordan_regs(A, n);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < n) acc = fmaf(A[i][j], u[j], acc);
    kap[i] = finite_or_zero(s2inv * acc + mu[i]);
  }
}

// A sparse state's record: r kappa, then the triangle of
// r (lambda + kappa kappa^T), laid out for SPARSE_N whatever N.
template <int N>
__device__ __forceinline__ void write_record(float* rec, int n, float r, const float (&A)[N][N],
                                             const float (&kap)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i < n) rec[i] = r * kap[i];
#pragma unroll
    for (int j = i; j < N; ++j)
      if (j < n) rec[SPARSE_N + rec_tri(i, j)] = r * (finite_or_zero(A[i][j]) + kap[i] * kap[j]);
  }
}

// A dense state's solve, a warp: lambda (n x n, raw), then u, kappa
// (finite) and the units, in the scratch sc; Gd and Psi as for solve_sparse.
template <bool SH>
__device__ void solve_dense(const uint32_t* m, int MW, int n, const float* wty_b, const float* Gd,
                            int gs, const float* Psi, int ps, const float* __restrict__ mus,
                            float s2inv, float* sc, int lane) {
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
    for (int j = lane; j < n; j += 32) lam[i * n + j] = ld<SH>(Psi + idx[i] * ps + idx[j]);
  }
  gauss_jordan_cols(lam, n, lane);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    for (int j = lane; j < n; j += 32) lam[i * n + j] += s2inv * ld<SH>(Gd + idx[i] * gs + idx[j]);
  }
  for (int i = lane; i < n; i += 32) {
    const int hi = idx[i];
    float ga = 0.f;
#pragma unroll 4
    for (int j = 0; j < n; ++j) ga = fmaf(ld<SH>(Gd + hi * gs + idx[j]), __ldg(mus + idx[j]), ga);
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

// A dense state's solve in registers, n <= R <= 32: lane j holds column j
// (the identity past n), both inversions by gauss_jordan_warp over R rows;
// lambda, u, kappa and the units idx in sc as solve_dense leaves them.
template <int R>
__device__ __forceinline__ void solve_dense_regs(const int* idx, int n, const float* wty_b,
                                                 const float* Gd, int gs, const float* Psi,
                                                 int ps, const float* __restrict__ mus,
                                                 float s2inv, float* sc, int lane) {
  float* lam = sc;
  float* u = lam + n * n;
  float* kap = u + n;
  const int jj = idx[lane < n ? lane : 0];
  float c[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float x = Psi[idx[i < n ? i : 0] * ps + jj];
    c[i] = i < n && lane < n ? x : (i == lane ? 1.f : 0.f);
  }
  gauss_jordan_warp(c, n, lane);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float g = Gd[idx[i < n ? i : 0] * gs + jj];
    if (i < n && lane < n) c[i] += s2inv * g;
  }
  if (lane < n) {
    float ga = 0.f;
    for (int k = 0; k < n; ++k) ga = fmaf(Gd[jj * gs + idx[k]], __ldg(mus + idx[k]), ga);
    u[lane] = wty_b[jj] - ga;
  }
  gauss_jordan_warp(c, n, lane);
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < n && lane < n) lam[i * n + lane] = c[i];
  __syncwarp();
  for (int i = lane; i < n; i += 32) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j) acc = fmaf(lam[i * n + j], u[j], acc);
    kap[i] = finite_or_zero(s2inv * acc + __ldg(mus + idx[i]));
  }
  __syncwarp();
}

// A dense state's solve, a warp, kept out of line so that its registers do
// not crowd the sparse path's: the units of the mask at mp (n of them),
// then lambda (raw) and kappa (finite) in the scratch sc as solve_dense
// leaves them; in registers over 16 rows up to 16 units and over 32 up to
// 32, by solve_dense above.  Psi and G in shared or device memory, read by plain loads.
__device__ __noinline__ void solve_dense_warp(const uint64_t* mp, int n, const float* wty_b,
                                              const float* Gd, int gs, const float* Psi, int ps,
                                              const float* __restrict__ mus, float s2inv,
                                              float* sc, int lane) {
  if (n > 32) {
    solve_dense<true>(reinterpret_cast<const uint32_t*>(mp), 2, n, wty_b, Gd, gs, Psi, ps, mus,
                      s2inv, sc, lane);
    return;
  }
  int* idx = reinterpret_cast<int*>(sc + n * n + 2 * n);
  const uint64_t m = *mp;
  if ((m >> lane) & 1ull) idx[__popcll(m & ((1ull << lane) - 1ull))] = lane;
  if ((m >> (lane + 32)) & 1ull) idx[__popcll(m & ((1ull << (lane + 32)) - 1ull))] = lane + 32;
  __syncwarp();
  if (n <= 16)
    solve_dense_regs<16>(idx, n, wty_b, Gd, gs, Psi, ps, mus, s2inv, sc, lane);
  else
    solve_dense_regs<32>(idx, n, wty_b, Gd, gs, Psi, ps, mus, s2inv, sc, lane);
}

// ---------------------------------------------------------------------------
// H <= 64: a warp a datapoint

constexpr int WP_MAX_H = 64;    // a state's mask in 64 bits
constexpr int WP_WARPS = 8;     // warps of a block at most
constexpr int WP_SM_WARPS = 16; // warps an SM at most: 128 registers a thread
constexpr int WP_ROWS = 32;     // rows of a datapoint a warp takes at a time, a lane each
constexpr int WP_TILE = 32;     // datapoints of a tile of the block's outer products

// Byte offsets in a block's shared memory for width H: Psi and, on
// complete data, G, with rows GS floats apart (GS > H a multiple of 4: rows
// copied 16 bytes at a time; at H = 32 and 64 lanes that read one column in
// rows 1 to 7 apart meet in distinct banks); then each warp's region: its
// triangles, the union's lists, each row's place of each unit of the union
// among its own units, its rows, the datapoint's xpt_s and xpt_sz, and a
// scratch that holds the datapoint's G_b (MASKED, rows GS apart) while its
// sparse states are solved, then their records, then a dense state's
// solve.  Once the warps are done, the block's outer products take the
// space from its start.
struct WpLayout {
  int TRI, GS;
  size_t psi, g, head, sst, zzt, ub, uz, ul, pos, rmask, rr, xv, scr, warp, acc, tile, end;
};

__host__ __device__ inline WpLayout wp_layout(int H, bool masked) {
  WpLayout L;
  L.TRI = H * (H + 1) / 2;
  L.GS = (H + 4) & ~3;
  const int gram = H * L.GS, recs = WP_ROWS * REC, dense = dense_floats(H);
  int scr = recs > dense ? recs : dense;
  if (masked && gram > scr) scr = gram;
  size_t o = 0;
  L.psi = take(o, 4 * size_t(gram));
  L.g = take(o, masked ? 0 : 4 * size_t(gram));
  L.head = o;
  o = 0;
  L.sst = take(o, 4 * size_t(L.TRI));       // xpt_ss, upper triangle
  L.zzt = take(o, 4 * size_t(L.TRI));       // xpt_szsz
  L.ub = take(o, 4 * WP_MAX_H);             // for each unit of the union: the rows that hold it
  L.uz = take(o, 4 * WP_MAX_H);             // and the sparse ones
  L.ul = take(o, 4 * WP_MAX_H);             // the union's units, ascending
  L.pos = take(o, size_t(H) * WP_ROWS);     // [unit of the union, row]: its place in the row
  L.rmask = take(o, 8 * WP_ROWS);           // the rows' masks
  L.rr = take(o, 4 * WP_ROWS);              // and responsibilities
  L.xv = take(o, 8 * WP_MAX_H);             // the datapoint's xpt_s, then its xpt_sz
  L.scr = take(o, 4 * size_t(scr));
  L.warp = o;
  o = 0;
  L.acc = take(o, 4 * size_t(H * H + L.TRI));        // s_sz_outer, the sz_sz_outer triangle
  L.tile = take(o, 4 * size_t(4 * WP_TILE) * H);     // two tiles' xpt_s, then xpt_sz
  L.end = o;
  return L;
}

inline size_t wp_smem(const WpLayout& L, int NW) {
  const size_t w = L.head + NW * L.warp;
  return w > L.end ? w : L.end;
}

// the mask of a state row of H <= 64 int8 bytes at p: bit h <=> byte h != 0
__device__ __forceinline__ uint64_t row_mask64(const uint8_t* p, int H, bool aligned) {
  uint64_t m = 0;
  for (int c = 0; 16 * c < H; ++c) {
    const uint4 v = load16(p + 16 * c, H - 16 * c, aligned);
    const uint32_t bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
                          nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
    m |= uint64_t(bits) << (16 * c);
  }
  return m;
}

// the place of unit h among the units of m (h must be in m)
__device__ __forceinline__ int compact64(uint64_t m, int h) {
  return __popcll(m & ((1ull << h) - 1ull));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

template <bool MASKED>
__global__ void __launch_bounds__(WP_WARPS * 32, 2)
sssc_suffstat_partial(const int8_t* __restrict__ ss, const float* __restrict__ rs,
                      const float* __restrict__ wty, const float* __restrict__ G,
                      const float* __restrict__ Psi, const float* __restrict__ mus,
                      const float* __restrict__ s2inv_p, float* __restrict__ xpt_sz,
                      float* __restrict__ xpt_s, float* __restrict__ partial,
                      unsigned long long* __restrict__ counts, int B, int S, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WpLayout L = wp_layout(H, MASKED);
  const int NW = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int TRI = L.TRI, HH = H * H, GS = L.GS;
  float* psi_s = reinterpret_cast<float*>(smem + L.psi);
  float* g_s = reinterpret_cast<float*>(smem + L.g);
  for (int e = threadIdx.x; e < HH; e += blockDim.x) {
    const int i = e / H, j = e - i * H;
    psi_s[i * GS + j] = __ldg(Psi + e);
    if (!MASKED) g_s[i * GS + j] = __ldg(G + e);
  }
  unsigned char* mine = smem + L.head + size_t(warp) * L.warp;
  float* sst = reinterpret_cast<float*>(mine + L.sst);
  float* zzt = reinterpret_cast<float*>(mine + L.zzt);
  uint32_t* ub = reinterpret_cast<uint32_t*>(mine + L.ub);
  uint32_t* uz = reinterpret_cast<uint32_t*>(mine + L.uz);
  int* ul = reinterpret_cast<int*>(mine + L.ul);
  uint8_t* pos = mine + L.pos;
  uint64_t* rmask = reinterpret_cast<uint64_t*>(mine + L.rmask);
  float* rr = reinterpret_cast<float*>(mine + L.rr);
  float* xv = reinterpret_cast<float*>(mine + L.xv);  // xpt_s[h], xpt_sz[h] at h, 64 + h
  float* scr = reinterpret_cast<float*>(mine + L.scr);
  const float s2inv = *s2inv_p;
  for (int e = lane; e < TRI; e += 32) sst[e] = zzt[e] = 0.f;
  __syncthreads();

  const int TW = gridDim.x * NW, first = blockIdx.x * NW;
  const bool aligned = H % 16 == 0 && reinterpret_cast<uintptr_t>(ss) % 16 == 0;
  // G_b 16 bytes a copy where its rows are 16-byte aligned and H a power of
  // two (a lane copies columns 4 (lane % Q) of rows lane / Q, Q = H / 4)
  const int Q = H / 4;
  const bool g16 = MASKED && H >= 4 && (H & (H - 1)) == 0 &&
                   reinterpret_cast<uintptr_t>(G) % 16 == 0;
  unsigned n_sparse = 0, n_dense = 0;
  for (int b0 = first; b0 < B; b0 += TW) {  // a round: datapoint b0 + w to warp w
    const int b = b0 + warp;
    if (b < B) {
      if (b + TW < B) {  // the next datapoint's rows and G_b on their way to L2
        const long long nb = b + TW;
        const uint8_t* rows = reinterpret_cast<const uint8_t*>(ss) + nb * S * H;
        for (int x = 128 * lane; x < S * H; x += 32 * 128) prefetch_l2(rows + x);
        if (lane == 0) prefetch_l2(rs + nb * S);
        if (MASKED)
          for (int x = 32 * lane; x < HH; x += 32 * 32) prefetch_l2(G + nb * HH + x);
      }
      const float* wty_b = wty + (long long)b * H;
      const float* Gd = MASKED ? G + (long long)b * HH : G;
      xv[lane] = xv[32 + lane] = xv[64 + lane] = xv[96 + lane] = 0.f;
      for (int k0 = 0; k0 < S; k0 += WP_ROWS) {
        // 1. a lane a row: mask, n, kind; the union and its rows; with MASKED
        // the datapoint's G_b into the scratch
        if (MASKED) {  // in flight while the rows are read
          if (g16)
            for (int i = lane / Q, j = 4 * (lane % Q); i < H; i += 32 / Q)
              cp_async16(scr + i * GS + j, Gd + i * H + j);
          else
            for (int i = 0; i < H; ++i)
              for (int j = lane; j < H; j += 32) cp_async4(scr + i * GS + j, Gd + i * H + j);
          cp_async_commit();
        }
        const long long row = (long long)b * S + k0 + lane;
        uint64_t m = 0;
        float r = 0.f;
        if (k0 + lane < S) {
          m = row_mask64(reinterpret_cast<const uint8_t*>(ss) + row * H, H, aligned);
          r = rs[row];
        }
        const int n = __popcll(m);
        const int kind = row_kind(n, r, 0);
        rmask[lane] = m;
        rr[lane] = r;
        const uint64_t live = kind != ROW_NONE ? m : 0ull;
        uint64_t uni = uint64_t(__reduce_or_sync(FULL, uint32_t(live))) |
                       uint64_t(__reduce_or_sync(FULL, uint32_t(live >> 32))) << 32;
        const int u = __popcll(uni);
        const uint32_t sparse_rows = __ballot_sync(FULL, kind == ROW_SPARSE);
        const uint32_t dense_rows = __ballot_sync(FULL, kind == ROW_DENSE);
        n_sparse += __popc(sparse_rows);
        n_dense += __popc(dense_rows);
        for (int i = 0; i < u; ++i) {
          const int h = __ffsll((long long)uni) - 1;
          uni &= uni - 1ull;
          const bool on = (live >> h) & 1ull;
          const uint32_t b1 = __ballot_sync(FULL, on);
          const uint32_t b2 = __ballot_sync(FULL, on && kind == ROW_SPARSE);
          pos[i * WP_ROWS + lane] = uint8_t(compact64(m, h));
          if (lane == (i & 31)) {
            ub[i] = b1;
            uz[i] = b2;
            ul[i] = h;
          }
        }
        if (MASKED) cp_async_wait();
        __syncwarp();
        // 2. sparse states, a lane each, in the smallest register tile that
        // holds the warp's largest; G_AA from the scratch (MASKED) or the
        // block's G; the records take the scratch once every sparse lane has
        // read its G_AA
        const int most = __reduce_max_sync(FULL, kind == ROW_SPARSE ? n : 0);
        const float* Gs = MASKED ? scr : g_s;
        if (kind == ROW_SPARSE) {
          float* rec = scr + lane * REC;
          if (most <= 4) {
            int idx[4];
            float A[4][4], kap[4];
            units_of(m, idx);
            solve_sparse<4, true>(idx, n, wty_b, Gs, GS, psi_s, GS, mus, s2inv, A, kap);
            if (MASKED) __syncwarp(sparse_rows);
            write_record(rec, n, r, A, kap);
          } else if (most <= 6) {
            int idx[6];
            float A[6][6], kap[6];
            units_of(m, idx);
            solve_sparse<6, true>(idx, n, wty_b, Gs, GS, psi_s, GS, mus, s2inv, A, kap);
            if (MASKED) __syncwarp(sparse_rows);
            write_record(rec, n, r, A, kap);
          } else {
            int idx[SPARSE_N];
            float A[SPARSE_N][SPARSE_N], kap[SPARSE_N];
            units_of(m, idx);
            solve_sparse<SPARSE_N, true>(idx, n, wty_b, Gs, GS, psi_s, GS, mus, s2inv, A, kap);
            if (MASKED) __syncwarp(sparse_rows);
            write_record(rec, n, r, A, kap);
          }
        }
        __syncwarp();
        // 3. lane i of the union's units adds the datapoint's xpt_s and xpt_sz
        // over the rows that hold it; the owners of the union's pairs add to
        // the warp's triangles; both in row order
        for (int i = lane; i < u; i += 32) {
          const int h = ul[i];
          const uint8_t* pi = pos + i * WP_ROWS;
          float as = xv[h], az = xv[64 + h];
          for (uint32_t bits = ub[i]; bits; bits &= bits - 1u) as += rr[__ffs(bits) - 1];
          for (uint32_t bits = uz[i]; bits; bits &= bits - 1u) {
            const int q = __ffs(bits) - 1;
            az += scr[q * REC + pi[q]];
          }
          xv[h] = as;
          xv[64 + h] = az;
        }
        // the pairs (i, j), i <= j, of the union in row order, 32 apart
        for (int i = 0, j = lane;; j += 32) {
          while (i < u && j >= u) {
            ++i;
            j += i - u;
          }
          if (i >= u) break;
          const uint32_t both = ub[i] & ub[j];
          if (both == 0u) continue;
          const int p = tri_index(ul[i], ul[j], H);
          const uint8_t *pi = pos + i * WP_ROWS, *pj = pos + j * WP_ROWS;
          float as = sst[p], az = zzt[p];
          for (uint32_t bits = both; bits; bits &= bits - 1u) as += rr[__ffs(bits) - 1];
          for (uint32_t bits = uz[i] & uz[j]; bits; bits &= bits - 1u) {
            const int q = __ffs(bits) - 1;
            az += scr[q * REC + SPARSE_N + rec_tri(pi[q], pj[q])];
          }
          sst[p] = as;
          zzt[p] = az;
        }
        __syncwarp();
        // 4. dense states, the warp each, in row order (their scratch takes
        // the records' place)
        for (uint32_t dl = dense_rows; dl; dl &= dl - 1u) {
          const int q = __ffs(dl) - 1;
          const uint64_t mq = rmask[q];
          const int nq = __popcll(mq);
          const float rq = rr[q];
          solve_dense_warp(rmask + q, nq, wty_b, MASKED ? Gd : g_s, MASKED ? H : GS, psi_s, GS, mus,
                           s2inv, scr, lane);
          const float* lam = scr;
          const float* kap = scr + nq * nq + nq;
          const int* idx = reinterpret_cast<const int*>(kap + nq);
          for (int i = lane; i < nq; i += 32) xv[64 + idx[i]] += rq * kap[i];
          for (int t = lane; t < nq * (nq + 1) / 2; t += 32) {
            int i, j;
            tri_at(t, nq, i, j);
            const int p = tri_index(idx[i], idx[j], H);
            zzt[p] += rq * (finite_or_zero(lam[i * nq + j]) + kap[i] * kap[j]);
          }
          __syncwarp();
        }
      }
      for (int h = lane; h < H; h += 32) {
        xpt_s[(long long)b * H + h] = xv[h];
        xpt_sz[(long long)b * H + h] = xv[64 + h];
      }
    }
    __syncthreads();
  }
  if (counts != nullptr && lane == 0 && (n_sparse | n_dense)) {
    atomicAdd(counts, (unsigned long long)n_sparse);
    atomicAdd(counts + 1, (unsigned long long)n_dense);
  }
  __syncthreads();

  // the warps' triangles, in warp order
  float* out = partial + size_t(blockIdx.x) * (3 * TRI + HH);
  for (int e = threadIdx.x; e < TRI; e += blockDim.x) {
    float as = 0.f, az = 0.f;
    for (int w = 0; w < NW; ++w) {
      as += reinterpret_cast<const float*>(smem + L.head + size_t(w) * L.warp + L.sst)[e];
      az += reinterpret_cast<const float*>(smem + L.head + size_t(w) * L.warp + L.zzt)[e];
    }
    out[e] = as;
    out[TRI + e] = az;
  }
  __syncthreads();
  // the outer products over the block's datapoints, a tile of WP_TILE at a
  // time: datapoint d of a tile is warp d % NW's (d / NW)-th of the tile's
  // rounds, each read back from xpt_s and xpt_sz (zeros past B), the next
  // tile's reads in flight while one is summed
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* txs = reinterpret_cast<float*>(smem + L.tile);
  for (int e = threadIdx.x; e < HH + TRI; e += blockDim.x) acc[e] = 0.f;
  const int rounds = WP_TILE / NW, TS = 2 * WP_TILE * H;
  auto read_tile = [&](long long m0, float* t) {  // in flight until the next wait
    for (int x = threadIdx.x; x < WP_TILE * H; x += blockDim.x) {
      const int d = x / H, h = x - d * H;
      const long long b = first + d % NW + (m0 + d / NW) * TW;
      if (b < B) {
        cp_async4(t + x, xpt_s + b * H + h);
        cp_async4(t + WP_TILE * H + x, xpt_sz + b * H + h);
      } else {
        t[x] = t[WP_TILE * H + x] = 0.f;
      }
    }
    cp_async_commit();
  };
  read_tile(0, txs);
  for (long long m0 = 0, t = 0; first + m0 * TW < B; m0 += rounds, t ^= 1) {
    const float* xs_t = txs + t * TS;
    const float* xz_t = xs_t + WP_TILE * H;
    if (first + (m0 + rounds) * TW < B) {
      read_tile(m0 + rounds, txs + (t ^ 1) * TS);
      cp_async_wait_one();
    } else {
      cp_async_wait();
    }
    __syncthreads();
    for (int e = threadIdx.x; e < HH + TRI; e += blockDim.x) {
      int i, j;
      const float* X = xs_t;
      if (e < HH) {
        i = e / H;
        j = e - i * H;
      } else {
        tri_at(e - HH, H, i, j);
        X = xz_t;
      }
      float a = acc[e];
#pragma unroll 8
      for (int d = 0; d < WP_TILE; ++d) a = fmaf(X[d * H + i], xz_t[d * H + j], a);
      acc[e] = a;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < HH + TRI; e += blockDim.x) out[2 * TRI + e] = acc[e];
}

// ---------------------------------------------------------------------------
// 64 < H <= 128 (complete data): a block a unit of datapoints

constexpr int SS_THREADS = 256;
constexpr int SS_NW = SS_THREADS / 32;  // warps
// rows of a sub-batch at most: at B = 4096, S = 20 units of 256 rows gave
// the card's 264 blocks one or two units each, units of 128 rows two or three
constexpr int SS_ROWS = 128;
constexpr int UMAX = 32;  // datapoints of a unit at most

// Byte offsets of a block's shared memory for width H, S slots, sub-batches
// of at most RB rows and a pool that holds DQ of the densest states.
struct SsLayout {
  int U, R, RW, MW, MS, TRI, POOL;
  size_t sst, zzt, szt, ssz, xs, xz, zd, pairs, masks, rrs, rn, rms, rmz, dlist, doff, pool,
      total;
};

__host__ __device__ inline SsLayout ss_layout(int H, int S, int cap, int RB, int DQ) {
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
  L.pool = take(o, 4 * size_t(L.POOL));  // sparse records, then dense scratch
  L.total = o;
  return L;
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

// 16 state bytes at chunk c of a run of `bytes` (zeros past its end)
__device__ __forceinline__ uint4 load_chunk(const uint8_t* base, int c, int bytes, bool aligned) {
  const int avail = bytes - 16 * c;
  return avail > 0 ? load16(base + 16 * c, avail, aligned) : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(SS_THREADS, 2)
sssc_suffstat_partial_units(const int8_t* __restrict__ ss, const float* __restrict__ rs,
                            const float* __restrict__ wty, const float* __restrict__ G,
                            const float* __restrict__ Psi, const float* __restrict__ mus,
                            const float* __restrict__ s2inv_p, float* __restrict__ xpt_sz,
                            float* __restrict__ xpt_s, float* __restrict__ partial, int B,
                            int S, int H, int cap, int RB, int DQ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SsLayout L = ss_layout(H, S, cap, RB, DQ);
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
  for (long long unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const long long b0 = unit * U;
    const int nd = int(B - b0 < U ? B - b0 : U);  // datapoints of the unit
    for (int e = tid; e < nd * H; e += SS_THREADS) xs[e] = xz[e] = zd[e] = 0.f;
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
      __syncthreads();
      // 3. sparse states, a thread each, in registers; warp 0 lists the dense
      // rows in row order with their scratch offsets
      if (kind == ROW_SPARSE) {
        const int dl = pieces ? 0 : tid / S;
        int idx[SPARSE_N];
        units_of(masks + tid * MS, MW, idx);
        float A[SPARSE_N][SPARSE_N], kap[SPARSE_N];
        solve_sparse<SPARSE_N, false>(idx, n, wty + (b0 + dl) * H, G, H, Psi, H, mus, s2inv, A,
                                      kap);
        write_record(pool + tid * REC, n, my_r, A, kap);
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
          solve_dense<false>(masks + r * MS, MW, rn[r], wty + (b0 + dl) * H, G, H, Psi, H, mus,
                             s2inv, pool + doff[q] - doff[q0], lane);
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

// ---------------------------------------------------------------------------
// Plans and launches

// The card's SM count and shared memory (a block's most, an SM's), read
// once a device, and a kernel's dynamic shared memory limit raised to the
// block's most, once a device and kernel (KERNEL: 0 the units body, 1 and
// 2 the warp body without and with MASKED).
struct SsCard {
  int n_sm;
  size_t smem, smem_sm;
};

template <int KERNEL>
int ss_card(const void* kernel, SsCard* out) {
  static std::atomic<uint64_t> ready{0};
  static SsCard cards[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev < 64 && (ready.load() >> dev & 1u)) {
    *out = cards[dev];
    return 0;
  }
  int n_sm = 0, smem = 0, smem_sm = 0;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  *out = SsCard{n_sm, size_t(smem), size_t(smem_sm)};
  if (dev < 64) {
    cards[dev] = *out;
    ready.fetch_or(uint64_t(1) << dev);
  }
  return 0;
}

// The warp body's warps a block NW (a power of two up to 8) that keep the
// most warps on an SM, at most WP_SM_WARPS (the larger NW on a tie), and
// its shared memory; NW = 0 if one warp does not fit.
struct WpPlan {
  int NW;
  size_t smem;
};

inline WpPlan wp_plan(int H, bool masked, const SsCard& c) {
  const WpLayout L = wp_layout(H, masked);
  WpPlan best{0, 0};
  int most = 0;
  for (int NW = WP_WARPS; NW >= 1; NW /= 2) {
    const size_t s = wp_smem(L, NW);
    if (s > c.smem) continue;
    const int per_sm = int(c.smem_sm / (s + 1024));  // 1 KB the runtime keeps a block
    const int w = NW * per_sm < WP_SM_WARPS ? NW * per_sm : WP_SM_WARPS;
    if (w > most) {
      most = w;
      best = WpPlan{NW, s};
    }
  }
  return best;
}

// The units body's sub-batch rows RB and a pool of DQ of the densest states
// for width H within smem bytes of shared memory, and within half of it
// where that fits two blocks an SM (RB = 0 if even 32 rows and one state do
// not fit).
struct SsPlan {
  int RB, DQ;
  size_t smem;
};

inline SsPlan ss_plan(int H, int S, int cap, size_t smem) {
  for (const size_t lim : {smem / 2 - 1024, smem})
    for (int RB = SS_ROWS; RB >= 32; RB /= 2)
      for (int DQ = SS_NW; DQ >= 1; DQ /= 2) {
        const SsLayout L = ss_layout(H, S, cap, RB, DQ);
        if (L.total <= lim) return SsPlan{RB, DQ, L.total};
      }
  return SsPlan{0, 0, 0};
}

// The number of blocks G for (B, S, H) on the current device: as many as
// fit on the card at once, at most one a unit (units body) or NW datapoints
// (warp body).  Negative: a CUDA error, or H too wide for shared memory.
template <bool MASKED>
int sssc_suffstat_blocks(int B, int S, int H, int cap) {
  SsCard c;
  int per_sm = 0;
  long long need = 0;
  if (H <= WP_MAX_H) {
    const void* k = reinterpret_cast<const void*>(sssc_suffstat_partial<MASKED>);
    const int e = ss_card<MASKED ? 2 : 1>(k, &c);
    if (e != 0) return -e;
    const WpPlan p = wp_plan(H, MASKED, c);
    if (p.NW == 0) return -int(cudaErrorInvalidValue);
    const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sssc_suffstat_partial<MASKED>, 32 * p.NW, p.smem);
    if (oe != cudaSuccess) return -int(oe);
    need = (B + p.NW - 1) / p.NW;
  } else {
    if (MASKED) return -int(cudaErrorInvalidValue);
    const int e = ss_card<0>(reinterpret_cast<const void*>(sssc_suffstat_partial_units), &c);
    if (e != 0) return -e;
    const SsPlan p = ss_plan(H, S, cap, c.smem);
    if (p.RB == 0) return -int(cudaErrorInvalidValue);
    const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sssc_suffstat_partial_units, SS_THREADS, p.smem);
    if (oe != cudaSuccess) return -int(oe);
    const SsLayout L = ss_layout(H, S, cap, p.RB, p.DQ);
    need = (B + L.U - 1) / L.U;
  }
  const long long fill = (long long)c.n_sm * (per_sm > 1 ? per_sm : 1);
  return int(need < fill ? need : fill);
}

// Both passes on `stream` with G blocks (from sssc_suffstat_blocks) and
// partial [G, 3 H(H+1)/2 + H^2] f32; `counts` (int64 [2] or null) gains the
// rows the warp body solved sparsely and densely.  The body follows H: the
// warp body up to WP_MAX_H, where its triangles fit, the units body above.
// Returns the first launch error (0 if none).
template <bool MASKED>
int launch_sssc_suffstat(const void* ss, const void* rs, const void* wty, const void* G,
                         const void* Psi, const void* mus, const void* s2inv, void* xpt_sz,
                         void* xpt_s, void* out, void* partial, void* counts, int B, int S,
                         int H, int cap, int n_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ss_ = static_cast<const int8_t*>(ss);
  const auto* rs_ = static_cast<const float*>(rs);
  const auto* wty_ = static_cast<const float*>(wty);
  const auto* G_ = static_cast<const float*>(G);
  const auto* Psi_ = static_cast<const float*>(Psi);
  const auto* mus_ = static_cast<const float*>(mus);
  const auto* s2inv_ = static_cast<const float*>(s2inv);
  auto* xpt_sz_ = static_cast<float*>(xpt_sz);
  auto* xpt_s_ = static_cast<float*>(xpt_s);
  auto* partial_ = static_cast<float*>(partial);
  SsCard c;
  if (n_blocks < 1) return int(cudaErrorInvalidValue);
  if (H <= WP_MAX_H) {
    const int e = ss_card<MASKED ? 2 : 1>(
        reinterpret_cast<const void*>(sssc_suffstat_partial<MASKED>), &c);
    if (e != 0) return e;
    const WpPlan p = wp_plan(H, MASKED, c);
    if (p.NW == 0) return int(cudaErrorInvalidValue);
    sssc_suffstat_partial<MASKED><<<n_blocks, 32 * p.NW, p.smem, st>>>(
        ss_, rs_, wty_, G_, Psi_, mus_, s2inv_, xpt_sz_, xpt_s_, partial_,
        static_cast<unsigned long long*>(counts), B, S, H);
  } else {
    if (MASKED) return int(cudaErrorInvalidValue);
    const int e = ss_card<0>(reinterpret_cast<const void*>(sssc_suffstat_partial_units), &c);
    if (e != 0) return e;
    const SsPlan p = ss_plan(H, S, cap, c.smem);
    if (p.RB == 0) return int(cudaErrorInvalidValue);
    sssc_suffstat_partial_units<<<n_blocks, SS_THREADS, p.smem, st>>>(
        ss_, rs_, wty_, G_, Psi_, mus_, s2inv_, xpt_sz_, xpt_s_, partial_, B, S, H, cap, p.RB,
        p.DQ);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int E = 3 * (H * (H + 1) / 2) + H * H;
  sssc_suffstat_reduce<<<(E + 31) / 32, dim3(32, 32), 0, st>>>(partial_, static_cast<float*>(out),
                                                               n_blocks, H);
  return int(cudaGetLastError());
}

}  // namespace
