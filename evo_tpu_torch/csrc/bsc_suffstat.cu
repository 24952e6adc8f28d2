// BSC M-step sufficient statistics of the merged state sets.
//
// Replaces: evo_tpu/ops/pallas_suffstat.py:bsc_suffstat_pallas, int8 states
// and lane-major packed uint8 states (EAConfig.packed_states):
//
//   rho[b,h]  = sum_s rs[b,s] ss[b,s,h]
//   sabs[b,s] = sum_h ss[b,s,h]
//   Wq[h,k]   = sum_{b,s} rs[b,s] ss[b,s,h] ss[b,s,k]
//
// What bounds it on an H100: reading the states once (67 MB as int8 at
// B = 4096, S = 64, H = 256: 0.02 ms at 3.35 TB/s; packed, 8.4 MB).  For a
// binary row with n latents on, Wq gains rs on the row's n^2 ordered pairs
// (n(n+1)/2 of them in the upper triangle, as Wq is symmetric), rho gains
// rs on its n latents and sabs is n: at the EA's sparsity (about 2 bits on)
// a few adds a row, far below the byte time.  Every sum is a plain f32 add
// (no TF32, no tensor cores) in an order fixed by the data alone, with no
// float atomics, so Wq is the same from run to run.
//
// Two kernels on the caller's stream.
//
// bsc_suffstat_partial: a grid of G chunks x the tiles of Wq's upper
// triangle.  A tile lives in shared memory in f32: the whole triangle
// (133 KB at H = 256) or, where that does not fit (H past about 270), the
// pairs of latent ranges I <= J of T latents (a triangle for I = J, a
// rectangle else), one block each.  Rows of a triangle start at the column
// of their 4 x 4 sub-block, so sub-blocks are 16-byte aligned.  Chunk x
// takes the units x, x + G, x + 2G, ... (a unit is the fewest whole
// datapoints that make 32 rows), so the dense datapoints of a block of
// states spread over the SMs, and walks them in sub-batches of up to 256
// rows and 16 datapoints (several units, or a piece of one datapoint when
// S is larger), with all of a thread's loads of a sub-batch in flight at
// once.  For each sub-batch:
//  1. Masks.  Each thread ORs its 16-byte chunks of the rows into per-row
//     bitmasks in shared memory (state_mask.cuh).  The int8 and packed rows
//     of a state give the same mask, and everything after this step is
//     shared, so the two modes give bit-identical rho, sabs and Wq.  A
//     thread a row then counts n (sabs, written by the blocks of tile 0)
//     and lists up to 32 active latents, ascending.
//  2. Sparse rows (n <= 32) by entry.  Each such row with rs != 0 has its
//     items: its pairs h <= k in the tile and, on the diagonal tiles, its
//     (datapoint, h) entries of rho.  Per group of 32 rows and latent of
//     the tile, a mask of the rows that hold the latent (the row masks'
//     bits transposed by shuffles), and per latent the groups that hold it.
//     A block scan numbers the items in row order; the warps take them 32
//     at a time, a lane an item, whichever latents are hot.  An item stops
//     where an earlier row of its group holds its entry; where its row
//     alone holds the entry it adds its rs; else it claims the entry in a
//     bitmap (an integer atomic), and the first claim lists the entry.
//     After a barrier a thread a listed entry sums the rs of all its
//     holders in row order into four partials and adds the four, in a
//     fixed order, once to the tile or to rho: the same sum whichever item
//     claimed it.  Rounds of ROUND_ITEMS items bound the list.  Where the
//     caller gives a counter, integer atomics count the rows of steps 2
//     and 3.
//  3. Dense rows (n > 32) by a tiled product.  They are staged 32 at a time
//     as 0/1 f32 columns with their rs, and every thread adds them into its
//     4 x 4 sub-blocks of the tile (the triangle's only): rs s_h s_k by FMA,
//     so zero bits add exact zeros, as the dense product would, on about
//     half of H^2 entries a row.  A thread a latent adds their rho.
// Rows with rs exactly 0 add exact zeros to Wq and rho and are skipped
// there (padded and invalid datapoints, the softmax's underflowed tail).
// After a datapoint's last rows its rho is written out; at the end the
// block writes its tile into its chunk's partial, laid out as Wq's packed
// upper triangle.
//
// bsc_suffstat_reduce: each entry of the triangle sums the G partials in
// f64 (32 fixed slices of chunks, then the slices in order), rounds once to
// f32 and writes Wq[h, k] and Wq[k, h].  G is about one block an SM (more,
// 2048 rows a chunk at most, for tall inputs), so the partials are 17 MB at
// H = 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "state_mask.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int NW = THREADS / 32;  // warps, and rho's datapoint slots
constexpr int RB_MAX = 256;       // rows of a sub-batch
static_assert(RB_MAX <= THREADS, "a thread a row of a sub-batch");
constexpr int PF = 8;             // 16-byte state loads a thread has in flight
constexpr int SUB_BYTES = PF * THREADS * 16;  // int8 bytes of a sub-batch at most: one round
constexpr int UNIT_ROWS = 32;     // a unit holds whole datapoints, this many rows where S allows
constexpr int LMAX = 32;          // latents a listed (sparse) row; denser rows are staged
constexpr int PAIRS = LMAX * (LMAX + 1) / 2;  // pairs a <= b of a sparse row's latents
constexpr int ROUND_ITEMS = 8 * THREADS;  // step 2's items a round
constexpr int LS = 34;            // list stride in halfwords (17 words: no bank conflicts)
constexpr int R = 32;             // dense rows staged at once
constexpr int ROWS_PER_CHUNK = 2048;
constexpr long long PARTIAL_FLOATS = 1LL << 26;  // the partials' budget (256 MB)
constexpr unsigned FULL = 0xffffffffu;

// rows of a sub-batch at width H: one round of loads, and at most NW
// datapoints (rho's slots); the same for both modes
__host__ __device__ inline int rows_per_batch(int H, int S) {
  int r = SUB_BYTES / H;
  r = r > NW * S ? NW * S : r;
  return r < 1 ? 1 : (r > RB_MAX ? RB_MAX : r);
}

// datapoints of a unit
__host__ __device__ inline int unit_dps(int S, int RB) {
  const int u = (UNIT_ROWS + S - 1) / S, cap = RB / S;
  return u < cap ? u : (cap < 1 ? 1 : cap);
}

// floats of a tile's storage: a triangle of edge n whose rows start at
// their sub-block's column, or an n x m rectangle (rows padded to 4)
__host__ __device__ inline int tile_floats(int n, int m, bool diag) {
  const int q = (n + 3) / 4;
  return diag ? 8 * q * (q + 1) : 4 * q * ((m + 3) / 4) * 4;
}

// A bitmap over a tile's entries and rho's (NW datapoint slots) in layers
// of 32 SPREAD bits, entry e at bit e / SPREAD % 32 of word e % SPREAD of
// its layer, so that a row's entries, which lie close together, fall in
// different words.
constexpr int SEEN_SHIFT = 9, SEEN_SPREAD = 1 << SEEN_SHIFT;
__host__ __device__ inline int seen_words(int T, bool tiled) {
  const int bits = tile_floats(T, T, !tiled) + NW * ((T + 3) & ~3);
  return SEEN_SPREAD * ((bits + 32 * SEEN_SPREAD - 1) / (32 * SEEN_SPREAD));
}

// Byte offsets of the block's shared memory for width H, latent ranges of
// T (the whole H when P = 1) and sub-batches of RB rows in NG groups of 32.
// Step 2's column masks share their area with step 3's staging.
struct Layout {
  int T4, MW, MS, NG;
  size_t stor, bk, bh, cols, ctab, seen, claims, srs, sdp, masks, rn, rrs, dlist, racc, rpos,
      erec, eoff, wsum, ptab, list, total;
};

__host__ __device__ inline Layout make_layout(int H, int T, bool tiled, int RB) {
  Layout L;
  L.T4 = (T + 3) & ~3;
  L.MW = (H + 31) / 32;
  L.MS = L.MW | 1;  // odd row stride: a thread a row reads without bank conflicts
  L.NG = (RB + 31) / 32;
  size_t o = 0;
  L.stor = o;  // the tile
  o += sizeof(float) * (tiled ? tile_floats(T, T, false) : tile_floats(T, T, true));
  const size_t staging = sizeof(float) * R * L.T4 * (tiled ? 2 : 1);
  const size_t cols = sizeof(uint32_t) * (L.NG + 1) * L.T4 * (tiled ? 2 : 1);
  L.bk = o;  // step 3: s_k of the staged dense rows (and s_h on the diagonal tiles)
  L.bh = o + sizeof(float) * R * L.T4;  // s_h of the staged dense rows on the other tiles
  L.cols = o;  // step 2: per group and latent of the h range (then of the k range), its rows;
               // then per latent, its groups
  L.ctab = o + cols;  // step 2: per 32 items, the row (of those with items) of the first
  const size_t ctab = (size_t(RB) * (LMAX + PAIRS) / 32 + 16) & ~size_t(15);
  L.seen = L.ctab + ctab;  // step 2: per entry of the tile and of rho, whether an item claimed it
  L.claims = L.seen + sizeof(uint32_t) * seen_words(T, tiled);  // step 2: a round's claimed entries
  const size_t scratch = L.claims + sizeof(uint32_t) * ROUND_ITEMS - o;
  o += (staging > scratch ? staging : scratch + 15) & ~size_t(15);
  L.srs = o;  // their rs
  o += sizeof(float) * R;
  L.sdp = o;  // their datapoints in the sub-batch
  o += sizeof(int) * R;
  L.masks = o;
  o += sizeof(uint32_t) * size_t(RB) * L.MS;
  L.rn = o;  // n per row
  o += sizeof(int) * RB;
  o = (o + 15) & ~size_t(15);
  L.rrs = o;  // rs per row (16-byte aligned: read 4 at a time)
  o += sizeof(float) * RB;
  L.dlist = o;  // the dense rows, ascending, then their count
  o += sizeof(int) * (RB + 1);
  L.racc = o;  // rho of the sub-batch's datapoints, one slot a datapoint
  o += sizeof(float) * NW * L.T4;
  L.rpos = o;  // step 2: per row, where its latents of the h and k ranges start and how many
  o += sizeof(uint32_t) * RB;
  o = (o + 15) & ~size_t(15);
  L.erec = o;  // step 2: the rows that have items, in order: (first item, row, rpos, 0)
  o += sizeof(uint4) * RB;
  L.eoff = o;  // step 2: ... their first items again, then the end
  o += sizeof(int) * (RB + 1);
  L.wsum = o;  // step 2: the warps' items, rows with items and dense rows; the claims
  o += sizeof(int) * (3 * NW + 1);
  L.ptab = o;  // step 2: the p-th pair (a, b), a <= b, of a row's latents, by b then a
  o += sizeof(uint16_t) * PAIRS;
  L.list = o;  // up to LMAX active latents a row
  o += sizeof(uint16_t) * size_t(RB) * LS;
  L.total = (o + 15) & ~size_t(15);
  return L;
}

// the t-th entry (i, j), j >= i, of an n x n upper triangle in row order
__host__ __device__ inline void tri_ij(long long t, int n, int& i, int& j) {
  const float d = 2.f * n + 1.f;
  i = int((d - sqrtf(fmaxf(d * d - 8.f * float(t), 0.f))) * 0.5f);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  auto off = [n](long long r) { return r * n - r * (r - 1) / 2; };
  while (i > 0 && off(i) > t) --i;
  while (i + 1 < n && off(i + 1) <= t) ++i;
  j = int(i + (t - off(i)));
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
bsc_suffstat_partial(const uint8_t* __restrict__ ss, const float* __restrict__ rs,
                     float* __restrict__ rho, float* __restrict__ sabs,
                     float* __restrict__ partial, unsigned long long* __restrict__ rows_out,
                     int B, int S, int H, int P, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RB = rows_per_batch(H, S);
  const Layout L = make_layout(H, T, P > 1, RB);
  float* stor = reinterpret_cast<float*>(smem + L.stor);
  float* bk_s = reinterpret_cast<float*>(smem + L.bk);
  float* srs = reinterpret_cast<float*>(smem + L.srs);
  int* sdp = reinterpret_cast<int*>(smem + L.sdp);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.masks);
  int* rn = reinterpret_cast<int*>(smem + L.rn);
  float* rrs = reinterpret_cast<float*>(smem + L.rrs);
  int* dlist = reinterpret_cast<int*>(smem + L.dlist);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L.list);
  uint32_t* rpos = reinterpret_cast<uint32_t*>(smem + L.rpos);
  uint4* erec = reinterpret_cast<uint4*>(smem + L.erec);
  int* eoff = reinterpret_cast<int*>(smem + L.eoff);
  int* wsum = reinterpret_cast<int*>(smem + L.wsum);
  uint8_t* ctab = smem + L.ctab;
  uint32_t* seen = reinterpret_cast<uint32_t*>(smem + L.seen);
  uint32_t* claims = reinterpret_cast<uint32_t*>(smem + L.claims);
  uint16_t* ptab = reinterpret_cast<uint16_t*>(smem + L.ptab);
  const int MW = L.MW, MS = L.MS, T4 = L.T4, NG = L.NG;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int I, J;
  tri_ij(blockIdx.y, P, I, J);
  const int h0 = I * T, nh = min(T, H - h0), k0 = J * T, nk = min(T, H - k0);
  const bool diag = I == J;
  const int nk4 = (nk + 3) & ~3;
  float* bh_s = diag ? bk_s : reinterpret_cast<float*>(smem + L.bh);
  float* racc = reinterpret_cast<float*>(smem + L.racc);
  // step 2's masks of the rows holding each latent of the h (k) range, T4 words a group
  uint32_t* colh = reinterpret_cast<uint32_t*>(smem + L.cols);
  uint32_t* colk = diag ? colh : colh + NG * T4;
  uint32_t* occh = colh + NG * T4 * (P > 1 ? 2 : 1);
  uint32_t* occk = diag ? occh : occh + T4;
  const int W8 = (H + 7) / 8, rb = PACKED ? W8 : H;
  for (int e = threadIdx.x; e < tile_floats(nh, nk, diag); e += THREADS) stor[e] = 0.f;
  for (int e = threadIdx.x; e < NW * T4; e += THREADS) racc[e] = 0.f;
  for (int p = threadIdx.x; p < PAIRS; p += THREADS) {
    int b = 0;
    while ((b + 1) * (b + 2) / 2 <= p) ++b;
    ptab[p] = uint16_t(p - b * (b + 1) / 2 | b << 8);
  }
  // where row hh (of the tile) starts, at the column of its sub-block
  auto row_at = [&](int hh) {
    const int q = hh >> 2;
    return diag ? 4 * q * ((nh + 3) & ~3) - 8 * q * (q - 1) + (hh & 3) * (((nh + 3) & ~3) - 4 * q)
                : hh * nk4;
  };
  // the storage offset of pair (h, k) of this tile
  auto sidx = [&](int h, int k) {
    const int hh = h - h0;
    return row_at(hh) + (k - k0) - (diag ? (hh & ~3) : 0);
  };

  const int G = gridDim.x;
  const int U = unit_dps(S, RB);
  const int unit_rows = U * S;
  const long long n_units = (B + U - 1) / U;
  const bool pieces = unit_rows > RB;  // then U = 1 and a datapoint's rows come in pieces
  const int kper = pieces ? 1 : RB / unit_rows;
  const int n_pieces = pieces ? (S + RB - 1) / RB : 1;

  // The block's t-th sub-batch: nseg units u0, u0 + G, ... of seg_rows rows
  // each (the last may have fewer datapoints), or a piece: rows s0 .. s0 +
  // seg_rows - 1 of the single datapoint u0.  nrows = 0 past the end.
  struct Batch {
    long long u0;
    int nseg, s0, seg_rows, rows_last, dps_last, nrows;
  };
  auto batch_at = [&](int t) {
    Batch b;
    b.u0 = blockIdx.x + (long long)(pieces ? t / n_pieces : t * kper) * G;
    b.nrows = 0;
    if (b.u0 >= n_units) return b;
    b.s0 = pieces ? (t % n_pieces) * RB : 0;
    b.nseg = pieces ? 1 : int(min((long long)kper, (n_units - 1 - b.u0) / G + 1));
    b.seg_rows = pieces ? min(RB, S - b.s0) : unit_rows;
    const long long u_last = b.u0 + (long long)(b.nseg - 1) * G;
    b.dps_last = pieces ? 1 : int(min((long long)U, B - u_last * U));
    b.rows_last = pieces ? b.seg_rows : b.dps_last * S;
    b.nrows = (b.nseg - 1) * b.seg_rows + b.rows_last;
    return b;
  };
  auto seg_row0 = [&](const Batch& b, int seg) {
    return (b.u0 + (long long)seg * G) * unit_rows + b.s0;
  };
  // the datapoint (rho's slot) of row r of sub-batch b
  auto dp_of = [&](const Batch& b, int r) {
    const int seg = r / b.seg_rows;
    return pieces ? 0 : seg * U + (r - seg * b.seg_rows) / S;
  };
  auto load_chunk = [&](const Batch& b, int seg, int p, int bytes) {
    const uint8_t* base = ss + size_t(seg_row0(b, seg)) * rb;
    return p < bytes ? load16(base + p, bytes - p, reinterpret_cast<uintptr_t>(base) % 16 == 0)
                     : make_uint4(0u, 0u, 0u, 0u);
  };

  unsigned n_sparse = 0, n_dense = 0;  // rows with rs != 0 of steps 2 and 3 (tile 0 counts)
  for (int t = 0;; ++t) {
    const Batch b = batch_at(t);
    const int nrows = b.nrows;
    if (nrows == 0) break;
    // 1. masks, then a thread a row: n, the list, rs, sabs
    for (int e = threadIdx.x; e < nrows * MS; e += THREADS) masks[e] = 0u;
    const int me = threadIdx.x;  // this thread's row
    const long long my_row = me < nrows ? seg_row0(b, me / b.seg_rows) + me % b.seg_rows : 0;
    const float my_rs = me < nrows ? rs[my_row] : 0.f;
    __syncthreads();
    {  // this thread's chunks, PF loads in flight at once
      const int cps = (b.seg_rows * rb + 15) / 16;  // chunks a segment
      const int n_chunks = b.nseg * cps;
      int seg = threadIdx.x / cps, cs = threadIdx.x - seg * cps;
      for (int c1 = threadIdx.x; c1 < n_chunks; c1 += PF * THREADS) {
        uint4 v[PF];
        int sg[PF], p0[PF];
#pragma unroll
        for (int q = 0; q < PF; ++q) {
          sg[q] = seg;
          p0[q] = 16 * cs;
          v[q] = c1 + q * THREADS < n_chunks
                     ? load_chunk(b, seg, p0[q], (seg == b.nseg - 1 ? b.rows_last : b.seg_rows) * rb)
                     : make_uint4(0u, 0u, 0u, 0u);
          for (cs += THREADS; cs >= cps; cs -= cps) ++seg;
        }
#pragma unroll
        for (int q = 0; q < PF; ++q)
          if (c1 + q * THREADS < n_chunks)
            or_chunk<PACKED>(masks + sg[q] * b.seg_rows * MS, MS, v[q], p0[q], H, W8);
      }
    }
    __syncthreads();
    if (me < nrows) {
      const uint32_t* m = masks + me * MS;
      uint16_t* lr = list + me * LS;
      int n = 0, pos = 0;
      for (int j = 0; j < MW; ++j) {
        uint32_t w = m[j];
        n += __popc(w);
        for (; w != 0u && pos < LMAX; w &= w - 1u) lr[pos++] = uint16_t(32 * j + __ffs(w) - 1);
      }
      rn[me] = n;
      rrs[me] = my_rs;
      if (blockIdx.y == 0) sabs[my_row] = float(n);
    }
    __syncthreads();

    // 2. the sparse rows' pairs and rho
    // 2a. a thread a row: its items (on diagonal tiles its rho entries
    // first, then its pairs, by k, then h) and where its latents of the two
    // ranges start (all ones: not a sparse row with rs != 0), the rows
    // counted; then, by block scans, the rows that have items, in order,
    // with their first item, where each 32 items start, and the dense rows
    int items = 0, dense = 0;
    if (me < nrows) rpos[me] = ~0u;
    for (int e = threadIdx.x; e < seen_words(T, P > 1); e += THREADS) seen[e] = 0u;
    for (int e = threadIdx.x; e < T4 * (P > 1 ? 2 : 1); e += THREADS) occh[e] = 0u;
    int* n_claims = wsum + 3 * NW;
    if (threadIdx.x == 0) *n_claims = 0;
    if (me < nrows && my_rs != 0.f) {
      const int n = rn[me];
      if (n <= LMAX) {
        int ia = 0, mh = n, ja = 0, mk = n;
        if (P > 1) {
          const uint16_t* lr = list + me * LS;
          int h_lo = 0, h_hi = 0, k_lo = 0, k_hi = 0;
          for (int c = 0; c < n; ++c) {
            const int v = lr[c];
            h_lo += v < h0;
            h_hi += v < h0 + nh;
            k_lo += v < k0;
            k_hi += v < k0 + nk;
          }
          ia = h_lo, mh = h_hi - h_lo, ja = k_lo, mk = k_hi - k_lo;
        }
        items = diag ? mh + mh * (mh + 1) / 2 : mh * mk;
        rpos[me] = uint32_t(ia) | uint32_t(mh) << 8 | uint32_t(ja) << 16 | uint32_t(mk) << 24;
        n_sparse += blockIdx.y == 0;
      } else {
        dense = 1;
        n_dense += blockIdx.y == 0;
      }
    }
    const int has = items > 0;
    int c_items = items, c_has = has, c_dense = dense;  // inclusive, within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, c_items, o), v = __shfl_up_sync(FULL, c_has, o),
                w = __shfl_up_sync(FULL, c_dense, o);
      if (lane >= o) c_items += u, c_has += v, c_dense += w;
    }
    if (lane == 31) wsum[warp] = c_items, wsum[NW + warp] = c_has, wsum[2 * NW + warp] = c_dense;
    __syncthreads();
    if (warp == 0) {
      int v[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) v[q] = lane < NW ? wsum[q * NW + lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const int u = __shfl_up_sync(FULL, v[q], o);
          if (lane >= o) v[q] += u;
        }
      }
      if (lane < NW)
#pragma unroll
        for (int q = 0; q < 3; ++q) wsum[q * NW + lane] = v[q];  // inclusive, over the warps
    }
    __syncthreads();
    const int ne = wsum[2 * NW - 1];  // the rows that have items
    if (has) {
      const int j = c_has - 1 + (warp > 0 ? wsum[NW + warp - 1] : 0);
      const int e0 = c_items - items + (warp > 0 ? wsum[warp - 1] : 0);
      eoff[j] = e0;
      erec[j] = make_uint4(uint32_t(e0), uint32_t(me), rpos[me], 0u);
      for (int c = (e0 + 31) >> 5; 32 * c < e0 + items; ++c) ctab[c] = uint8_t(j);
    }
    if (dense) dlist[c_dense - 1 + (warp > 0 ? wsum[2 * NW + warp - 1] : 0)] = me;
    if (threadIdx.x == 0) {
      eoff[ne] = wsum[NW - 1];
      dlist[RB] = wsum[3 * NW - 1];
    }
    // 2b. the column masks: warp tasks (group, 32 latents of a range), a
    // lane a row's bits of the 32 latents, transposed by shuffles so that a
    // lane holds a latent's bits of the 32 rows
    auto columns = [&](uint32_t* col, uint32_t* occ, int first, int cnt) {
      const int nc = (cnt + 31) / 32;
      for (int t = warp; t < NG * nc; t += NW) {
        const int g = t / nc, c = t - g * nc, r = 32 * g + lane, l0 = first + 32 * c;
        uint32_t w = 0u;
        if (r < nrows && rpos[r] != ~0u) {
          const uint32_t* m = masks + r * MS;
          const int q = l0 >> 5, sh = l0 & 31;
          uint64_t two = m[q];
          if (sh != 0 && q + 1 < MW) two |= uint64_t(m[q + 1]) << 32;
          w = uint32_t(two >> sh);
          if (cnt - 32 * c < 32) w &= (1u << (cnt - 32 * c)) - 1u;
        }
#pragma unroll
        for (int sw = 16; sw > 0; sw >>= 1) {  // swap the off-diagonal sw x sw blocks
          const uint32_t lo = sw == 16 ? 0x0000ffffu : sw == 8 ? 0x00ff00ffu : sw == 4 ? 0x0f0f0f0fu
                              : sw == 2 ? 0x33333333u : 0x55555555u;
          const uint32_t o = __shfl_xor_sync(FULL, w, sw);
          w = (lane & sw) ? ((o >> sw) & lo) | (w & ~lo) : (w & lo) | ((o << sw) & ~lo);
        }
        if (32 * c + lane < cnt) {
          col[g * T4 + 32 * c + lane] = w;
          if (w != 0u) atomicOr(&occ[32 * c + lane], 1u << g);
        }
      }
    };
    columns(colh, occh, h0, nh);
    if (!diag) columns(colk, occk, k0, nk);
    __syncthreads();

    // 2c. in rounds of ROUND_ITEMS items, the items 32 at a time a warp, a
    // lane an item: its row r and latents h <= k (h = k for rho).  The rows
    // that hold its entry (rho: of its datapoint) come from the column
    // masks.  Where an earlier row of its group holds the entry, the item
    // stops; where its row alone holds it, it adds its rs; else it claims
    // the entry in the bitmap, and the first claim lists it.
    const int n_items = eoff[ne];
    auto holders = [&](int q, int h, int k, bool rho, int d0, int d1) {
      const uint32_t w = colh[q * T4 + h - h0];
      if (!rho) return w & colk[q * T4 + k - k0];
      const int a = max(d0 - 32 * q, 0), z = min(d1 - 32 * q, 32);
      return a >= z ? 0u : w & (z == 32 ? FULL : (1u << z) - 1u) & ~((1u << a) - 1u);
    };
    for (int base = 0, first_claim = 0; base < n_items; base += ROUND_ITEMS) {
      const int end_items = min(n_items, base + ROUND_ITEMS);
      for (int c0 = base + 32 * warp; c0 < end_items; c0 += THREADS) {
        int j = ctab[c0 >> 5];  // the row of item c0, then each lane's among those that start here
        const int jn = j + 1 + lane;
        const int at = jn < ne ? eoff[jn] - c0 : 32;
        const uint32_t starts = __reduce_or_sync(FULL, at < 32 ? 1u << at : 0u);
        const int i = c0 + lane;
        if (i >= end_items) continue;
        j += __popc(starts & ((2u << lane) - 1u));
        const uint4 rec = erec[j];
        const int r = int(rec.y), t = i - int(rec.x);
        const uint32_t p = rec.z;
        const int ia = p & 0xff, mh = p >> 8 & 0xff, ja = p >> 16 & 0xff, mk = p >> 24;
        const uint16_t* lr = list + r * LS;
        const bool rho = diag && t < mh;
        int h, k;
        if (rho) {
          h = k = lr[ia + t];
        } else if (diag) {
          const int ab = ptab[t - mh];
          h = lr[ia + (ab & 0xff)];
          k = lr[ia + (ab >> 8)];
        } else {
          const int a = t / mk;
          h = lr[ia + a];
          k = lr[ja + t - a * mk];
        }
        const int dp = rho && !pieces ? r / S : 0;
        const int d0 = rho && !pieces ? dp * S : 0, d1 = rho && !pieces ? d0 + S : nrows;
        const int g = r >> 5;
        const uint32_t x = holders(g, h, k, rho, d0, d1);
        if (x & ((1u << (r & 31)) - 1u)) continue;  // an earlier row of its group holds the entry
        const int e = rho ? tile_floats(nh, nk, diag) + dp * T4 + h - h0 : sidx(h, k);
        const uint32_t groups = occh[h - h0] & (rho ? (2u << ((d1 - 1) >> 5)) - (1u << (d0 >> 5))
                                                    : occk[k - k0]);
        if (groups == 1u << g && (x & (x - 1u)) == 0u) {  // the row alone holds it: its rs
          if (rho) racc[dp * T4 + h - h0] += rrs[r];
          else stor[e] += rrs[r];
          continue;
        }
        const uint32_t bit = 1u << ((e >> SEEN_SHIFT) & 31);
        const int word = (e >> (SEEN_SHIFT + 5) << SEEN_SHIFT) + (e & (SEEN_SPREAD - 1));
        if (atomicOr(&seen[word], bit) & bit) continue;  // claimed by another row's item
        claims[atomicAdd(n_claims, 1) - first_claim] = uint32_t(h - h0) | uint32_t(k - k0) << 9 |
                                                       uint32_t(dp) << 18 | groups << 22 |
                                                       uint32_t(rho) << 31;
      }
      __syncthreads();
      // the round's claimed entries, a thread each: the rs of all their
      // holders, group by group in row order into four partials (up to four
      // rows of a group: the i-th into partial i; more: row i of the group
      // into partial i % 4, read four at a time), then the four in a fixed
      // order, added once to the tile or to rho
      const int last_claim = *n_claims;
      for (int c = first_claim + threadIdx.x; c < last_claim; c += THREADS) {
        const uint32_t cl = claims[c - first_claim];
        const bool rho = cl >> 31;
        const int h = h0 + int(cl & 0x1ff), k = k0 + int(cl >> 9 & 0x1ff), dp = int(cl >> 18 & 15);
        const int d0 = rho && !pieces ? dp * S : 0, d1 = rho && !pieces ? d0 + S : nrows;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (uint32_t groups = cl >> 22 & 0xffu; groups != 0u; groups &= groups - 1u) {
          const int q = __ffs(groups) - 1;  // a group that may hold the entry
          uint32_t m = holders(q, h, k, rho, d0, d1);
          if (m == 0u) continue;
          if (__popc(m) <= 4) {  // a few rows: by rank, holder i into partial i
            int b[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              b[u] = m != 0u ? __ffs(m) - 1 : -1;
              m &= m - 1u;
            }
            a0 += rrs[32 * q + b[0]];
            a1 += b[1] >= 0 ? rrs[32 * q + b[1]] : 0.f;
            a2 += b[2] >= 0 ? rrs[32 * q + b[2]] : 0.f;
            a3 += b[3] >= 0 ? rrs[32 * q + b[3]] : 0.f;
            continue;
          }
          const float4* v = reinterpret_cast<const float4*>(rrs + 32 * q);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const uint32_t nib = m >> (4 * u) & 15u;
            if (nib != 0u) {
              const float4 f = v[u];
              a0 += nib & 1u ? f.x : 0.f;
              a1 += nib & 2u ? f.y : 0.f;
              a2 += nib & 4u ? f.z : 0.f;
              a3 += nib & 8u ? f.w : 0.f;
            }
          }
        }
        const float sum = (a0 + a1) + (a2 + a3);
        if (rho) racc[dp * T4 + h - h0] += sum;
        else stor[sidx(h, k)] += sum;
      }
      first_claim = last_claim;
      __syncthreads();
    }

    // 3. the dense rows, R at a time, into the tile's 4 x 4 sub-blocks
    const int nd = dlist[RB];
    const int nqh = (nh + 3) / 4, nqk = nk4 / 4;
    const int nsb = diag ? nqh * (nqh + 1) / 2 : nqh * nqk;
    for (int q0 = 0; q0 < nd; q0 += R) {
      const int rc = min(R, nd - q0);
      for (int e = threadIdx.x; e < rc * T4; e += THREADS) {
        const int r = e / T4, c = e - r * T4;
        const uint32_t* m = masks + dlist[q0 + r] * MS;
        const int h = h0 + c, k = k0 + c;
        bk_s[e] = (c < nk && ((m[k >> 5] >> (k & 31)) & 1u)) ? 1.f : 0.f;
        if (!diag) bh_s[e] = (c < nh && ((m[h >> 5] >> (h & 31)) & 1u)) ? 1.f : 0.f;
      }
      if (threadIdx.x < rc) {
        srs[threadIdx.x] = rrs[dlist[q0 + threadIdx.x]];
        sdp[threadIdx.x] = dp_of(b, dlist[q0 + threadIdx.x]);
      }
      __syncthreads();
      if (diag && threadIdx.x < nh)  // rho: a thread a latent, the rows in order
        for (int r = 0; r < rc; ++r)
          if (bk_s[r * T4 + threadIdx.x] != 0.f) racc[sdp[r] * T4 + threadIdx.x] += srs[r];
      for (int sb = threadIdx.x; sb < nsb; sb += THREADS) {
        int i, j;
        if (diag) {
          tri_ij(sb, nqh, i, j);
        } else {
          i = sb / nqk;
          j = sb - i * nqk;
        }
        // the sub-block's four rows (padding and the entries below the
        // diagonal are summed too, and never read)
        float4* row[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          row[x] = reinterpret_cast<float4*>(stor + row_at(4 * i + x) + 4 * (diag ? j - i : j));
        float acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 w = *row[x];
          acc[x][0] = w.x;
          acc[x][1] = w.y;
          acc[x][2] = w.z;
          acc[x][3] = w.w;
        }
#pragma unroll 4
        for (int r = 0; r < rc; ++r) {
          const float v = srs[r];
          const float4 a = *reinterpret_cast<const float4*>(bh_s + r * T4 + 4 * i);
          const float4 k4 = *reinterpret_cast<const float4*>(bk_s + r * T4 + 4 * j);
          const float av[4] = {v * a.x, v * a.y, v * a.z, v * a.w};
          const float bv[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int x = 0; x < 4; ++x)
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) *row[x] = make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
      }
      __syncthreads();
    }
    if (diag && (!pieces || b.s0 + b.seg_rows == S)) {  // rho of the sub-batch's datapoints
      const int ndp = (b.nseg - 1) * U + b.dps_last;
      for (int e = threadIdx.x; e < ndp * nh; e += THREADS) {
        const int dp = e / nh, hh = e - dp * nh, sd = dp / U;
        rho[((b.u0 + (long long)sd * G) * U + dp - sd * U) * H + h0 + hh] = racc[dp * T4 + hh];
        racc[dp * T4 + hh] = 0.f;
      }
    }
  }
  __syncthreads();
  if (rows_out != nullptr && blockIdx.y == 0) {
    for (int o = 16; o > 0; o >>= 1) {
      n_sparse += __shfl_xor_sync(FULL, n_sparse, o);
      n_dense += __shfl_xor_sync(FULL, n_dense, o);
    }
    if (lane == 0) {
      atomicAdd(rows_out, (unsigned long long)n_sparse);
      atomicAdd(rows_out + 1, (unsigned long long)n_dense);
    }
  }

  // the tile into this chunk's partial (Wq's packed upper triangle)
  float* out = partial + size_t(blockIdx.x) * (size_t(H) * (H + 1) / 2);
  for (int hh = warp; hh < nh; hh += NW) {
    const int h = h0 + hh, kb = diag ? h : k0, cnt = diag ? nh - hh : nk;
    const size_t e0 = size_t(h) * (2 * size_t(H) - h + 1) / 2 + (kb - h);
    const float* src = stor + sidx(h, kb);
    for (int c = lane; c < cnt; c += 32) out[e0 + c] = src[c];
  }
}

__global__ void __launch_bounds__(1024)
bsc_suffstat_reduce(const float* __restrict__ partial, float* __restrict__ wq, int G, int H) {
  __shared__ double part[32][33];
  const long long tri = (long long)H * (H + 1) / 2;
  const long long e = blockIdx.x * 32LL + threadIdx.x;
  double v = 0.0;
  if (e < tri)
    for (int p = threadIdx.y; p < G; p += 32) v += double(partial[p * tri + e]);
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y != 0 || e >= tri) return;
  double t = 0.0;
  for (int q = 0; q < 32; ++q) t += part[q][threadIdx.x];
  int h, k;
  tri_ij(e, H, h, k);
  const float f = float(t);
  wq[size_t(h) * H + k] = f;
  wq[size_t(k) * H + h] = f;
}

// Latent ranges for width H within smem bytes of shared memory: P ranges
// of T latents; P = 0 if even the narrowest ranges do not fit.
struct Plan {
  int P, T;
  size_t smem;
};

Plan make_plan(int H, int S, size_t smem) {
  Plan p;
  const int RB = rows_per_batch(H, S);
  for (int parts = 1;; ++parts) {
    p.T = parts == 1 ? H : (((H + parts - 1) / parts + 3) & ~3);
    p.P = (H + p.T - 1) / p.T;
    p.smem = make_layout(H, p.T, p.P > 1, RB).total;
    if (p.smem <= smem && p.T <= 32 * NW) return p;  // a warp's latents fit its lanes
    if (p.T <= 4) {
      p.P = 0;
      return p;
    }
  }
}

// The card's SM count and the kernels' shared memory limit, once a device.
struct Card {
  int n_sm;
  size_t smem;
};

int card(Card* out) {
  static std::atomic<uint64_t> ready{0};
  static Card cards[64];
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
    e = cudaFuncSetAttribute(bsc_suffstat_partial<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(bsc_suffstat_partial<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return int(e);
  *out = Card{n_sm, size_t(smem)};
  if (dev < 64) {
    cards[dev] = *out;
    ready.fetch_or(uint64_t(1) << dev);
  }
  return 0;
}

template <bool PACKED>
int launch(const void* ss, const void* rs, void* rho, void* sabs, void* wq, void* partial,
           void* rows, int B, int S, int H, int G, void* stream) {
  Card c;
  const int e = card(&c);
  if (e != 0) return e;
  const Plan p = make_plan(H, S, c.smem);
  if (p.P == 0 || G < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bsc_suffstat_partial<PACKED><<<dim3(G, p.P * (p.P + 1) / 2), THREADS, p.smem, st>>>(
      static_cast<const uint8_t*>(ss), static_cast<const float*>(rs), static_cast<float*>(rho),
      static_cast<float*>(sabs), static_cast<float*>(partial),
      static_cast<unsigned long long*>(rows), B, S, H, p.P, p.T);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const long long tri = (long long)H * (H + 1) / 2;
  bsc_suffstat_reduce<<<unsigned((tri + 31) / 32), dim3(32, 32), 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(wq), G, H);
  return int(cudaGetLastError());
}

}  // namespace

// The number of chunks G for (B, S, H) on the current device, the first
// dimension of the partial the launch takes ([G, H(H+1)/2] f32); the same
// for both modes, so that they sum in the same order.  Negative: a CUDA
// error, or H too wide for shared memory.
extern "C" int evo_bsc_suffstat_chunks(int B, int S, int H) {
  Card c;
  const int e = card(&c);
  if (e != 0) return -e;
  const Plan p = make_plan(H, S, c.smem);
  if (p.P == 0) return -int(cudaErrorInvalidValue);
  int per_sm = 0;
  const cudaError_t oe = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, bsc_suffstat_partial<false>, THREADS, p.smem);
  if (oe != cudaSuccess) return -int(oe);
  const long long tiles = (long long)p.P * (p.P + 1) / 2;
  const long long fill = (c.n_sm * (long long)std::max(per_sm, 1) + tiles - 1) / tiles;
  const long long tall = ((long long)B * S + ROWS_PER_CHUNK - 1) / ROWS_PER_CHUNK;
  const int U = unit_dps(S, rows_per_batch(H, S));
  const long long n_units = (B + U - 1) / U;
  const long long cap = std::max(1LL, PARTIAL_FLOATS / ((long long)H * (H + 1) / 2));
  return int(std::max(1LL, std::min({std::max(fill, tall), n_units, cap})));
}

// ss: int8 0/1 [B, S, H]; partial: [G, H(H+1)/2] f32, G from evo_bsc_suffstat_chunks;
// rows: null, or two uint64 counters that gain the rows with rs != 0 summed
// sparsely (n <= 32) and densely
extern "C" int evo_bsc_suffstat(const void* ss, const void* rs, void* rho, void* sabs, void* wq,
                                void* partial, void* rows, int B, int S, int H, int G,
                                void* stream) {
  return launch<false>(ss, rs, rho, sabs, wq, partial, rows, B, S, H, G, stream);
}

// ss: lane-major packed uint8 [B, S, ceil(H/8)]
extern "C" int evo_bsc_suffstat_packed(const void* ss, const void* rs, void* rho, void* sabs,
                                       void* wq, void* partial, void* rows, int B, int S, int H,
                                       int G, void* stream) {
  return launch<true>(ss, rs, rho, sabs, wq, partial, rows, B, S, H, G, stream);
}
