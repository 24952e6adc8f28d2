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
//  2. Sparse rows (n <= 32) by scatter.  Warp w owns the latents h with
//     h % 16 = w: their Wq rows and their rho.  It gathers the rows with a
//     latent it owns, and lane j takes its latent h = w + 16 j: it walks
//     those rows that have h in order and adds each row's rs to rho[., h]
//     and to Wq[h, k] for the row's latents k >= h.  No two threads touch
//     one entry, so there is nothing to order between them, and each
//     entry's adds follow the rows' order.
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
constexpr int NW = THREADS / 32;  // warps; warp w owns the Wq rows h with h % NW == w
constexpr int RB_MAX = 256;       // rows of a sub-batch
static_assert(RB_MAX <= THREADS, "a thread a row of a sub-batch");
constexpr int PF = 8;             // 16-byte state loads a thread has in flight
constexpr int SUB_BYTES = PF * THREADS * 16;  // int8 bytes of a sub-batch at most: one round
constexpr int UNIT_ROWS = 32;     // a unit holds whole datapoints, this many rows where S allows
constexpr int LMAX = 32;          // latents a listed (sparse) row; denser rows are staged
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

// Byte offsets of the block's shared memory for width H, latent ranges of
// T (the whole H when P = 1) and sub-batches of RB rows.
struct Layout {
  int T4, MW, MS;
  size_t stor, bk, bh, srs, sdp, masks, rn, rflag, rrs, dlist, racc, wrows, list, total;
};

__host__ __device__ inline Layout make_layout(int H, int T, bool tiled, int RB) {
  Layout L;
  L.T4 = (T + 3) & ~3;
  L.MW = (H + 31) / 32;
  L.MS = L.MW | 1;  // odd row stride: a thread a row reads without bank conflicts
  size_t o = 0;
  L.stor = o;  // the tile
  o += sizeof(float) * (tiled ? tile_floats(T, T, false) : tile_floats(T, T, true));
  L.bk = o;  // s_k of the staged dense rows (and s_h on the diagonal tiles)
  o += sizeof(float) * R * L.T4;
  L.bh = o;  // s_h of the staged dense rows on the other tiles
  o += tiled ? sizeof(float) * R * L.T4 : 0;
  L.srs = o;  // their rs
  o += sizeof(float) * R;
  L.sdp = o;  // their datapoints in the sub-batch
  o += sizeof(int) * R;
  L.masks = o;
  o += sizeof(uint32_t) * size_t(RB) * L.MS;
  L.rn = o;  // n per row
  o += sizeof(int) * RB;
  L.rflag = o;  // per row: bit w <=> a latent of warp w's Wq rows, sparse rows with rs != 0
  o += sizeof(uint32_t) * RB;
  L.rrs = o;  // rs per row
  o += sizeof(float) * RB;
  L.dlist = o;  // the dense rows, ascending, then their count
  o += sizeof(int) * (RB + 1);
  L.racc = o;  // rho of the datapoints the warps sum, one slot a datapoint
  o += sizeof(float) * NW * L.T4;
  L.wrows = o;  // each warp's rows with a latent it owns
  o += sizeof(uint16_t) * NW * RB;
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
                     float* __restrict__ partial, int B, int S, int H, int P, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int RB = rows_per_batch(H, S);
  const Layout L = make_layout(H, T, P > 1, RB);
  float* stor = reinterpret_cast<float*>(smem + L.stor);
  float* bk_s = reinterpret_cast<float*>(smem + L.bk);
  float* srs = reinterpret_cast<float*>(smem + L.srs);
  int* sdp = reinterpret_cast<int*>(smem + L.sdp);
  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + L.masks);
  int* rn = reinterpret_cast<int*>(smem + L.rn);
  uint32_t* rflag = reinterpret_cast<uint32_t*>(smem + L.rflag);
  float* rrs = reinterpret_cast<float*>(smem + L.rrs);
  int* dlist = reinterpret_cast<int*>(smem + L.dlist);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + L.list);
  const int MW = L.MW, MS = L.MS, T4 = L.T4;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;  // the lanes below this one
  int I, J;
  tri_ij(blockIdx.y, P, I, J);
  const int h0 = I * T, nh = min(T, H - h0), k0 = J * T, nk = min(T, H - k0);
  const bool diag = I == J;
  const int nk4 = (nk + 3) & ~3;
  float* bh_s = diag ? bk_s : reinterpret_cast<float*>(smem + L.bh);
  float* racc = reinterpret_cast<float*>(smem + L.racc);
  uint16_t* wrows = reinterpret_cast<uint16_t*>(smem + L.wrows) + warp * RB;
  // this warp's latents of the tile's h range: hb, hb + 16, ... (nh <= 512:
  // at most 32), lane j on latent h = hb + 16 j
  const int hb = h0 + ((warp - h0) % NW + NW) % NW;
  const int nown = hb < h0 + nh ? (h0 + nh - 1 - hb) / NW + 1 : 0;
  const int hl = hb + NW * lane;
  const int W8 = (H + 7) / 8, rb = PACKED ? W8 : H;
  for (int e = threadIdx.x; e < tile_floats(nh, nk, diag); e += THREADS) stor[e] = 0.f;
  for (int e = threadIdx.x; e < NW * T4; e += THREADS) racc[e] = 0.f;
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

  for (int t = 0;; ++t) {
    const Batch b = batch_at(t);
    const int nrows = b.nrows;
    if (nrows == 0) break;
    // 1. masks, then a thread a row: n, the list, rs, sabs, the warps' flags
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
      uint32_t orw = 0u;
      for (int j = 0; j < MW; ++j) {
        uint32_t w = m[j];
        n += __popc(w);
        orw |= w;
        for (; w != 0u && pos < LMAX; w &= w - 1u) lr[pos++] = uint16_t(32 * j + __ffs(w) - 1);
      }
      rn[me] = n;
      rrs[me] = my_rs;
      rflag[me] = n <= LMAX && my_rs != 0.f ? (orw | orw >> 16) & 0xffffu : 0u;
      if (blockIdx.y == 0) sabs[my_row] = float(n);
    }
    __syncthreads();

    // 2. the dense rows' list (warp 0); the sparse rows' pairs and rho
    if (warp == 0) {
      int nd = 0;
      for (int g = 0; g < nrows; g += 32) {
        const int r = g + lane;
        const bool d = r < nrows && rn[r] > LMAX && rrs[r] != 0.f;
        const uint32_t bal = __ballot_sync(FULL, d);
        if (d) dlist[nd + __popc(bal & below)] = r;
        nd += __popc(bal);
      }
      if (lane == 0) dlist[RB] = nd;
    }
    int nw = 0;  // this warp's rows, in order
    for (int g = 0; g < nrows; g += 32) {
      const int r = g + lane;
      const bool mine = r < nrows && ((rflag[r] >> warp) & 1u);
      const uint32_t bal = __ballot_sync(FULL, mine);
      if (mine) wrows[nw + __popc(bal & below)] = uint16_t(r);
      nw += __popc(bal);
    }
    __syncwarp();
    for (int i0 = 0; i0 < nw; i0 += 32) {
      // lane p: row wrows[i0 + p]; bit j of `has`: the row has latent hb + 16 j
      uint32_t has = 0u;
      if (i0 + lane < nw) {
        const uint32_t* m = masks + wrows[i0 + lane] * MS;
        for (int j = 0; j < nown; ++j) {
          const int hj = hb + NW * j;
          has |= ((m[hj >> 5] >> (hj & 31)) & 1u) << j;
        }
      }
      uint32_t mine = 0u;  // lane j: the rows with latent h = hb + 16 j, in order
      for (int j = 0; j < nown; ++j) {
        const uint32_t bal = __ballot_sync(FULL, (has >> j) & 1u);
        if (lane == j) mine = bal;
      }
      for (; mine != 0u; mine &= mine - 1u) {  // rho[., h], then Wq[h, k], k >= h
        const int r = wrows[i0 + __ffs(mine) - 1];
        const int n = rn[r];
        const float v = rrs[r];
        const uint16_t* lr = list + r * LS;
        if (diag) racc[dp_of(b, r) * T4 + hl - h0] += v;
        for (int c = 0; c < n; ++c) {
          const int k = lr[c];
          if (k >= hl && k >= k0 && k < k0 + nk) stor[sidx(hl, k)] += v;
        }
      }
      __syncwarp();
    }
    __syncthreads();

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
int launch(const void* ss, const void* rs, void* rho, void* sabs, void* wq, void* partial, int B,
           int S, int H, int G, void* stream) {
  Card c;
  const int e = card(&c);
  if (e != 0) return e;
  const Plan p = make_plan(H, S, c.smem);
  if (p.P == 0 || G < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  bsc_suffstat_partial<PACKED><<<dim3(G, p.P * (p.P + 1) / 2), THREADS, p.smem, st>>>(
      static_cast<const uint8_t*>(ss), static_cast<const float*>(rs), static_cast<float*>(rho),
      static_cast<float*>(sabs), static_cast<float*>(partial), B, S, H, p.P, p.T);
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

// ss: int8 0/1 [B, S, H]; partial: [G, H(H+1)/2] f32, G from evo_bsc_suffstat_chunks
extern "C" int evo_bsc_suffstat(const void* ss, const void* rs, void* rho, void* sabs, void* wq,
                                void* partial, int B, int S, int H, int G, void* stream) {
  return launch<false>(ss, rs, rho, sabs, wq, partial, B, S, H, G, stream);
}

// ss: lane-major packed uint8 [B, S, ceil(H/8)]
extern "C" int evo_bsc_suffstat_packed(const void* ss, const void* rs, void* rho, void* sabs,
                                       void* wq, void* partial, int B, int S, int H, int G,
                                       void* stream) {
  return launch<true>(ss, rs, rho, sabs, wq, partial, B, S, H, G, stream);
}
