// BSC log-pseudo-joint of binary candidate states, with optional dedup keys.
//
// Replaces: evo_tpu/ops/pallas_lpj.py:bsc_lpj_pallas (body _make_kernel),
// int8 states and lane-major packed uint8 states (EAConfig.packed_states),
// both emit_keys modes.  For every state row (b, k):
//
//   lpj[b,k] = pre1 * (y2[b] - 2 s.Wty[b] + s^T G s) + pil_bar * |s|
//
// and, in keys mode, the dedup keys of ops.bitpack.dedup_keys: the exact
// packed words for H <= 64, the 2-word halfword hash above.
//
// What bounds it on an H100: reading the states once (67 MB as int8 at
// B*K = 262,144 states, H = 256: 0.02 ms at 3.35 TB/s; packed, 8.4 MB).
// For a binary s, s^T G s is the sum of G[i, j] over the ordered pairs of
// active latents, s.Wty the sum of Wty over them and |s| their count, so
// at the EA's sparsity (about 2 bits on) the arithmetic is a few gathers a
// row, far below the byte time.  Every sum is plain f32 (no TF32, no tensor
// cores) in a fixed order that depends on the row alone: the same from run
// to run, whichever rows share a warp, and with no float atomics.  G is
// not assumed symmetric: every ordered pair is summed.
//
// Two kernels, launched one after the other on the caller's stream.
//
// bsc_lpj_kernel: one warp takes a group of 32 consecutive state rows
// (warp w of block x takes group w * gridDim.x + x, so neighbouring groups
// run on different SMs).
//  1. Mask.  The warp reads the group's bytes once, 16 bytes a lane with
//     neighbouring lanes on neighbouring addresses (a group starts on a
//     32-byte boundary whenever the tensor does), and ORs each nonzero
//     byte's latents into its row's bitmask in shared memory: ceil(H/32)
//     words, bit i of word w for latent 32w + i.  Int8: byte compares, and
//     for H % 16 == 0 one OR of a whole halfword a chunk; packed: latent h
//     is bit h / W8 of byte h % W8, W8 = ceil(H/8), so the set bits of each
//     nonzero byte are walked.  Integer ORs commute, so the mask does not
//     depend on their order, and everything after it is shared: the two
//     modes give bit-identical lpj and keys.
//  2. |s| by popcount, and the keys from the mask words: the words
//     themselves for H <= 64, else the multilinear hash over their 16-bit
//     halves (zero halves add nothing and are skipped).
//  3. A row with n <= SPARSE_MAX latents on is summed by its own lane: its
//     latents go to registers, then for each active i in ascending order
//     the loads of G[i, j] over the active j are issued together and added
//     in ascending j, after Wty[b, i].  A row with n <= WARP_MAX is summed
//     by the warp: lane c takes the row's c-th latent j and adds G[i, j]
//     over the active i, ascending, and a fixed butterfly adds the lanes.
//     G and Wty are read by gathers through the read-only path (G stays in
//     L2).  A denser row gets a marker in its lpj slot (a NaN payload that
//     f32 arithmetic does not make) and is left to the second kernel.
//
// bsc_lpj_dense: the same grid over the same groups.  A block whose groups
// hold marked rows deals them to its warps (at most 32 each), rebuilds
// their masks and sums s.Wty by the mask.  For s^T G s it stages G through
// shared memory in double-buffered tiles of 32 rows x 256 columns, only
// the tiles whose rows some dense row has on.  Lane l takes columns
// 4l..4l+3 and 128+4l..128+4l+3 of a chunk with weight 1 where the row has
// them on, else 0, and for every active i of a tile, ascending, adds the
// weighted columns of G[i, :] to the row's sum: the zero weights add exact
// zeros, so the sum is that of the active pairs, in a fixed order.  One
// conflict-free read of a staged row of G serves up to PAIR_ROWS dense rows.
// A dense row costs n * 256 / 32 multiply-adds a lane per chunk (twice its
// pairs at half density, and never more than H / WARP_MAX times them),
// where the pairs' own gathers from L2 measured slower on dense rows than
// the dense product this kernel replaces.  Blocks without marked rows read
// their lpj words and stop.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_H = 1024;  // ops/bsc_lpj.py:MAX_H
constexpr int WARPS = 8;     // row groups per block
constexpr int THREADS = 32 * WARPS;
constexpr int SPARSE_MAX = 8;       // rows summed by their own lane
constexpr int WARP_MAX = 32;        // rows summed by their warp; denser: bsc_lpj_dense
constexpr int UNROLL = 4;           // 16-byte state loads a lane has in flight
constexpr int SUB = 4;              // dense rows a warp reads at once
constexpr int PAIR_ROWS = 8;        // dense rows that share each staged row of G
constexpr int DENSE_BLOCKS = 2;     // bsc_lpj_dense blocks an SM holds (register budget)
constexpr int CW = 8;               // mask words of a chunk of columns (256)
constexpr int TILE = 32 * 32 * CW;  // G entries a staged tile holds (32 rows x 256, 32 KB)
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t DENSE_MARK = 0x7fbadbadu;  // NaN payload: "summed by bsc_lpj_dense"

__device__ __forceinline__ uint32_t fmix32(uint32_t k) {
  k ^= k >> 16;
  k *= 0x85EBCA6Bu;
  k ^= k >> 13;
  k *= 0xC2B2AE35u;
  k ^= k >> 16;
  return k;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// bit k of the result <=> byte k of w is nonzero (k < 4)
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// the 16 bytes at p, or the `avail` of them that exist and zeros after
__device__ __forceinline__ uint4 load16(const uint8_t* p, int avail, bool aligned) {
  if (aligned && avail >= 16) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int k = 0; k < 16 && k < avail; ++k) w[k >> 2] |= uint32_t(__ldg(p + k)) << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the n-th set bit of m (n < popc(m))
__device__ __forceinline__ int nth_bit(uint32_t m, int n) {
  for (; n > 0; --n) m &= m - 1u;
  return __ffs(m) - 1;
}

// OR the latents of the 16 state bytes v, at byte p0 of consecutive rows
// of H int8 bytes or W8 packed bytes, into the rows' masks (MS words apart)
template <bool PACKED>
__device__ __forceinline__ void or_chunk(uint32_t* mask, int MS, uint4 v, int p0, int H, int W8) {
  const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
  if (!PACKED) {
    uint32_t m = nonzero_bytes(w4[0]) | nonzero_bytes(w4[1]) << 4 | nonzero_bytes(w4[2]) << 8 |
                 nonzero_bytes(w4[3]) << 12;
    if (m == 0u) return;
    if (H % 16 == 0) {  // the chunk is one aligned halfword of one row
      const int r = p0 / H, h = p0 - r * H;
      atomicOr(&mask[r * MS + (h >> 5)], m << (h & 16));
    } else {
      for (; m != 0u; m &= m - 1u) {
        const int p = p0 + __ffs(m) - 1, r = p / H, h = p - r * H;
        atomicOr(&mask[r * MS + (h >> 5)], 1u << (h & 31));
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      for (uint32_t nz = nonzero_bytes(w4[q]); nz != 0u; nz &= nz - 1u) {
        const int k = __ffs(nz) - 1;
        const int p = p0 + 4 * q + k, r = p / W8, j = p - r * W8;
        for (uint32_t byte = (w4[q] >> (8 * k)) & 0xffu; byte != 0u; byte &= byte - 1u) {
          const int h = (__ffs(byte) - 1) * W8 + j;
          if (h < H) atomicOr(&mask[r * MS + (h >> 5)], 1u << (h & 31));
        }
      }
    }
  }
}

template <bool KEYS, bool PACKED>
__global__ void __launch_bounds__(THREADS)
bsc_lpj_kernel(const uint8_t* __restrict__ ss, const float* __restrict__ wty,
               const float* __restrict__ y2, const float* __restrict__ G,
               const float* __restrict__ scal, float* __restrict__ lpj,
               uint32_t* __restrict__ keys, int n_rows, int K, int H, bool aligned) {
  const int MW = (H + 31) / 32;  // mask words a row
  const int MS = MW | 1;         // their stride in shared memory (odd: no bank conflicts)
  const int W8 = (H + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* consts = reinterpret_cast<uint32_t*>(smem);  // [2][2 MW]
  uint32_t* masks = consts + 4 * MW;                     // [WARPS][32][MS]
  uint16_t* lists = reinterpret_cast<uint16_t*>(masks + WARPS * 32 * MS);  // [WARPS][32 MW]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (KEYS && H > 64) {
    const int W16 = 2 * MW;
    for (int v = threadIdx.x; v < W16; v += THREADS) {
      consts[v] = fmix32(uint32_t(v + 1) * GOLDEN) | 1u;
      consts[W16 + v] = fmix32(uint32_t(v + 1 + W16) * GOLDEN) | 1u;
    }
  }
  __syncthreads();
  const int row0 = 32 * (warp * gridDim.x + blockIdx.x);
  if (row0 >= n_rows) return;
  const int nrows = min(32, n_rows - row0);
  uint32_t* mask = masks + warp * 32 * MS;
  uint16_t* list = lists + warp * 32 * MW;

  // 1. the group's masks
  for (int e = lane; e < 32 * MS; e += 32) mask[e] = 0u;
  __syncwarp();
  const int rb = PACKED ? W8 : H;  // bytes a row
  const uint8_t* base = ss + size_t(row0) * rb;
  const int nbytes = nrows * rb;
  for (int p1 = 16 * lane; p1 < nbytes; p1 += 16 * 32 * UNROLL) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int p0 = p1 + 16 * 32 * u;
      v[u] = p0 < nbytes ? load16(base + p0, nbytes - p0, aligned) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) or_chunk<PACKED>(mask, MS, v[u], p1 + 16 * 32 * u, H, W8);
  }
  __syncwarp();

  // 2. |s| and the keys
  const bool valid = lane < nrows;
  const int row = row0 + lane;
  const uint32_t* mrow = mask + lane * MS;
  int n = 0, wlo = MW, whi = -1;
  for (int w = 0; w < MW; ++w) {
    const uint32_t m = mrow[w];
    if (m != 0u) {
      n += __popc(m);
      wlo = min(wlo, w);
      whi = w;
    }
  }
  if (KEYS && valid) {
    if (H <= 64) {  // exact pack_states words
      for (int w = 0; w < MW; ++w) keys[size_t(row) * MW + w] = mrow[w];
    } else {  // ops.bitpack.hash_halfwords over the 2 MW halfwords
      const int W16 = 2 * MW;
      uint32_t k1 = 0u, k2 = 0u;
      for (int w = wlo; w <= whi; ++w) {
        const uint32_t m = mrow[w], lo = m & 0xffffu, hi = m >> 16;
        k1 += lo * consts[2 * w] + hi * consts[2 * w + 1];
        k2 += lo * consts[W16 + 2 * w] + hi * consts[W16 + 2 * w + 1];
      }
      reinterpret_cast<uint2*>(keys)[row] = make_uint2(fmix32(k1), fmix32(k2));
    }
  }

  // 3. the sums: a sparse row by its lane, a denser one by the warp, and a
  // dense one is marked for bsc_lpj_dense
  const float pre1 = scal[0], pil_bar = scal[1];
  if (valid && n > WARP_MAX) lpj[row] = __uint_as_float(DENSE_MARK);
  if (valid && n <= SPARSE_MAX) {
    int js[SPARSE_MAX];  // the active latents, ascending
    int w = min(wlo, MW - 1);
    uint32_t m = mrow[w];
#pragma unroll
    for (int a = 0; a < SPARSE_MAX; ++a) {
      while (m == 0u && w < whi) m = mrow[++w];
      js[a] = m != 0u ? 32 * w + __ffs(m) - 1 : 0;
      m &= m - 1u;
    }
    const int b = row / K;
    const float* wrow = wty + size_t(b) * H;
    float sgs = 0.f, sw = 0.f;
#pragma unroll
    for (int a = 0; a < SPARSE_MAX; ++a) {
      if (a < n) {
        const float* grow = G + size_t(js[a]) * H;
        float g[SPARSE_MAX];
#pragma unroll
        for (int c = 0; c < SPARSE_MAX; ++c) g[c] = c < n ? __ldg(grow + js[c]) : 0.f;
        sw += __ldg(wrow + js[a]);
#pragma unroll
        for (int c = 0; c < SPARSE_MAX; ++c)
          if (c < n) sgs += g[c];
      }
    }
    lpj[row] = pre1 * (y2[b] - 2.f * sw + sgs) + pil_bar * float(n);
  }
  // lane c holds the row's c-th active latent j and sums G[i, j] over its
  // active i, ascending
  for (uint32_t mid = __ballot_sync(FULL, valid && n > SPARSE_MAX && n <= WARP_MAX); mid != 0u;
       mid &= mid - 1u) {
    const int d = __ffs(mid) - 1;
    const uint32_t m = lane < MW ? mask[d * MS + lane] : 0u;
    const int cnt = __popc(m);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    int pos = incl - cnt;
    for (uint32_t mm = m; mm != 0u; mm &= mm - 1u)
      list[pos++] = uint16_t(32 * lane + __ffs(mm) - 1);
    const int nd = __shfl_sync(FULL, incl, 31);
    __syncwarp();
    const int b = (row0 + d) / K;
    float acc = 0.f, accw = 0.f;
    if (lane < nd) {
      const int j = list[lane];
      accw = __ldg(wty + size_t(b) * H + j);
#pragma unroll 4
      for (int a = 0; a < nd; ++a) acc += __ldg(G + size_t(list[a]) * H + j);
    }
    acc = warp_sum(acc);
    accw = warp_sum(accw);
    if (lane == d) lpj[row] = pre1 * (y2[b] - 2.f * accw + acc) + pil_bar * float(n);
    __syncwarp();  // the list is rewritten for the next row
  }
}

// Start copying G[i0 : i0 + 32, 32 cw0 : 32 (cw0 + CW)] into buf, zeros
// outside G (asynchronously where G and its rows are 16-byte aligned), and
// commit it.
__device__ __forceinline__ void stage_tile(float* buf, const float* G, int H, bool g_aligned,
                                           int i0, int cw0) {
  if (g_aligned && H % 4 == 0) {
    for (int e = threadIdx.x; e < TILE / 4; e += THREADS) {
      const int r = e / (8 * CW), c = 32 * cw0 + 4 * (e % (8 * CW));
      const bool in = i0 + r < H && c < H;
      __pipeline_memcpy_async(buf + 4 * e, in ? G + size_t(i0 + r) * H + c : G, 16, in ? 0 : 16);
    }
  } else {
    for (int e = threadIdx.x; e < TILE; e += THREADS) {
      const int r = e / (32 * CW), c = 32 * cw0 + e % (32 * CW);
      buf[e] = i0 + r < H && c < H ? __ldg(G + size_t(i0 + r) * H + c) : 0.f;
    }
  }
  __pipeline_commit();
}

// For rows t0 .. t0 + S - 1 of the warp (those below n_mine): add, for each
// latent i of mask word w that a row has on, ascending, the row's weighted
// columns of the tile's G[i, chunk] to this lane's partial sum acc[row][lane].
// Lane l takes columns 4l..4l+3 and 128+4l..128+4l+3 of the chunk cw0.
template <int S>
__device__ __forceinline__ void tile_pairs(const float* tile, const uint32_t* mask, int MW, int w,
                                           int cw0, int t0, int n_mine, float* acc) {
  const int lane = threadIdx.x & 31;
  uint32_t mt[S], any = 0u;
#pragma unroll
  for (int u = 0; u < S; ++u) {
    mt[u] = t0 + u < n_mine ? mask[(t0 + u) * MW + w] : 0u;
    any |= mt[u];
  }
  if (any == 0u) return;
  float on[S][8], sa[S], sb[S];
  const int wa = cw0 + lane / 8, wb = cw0 + 4 + lane / 8, sh = 4 * (lane % 8);
#pragma unroll
  for (int u = 0; u < S; ++u) {
    const uint32_t na = mt[u] != 0u && wa < MW ? mask[(t0 + u) * MW + wa] >> sh : 0u;
    const uint32_t nb = mt[u] != 0u && wb < MW ? mask[(t0 + u) * MW + wb] >> sh : 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      on[u][k] = float((na >> k) & 1u);
      on[u][4 + k] = float((nb >> k) & 1u);
    }
    sa[u] = sb[u] = 0.f;
  }
  for (; any != 0u; any &= any - 1u) {
    const int b = __ffs(any) - 1;
    const float4 ga = *reinterpret_cast<const float4*>(tile + 32 * CW * b + 4 * lane);
    const float4 gb = *reinterpret_cast<const float4*>(tile + 32 * CW * b + 128 + 4 * lane);
#pragma unroll
    for (int u = 0; u < S; ++u) {
      if ((mt[u] >> b) & 1u) {
        sa[u] = fmaf(on[u][0], ga.x, sa[u]);
        sb[u] = fmaf(on[u][1], ga.y, sb[u]);
        sa[u] = fmaf(on[u][2], ga.z, sa[u]);
        sb[u] = fmaf(on[u][3], ga.w, sb[u]);
        sa[u] = fmaf(on[u][4], gb.x, sa[u]);
        sb[u] = fmaf(on[u][5], gb.y, sb[u]);
        sa[u] = fmaf(on[u][6], gb.z, sa[u]);
        sb[u] = fmaf(on[u][7], gb.w, sb[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < S; ++u)
    if (mt[u] != 0u) acc[(t0 + u) * 32 + lane] += sa[u] + sb[u];
}

template <bool PACKED>
__global__ void __launch_bounds__(THREADS, DENSE_BLOCKS)
bsc_lpj_dense(const uint8_t* __restrict__ ss, const float* __restrict__ wty,
              const float* __restrict__ y2, const float* __restrict__ G,
              const float* __restrict__ scal, float* __restrict__ lpj, int n_rows, int K,
              int H, bool aligned, bool g_aligned) {
  const int MW = (H + 31) / 32;
  const int W8 = (H + 7) / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);                 // [2][TILE]
  float* accs = tiles + 2 * TILE;                                // [WARPS][32 rows][32 lanes]
  float* sws = accs + WARPS * 32 * 32;                           // [WARPS][32] s.Wty
  int* rows = reinterpret_cast<int*>(sws + WARPS * 32);          // [WARPS][32] row index
  uint32_t* dense_rows = reinterpret_cast<uint32_t*>(rows + WARPS * 32);  // [WARPS]
  uint32_t* masks = dense_rows + WARPS;                          // [WARPS][32][MW]
  __shared__ uint32_t need;  // bit w: some dense row has latents in mask word w

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = 32 * (warp * gridDim.x + blockIdx.x);
  const bool marked = row0 + lane < n_rows && __float_as_uint(lpj[row0 + lane]) == DENSE_MARK;
  const uint32_t mine = __ballot_sync(FULL, marked);
  if (lane == 0) dense_rows[warp] = mine;
  if (threadIdx.x == 0) need = 0u;
  __syncthreads();
  int n_dense = 0;
  for (int w = 0; w < WARPS; ++w) n_dense += __popc(dense_rows[w]);
  if (n_dense == 0) return;
  // the block's dense rows, in rank order, dealt to the warps (at most 32 each)
  const int per_warp = (n_dense + WARPS - 1) / WARPS;
  const int n_mine = max(0, min(per_warp, n_dense - warp * per_warp));
  float* acc = accs + warp * 32 * 32;
  float* sw = sws + warp * 32;
  int* rd = rows + warp * 32;
  uint32_t* mask = masks + warp * 32 * MW;

  // 1. the masks of the warp's rows (the loads of SUB rows in flight), their
  // s.Wty, and the mask words any of them uses
  for (int t0 = 0; t0 < n_mine; t0 += SUB) {
    int rr[SUB];
#pragma unroll
    for (int u = 0; u < SUB; ++u) {
      rr[u] = -1;
      if (t0 + u < n_mine) {
        int r = warp * per_warp + t0 + u, w = 0;
        while (r >= __popc(dense_rows[w])) r -= __popc(dense_rows[w++]);
        rr[u] = 32 * (w * gridDim.x + blockIdx.x) + nth_bit(dense_rows[w], r);
        if (lane == 0) rd[t0 + u] = rr[u];
      }
    }
    for (int e = lane; e < min(SUB, n_mine - t0) * MW; e += 32) mask[t0 * MW + e] = 0u;
    __syncwarp();
    if (PACKED) {  // a byte a lane: its set bits are latents b W8 + j
      uint32_t by[SUB][4];
#pragma unroll
      for (int u = 0; u < SUB; ++u)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = lane + 32 * c;
          by[u][c] = rr[u] >= 0 && j < W8 ? __ldg(ss + size_t(rr[u]) * W8 + j) : 0u;
        }
      // bit b of the bytes j = 32c .. 32c + 31: latents b W8 + j, 32 in a row
#pragma unroll
      for (int u = 0; u < SUB; ++u) {
        if (rr[u] < 0) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (32 * c >= W8) break;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const uint32_t bal = __ballot_sync(FULL, (by[u][c] >> b) & 1u);
            const int h0 = b * W8 + 32 * c, w = h0 >> 5, sh = h0 & 31;
            if (lane == 0 && bal != 0u && w < MW) {
              mask[(t0 + u) * MW + w] |= bal << sh;
              if (sh != 0 && w + 1 < MW) mask[(t0 + u) * MW + w + 1] |= bal >> (32 - sh);
            }
          }
        }
        if (lane == 0 && H % 32 != 0) mask[(t0 + u) * MW + MW - 1] &= (1u << (H % 32)) - 1u;
      }
    } else {  // 16 bytes a lane
      uint4 v[SUB][2];
#pragma unroll
      for (int u = 0; u < SUB; ++u)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p0 = 16 * lane + 512 * c;
          const uint8_t* row = ss + size_t(max(rr[u], 0)) * H;
          v[u][c] = rr[u] >= 0 && p0 < H
                        ? load16(row + p0, H - p0, aligned && size_t(rr[u]) * H % 16 == 0)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int u = 0; u < SUB; ++u)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (rr[u] >= 0)
            or_chunk<false>(mask + (t0 + u) * MW, MW, v[u][c], 16 * lane + 512 * c, H, W8);
    }
    __syncwarp();
  }
  uint32_t words = 0u;
  for (int t = 0; t < n_mine; ++t)
    if (lane < MW && mask[t * MW + lane] != 0u) words |= 1u << lane;
  words = __reduce_or_sync(FULL, words);
  __syncwarp();
  for (int t = 0; t < n_mine; ++t) {
    const float* wrow = wty + size_t(rd[t] / K) * H;
    float s = 0.f;
#pragma unroll 8
    for (int w = 0; w < MW; ++w)
      if ((mask[t * MW + w] >> lane) & 1u) s += __ldg(wrow + 32 * w + lane);
    s = warp_sum(s);
    if (lane == 0) sw[t] = s;
    acc[t * 32 + lane] = 0.f;
  }
  if (lane == 0) atomicOr(&need, words);
  __syncthreads();

  // 2. s^T G s, by chunks of 256 columns (CW mask words) and tiles of 32
  // rows of G: one tile per mask word some row uses, double-buffered.
  for (int cw0 = 0; cw0 < MW; cw0 += CW) {
    uint32_t todo = need;
    int cur = 0;
    if (todo != 0u) stage_tile(tiles, G, H, g_aligned, 32 * (__ffs(todo) - 1), cw0);
    while (todo != 0u) {
      const int w = __ffs(todo) - 1;
      todo &= todo - 1u;
      if (todo != 0u) {
        stage_tile(tiles + (cur ^ 1) * TILE, G, H, g_aligned, 32 * (__ffs(todo) - 1), cw0);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float* tile = tiles + cur * TILE;
      for (int t0 = 0; t0 < n_mine; t0 += PAIR_ROWS)
        tile_pairs<PAIR_ROWS>(tile, mask, MW, w, cw0, t0, n_mine, acc);
      __syncthreads();  // this tile is consumed before its buffer is refilled
      cur ^= 1;
    }
  }

  // 3. the lpj of the warp's rows
  const float pre1 = scal[0], pil_bar = scal[1];
  for (int t = 0; t < n_mine; ++t) {
    const float sgs = warp_sum(acc[t * 32 + lane]);
    int n = 0;
    for (int w = 0; w < MW; ++w) n += __popc(mask[t * MW + w]);
    if (lane == 0) lpj[rd[t]] = pre1 * (y2[rd[t] / K] - 2.f * sw[t] + sgs) + pil_bar * float(n);
  }
}

// dynamic shared memory of the two kernels at H
size_t smem_sums(int H) {
  const int MW = (H + 31) / 32;
  return sizeof(uint32_t) * (4 * MW + size_t(WARPS) * 32 * (MW | 1)) +
         sizeof(uint16_t) * size_t(WARPS) * 32 * MW;
}
size_t smem_dense(int H) {
  return sizeof(float) * (2 * TILE + WARPS * 32 * 32 + WARPS * 32) +
         sizeof(uint32_t) * (WARPS * 32 + WARPS + size_t(WARPS) * 32 * ((H + 31) / 32));
}

template <bool KEYS, bool PACKED>
int launch(const void* ss, const void* wty, const void* y2, const void* G, const void* scal,
           void* lpj, void* keys, int B, int K, int H, void* stream) {
  const int n_rows = B * K;
  // Let both kernels take the dynamic shared memory they need at MAX_H,
  // once for each device of this process (the attribute is kept per device).
  static std::atomic<uint64_t> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  if (dev >= 64 || !(ready.load() >> dev & 1u)) {
    e = cudaFuncSetAttribute(bsc_lpj_kernel<KEYS, PACKED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_sums(MAX_H)));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(bsc_lpj_dense<PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem_dense(MAX_H)));
    if (e != cudaSuccess) return int(e);
    if (dev < 64) ready.fetch_or(uint64_t(1) << dev);
  }
  const int groups = (n_rows + 31) / 32;
  const int blocks = (groups + WARPS - 1) / WARPS;
  const bool aligned = reinterpret_cast<uintptr_t>(ss) % 16 == 0;
  const bool g_aligned = reinterpret_cast<uintptr_t>(G) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s8 = static_cast<const uint8_t*>(ss);
  const float *w = static_cast<const float*>(wty), *y = static_cast<const float*>(y2),
              *g = static_cast<const float*>(G), *sc = static_cast<const float*>(scal);
  float* out = static_cast<float*>(lpj);
  bsc_lpj_kernel<KEYS, PACKED><<<blocks, THREADS, smem_sums(H), st>>>(
      s8, w, y, g, sc, out, static_cast<uint32_t*>(keys), n_rows, K, H, aligned);
  e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  bsc_lpj_dense<PACKED><<<blocks, THREADS, smem_dense(H), st>>>(s8, w, y, g, sc, out, n_rows,
                                                                 K, H, aligned, g_aligned);
  return int(cudaGetLastError());
}

}  // namespace

// ss: int8 0/1 [B, K, H]
extern "C" int evo_bsc_lpj(const void* ss, const void* wty, const void* y2, const void* G,
                           const void* scal, void* lpj, void* keys, int B, int K, int H,
                           void* stream) {
  return keys != nullptr ? launch<true, false>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream)
                         : launch<false, false>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream);
}

// ss: lane-major packed uint8 [B, K, ceil(H/8)]
extern "C" int evo_bsc_lpj_packed(const void* ss, const void* wty, const void* y2, const void* G,
                                  const void* scal, void* lpj, void* keys, int B, int K, int H,
                                  void* stream) {
  return keys != nullptr ? launch<true, true>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream)
                         : launch<false, true>(ss, wty, y2, G, scal, lpj, keys, B, K, H, stream);
}
