// The unification merge of K^(n) and the children (variational/varykn.py:vary_Kn).
//
// Replaces no TPU kernel: evo_tpu leaves vary_Kn (evo_tpu/variational/varykn.py) to XLA, and
// the port ran it as plain torch ops (ops/varykn_merge.py:vary_Kn_plain: a cat of both sets,
// a stable sort of the lpjs, a gather of the rows).  For each datapoint b, of its S old states
// ss[b] with lpj[b] and its T children[b] with child_lpj[b] (-inf at duplicates):
//
//   1. where Mprime < T, the children past the Mprime best are masked to -inf exactly as
//      _prune_to_mprime does: the Mprime-th value kth in the sort's order, then a child stays
//      if it is > kth, or == kth among the first Mprime - #(> kth) such ties by index;
//   2. each of the S + T candidates j gets its place in torch.sort(descending=True,
//      stable=True) by counting the candidates before it: a larger value, or an equal one at
//      a lower index, so an old state wins a tie against a child.  The values are compared as
//      that sort compares them, through order keys (ints): NaN above +inf and all NaNs equal,
//      -0.0 equal to +0.0;
//   3. the candidates of place r < S write idx[b, r], vals[b, r] (the value's bits as they
//      came in) and their row into ss_new[b, r]; n_sub[b] counts the children among them.
//
// What bounds it: bytes.  A datapoint reads and writes its S kept rows once (2 S W bytes) and
// moves its S + T lpjs, S vals, S idx and n_sub: 33.6 KB at S = 64, T = 10, W = 256, so
// 137.6 MB for the EBSC block of 4,096 datapoints, 0.041 ms at 3.35 TB/s.  The compares of
// step 2 are (S + T)^2 a datapoint on values in shared memory, far below that time.
//
// Design: a warp a datapoint up to SMALL_N = 256 candidates, up to 8 warps a block (fewer
// where the shared memory of a large S + T asks for it), so the EBSC block is 512 blocks and
// ES3C inpainting's 151,209 datapoints 18,901, both past a wave of the 132 SMs.  Past
// SMALL_N a block of 8 warps takes a datapoint, so that the (S + T)^2 compares spread over
// 256 threads and a few datapoints still fill the card.  The group stages the lpjs in shared
// memory with their order keys, ranks by broadcast reads, and writes each place's candidate
// to shared memory; then it copies the datapoint's S rows, which lie end to end as one
// [S, W] run of ss_new, in 16-byte words (8, 4, 2 or 1 bytes where W or a pointer is not
// 16-byte aligned), four words a thread in flight.  No global atomics (a block of 8 warps
// adds its counts by integer atomics in shared memory), no synchronisation beyond the
// group and nothing asked of the card at launch, so a CUDA graph can capture it.  Rows are
// only copied: any 1-byte dtype (int8 states, lane-major packed uint8) takes the same path.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_WARPS = 8;        // warps a block
constexpr int GROUP_WARPS = 8;      // warps a datapoint past SMALL_N candidates
constexpr int SMALL_N = 256;        // S + T that a warp a datapoint ranks alone
constexpr int MAX_CANDIDATES = 1024;  // S + T (ops/varykn_merge.py:MAX_CANDIDATES)
constexpr int SMEM_BYTES = 48 * 1024;  // a block's shared memory without an opt-in
constexpr int UNROLL = 4;           // words a lane has in flight in the copy
constexpr uint32_t NEG_INF = 0xff800000u;

// An int that orders as torch's sort orders f32 values: NaN above +inf (every NaN alike),
// -0.0 and +0.0 alike, the rest as the floats.
__device__ __forceinline__ int order_key(uint32_t bits) {
  const uint32_t mag = bits & 0x7fffffffu;
  if (mag > 0x7f800000u) return INT_MAX;
  if (mag == 0) return 0;
  const int b = int(bits);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

// ints of shared memory a group of G warps uses (see varykn_merge_kernel)
__host__ __device__ constexpr int group_ints(int S, int T, int G) {
  return 2 * (S + T) + S + (G > 1 ? G + 3 : 0);
}

template <int V> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<1> { using T = unsigned char; };

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 1) {
    __syncwarp();
  } else {
    __syncthreads();  // a block of G warps is one group
  }
}

// G warps a datapoint (a group): 1, or GROUP_WARPS past SMALL_N candidates.  Shared memory a
// group: key [S + T] int, raw [S + T] f32 bits, src [S] int (the candidate of each place),
// and with G > 1 scratch [G + 3] int (per-warp tie counts, kth's bits, #(> kth), n_sub).
template <int V, int G>
__global__ void __launch_bounds__(MAX_WARPS * 32)
varykn_merge_kernel(const uint8_t* __restrict__ ss, const float* __restrict__ lpj,
                    const uint8_t* __restrict__ children, const float* __restrict__ child_lpj,
                    uint8_t* __restrict__ ss_new, float* __restrict__ vals,
                    long long* __restrict__ n_sub, long long* __restrict__ idx, int B, int S,
                    int T, int W, int Mprime) {
  using Wd = typename Word<V>::T;
  constexpr int GT = 32 * G;  // threads a group
  extern __shared__ int smem[];
  const int n = S + T;
  const int grp = threadIdx.x / GT, t = threadIdx.x % GT, warp = t >> 5, lane = t & 31;
  int* key = smem + grp * group_ints(S, T, G);
  uint32_t* raw = reinterpret_cast<uint32_t*>(key + n);
  int* src = key + 2 * n;
  int* scratch = src + S;
  const long long bl = (long long)blockIdx.x * (blockDim.x / GT) + grp;
  if (bl >= B) return;  // a whole group: nothing below waits for another
  const size_t b = size_t(bl);

  for (int i = t; i < n; i += GT) {
    const uint32_t v = __float_as_uint(i < S ? lpj[b * S + i] : child_lpj[b * T + (i - S)]);
    raw[i] = v;
    key[i] = order_key(v);
  }
  if constexpr (G > 1) {
    if (t < 2) scratch[G + 1 + t] = 0;
  }
  group_sync<G>();

  // 1. the children past the Mprime best masked, as _prune_to_mprime does
  if (Mprime < T) {
    uint32_t kth = 0;
    bool has = false;
    for (int c0 = 0; c0 < T; c0 += GT) {
      const int c = c0 + t;
      const int kc = c < T ? key[S + c] : INT_MIN;
      int r = 0;
      for (int j = 0; j < T; ++j) {
        const int kj = key[S + j];
        r += (kj > kc) | ((kj == kc) & (j < c));
      }
      if (c < T && r == Mprime - 1) {
        kth = raw[S + c];
        has = true;
      }
    }
    if constexpr (G == 1) {
      kth = __shfl_sync(FULL, kth, __ffs(__ballot_sync(FULL, has)) - 1);
    } else {
      if (has) scratch[G] = kth;  // one child of the group holds each rank
      group_sync<G>();
      kth = scratch[G];
    }
    const float fk = __uint_as_float(kth);
    int n_greater = 0;
    for (int c0 = 0; c0 < T; c0 += GT) {
      const int c = c0 + t;
      n_greater += __popc(__ballot_sync(FULL, c < T && __uint_as_float(raw[S + c]) > fk));
    }
    if constexpr (G > 1) {
      if (lane == 0) atomicAdd(&scratch[G + 1], n_greater);
      group_sync<G>();
      n_greater = scratch[G + 1];
    }
    group_sync<G>();
    int ties_before = 0;  // ties at kth among the earlier chunks of the children
    for (int c0 = 0; c0 < T; c0 += GT) {
      const int c = c0 + t;
      const float v = c < T ? __uint_as_float(raw[S + c]) : 0.0f;
      const bool greater = c < T && v > fk, tie = c < T && v == fk;
      const unsigned ties = __ballot_sync(FULL, tie);
      int tie_rank = ties_before + __popc(ties & ((2u << lane) - 1u));  // 1-based
      if constexpr (G == 1) {
        ties_before += __popc(ties);
      } else {
        if (lane == 0) scratch[warp] = __popc(ties);
        group_sync<G>();
        for (int w = 0; w < G; ++w) {
          const int k = scratch[w];
          tie_rank += w < warp ? k : 0;
          ties_before += k;
        }
        group_sync<G>();  // scratch is the next chunk's
      }
      if (c < T && !(greater || (tie && tie_rank <= Mprime - n_greater))) {
        raw[S + c] = NEG_INF;
        key[S + c] = order_key(NEG_INF);
      }
    }
    group_sync<G>();
  }

  // 2. each candidate's place in the stable descending order
  for (int i0 = 0; i0 < n; i0 += GT) {
    const int i = i0 + t;
    const int ki = i < n ? key[i] : INT_MIN;
    int r = 0;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int kj = key[j];
      r += (kj > ki) | ((kj == ki) & (j < i));
    }
    if (i < n && r < S) src[r] = i;
  }
  group_sync<G>();

  // 3. the S first: indices, values, the children kept, then their rows
  unsigned sub = 0;
  for (int r = t; r < S; r += GT) {
    const int i = src[r];
    idx[b * S + r] = i;
    vals[b * S + r] = __uint_as_float(raw[i]);
    sub += i >= S;
  }
  sub = __reduce_add_sync(FULL, sub);
  if constexpr (G == 1) {
    if (lane == 0) n_sub[b] = sub;
  } else {
    if (lane == 0) atomicAdd(&scratch[G + 2], int(sub));
    group_sync<G>();
    if (t == 0) n_sub[b] = scratch[G + 2];
  }

  const int per_row = W / V;
  const int words = S * per_row;
  const uint8_t* old_b = ss + b * S * W;
  const uint8_t* new_b = children + b * T * W;
  Wd* dst = reinterpret_cast<Wd*>(ss_new + b * S * W);
  for (int w0 = t; w0 < words; w0 += GT * UNROLL) {
    Wd x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + GT * u;
      if (w < words) {
        const int r = w / per_row, c = w - r * per_row;
        const int i = src[r];
        const uint8_t* row = i < S ? old_b + size_t(i) * W : new_b + size_t(i - S) * W;
        x[u] = __ldg(reinterpret_cast<const Wd*>(row) + c);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int w = w0 + GT * u;
      if (w < words) dst[w] = x[u];
    }
  }
}

template <int V, int G>
int launch_group(const void* ss, const void* lpj, const void* children, const void* child_lpj,
                 void* ss_new, void* vals, void* n_sub, void* idx, int B, int S, int T, int W,
                 int Mprime, cudaStream_t st) {
  const int per_group = group_ints(S, T, G) * int(sizeof(int));
  const int groups = G > 1 ? 1
                     : per_group * MAX_WARPS <= SMEM_BYTES ? MAX_WARPS
                                                           : SMEM_BYTES / per_group;
  const unsigned blocks = unsigned((B + groups - 1) / groups);
  varykn_merge_kernel<V, G><<<blocks, groups * 32 * G, groups * per_group, st>>>(
      static_cast<const uint8_t*>(ss), static_cast<const float*>(lpj),
      static_cast<const uint8_t*>(children), static_cast<const float*>(child_lpj),
      static_cast<uint8_t*>(ss_new), static_cast<float*>(vals), static_cast<long long*>(n_sub),
      static_cast<long long*>(idx), B, S, T, W, Mprime);
  return int(cudaGetLastError());
}

template <int V>
int launch(const void* ss, const void* lpj, const void* children, const void* child_lpj,
           void* ss_new, void* vals, void* n_sub, void* idx, int B, int S, int T, int W,
           int Mprime, cudaStream_t st) {
  if (S + T > SMALL_N)
    return launch_group<V, GROUP_WARPS>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx,
                                        B, S, T, W, Mprime, st);
  return launch_group<V, 1>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W,
                            Mprime, st);
}

}  // namespace

// ss [B, S, W] and children [B, T, W] of one 1-byte dtype, lpj [B, S] and child_lpj [B, T]
// f32, all contiguous; out ss_new [B, S, W], vals [B, S] f32, n_sub [B] and idx [B, S] int64.
// 1 <= S, S + T <= MAX_CANDIDATES, 1 <= Mprime (Mprime >= T: no child masked).
extern "C" int evo_varykn_merge(const void* ss, const void* lpj, const void* children,
                                const void* child_lpj, void* ss_new, void* vals, void* n_sub,
                                void* idx, int B, int S, int T, int W, int Mprime,
                                void* stream) {
  if (B < 1 || S < 1 || T < 0 || W < 1 || S + T > MAX_CANDIDATES || Mprime < 1)
    return int(cudaErrorInvalidValue);
  // the widest word that W and every row pointer allow
  const uintptr_t a = reinterpret_cast<uintptr_t>(ss) | reinterpret_cast<uintptr_t>(ss_new) |
                      (T > 0 ? reinterpret_cast<uintptr_t>(children) : 0) | uintptr_t(W);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a % 16 == 0)
    return launch<16>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime,
                      st);
  if (a % 8 == 0)
    return launch<8>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime,
                     st);
  if (a % 4 == 0)
    return launch<4>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime,
                     st);
  if (a % 2 == 0)
    return launch<2>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime,
                     st);
  return launch<1>(ss, lpj, children, child_lpj, ss_new, vals, n_sub, idx, B, S, T, W, Mprime,
                   st);
}
