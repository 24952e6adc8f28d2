// ES3C M-step sufficient statistics under the shared Gram (complete data).
//
// Replaces: evo_tpu/ops/pallas_sssc.py:sssc_suffstat_pallas.  The kernel,
// its bound and its design are in sssc_suffstat.cuh (MASKED = false).

#include "sssc_suffstat.cuh"

// The number of blocks G for (B, S, H) with overflow cap `cap` on the
// current device, the first dimension of the partial the launch takes;
// negative on a CUDA error.
extern "C" int evo_sssc_suffstat_blocks(int B, int S, int H, int cap) {
  return sssc_suffstat_blocks<false>(B, S, H, cap);
}

// partial: [G, 3 H(H+1)/2 + H^2] f32, G from evo_sssc_suffstat_blocks;
// counts: int64 [2] or null, gains the rows solved sparsely and densely (H <= 64)
extern "C" int evo_sssc_suffstat(const void* ss, const void* rs, const void* wty, const void* G,
                                 const void* Psi, const void* mus, const void* s2inv,
                                 void* xpt_sz, void* xpt_s, void* out, void* partial,
                                 void* counts, int B, int S, int H, int cap, int n_blocks,
                                 void* stream) {
  return launch_sssc_suffstat<false>(ss, rs, wty, G, Psi, mus, s2inv, xpt_sz, xpt_s, out,
                                     partial, counts, B, S, H, cap, n_blocks, stream);
}
