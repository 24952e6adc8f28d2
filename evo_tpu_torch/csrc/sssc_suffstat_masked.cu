// ES3C M-step sufficient statistics under a per-datapoint Gram
// G_b = W^T diag(m_b) W [B, H, H] (incomplete data), H <= 64.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:_suffstat_pallas_masked (body
// _make_suffstat_kernel with masked=True).  The TPU kernel streams G_b as a
// lane-major block beside a Ga = G_b (s * mus) computed outside the kernel
// (Mosaic could not build it); here a warp takes a datapoint, copies its
// G_b into the warp's own shared memory (cp.async, 16 bytes at a time, while
// the rows are read; the next datapoint's G_b asked into L2 ahead), and each
// of its states' solves reads G_AA there and forms G_AA mus_A itself.  The
// kernel, its bound and its design are in sssc_suffstat.cuh (MASKED = true,
// no overflow cap: every state is solved exactly).

#include "sssc_suffstat.cuh"

// The number of blocks G for (B, S, H) on the current device; negative on
// a CUDA error.
extern "C" int evo_sssc_suffstat_masked_blocks(int B, int S, int H) {
  return sssc_suffstat_blocks<true>(B, S, H, 0);
}

// partial: [G, 3 H(H+1)/2 + H^2] f32, G from evo_sssc_suffstat_masked_blocks;
// counts: int64 [2] or null, gains the rows solved sparsely and densely
extern "C" int evo_sssc_suffstat_masked(const void* ss, const void* rs, const void* wty,
                                        const void* G, const void* Psi, const void* mus,
                                        const void* s2inv, void* xpt_sz, void* xpt_s,
                                        void* out, void* partial, void* counts, int B, int S,
                                        int H, int n_blocks, void* stream) {
  return launch_sssc_suffstat<true>(ss, rs, wty, G, Psi, mus, s2inv, xpt_sz, xpt_s, out,
                                    partial, counts, B, S, H, 0, n_blocks, stream);
}
