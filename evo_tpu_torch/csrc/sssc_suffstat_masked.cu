// ES3C M-step sufficient statistics under a per-datapoint Gram
// G_b = W^T diag(m_b) W [B, H, H] (incomplete data), H <= 64.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:_suffstat_pallas_masked (body
// _make_suffstat_kernel with masked=True).  The TPU kernel streams G_b as a
// lane-major block beside a Ga = G_b (s * mus) computed outside the kernel
// (Mosaic could not build it); here each warp reads the G_b entries of its
// state's active units through L1 and forms G_AA mus_A itself.  The kernel,
// its bound and its design are in sssc_suffstat.cuh (MASKED = true, no
// overflow cap: every state is solved exactly).

#include "sssc_suffstat.cuh"

extern "C" int evo_sssc_suffstat_masked(const void* ss, const void* rs, const void* wty,
                                        const void* G, const void* Psi, const void* mus,
                                        const void* s2inv, void* xpt_sz, void* xpt_s,
                                        void* out, void* partial, int B, int S, int H,
                                        int chunk, void* stream) {
  return launch_sssc_suffstat<true>(ss, rs, wty, G, Psi, mus, s2inv, xpt_sz, xpt_s, out,
                                    partial, B, S, H, 0, chunk, stream);
}
