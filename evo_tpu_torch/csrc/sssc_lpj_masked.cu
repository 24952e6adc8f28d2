// ES3C log-pseudo-joint of binary candidate states under a per-datapoint
// Gram G_b = W^T diag(m_b) W [B, H, H] (incomplete data), slab
// marginalized, H <= 64.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:_lpj_pallas_masked (body
// _make_lpj_kernel_masked, solves _solve_core with _pd_inv_logdet).  The
// TPU kernel was given Ga = G_b a from an XLA einsum because Mosaic could
// not build it; here each solve forms it from the G_b rows its block
// staged.  The kernel, its bound and its design are in sssc_lpj.cuh
// (MASKED = true, no overflow cap: every state is solved exactly).

#include "sssc_lpj.cuh"

extern "C" int evo_sssc_lpj_masked(const void* ss, const void* wty, const void* y2,
                                   const void* G, const void* Psi, const void* mus,
                                   const void* pil, const void* s2inv, void* lpj, void* bad,
                                   int B, int K, int H, void* stream) {
  return launch_sssc_lpj<true>(ss, wty, y2, G, Psi, mus, pil, s2inv, lpj, bad, B, K, H, 0,
                               stream);
}
