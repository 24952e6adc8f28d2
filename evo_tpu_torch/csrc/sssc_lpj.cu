// ES3C log-pseudo-joint of binary candidate states under the shared Gram
// (complete data), slab marginalized.
//
// Replaces: evo_tpu/ops/pallas_sssc.py:sssc_lpj_pallas (body
// _make_lpj_kernel, with _lu_logdet_solve and _build_P).  The kernel, its
// bound and its design are in sssc_lpj.cuh (MASKED = false).

#include "sssc_lpj.cuh"

// cap: the overflow cap of 64 < H <= 128 (16), else 0
extern "C" int evo_sssc_lpj(const void* ss, const void* wty, const void* y2, const void* G,
                            const void* Psi, const void* mus, const void* pil,
                            const void* s2inv, void* lpj, void* bad, int B, int K, int H,
                            int cap, void* stream) {
  return launch_sssc_lpj<false>(ss, wty, y2, G, Psi, mus, pil, s2inv, lpj, bad, B, K, H, cap,
                                stream);
}
