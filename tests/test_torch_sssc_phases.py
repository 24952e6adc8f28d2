"""ES3C's epoch through the phases of the shared block runner
(evo_tpu_torch/models/epoch.py) against the block loop that ``SSSC.em_step``
ran before (kept below, without its spans, as the reference): K^(n), lpj,
every Theta leaf, every ``StepStats`` field, the reconstruction and the
epoch generator's final state bit for bit, epoch by epoch, on the CPU."""

import numpy as np
import pytest
import torch

from evo_tpu_torch import SSSC, init_states, make_data
from evo_tpu_torch.models.base import StepStats, block_gram, sum_over_ranks
from evo_tpu_torch.ops import sssc_lpj as sssc_lpj_ops
from evo_tpu_torch.ops.bitpack import pack_bits_lane, unpack_bits_lane
from evo_tpu_torch.ops.numerics import posterior_weights, reset_lpj, shifted_logsumexp
from evo_tpu_torch.ops.sssc_lpj import sssc_lpj
from evo_tpu_torch.ops.sssc_suffstat import sssc_suffstat
from evo_tpu_torch.models.sssc import sssc_lpj_wide, sssc_suffstat_wide
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.variational.evolve import evolve_states_block
from evo_tpu_torch.variational.varykn import merge_states

from test_torch_bsc_graph import CASES, _assert_same, _epochs

H, D, NB, B = 6, 9, 3, 31  # N = 91 rows padded to 93: the last block holds two padding rows


def _problem(seed=0, missing=0.0, **opts):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(D, H)) * 2.0
    s = rng.random((NB * B - 2, H)) < 0.3
    z = rng.normal(size=s.shape) + 1.0
    Y = ((s * z) @ W.T + 0.5 * rng.normal(size=(s.shape[0], D))).astype(np.float32)
    if missing:
        Y[rng.random(Y.shape) < missing] = np.nan
    data = make_data(Y, n_blocks=NB, device="cpu")
    ea = dict(no_parents=4, no_children=2, no_generations=2)
    ea.update(opts)
    cfg, estate = init_states(N=NB * B, S=8, H=H, n_blocks=NB, seed=seed + 1, device="cpu", **ea)
    model = SSSC(D=D, H=H, device="cpu")
    return model, data, cfg, estate, model.standard_init(data, seed=seed + 2, y_host=Y)


def _em_step_before(model, params, estate, data, generator, cfg, do_reconstruction=False):
    """``SSSC.em_step`` as it was before its blocks ran through the shared
    phases (without its spans): the reference for the phase-split epoch."""
    wide = model.wide(data)
    lpj_fn = sssc_lpj_wide if wide else sssc_lpj
    suffstat_fn = sssc_suffstat_wide if wide else sssc_suffstat
    params = model.check_params(params)
    pre = model._precompute(params, data)
    rows = distributed.block_rows(data.y.shape[1])
    dt, Hm = params.W.dtype, model.H
    acc = {k: torch.zeros((Hm, Hm), dtype=dt)
           for k in ("xpt_ss", "xpt_szsz", "s_sz_outer", "sz_sz_outer")}
    acc.update(xpt_s=torch.zeros((Hm,), dtype=dt), xpt_sz=torch.zeros((Hm,), dtype=dt),
               Wp=torch.zeros((model.D, Hm), dtype=dt), y2sum=torch.zeros((), dtype=dt),
               trWszszW=torch.zeros((), dtype=dt))
    Fsum = torch.zeros((), dtype=dt)
    nuni, nsub = torch.zeros((), dtype=torch.int64), torch.zeros((), dtype=torch.int64)
    resets = torch.zeros((3,), dtype=torch.int64)
    ss_all, lpj_all = torch.empty_like(estate.ss), torch.empty_like(estate.lpj)
    y_rec_all = torch.empty_like(data.y) if do_reconstruction else None
    for i in range(data.n_blocks):
        y_b, valid_b = data.y[i], data.row_valid[i]
        G_b, Wty_b, y2_b = block_gram(params.W, y_b, data.x_infr[i], data.incomplete)
        ss_b = estate.ss[i]
        if cfg.packed_states:
            ss_b = unpack_bits_lane(ss_b, Hm).to(torch.int8)

        def lpj_block(states):
            lpj, _bad = lpj_fn(states, Wty_b, y2_b, G_b, params.Psi, params.mus,
                               pre["pil_bar"], pre["sigma2_inv"])
            lpj, counts = reset_lpj(lpj, valid=valid_b)
            return lpj, None, torch.stack(counts)

        lpj_K, _, counts = lpj_block(ss_b)
        if cfg.exact:
            zeros = torch.zeros(ss_b.shape[0], dtype=torch.int64)
            ss2, lpj2, n_uni, n_sub = ss_b, lpj_K, zeros, zeros
        else:
            children, child_lpj, new_unique, child_lpj_raw, aux = evolve_states_block(
                ss_b, lpj_K, lpj_block, cfg, pre["piH"], generator, rows=rows)
            counts = counts + sum(aux)
            ss2, lpj2, n_uni, n_sub, _ = merge_states(cfg, ss_b, lpj_K, children, child_lpj,
                                                      new_unique, child_lpj_raw)
        if cfg.allzero:
            lpj2 = torch.cat([-0.5 * pre["sigma2_inv"] * y2_b[:, None], lpj2], 1)
        vf = valid_b.to(dt)
        Fsum += (shifted_logsumexp(lpj2) * vf).sum()
        rs = (posterior_weights(lpj2) * vf[:, None])[:, cfg.S_perm:].contiguous()
        xpt_sz, xpt_s, xpt_ss, xpt_szsz, s_sz, sz_sz = suffstat_fn(
            ss2, rs, Wty_b, G_b, params.Psi, params.mus, pre["sigma2_inv"])
        y_m = y_b
        if do_reconstruction:
            est = xpt_sz @ params.W.T
            y_rec_all[i] = torch.where(data.x[i], y_b, est)
            if data.incomplete:
                y_m = y_rec_all[i]
                acc["trWszszW"] += (data.x_infr[i] * est * est).sum()
        acc["Wp"] += y_m.T @ xpt_sz
        acc["xpt_s"] += xpt_s.sum(0)
        acc["xpt_sz"] += xpt_sz.sum(0)
        acc["xpt_ss"] += xpt_ss
        acc["xpt_szsz"] += xpt_szsz
        acc["s_sz_outer"] += s_sz
        acc["sz_sz_outer"] += sz_sz
        acc["y2sum"] += (y2_b * vf).sum()
        nuni += (n_uni * valid_b).sum()
        nsub += (n_sub * valid_b).sum()
        resets += counts
        ss_all[i] = pack_bits_lane(ss2) if cfg.packed_states else ss2
        lpj_all[i] = lpj2
    pre, acc, tot = sum_over_ranks(model, params, data, pre, acc,
                                   dict(Fsum=Fsum, nuni=nuni, nsub=nsub, resets=resets))
    new_params, guards = model._m_step_finalize(params, acc, pre, data.incomplete, cfg)
    N, resets = pre["N"], tot["resets"]
    z = torch.zeros((), dtype=torch.int64)
    # every parameter is learned: the model sets all three of its guard fields
    stats = StepStats(
        F=pre["ljc"] + tot["Fsum"] / N, S_nunique=tot["nuni"] / N, S_sub=tot["nsub"] / N,
        n_reset_nan=resets[0], n_reset_small=resets[1], n_reset_inf=resets[2],
        n_guard_sigma_floor=z, n_guard_mus_freeze=guards["n_guard_mus_freeze"],
        n_guard_psi_freeze=guards["n_guard_psi_freeze"],
        guard_psi_renorm=guards["guard_psi_renorm"])
    return new_params, type(estate)(ss=ss_all, lpj=lpj_all), stats, y_rec_all


class _Before:
    """A model whose em_step is ``_em_step_before``."""

    def __init__(self, model):
        self.model = model

    def em_step(self, *a, **k):
        return _em_step_before(self.model, *a, **k)


@pytest.mark.parametrize("case", list(CASES) + ["incomplete", "exact", "wide"])
def test_the_phase_split_epoch_equals_the_loop_it_replaced(case, monkeypatch):
    opts = CASES.get(case, {})
    rec = case == "incomplete"
    if case == "exact":
        opts = dict(no_parents=1, no_children=1, no_generations=1)
    model, data, cfg, estate, params = _problem(missing=0.2 if rec else 0.0, **opts)
    if case == "exact":
        cfg, estate = init_states(N=NB * B, S=2**H, H=H, n_blocks=NB, device="cpu")
        assert cfg.exact
    if case == "wide":
        monkeypatch.setattr(sssc_lpj_ops, "MAX_H", H - 1)
        assert model.wide(data)
    args = (data, cfg, estate, params)
    _assert_same(_epochs(model, *args, rec=rec), _epochs(_Before(model), *args, rec=rec))
