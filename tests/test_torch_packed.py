"""Packed state sets (``EAConfig.packed_states``) in the port.

The initial packed states must be bit-identical to evo_tpu's (the same
NumPy draws, packed lane-major).  A packed epoch must equal the unpacked
one from the same states and generator bit for bit: the kernels' plain
versions unpack to the same int8 states, the dedup keys from the bytes
make the same duplicates as those of the unpacked states (exact words at
H <= 64), and the EA draws the same random numbers in the same order; so
the lpj, the unpacked states, F and every parameter are equal, with no
tolerance.  The cases cover both models on complete and incomplete data,
at H = 32 (whole bytes) and at a ragged H = 12 (4 pad bits a byte row).
"""

import numpy as np
import pytest
import torch

from evo_tpu.variational.state_init import init_states as j_init_states
from evo_tpu_torch import BSC, SSSC, convert, init_states, make_data
from evo_tpu_torch.ops.bitpack import n_bytes_lane, pack_bits_lane, unpack_bits_lane


@pytest.mark.parametrize("H,S,opts", [(12, 8, {}), (32, 6, {"allzero": True}),
                                      (20, 8, {"background": True}), (4, 16, {})])
def test_init_states_packed_matches_evo_tpu(H, S, opts):
    """EA and (H = 4, S = 2^4) exact mode, with the permanent states."""
    kw = dict(N=64, S=S, H=H, no_parents=3, n_blocks=2, seed=3, packed_states=True, **opts)
    jcfg, jstate = j_init_states(**kw)
    tcfg, tstate = init_states(**kw, device="cpu")
    assert tcfg.packed_states and tcfg.exact == jcfg.exact == (H == 4)
    assert tstate.ss.dtype == torch.uint8
    assert tuple(tstate.ss.shape) == (2, 32, tcfg.S, n_bytes_lane(H))
    np.testing.assert_array_equal(tstate.ss.numpy(), np.asarray(jstate.ss))
    assert tuple(tstate.lpj.shape) == tuple(jstate.lpj.shape)
    carried = convert.estate_from_numpy(jstate, "cpu")  # packed states stay packed
    assert carried.ss.dtype == torch.uint8 and torch.equal(carried.ss, tstate.ss)
    _, unpacked = init_states(**dict(kw, packed_states=False), device="cpu")
    np.testing.assert_array_equal(unpack_bits_lane(tstate.ss, H).numpy(),
                                  unpacked.ss.numpy() != 0)


def _observations(kind, H, D, N, seed):
    rng = np.random.default_rng(seed)
    s = rng.random((N, H)) < 2.0 / H
    if kind == "sssc":
        s = s * (1.0 + 0.3 * rng.standard_normal((N, H)))
    return (s @ rng.normal(size=(D, H)).T * 3.0 + rng.standard_normal((N, D))).astype(np.float32)


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
@pytest.mark.parametrize("incomplete", [False, True])
@pytest.mark.parametrize("H", [32, 12])
def test_packed_epochs_equal_unpacked(kind, incomplete, H):
    D, N, S = 16, 96, 6
    Y = _observations(kind, H, D, N, seed=H)
    if incomplete:
        Y = np.where(np.random.default_rng(1).random(Y.shape) < 0.15, np.nan, Y)
    model = (BSC if kind == "bsc" else SSSC)(D=D, H=H, device="cpu")
    data = make_data(Y, n_blocks=2, device="cpu")
    runs = {}
    for packed in (False, True):
        cfg, estate = init_states(N=N, S=S, H=H, no_parents=4, no_children=2,
                                  no_generations=2, n_blocks=2, seed=5,
                                  packed_states=packed, device="cpu")
        params = model.standard_init(data, seed=0)
        gen = torch.Generator().manual_seed(3)
        out = []
        for _ in range(3):
            params, estate, stats, y_rec = model.em_step(
                params, estate, data, gen, cfg, do_reconstruction=incomplete)
            out.append((params, estate, stats, y_rec))
        runs[packed] = out
    for (pa, ea, sa, ra), (pb, eb, sb, rb) in zip(runs[False], runs[True]):
        assert eb.ss.dtype == torch.uint8 and eb.ss.shape[-1] == n_bytes_lane(H)
        np.testing.assert_array_equal(unpack_bits_lane(eb.ss, H).numpy(), ea.ss.numpy() != 0)
        np.testing.assert_array_equal(eb.ss.numpy(), pack_bits_lane(ea.ss).numpy())
        np.testing.assert_array_equal(eb.lpj.numpy(), ea.lpj.numpy())
        for f in vars(sa):
            np.testing.assert_array_equal(getattr(sb, f).numpy(), getattr(sa, f).numpy())
        for f in vars(pa):
            np.testing.assert_array_equal(getattr(pb, f).numpy(), getattr(pa, f).numpy())
        if incomplete:
            np.testing.assert_array_equal(rb.numpy(), ra.numpy())
    assert float(runs[True][-1][2].S_nunique) > 0
