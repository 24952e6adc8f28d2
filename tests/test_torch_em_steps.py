"""The port's em_steps, epoch_generator, blockify and unblockify.

em_steps against stepping the same epochs one by one with
epoch_generator(seed, e), on both models, exactly (as
tests/test_bsc_em.py::test_em_steps_matches_host_loop holds evo_tpu's scan
to its host loop), across a chunk boundary through e0; blockify and
unblockify against evo_tpu's on the same arrays, exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from evo_tpu.models.base import blockify as j_blockify
from evo_tpu.models.base import make_data as j_make_data
from evo_tpu.models.base import unblockify as j_unblockify
from evo_tpu_torch import BSC, SSSC, SSSCParams, init_states, make_data
from evo_tpu_torch.models import blockify, em_steps, epoch_generator, unblockify
from evo_tpu_torch.variational.state_init import EState


def _bars_Y(H=8, N=256, seed=0):
    R = H // 2
    W = np.zeros((R, R, H))
    for i in range(R):
        W[i, :, i] = 10.0
        W[:, i, R + i] = 10.0
    rng = np.random.default_rng(seed)
    s = rng.random((N, H)) <= 2.0 / H
    return (s @ W.reshape(R * R, H).T + rng.standard_normal((N, R * R))).astype(np.float32)


def _problem(kind):
    H, N = 8, 256
    if kind == "bsc":
        Y = _bars_Y(H, N)
        model = BSC(D=Y.shape[1], H=H, device="cpu")
    else:
        g = torch.Generator().manual_seed(3)
        A = torch.randn(H, H, generator=g) * 0.3
        gen = SSSCParams(W=2 * torch.randn(16, H, generator=g), pies=torch.full((H,), 2.0 / H),
                         mus=torch.randn(H, generator=g), Psi=A @ A.T + torch.eye(H),
                         sigma2=torch.tensor(0.5))
        model = SSSC(D=16, H=H, device="cpu")
        Y = model.generate_data(gen, N, g)["y"].numpy()
    data = make_data(Y, n_blocks=2, device="cpu")
    cfg, estate = init_states(N=N, S=12, H=H, no_parents=5, no_children=1, no_generations=1,
                              n_blocks=2, seed=3, device="cpu")
    return model, data, cfg, estate, model.standard_init(data, seed=3, y_host=Y)


@pytest.mark.parametrize("kind", ["bsc", "sssc"])
def test_em_steps_matches_host_stepping(kind):
    model, data, cfg, estate, params = _problem(kind)
    seed = 11
    p_h, s_h, F_host = params, estate, []
    for e in range(5):
        p_h, s_h, st, _ = model.em_step(p_h, s_h, data, epoch_generator(seed, e, "cpu"), cfg)
        F_host.append(float(st.F))

    # 3 epochs, then 2 more from e0 = 3 (a chunk boundary)
    p_s, s_s, st1 = em_steps(model, params, estate, data, seed, cfg, 3)
    p_s, s_s, st2 = em_steps(model, p_s, s_s, data, seed, cfg, 2, e0=3)
    assert st1.F.shape == (3,) and st2.F.shape == (2,)
    assert st1.n_reset_nan.shape == (3,) and st1.guard_psi_renorm.shape == (3,)
    F_steps = [float(f) for f in st1.F] + [float(f) for f in st2.F]
    np.testing.assert_array_equal(np.asarray(F_steps), np.asarray(F_host))
    for name in vars(p_h):
        np.testing.assert_array_equal(getattr(p_s, name).numpy(), getattr(p_h, name).numpy())
    np.testing.assert_array_equal(s_s.ss.numpy(), s_h.ss.numpy())
    np.testing.assert_array_equal(s_s.lpj.numpy(), s_h.lpj.numpy())
    # the EA drew from the generators: another seed takes another path
    p_o, _, _ = em_steps(model, params, estate, data, seed + 1, cfg, 5)
    assert not torch.equal(p_o.W, p_s.W)


def test_em_steps_rejects_incomplete_data():
    Y = _bars_Y(4, 32)
    Y[0, 0] = np.nan
    data = make_data(Y, device="cpu")
    model = BSC(D=Y.shape[1], H=4, device="cpu")
    cfg, estate = init_states(N=32, S=4, H=4, no_parents=2, device="cpu")
    with pytest.raises(ValueError, match="complete data only"):
        em_steps(model, model.standard_init(data), estate, data, 0, cfg, 2)


def test_blockify_unblockify_match_evo_tpu():
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((12, 5)).astype(np.float32),
              "b": rng.integers(0, 2, (12, 3, 4)).astype(np.int8)}
    for a in arrays.values():
        j, t = j_blockify(jnp.asarray(a), 3), blockify(torch.from_numpy(a), 3)
        assert t.shape == (3, 4) + a.shape[1:]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(unblockify(t).numpy(), np.asarray(j_unblockify(j)))
        np.testing.assert_array_equal(blockify(a, 3), np.asarray(j))
    # the dataclasses: Data (with its static flag) and EState
    Y = rng.standard_normal((12, 5)).astype(np.float32)
    Y[1, 2] = np.nan
    jd, td = j_make_data(Y, n_blocks=3), make_data(Y, n_blocks=3, device="cpu")
    jf, tf = j_unblockify(jd), unblockify(td)
    assert tf.incomplete and tf.y.shape == (12, 5)
    for name in ("y", "x_infr", "x", "row_valid"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)))
        np.testing.assert_array_equal(getattr(blockify(tf, 3), name).numpy(),
                                      np.asarray(getattr(j_blockify(jf, 3), name)))
    es = EState(ss=torch.from_numpy(arrays["b"]), lpj=torch.from_numpy(arrays["a"]))
    back = unblockify(blockify(es, 4))
    assert torch.equal(back.ss, es.ss) and torch.equal(back.lpj, es.lpj)


def test_epoch_generator_streams():
    """Each (seed, e) pair has its own stream, and the same pair the same
    stream; the mix leaves no neighbouring pairs alike."""
    pairs = [(s, e) for s in (0, 1, 2, 2**32 - 1) for e in range(6)]
    draws = {p: torch.rand(16, generator=epoch_generator(*p, "cpu")) for p in pairs}
    for p in pairs:
        assert torch.equal(draws[p], torch.rand(16, generator=epoch_generator(*p, "cpu")))
    rows = torch.stack([draws[p] for p in pairs])
    assert torch.unique(rows, dim=0).shape[0] == len(pairs)
    with pytest.raises(ValueError):
        epoch_generator(-1, 0, "cpu")
