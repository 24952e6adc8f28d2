"""Data parallelism of the port (evo_tpu_torch/parallel/) on the CPU.

Unit tests against evo_tpu's functions with no process group, and a
2-rank run over gloo: two worker processes (this file run as a script; see
the end) form a group through a file store, each holding its own rows of
every block as evo_tpu's tests/mp_worker.py builds them, and run Theta^0
from global sums, EA epochs with a checkpoint and a reconstruction, data
with NaNs in rank 0's rows only, and exact-mode epochs.  The parent holds
their results against the port's single-process run and against evo_tpu.

The workers import neither jax nor evo_tpu (each asserts it), so this
module imports them only inside the tests.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 120
_TRIGGERS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the experiment of evo_tpu's tests/mp_worker.py: N rows in nb blocks,
# split over P ranks
N, D, H, S, nb, P = 64, 9, 6, 8, 2, 2
B = N // nb
B_loc = B // P
KINDS = ("bsc", "sssc")
EA_SEED, EPOCHS, REC_EPOCH, CKPT_EPOCH = 7, 5, 3, 4
EA = dict(no_parents=4, no_children=1, no_generations=2, n_blocks=nb)


def _data():
    """Y [N, D] and its copy with 10% NaN in rank 0's rows only."""
    Y = np.random.default_rng(1).normal(size=(N, D)).astype(np.float32)
    Y_inc = Y.copy()
    miss = np.random.default_rng(5).random(Y.shape) < 0.1
    rank0 = np.zeros(N, dtype=bool)
    for b in range(nb):
        rank0[b * B:b * B + B_loc] = True
    Y_inc[miss & rank0[:, None]] = np.nan
    return Y, Y_inc


def _local(Y, rank):
    """Rank ``rank``'s rows: of each block b, global rows b*B + rank*B_loc
    ... b*B + (rank+1)*B_loc (mp_worker.py:57-59)."""
    return np.concatenate([Y[b * B + rank * B_loc:b * B + (rank + 1) * B_loc]
                           for b in range(nb)])


def _mp_order(a):
    """A single-process [N, ...] row array in the ranks' gathered order,
    [rank 0's rows | rank 1's rows] (test_multiprocess.py:158-173)."""
    return np.concatenate([_local(a, p) for p in range(P)])


def _model(kind):
    from evo_tpu_torch import BSC, SSSC

    return (BSC if kind == "bsc" else SSSC)(D=D, H=H, device="cpu")


def _params(kind, arrays, prefix):
    from evo_tpu_torch import BSCParams, SSSCParams

    cls = BSCParams if kind == "bsc" else SSSCParams
    names = ("W", "pi", "sigma", "pies") if kind == "bsc" else ("W", "pies", "mus", "Psi",
                                                                  "sigma2")
    return cls(**{f: torch.as_tensor(np.asarray(arrays[prefix + f])) for f in names})


def _put(out, prefix, params):
    for f, v in vars(params).items():
        out[prefix + f] = v.numpy()


def run(kind, params, estate, data, cfg, out, prefix, reconstruct_at=(), checkpoint=None):
    """EPOCHS (or one, exact) epochs of ``kind`` with the epoch generators
    of EA_SEED, keeping F, the first epoch's states, the parameters and the
    gathered reconstructions in ``out``; with ``checkpoint`` (a path) the
    run is written and read back before epoch CKPT_EPOCH."""
    from evo_tpu_torch.apps.training import gather_reconstruction
    from evo_tpu_torch.models.base import epoch_generator
    from evo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    model, Fs = _model(kind), []
    n_epochs = 1 if cfg.exact else EPOCHS
    for e in range(n_epochs):
        if checkpoint and e == CKPT_EPOCH:
            save_checkpoint(checkpoint, params, estate, e, 9, cfg, model, data)
            p2, e2, epoch, seed = load_checkpoint(checkpoint, params, cfg, model, data)
            assert (epoch, seed) == (e, 9)
            assert all(torch.equal(getattr(p2, f), getattr(params, f)) for f in vars(params))
            assert torch.equal(e2.ss, estate.ss) and torch.equal(e2.lpj, estate.lpj)
            _put(out, prefix + "ckpt/", params)
            out[prefix + "ckpt/ss"] = estate.ss.numpy()
            out[prefix + "ckpt/lpj"] = estate.lpj.numpy()
            params, estate = p2, e2
        rec = e in reconstruct_at or data.incomplete
        params, estate, stats, y_rec = model.em_step(
            params, estate, data, epoch_generator(EA_SEED, e, "cpu"), cfg, do_reconstruction=rec)
        Fs.append(float(stats.F))
        if e == 0:
            out[prefix + "ss0"] = estate.ss.numpy()
        if rec:
            out[prefix + f"rec{e}"] = gather_reconstruction(y_rec, N)
    out[prefix + "F"] = np.asarray(Fs)
    _put(out, prefix, params)


def scenarios(rank, out, expected):
    """Every scenario of the 2-rank run on this rank's rows (with no group,
    on all rows: the parent's single-process run).  Theta^0 of the EA and
    exact runs comes from ``expected`` (the parent's), so that the runs
    differ only where the ranks split the work."""
    from evo_tpu_torch import init_states, make_data
    from evo_tpu_torch.parallel import (distribute_estate, gather_to_host, make_global_data,
                                        make_mesh, replicate, shard_blocked)

    Y, Y_inc = _data()
    ys = {"complete": _local(Y, rank), "incomplete": _local(Y_inc, rank)}
    datas = {tag: make_global_data(y, n_blocks=nb, device="cpu") for tag, y in ys.items()}
    out["incomplete"] = np.asarray([datas[t].incomplete for t in ("complete", "incomplete")])
    mesh = make_mesh("cpu")
    out["mesh"] = np.asarray([mesh.rank, mesh.world_size])
    shard = shard_blocked(make_data(Y_inc, n_blocks=nb, device="cpu"), mesh)
    out["shard_equal"] = np.asarray([torch.equal(getattr(shard, f), getattr(datas["incomplete"], f))
                                     for f in ("y", "x_infr", "x", "row_valid")])
    out["gathered_y"] = gather_to_host(datas["incomplete"].y)
    out["replicated"] = replicate(torch.full((3,), float(rank + 1)), mesh).numpy()
    for kind in KINDS:
        model = _model(kind)
        for tag, data in datas.items():
            _put(out, f"init/{kind}/{tag}/y_host/",
                 model.standard_init(data, seed=0, y_host=ys[tag]))
            _put(out, f"init/{kind}/{tag}/data/", model.standard_init(data, seed=0))
        cfg, estate = init_states(N=N, S=S, H=H, seed=2, device="cpu", **EA)
        run(kind, _params(kind, expected, f"{kind}/complete/"), distribute_estate(estate, "cpu"),
            datas["complete"], cfg, out, f"ea/{kind}/", reconstruct_at=(REC_EPOCH,),
            checkpoint=expected.get("ckpt") and f"{expected['ckpt']}_{kind}.npz")
        cfg, estate = init_states(N=N, S=S, H=H, seed=3, device="cpu", **EA)
        run(kind, _params(kind, expected, f"{kind}/incomplete/"),
            distribute_estate(estate, "cpu"), datas["incomplete"], cfg, out, f"inc/{kind}/")
        cfg, estate = init_states(N=N, S=2**H, H=H, n_blocks=nb, device="cpu")
        for tag in ("complete", "incomplete") if kind == "sssc" else ("complete",):
            run(kind, _params(kind, expected, f"exact/{kind}/{tag}/"),
                distribute_estate(estate, "cpu"), datas[tag], cfg, out, f"exact/{kind}/{tag}/")


def _worker(outdir, rank, world):
    """One rank of the 2-rank run: results to <outdir>/rank<rank>.npz."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from evo_tpu_torch.parallel import init_distributed

    got = init_distributed(backend="gloo", rank=rank, world_size=world,
                           init_method="file://" + os.path.join(outdir, "store"), device="cpu")
    assert got == (rank, world), got
    with np.load(os.path.join(outdir, "expected.npz")) as z:
        expected = dict(z)
    expected["ckpt"] = os.path.join(outdir, "ckpt")
    out = {}
    scenarios(rank, out, expected)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evo_tpu")]
    assert not bad, bad
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def _expected():
    """Theta^0 of every run: the port's single-process standard_init for
    the EA runs, evo_tpu's for the exact runs (held against evo_tpu)."""
    import jax

    from evo_tpu.models.base import make_data as j_make_data
    from evo_tpu.models.bsc import BSC as JBSC
    from evo_tpu.models.sssc import SSSC as JSSSC
    from evo_tpu_torch import make_data

    Y, Y_inc = _data()
    exp = {}
    for kind in KINDS:
        for tag, y in (("complete", Y), ("incomplete", Y_inc)):
            p = _model(kind).standard_init(make_data(y, n_blocks=nb, device="cpu"), seed=0,
                                           y_host=y)
            _put(exp, f"{kind}/{tag}/", p)
            jp = (JBSC if kind == "bsc" else JSSSC)(D=D, H=H).standard_init(
                j_make_data(y, n_blocks=nb), seed=4, y_host=y)
            for f, v in vars(jp).items():
                exp[f"exact/{kind}/{tag}/{f}"] = np.asarray(jax.device_get(v))
    return exp


def _spawn(outdir):
    """Start the P workers; returns the processes and their log files."""
    env = {k: v for k, v in os.environ.items() if k not in _TRIGGERS}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for rank in range(P):
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), outdir,
                                        str(rank), str(P)], env=env, cwd=REPO, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def _wait(procs, outdir):
    """Wait for every worker within WORKER_TIMEOUT_S; on expiry kill them
    all; fail unless every one exited 0."""
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(outdir, f"rank{rank}.log")) as f:
                pytest.fail(f"worker {rank} exited {p.returncode}:\n{f.read()[-4000:]}")


@pytest.fixture(scope="module")
def mp(tmp_path_factory):
    """The ranks' results, the single-process run's (``one``) and
    ``expected``, from one 2-rank run of every scenario."""
    outdir = str(tmp_path_factory.mktemp("ranks"))
    exp = _expected()
    np.savez(os.path.join(outdir, "expected.npz"), **exp)
    procs = _spawn(outdir)
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the workers
    try:
        _single(one, exp)
    finally:
        torch.set_num_threads(threads)
        _wait(procs, outdir)
    ranks = []
    for rank in range(P):
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            ranks.append(dict(z))
    return dict(ranks=ranks, one=one, exp=exp, outdir=outdir)


def _single(one, exp):
    """The single-process run of the same scenarios, with no group."""
    from evo_tpu_torch import init_states, make_data

    Y, Y_inc = _data()
    datas = {"complete": make_data(Y, n_blocks=nb, device="cpu"),
             "incomplete": make_data(Y_inc, n_blocks=nb, device="cpu")}
    for kind in KINDS:
        cfg, estate = init_states(N=N, S=S, H=H, seed=2, device="cpu", **EA)
        run(kind, _params(kind, exp, f"{kind}/complete/"), estate, datas["complete"], cfg, one,
            f"ea/{kind}/", reconstruct_at=(REC_EPOCH,))
        cfg, estate = init_states(N=N, S=S, H=H, seed=3, device="cpu", **EA)
        run(kind, _params(kind, exp, f"{kind}/incomplete/"), estate, datas["incomplete"], cfg,
            one, f"inc/{kind}/")


# ------------------------------------------------------- without a group


def test_init_distributed_without_a_group_is_a_noop(monkeypatch):
    from evo_tpu_torch.parallel import distributed, init_distributed

    for k in _TRIGGERS:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed() == (0, 1)
    assert init_distributed(backend="gloo") == (0, 1)  # again: still nothing
    assert not distributed.active() and distributed.rank_world() == (0, 1)
    assert distributed.block_rows(16) is None


def test_process_device_is_the_local_rank_card(monkeypatch):
    """A card named without an index is this process's: cuda:{LOCAL_RANK %
    device_count}; the CPU stays the CPU; no card raises."""
    from evo_tpu_torch.parallel import process_device

    assert process_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    for dev in (None, "cuda"):
        assert process_device(dev) == torch.device("cuda", 1)
    assert process_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        process_device()


def test_no_group_issues_no_collective(monkeypatch):
    """With no group an epoch of either model issues no collective and the
    sums pass through as the same objects."""
    from evo_tpu_torch import init_states, make_data
    from evo_tpu_torch.models.base import epoch_generator
    from evo_tpu_torch.parallel import distributed

    def refuse(*a, **k):
        raise AssertionError("a collective was issued with no group")

    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    d = {"a": torch.ones(2)}
    assert distributed.allreduce_sums(d)[0] is d
    Y = _data()[0]
    for kind in KINDS:
        cfg, estate = init_states(N=N, S=S, H=H, seed=2, device="cpu", **EA)
        model = _model(kind)
        data = make_data(Y, n_blocks=nb, device="cpu")
        params = model.standard_init(data, seed=0)
        model.em_step(params, estate, data, epoch_generator(0, 0, "cpu"), cfg)


def test_make_global_data_one_rank_equals_make_data():
    from evo_tpu_torch import make_data
    from evo_tpu_torch.parallel import make_global_data

    for Y in _data():
        want = make_data(Y, n_blocks=nb, device="cpu")
        got = make_global_data(Y, n_blocks=nb, device="cpu")
        for f in ("y", "x_infr", "x", "row_valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert got.incomplete == want.incomplete
    with pytest.raises(ValueError, match="multiple of n_blocks"):
        make_global_data(Y[:N - 1], n_blocks=nb, device="cpu")


def test_deinterleave_processes_matches_evo_tpu():
    from evo_tpu.apps.training import deinterleave_processes as j_deinterleave
    from evo_tpu_torch.apps.training import deinterleave_processes

    a = np.random.default_rng(0).normal(size=(2, 12, 5))
    for P_ in (1, 2, 3, 4):
        np.testing.assert_array_equal(deinterleave_processes(a, P_), j_deinterleave(a, P_))
    with pytest.raises(ValueError, match="multiple"):
        deinterleave_processes(a, 5)


@pytest.mark.parametrize("incomplete", [False, True])
def test_global_init_stats_one_rank_matches_evo_tpu(incomplete):
    """evo_tpu's test_distributed.py:133-163: through y_host and through
    the data, the port's global_init_stats equals evo_tpu's."""
    from evo_tpu.models.base import make_data as j_make_data
    from evo_tpu.parallel.distributed import global_init_stats as j_stats
    from evo_tpu_torch import make_data
    from evo_tpu_torch.parallel import global_init_stats

    Y = _data()[1 if incomplete else 0]
    want = j_stats(j_make_data(Y, n_blocks=nb), y_host=Y, D=D)
    data = make_data(Y, n_blocks=nb, device="cpu")
    for got in (global_init_stats(data, y_host=Y, D=D), global_init_stats(data, D=D)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert want[0] == N and (want[3] < N * D) == incomplete


# ---------------------------------------------------------- two ranks


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tag", ["complete", "incomplete"])
def test_two_ranks_global_theta0_matches_evo_tpu(mp, kind, tag):
    """Theta^0 from global sums, with and without y_host, is the same on
    both ranks and equals evo_tpu's single-process standard_init on all
    rows; with NaNs in rank 0's rows only both ranks' data are incomplete."""
    from evo_tpu.models.base import make_data as j_make_data
    from evo_tpu.models.bsc import BSC as JBSC
    from evo_tpu.models.sssc import SSSC as JSSSC

    r0, r1 = mp["ranks"]
    for r in (r0, r1):
        assert r["incomplete"].tolist() == [False, True]
    y = _data()[tag == "incomplete"]
    want = (JBSC if kind == "bsc" else JSSSC)(D=D, H=H).standard_init(
        j_make_data(y, n_blocks=nb), seed=0, y_host=y)
    for src in ("y_host", "data"):
        prefix = f"init/{kind}/{tag}/{src}/"
        for f, w in vars(want).items():
            np.testing.assert_array_equal(r0[prefix + f], r1[prefix + f])
            np.testing.assert_allclose(r0[prefix + f], np.asarray(w), rtol=1e-4, atol=1e-5,
                                       err_msg=prefix + f)


def test_two_rank_mesh_helpers(mp):
    """mesh.py over 2 ranks: make_mesh reads the group, shard_blocked of
    the whole data equals make_global_data of the rank's rows,
    gather_to_host gives every rank the global blocked layout (make_data's
    of all rows), replicate broadcasts rank 0's tensor."""
    from evo_tpu_torch import make_data

    want = make_data(_data()[1], n_blocks=nb, device="cpu").y.numpy()
    for rank, r in enumerate(mp["ranks"]):
        assert r["mesh"].tolist() == [rank, P]
        assert r["shard_equal"].all()
        np.testing.assert_array_equal(r["gathered_y"], want)
        np.testing.assert_array_equal(r["replicated"], np.full(3, 1.0, np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_run_matches_one_rank(mp, kind):
    """Five EA epochs (a checkpoint written and read before the fifth, a
    reconstruction in the fourth) and an epoch on incomplete data: both
    ranks bit for bit alike, F within rtol 2e-4 of the single-process run,
    W within rtol 1e-3, atol 1e-4 (test_multiprocess.py:146-155)."""
    r0, r1, one = *mp["ranks"], mp["one"]
    for key in r0:
        if key.startswith((f"ea/{kind}/", f"inc/{kind}/", f"exact/{kind}/")) and not (
                key.endswith(("ss0", "ckpt/ss", "ckpt/lpj"))):
            np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    for prefix in (f"ea/{kind}/", f"inc/{kind}/"):
        np.testing.assert_allclose(r0[prefix + "F"], one[prefix + "F"], rtol=2e-4)
        np.testing.assert_allclose(r0[prefix + "W"], one[prefix + "W"], rtol=1e-3, atol=1e-4)
    assert len(r0[f"ea/{kind}/F"]) == EPOCHS


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_first_epoch_states_bit_for_bit(mp, kind):
    """The first epoch's states of each rank equal the single-process
    run's rows of that rank bit for bit: a row's EA draws depend on (seed,
    epoch, block, global row), not on the number of ranks."""
    one = mp["one"]
    for prefix in (f"ea/{kind}/", f"inc/{kind}/"):
        for rank, r in enumerate(mp["ranks"]):
            want = one[prefix + "ss0"][:, rank * B_loc:(rank + 1) * B_loc]
            np.testing.assert_array_equal(r[prefix + "ss0"], want, err_msg=prefix)


@pytest.mark.parametrize("kind", KINDS)
def test_two_rank_reconstruction_in_evo_tpu_order(mp, kind):
    """The gathered reconstruction comes back de-interleaved, [rank 0's
    rows | rank 1's rows], on both ranks (test_multiprocess.py:158-173)."""
    r0, r1, one = *mp["ranks"], mp["one"]
    for key in (f"ea/{kind}/rec{REC_EPOCH}", f"inc/{kind}/rec0"):
        np.testing.assert_array_equal(r0[key], r1[key])
        assert r0[key].shape == (N, D)
        np.testing.assert_allclose(r0[key], _mp_order(one[key]), rtol=1e-3, atol=1e-4)
    obs = ~np.isnan(_data()[1])
    np.testing.assert_array_equal(r0[f"inc/{kind}/rec0"][_mp_order(obs)],
                                  _mp_order(_data()[1])[_mp_order(obs)])


def test_two_rank_checkpoint_loads_in_evo_tpu_and_one_process(mp):
    """The checkpoint the 2 ranks wrote (before their fifth epoch) holds the
    global layout: evo_tpu's single-process load_checkpoint and the port's
    give the ranks' params and, with each block's rows [rank 0 | rank 1],
    their states."""
    import jax

    from evo_tpu.models.bsc import BSCParams as JBSCParams
    from evo_tpu.models.sssc import SSSCParams as JSSSCParams
    from evo_tpu.utils.checkpoint import load_checkpoint as j_load
    from evo_tpu_torch.utils.checkpoint import load_checkpoint

    r0, r1 = mp["ranks"]
    for kind in KINDS:
        path = os.path.join(mp["outdir"], f"ckpt_{kind}.npz")
        prefix = f"ea/{kind}/ckpt/"
        ss = np.concatenate([r0[prefix + "ss"], r1[prefix + "ss"]], axis=1)
        lpj = np.concatenate([r0[prefix + "lpj"], r1[prefix + "lpj"]], axis=1)
        like_t = _params(kind, r0, prefix)
        jcls = JBSCParams if kind == "bsc" else JSSSCParams
        like_j = jcls(**{f: np.asarray(v) for f, v in vars(like_t).items()})
        jp, je, jepoch, _ = j_load(path, like_j)
        tp, te, tepoch, seed = load_checkpoint(path, like_t)
        assert jepoch == tepoch == CKPT_EPOCH and seed == 9
        for f in vars(like_t):
            np.testing.assert_array_equal(np.asarray(jax.device_get(getattr(jp, f))),
                                          r0[prefix + f])
            np.testing.assert_array_equal(getattr(tp, f).numpy(), r0[prefix + f])
        for got in (np.asarray(je.ss), te.ss.numpy()):
            np.testing.assert_array_equal(got, ss)
        for got in (np.asarray(je.lpj), te.lpj.numpy()):
            np.testing.assert_array_equal(got, lpj)


@pytest.mark.parametrize("kind,tag", [("bsc", "complete"), ("sssc", "complete"),
                                      ("sssc", "incomplete")])
def test_two_rank_exact_epoch_matches_evo_tpu(mp, kind, tag):
    """One exact-mode epoch (S = 2^H) over 2 ranks against evo_tpu's
    single-process exact epoch from the same Theta^0: F within rtol 1e-5,
    W within rtol 1e-4, atol 1e-5 (test_sharding.py:43-44); on incomplete
    data with the reconstruction, gathered in the ranks' order."""
    import jax

    from evo_tpu import init_states as j_init_states
    from evo_tpu.models.base import make_data as j_make_data
    from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JBSCParams
    from evo_tpu.models.sssc import SSSC as JSSSC, SSSCParams as JSSSCParams

    r0 = mp["ranks"][0]
    y = _data()[tag == "incomplete"]
    model = (JBSC if kind == "bsc" else JSSSC)(D=D, H=H)
    cls = JBSCParams if kind == "bsc" else JSSSCParams
    params = cls(**{f.name: mp["exp"][f"exact/{kind}/{tag}/{f.name}"]
                    for f in dataclasses.fields(cls)})
    cfg, estate = j_init_states(N=N, S=2**H, H=H, n_blocks=nb)
    p, _, stats, y_rec = model.em_step(params, estate, j_make_data(y, n_blocks=nb),
                                       jax.random.key(0), cfg,
                                       do_reconstruction=tag == "incomplete")
    prefix = f"exact/{kind}/{tag}/"
    np.testing.assert_allclose(r0[prefix + "F"][0], float(stats.F), rtol=1e-5)
    np.testing.assert_allclose(r0[prefix + "W"], np.asarray(p.W), rtol=1e-4, atol=1e-5)
    if tag == "incomplete":
        np.testing.assert_allclose(r0[prefix + "rec0"],
                                   _mp_order(np.asarray(y_rec).reshape(-1, D)),
                                   rtol=1e-4, atol=1e-5)


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
