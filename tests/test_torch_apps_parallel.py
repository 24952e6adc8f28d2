"""The port's apps over 2 ranks on the CPU, launched as torchrun launches
them.

Two worker processes (this file run as a script; see the end) get
torchrun's variables and EVO_PLATFORM=cpu, bring the group up through the
apps' ``platform_device()`` and run the apps' own ``build`` and
``EMTrainer``: the bars test (EBSC and ES3C) and ES3C denoising at a row
count that does not split evenly over 2 ranks and their blocks, the
feature-learning app, an exact-mode bars epoch, and the bars and
feature-learning CLIs with an output directory for each rank.  The parent
holds their results against the same flags in one process with no group
and ``pad_multiple=2`` (the same padded rows), and the exact epoch against
evo_tpu's single-process epoch on the same padded data.

The workers import neither jax nor evo_tpu (each asserts it), so this
module imports them only inside the tests.
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_dist_env import REPO, start_ranks, wait_ranks

P = 2
WORKER_TIMEOUT_S = 120
# 102 rows in 2 blocks: 104 with padding, each rank 26 rows of a block and
# the 2 padding rows rank 1's
BARS = {algo: [algo, "--no_data_points", "102", "--n_blocks", "2", "--no_epochs", "4",
               "--Ksize", "10", "--no_parents", "4"] for algo in ("ebsc", "es3c")}
EXACT = ["ebsc", "-H", "8", "--Ksize", "256", "--no_data_points", "102", "--n_blocks", "2",
         "--no_epochs", "1"]
# --rescale 0.1: the synthetic 25 x 25 image, 441 patches of 5 x 5
DENOISE = ["denoising", "es3c", "--rescale", "0.1", "--no_epochs", "3", "--merge_every", "1",
           "-H", "12", "--Ksize", "10", "--no_parents", "4", "--clean_image", "/nonexistent.png"]
FEATURE = ["--model", "sssc", "-H", "6", "--Ksize", "5", "--no_epochs", "3", "--no_parents", "3",
           "--no_children", "1"]
FEATURE_N = 301


def train(b, seed, n_epochs, reconstruct_at=None, callback=None):
    """``build``'s pieces through EMTrainer with a DataLog of no handler:
    F per epoch, the first epoch's states, the final parameters."""
    from evo_tpu_torch.apps.training import EMTrainer
    from evo_tpu_torch.utils.datalog import DataLog

    out = {"F": []}
    tr = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], DataLog(),
                   os.devnull, seed=seed)

    def cb(epoch, F, **kw):
        out["F"].append(F)
        if epoch == 1:
            out["ss0"] = tr.estate.ss.numpy().copy()
        if callback is not None:
            callback(epoch=epoch, F=F, **kw)

    params, _, _ = tr.run(n_epochs, reconstruct_at=reconstruct_at, epoch_callback=cb)
    out["F"] = np.asarray(out["F"])
    out.update({f"p/{k}": v.numpy() for k, v in vars(params).items()})
    return out


def _put(res, prefix, d):
    res.update({prefix + k: v for k, v in d.items()})


def scenarios(pad_multiple):
    """Every driven scenario on this process's rows (all rows with no
    group): {name: array}."""
    from evo_tpu_torch.apps import bars, feature_learning, images
    from evo_tpu_torch.utils.datalog import DataLog

    cpu, res = torch.device("cpu"), {}
    for algo, argv in BARS.items():
        args = bars.get_args(argv)
        b = bars.build(args, cpu, pad_multiple=pad_multiple)
        res[f"{algo}/L_gen"] = np.asarray(b["L_gen"])
        _put(res, f"{algo}/", train(b, args.seed + 1, args.no_epochs))

    args = bars.get_args(EXACT)
    b = bars.build(args, cpu, pad_multiple=pad_multiple)
    assert b["cfg"].exact
    _put(res, "exact/theta0/", {k: v.numpy() for k, v in vars(b["params"]).items()})
    _put(res, "exact/", train(b, args.seed + 1, 1))

    args = images.get_args(DENOISE)
    clean = images.get_image(args.clean_image, args.rescale)
    noisy = images.add_noise(clean, args)
    b = images.build(args, clean, noisy, None, cpu, pad_multiple=pad_multiple)
    callback, last = images.make_epoch_callback(args, b, clean, DataLog(), cpu)
    assert last["route"] == "full"
    merges = {"psnr": [], "rec": []}

    def keep(**kw):
        callback(**kw)
        merges["psnr"].append(last["psnr"])
        merges["rec"].append(last["rec"])

    _put(res, "denoise/", train(b, args.seed + 1, args.no_epochs, b["reconstruct_at"], keep))
    res["denoise/N"] = np.asarray(b["N"])
    res["denoise/psnr"], res["denoise/rec"] = np.asarray(merges["psnr"]), np.stack(merges["rec"])

    args = feature_learning.get_args(FEATURE)
    rng = np.random.default_rng(5)
    Y = rng.normal(size=(FEATURE_N, 16)).astype(np.float32)
    b = feature_learning.build(args, Y, cpu, pad_multiple=pad_multiple)
    _put(res, "feature/", train(b, args.seed + 1, args.no_epochs))
    return res


def cli_runs(outdir, rank):
    """The bars and feature-learning CLIs with this rank's own output
    directory (rank 0's stays the one that is written) and a patch file
    that rank 0 writes and both read: their final F and parameters."""
    from evo_tpu_torch.apps import bars, feature_learning

    res = {}
    r = bars.main(BARS["ebsc"] + ["--viz_every", "4", "--checkpoint_every", "2",
                                  "--output_directory", os.path.join(outdir, f"bars{rank}")])
    res["cli/bars/F"] = np.asarray(r["F"])
    res.update({f"cli/bars/p/{k}": v.numpy() for k, v in vars(r["params"]).items()})
    r = feature_learning.main(FEATURE + [
        "--viz_every", "3", "--data_file", os.path.join(outdir, "data", "patches.npz"),
        "--output_directory", os.path.join(outdir, f"fl{rank}")])
    res["cli/fl/F"] = np.asarray(r["F"])
    res.update({f"cli/fl/p/{k}": v.numpy() for k, v in vars(r["params"]).items()})
    return res


def _worker(outdir):
    """One rank: the group from torchrun's variables through
    platform_device(), every scenario, results to <outdir>/rank<r>.npz."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from evo_tpu_torch.apps.common import platform_device
    from evo_tpu_torch.parallel import distributed

    assert platform_device() == torch.device("cpu")
    rank, world = distributed.rank_world()
    assert world == P and rank == int(os.environ["RANK"])
    res = scenarios(pad_multiple=1)
    res.update(cli_runs(outdir, rank))
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evo_tpu")]
    assert not bad, bad
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and this process's (``one``: no group,
    pad_multiple=2), made while the ranks run."""
    outdir = str(tmp_path_factory.mktemp("apps_ranks"))
    procs = start_ranks(os.path.abspath(__file__), [outdir], outdir)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the workers
    try:
        one = scenarios(pad_multiple=2)
    finally:
        torch.set_num_threads(threads)
        wait_ranks(procs, outdir, WORKER_TIMEOUT_S)
    ranks = []
    for rank in range(P):
        with np.load(os.path.join(outdir, f"rank{rank}.npz")) as z:
            ranks.append(dict(z))
    return dict(ranks=ranks, one=one, outdir=outdir)


@pytest.mark.parametrize("name", ["ebsc", "es3c", "denoise", "feature"])
def test_two_ranks_match_one_process_with_the_same_padding(runs, name):
    """F per epoch within rtol 2e-4 and W within rtol 1e-3, atol 1e-4 of
    one process with pad_multiple=2 (test_torch_parallel.py's tolerances),
    both ranks bit for bit alike, over row counts that do not split evenly
    (bars: 102 rows in 2 blocks; feature learning: 301 in one)."""
    r0, r1, one = *runs["ranks"], runs["one"]
    keys = [k for k in one if k.startswith(name + "/") and not k.endswith("ss0")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    np.testing.assert_allclose(r0[f"{name}/F"], one[f"{name}/F"], rtol=2e-4)
    np.testing.assert_allclose(r0[f"{name}/p/W"], one[f"{name}/p/W"], rtol=1e-3, atol=1e-4)
    if f"{name}/L_gen" in one:
        np.testing.assert_allclose(r0[f"{name}/L_gen"], one[f"{name}/L_gen"], rtol=1e-6)


@pytest.mark.parametrize("name", ["ebsc", "es3c", "denoise", "feature"])
def test_two_ranks_first_epoch_states_bit_for_bit(runs, name):
    """Each rank's first-epoch states are its rows of the one-process
    run's (pad_multiple=2) bit for bit, the padding rows among rank 1's."""
    one = runs["one"][f"{name}/ss0"]
    Bl = one.shape[1] // P
    for rank, r in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(r[f"{name}/ss0"], one[:, rank * Bl:(rank + 1) * Bl])


def test_two_rank_denoising_merge_matches_one_process(runs):
    """ES3C denoising of 441 patches (odd) over 2 ranks: the reconstruction
    gathered in Y's row order and merged on the host every epoch gives the
    one-process image within rtol 1e-3, atol 1e-4 and its PSNR within
    rtol 2e-4."""
    r0, one = runs["ranks"][0], runs["one"]
    assert int(one["denoise/N"]) == 441 and r0["denoise/rec"].shape == (3, 25, 25)
    np.testing.assert_allclose(r0["denoise/rec"], one["denoise/rec"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(r0["denoise/psnr"], one["denoise/psnr"], rtol=2e-4)
    assert np.isfinite(r0["denoise/psnr"]).all()


def test_two_rank_exact_bars_epoch_matches_evo_tpu(runs):
    """The bars app in exact mode (-H 8 --Ksize 256) over 2 ranks: one
    epoch's F within rtol 1e-5 and W within rtol 1e-4, atol 1e-5
    (test_sharding.py:43-44) of evo_tpu's single-process em_step on
    make_data(Y, n_blocks=2, pad_multiple=2) from the ranks' Theta^0."""
    import jax

    from evo_tpu import init_states as j_init_states
    from evo_tpu.models import make_data as j_make_data
    from evo_tpu.models.bsc import BSC as JBSC, BSCParams as JBSCParams
    from evo_tpu_torch.apps import bars
    from evo_tpu_torch.convert import params_to_numpy
    from evo_tpu_torch.models.bsc import BSCParams

    r0 = runs["ranks"][0]
    args = bars.get_args(EXACT)
    Y = bars.build(args, torch.device("cpu"))["Y"]
    theta0 = BSCParams(**{f: torch.as_tensor(r0[f"exact/theta0/{f}"])
                          for f in ("W", "pi", "sigma", "pies")})
    data = j_make_data(Y, n_blocks=2, pad_multiple=2)
    cfg, estate = j_init_states(N=104, S=256, H=8, n_blocks=2)
    D = (args.H // 2) ** 2
    p, _, stats, _ = JBSC(D=D, H=args.H).em_step(JBSCParams(**params_to_numpy(theta0)), estate,
                                                 data, jax.random.key(0), cfg)
    np.testing.assert_allclose(r0["exact/F"][0], float(stats.F), rtol=1e-5)
    np.testing.assert_allclose(r0["exact/p/W"], np.asarray(p.W), rtol=1e-4, atol=1e-5)


def test_two_rank_clis_rank0_alone_writes(runs):
    """The bars and feature-learning CLIs over 2 ranks, each rank told its
    own output directory: rank 0's holds the run's files (training.h5,
    terminal.txt, the figures, the checkpoint), rank 1's is never made; the
    patch file rank 0 wrote is the synthetic one; both ranks end with the
    same F and parameters."""
    from evo_tpu_torch.apps import feature_learning

    out, (r0, r1) = runs["outdir"], runs["ranks"]
    for app in ("bars", "fl"):
        assert not os.path.exists(os.path.join(out, f"{app}1"))
        files = set(os.listdir(os.path.join(out, f"{app}0")))
        assert {"training.h5", "terminal.txt"} <= files
        assert any(f.endswith(".png") for f in files), files
        for k in r0:
            if k.startswith(f"cli/{app}/"):
                np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert "checkpoint.npz" in os.listdir(os.path.join(out, "bars0"))
    with open(os.path.join(out, "bars0", "terminal.txt")) as f:
        assert f.read().count("Hyperparameters used:") == 1
    want = feature_learning.synthetic_patchfile(os.path.join(out, "want.npz"))
    with np.load(want) as w, np.load(os.path.join(out, "data", "patches.npz")) as g:
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("app", ["bars", "feature", "denoise", "inpaint"])
def test_one_process_build_is_the_single_process_recipe(app):
    """With no group and pad_multiple 1 each app's build gives what make_data,
    standard_init(y_host=Y) and init_states of all rows give, bit for bit
    (the apps' build before rows were split over ranks)."""
    from evo_tpu_torch import init_states, make_data
    from evo_tpu_torch.apps import bars, feature_learning, images

    cpu = torch.device("cpu")
    if app == "bars":
        args = bars.get_args(BARS["es3c"])
        b = bars.build(args, cpu)
        Y, x = b["Y"], None
    elif app == "feature":
        args = feature_learning.get_args(FEATURE)
        Y, x = np.random.default_rng(5).normal(size=(FEATURE_N, 16)).astype(np.float32), None
        b = feature_learning.build(args, Y, cpu)
    else:
        args = images.get_args(DENOISE if app == "denoise" else
                               ["inpainting", "es3c", "--rescale", "0.1", "-H", "8",
                                "--n_blocks", "2", "--clean_image", "/nonexistent.png"])
        clean = images.get_image(args.clean_image, args.rescale)
        corrupted = (images.add_noise(clean, args) if app == "denoise"
                     else images.remove_values(clean, args))
        x = None if app == "denoise" else images.observed(corrupted, args)
        b = images.build(args, clean, corrupted, x, cpu)
        Y = b["Y"]
        x = np.zeros_like(Y, dtype=bool) if x is None else x
    data = make_data(Y, x=x, n_blocks=args.n_blocks, device=cpu)
    params = b["model"].standard_init(data, seed=args.seed, y_host=Y)
    cfg, estate = init_states(
        N=data.y.shape[0] * data.y.shape[1], S=args.Ksize, H=args.H,
        parent_selection=args.parent_selection, mutation_algorithm=args.mutation_algorithm,
        no_parents=args.no_parents, no_children=args.no_children,
        no_generations=args.no_generations, bitflip_prob=args.bitflip_prob,
        n_blocks=args.n_blocks, seed=args.seed, device=cpu)
    assert b["cfg"] == cfg and b["data"].incomplete == data.incomplete
    for got, want in ((b["data"], data), (b["params"], params), (b["estate"], estate)):
        for f, v in vars(want).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(getattr(got, f), v), f


if __name__ == "__main__":
    _worker(sys.argv[1])
