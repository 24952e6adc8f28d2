"""The port's image denoising, inpainting and feature-learning apps on the
CPU (EVO_PLATFORM=cpu): their inputs against evo_tpu's bit for bit (the
synthetic images, the noisy and MCAR-corrupted images drawn from the
seed, the patch matrix, its DC, the x mask and the synthetic patch file),
Theta^0 to f32, the host merge and its PSNR against evo_tpu's on the same
reconstruction, the counterparts of tests/test_apps.py's image and
feature-learning runs, and the two CLIs against the examples' flags."""

import argparse
import importlib.util
import os
import sys

import h5py
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import evo_tpu.apps.images as jimages
from evo_tpu.apps import feature_learning as jfeature_learning
from evo_tpu.apps.training import gather_reconstruction as j_gather_reconstruction
from evo_tpu.models.bsc import BSC as JBSC
from evo_tpu.models.sssc import SSSC as JSSSC
from evo_tpu.prepost import psnr as j_psnr
from evo_tpu.utils.datalog import DataLog as JDataLog
from evo_tpu_torch.apps import feature_learning, images
from evo_tpu_torch.apps.common import stdout_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("EVO_PLATFORM", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's many small ops: the tier-1
    run's workers share the cores, and a thread pool per worker
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns(**kw):
    return argparse.Namespace(**kw)


def _common(**over):
    base = dict(output_directory=None, Ksize=10, parent_selection="fit",
                mutation_algorithm="randflip", no_parents=5, no_children=1,
                no_generations=1, bitflip_prob=None, no_epochs=4, seed=0, n_blocks=1,
                checkpoint_every=0, resume=None, viz_every=100, gif_framerate=None)
    base.update(over)
    return base


def _image_args(task, algo, **over):
    base = dict(algo=algo, clean_image="/nonexistent.png", rescale=0.25, patch_height=5,
                patch_width=None, H=12, merge_every=2, save_theta_all_epochs=False)
    if task == "denoising":
        base.update(noise_level=25.0)
    else:
        base.update(percentage_missing=0.15)
    base.update({k: v for k, v in over.items() if k in base})
    return _ns(**base, **_common(**{k: v for k, v in over.items() if k not in base}))


def _rgb_file(tmp_path):
    g = images.synthetic_image(36)
    rgb = np.stack([g, np.roll(g, 5, axis=0), np.roll(g, 9, axis=1)], axis=2).astype(np.uint8)
    from PIL import Image

    path = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(path)
    return path


def test_synthetic_image_matches_evo_tpu():
    for size in (36, 64, 128, 256):
        np.testing.assert_array_equal(images.synthetic_image(size),
                                      jimages.synthetic_image(size))
    np.testing.assert_array_equal(images.get_image("/nonexistent.png", 0.4),
                                  jimages.get_image("/nonexistent.png", 0.4))


class _Stop(Exception):
    pass


def _evo_inputs(args, task, monkeypatch, tmp_path):
    """What evo_tpu's app hands its experiment (clean, corrupted, x_keep)
    and what that makes of them (Y and x given to make_data, Theta^0),
    stopped before the initial states."""
    seen = {}
    run_patch = jimages._run_patch_experiment

    def capture_experiment(args, clean, corrupted, x_keep, name):
        seen.update(clean=clean, corrupted=corrupted, x_keep=x_keep)
        return run_patch(args, clean, corrupted, x_keep, name)

    def capture_data(Y, x=None, **kw):
        seen.update(Y=np.array(Y), x=np.array(x))
        return make_data(Y, x=x, **kw)

    def capture_init(cls):
        init = cls.standard_init

        def standard_init(self, *a, **kw):
            seen["params"] = init(self, *a, **kw)
            return seen["params"]
        return standard_init

    def stop(*_, **__):
        raise _Stop

    make_data = jimages.make_data
    monkeypatch.setattr(jimages, "_run_patch_experiment", capture_experiment)
    monkeypatch.setattr(jimages, "make_data", capture_data)
    monkeypatch.setattr(jimages, "setup_experiment", lambda a, n: (JDataLog(), str(tmp_path)))
    monkeypatch.setattr(jimages, "init_states", stop)
    for cls in (JBSC, JSSSC):
        monkeypatch.setattr(cls, "standard_init", capture_init(cls))
    with pytest.raises(_Stop):
        (jimages.run_denoising if task == "denoising" else jimages.run_inpainting)(args)
    return seen


@pytest.mark.parametrize("task,algo,rgb", [("denoising", "ebsc", False),
                                           ("denoising", "es3c", False),
                                           ("inpainting", "es3c", False),
                                           ("inpainting", "ebsc", True)])
def test_inputs_and_theta0_match_evo_tpu(task, algo, rgb, monkeypatch, tmp_path):
    over = dict(clean_image=_rgb_file(tmp_path), rescale=1.0, patch_height=4) if rgb else {}
    args = _image_args(task, algo, **over)
    want = _evo_inputs(args, task, monkeypatch, tmp_path)
    clean = images.get_image(args.clean_image, args.rescale)
    if task == "denoising":
        corrupted, x_keep = images.add_noise(clean, args), None
    else:
        corrupted = images.remove_values(clean, args)
        x_keep = images.observed(corrupted, args)
        np.testing.assert_array_equal(x_keep, want["x_keep"])
    np.testing.assert_array_equal(clean, want["clean"])
    np.testing.assert_array_equal(corrupted, want["corrupted"])
    b = images.build(args, clean, corrupted, x_keep, CPU)
    np.testing.assert_array_equal(b["Y"], want["Y"])
    np.testing.assert_array_equal(b["data"].x.reshape(want["x"].shape).numpy(), want["x"])
    raw = (jimages.MultiDimOverlappingPatches if rgb else jimages.OverlappingPatches)(
        want["corrupted"], args.patch_height, args.patch_height, 1).get().T
    np.testing.assert_array_equal(raw - b["dc"], want["Y"])  # the same DC centring
    for name in vars(b["params"]):
        np.testing.assert_allclose(getattr(b["params"], name).numpy(),
                                   np.asarray(getattr(want["params"], name)), rtol=1e-6,
                                   atol=1e-7)


def test_synthetic_patchfile_matches_evo_tpu(tmp_path):
    a = feature_learning.synthetic_patchfile(str(tmp_path / "a.npz"), N=300, ph=6, pw=5, seed=2)
    b = jfeature_learning.synthetic_patchfile(str(tmp_path / "b.npz"), N=300, ph=6, pw=5, seed=2)
    with np.load(a) as fa, np.load(b) as fb:
        assert set(fa.files) == set(fb.files)
        for key in fa.files:
            np.testing.assert_array_equal(fa[key], fb[key])
    Y, ph, pw, C = feature_learning.load_patches(a)
    assert Y.shape == (300, 30) and Y.dtype == np.float32 and (ph, pw, C) == (6, 5, 1)


@pytest.mark.parametrize("rgb", [False, True])
def test_host_merge_and_readbacks_match_evo_tpu(rgb, tmp_path):
    """The same y_rec (observed entries the data, the missing ones random)
    gives evo_tpu's merged images and PSNR through the port's full and
    compact read-backs, which are equal bit for bit."""
    over = dict(clean_image=_rgb_file(tmp_path), rescale=1.0, patch_height=4) if rgb else {}
    args = _image_args("inpainting", "ebsc", n_blocks=3, **over)
    clean = images.get_image(args.clean_image, args.rescale)
    corrupted = images.remove_values(clean, args)
    b = images.build(args, clean, corrupted, images.observed(corrupted, args), CPU)
    data = b["data"]
    est = torch.from_numpy(np.random.default_rng(1).normal(size=data.y.shape).astype(np.float32))
    y_rec = torch.where(data.x, data.y, est)
    full = images.full_readback(b, y_rec)
    np.testing.assert_array_equal(images.compact_reader(b, CPU)(y_rec), full)
    Y_j = j_gather_reconstruction(jnp.asarray(y_rec.numpy()), b["N"]) + b["dc"]
    np.testing.assert_array_equal(full, Y_j)
    got = images.host_merge(b, clean, full)
    ovp_j = (jimages.MultiDimOverlappingPatches if rgb else jimages.OverlappingPatches)(
        corrupted, args.patch_height, args.patch_height, 1)
    for name, merger in (("mean", jimages.mean_merger), ("median", jimages.median_merger)):
        img = ovp_j.set_and_merge(Y_j.T, merge_method=merger)
        np.testing.assert_array_equal(got[name][0], img)
        assert got[name][1] == j_psnr(clean, img, data_range=255.0)


def test_denoising_app_improves_psnr(tmp_path):
    args = _image_args("denoising", "ebsc", H=16, merge_every=4, no_epochs=8, Ksize=12,
                       no_parents=6, output_directory=str(tmp_path / "out"))
    out = images.run_denoising(args)
    clean = images.synthetic_image(64)
    psnr_noisy = images.psnr(clean, images.add_noise(clean, args), 255.0)
    assert out["psnr"] > psnr_noisy + 1.0, (out["psnr"], psnr_noisy)
    with h5py.File(os.path.join(out["outdir"], "training.h5"), "r") as f:
        assert f["F"].shape == (8,) and f["W"].shape[0] == 1  # Theta overwritten
        assert f["psnr_mean"].shape == (3,)  # epochs 1, 4 and 8
    assert not isinstance(sys.stdout, stdout_logger)


def test_inpainting_app_fills_missing(tmp_path):
    args = _image_args("inpainting", "es3c", H=16, Ksize=12, no_parents=6,
                       output_directory=str(tmp_path / "out"))
    out = images.run_inpainting(args)
    assert out["psnr"] is not None and np.isfinite(out["psnr"])
    assert np.isfinite(out["rec"]).all() and np.isfinite(out["F"])
    assert out["params"].Psi.shape == (16, 16)


def test_inpainting_rgb_per_channel_missing(tmp_path):
    """RGB inpainting with MCAR per channel entry: observed values pass the
    reconstruction and merge unchanged, missing ones are filled."""
    path = _rgb_file(tmp_path)
    args = _image_args("inpainting", "es3c", clean_image=path, rescale=1.0, patch_height=4,
                       no_epochs=3, output_directory=str(tmp_path / "out"))
    out = images.run_inpainting(args)
    rec = out["rec"]
    clean = images.get_image(path)
    assert rec.shape == clean.shape and np.isfinite(rec).all()
    miss = np.random.default_rng(args.seed).random(clean.shape) < 0.15
    per_pixel = miss.sum(axis=2)
    assert ((per_pixel > 0) & (per_pixel < 3)).any()
    assert np.allclose(rec[~miss], clean[~miss], atol=1e-3)


@pytest.mark.parametrize("model", ["bsc", "sssc"])
def test_feature_learning_app(model, tmp_path):
    path = str(tmp_path / "patches.npz")
    feature_learning.synthetic_patchfile(path, N=200, ph=5, pw=5)
    args = _ns(data_file=path, model=model, H=10, sort_gfs=model == "bsc",
               **_common(no_epochs=3, Ksize=8, no_parents=4,
                         output_directory=str(tmp_path / "out")))
    out = feature_learning.run(args)
    assert np.isfinite(out["F"])
    with h5py.File(os.path.join(out["outdir"], "training.h5"), "r") as f:
        assert f["F"].shape == (3,) and f["W"].shape == (3, 25, 10)


def test_feature_learning_app_writes_missing_patch_file(tmp_path):
    path = str(tmp_path / "data" / "patches.npz")
    args = feature_learning.get_args(["--data_file", path, "-H", "6", "--no_epochs", "1",
                                      "--output_directory", str(tmp_path / "out")])
    assert np.isfinite(feature_learning.run(args)["F"])
    with np.load(path) as f:
        assert f["data"].shape == (2000, 64)


def test_inpainting_compact_readback_bit_exact(tmp_path):
    outs = [images.run_inpainting(_image_args(
        "inpainting", "es3c", compact_readback=compact, no_epochs=3,
        output_directory=str(tmp_path / str(compact)))) for compact in (False, True)]
    assert outs[0]["F"] == outs[1]["F"] and outs[0]["psnr"] == outs[1]["psnr"]
    np.testing.assert_array_equal(outs[0]["rec"], outs[1]["rec"])


def test_chunk_epochs_with_reconstruction_boundaries(tmp_path):
    """Chunks step the reconstruction epochs alone and give the per-epoch
    run's F and PSNR."""
    outs = [images.run_denoising(_image_args(
        "denoising", "ebsc", merge_every=4, no_epochs=8, chunk_epochs=chunk,
        output_directory=str(tmp_path / str(chunk)))) for chunk in (1, 3)]
    assert outs[0]["F"] == outs[1]["F"] and outs[0]["psnr"] == outs[1]["psnr"]
    np.testing.assert_array_equal(outs[0]["rec"], outs[1]["rec"])


def test_image_apps_raise_without_a_card(tmp_path, monkeypatch):
    monkeypatch.delenv("EVO_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    for run in (images.run_denoising, images.run_inpainting):
        with pytest.raises(RuntimeError, match="EVO_PLATFORM=cpu"):
            run(_image_args("inpainting", "ebsc", output_directory=str(out)))
    assert not out.exists()


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_main", os.path.join(REPO, "examples", name, "main.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_clis_take_the_examples_flags(monkeypatch):
    """python -m evo_tpu_torch.apps.images {denoising|inpainting} and
    python -m evo_tpu_torch.apps.feature_learning parse what the examples
    parse, to the same values."""
    for task, example in (("denoising", "image-denoising"), ("inpainting", "image-inpainting")):
        module = _example(example)
        for argv in (["es3c"], ["ebsc", "-H", "16", "--Ksize", "7", "--chunk_epochs", "2",
                                "--no_dc_center", "--host_merge", "--patch_width", "4"],
                     ["es3c", "--rescale", "1.0", "--merge_every", "3", "--seed", "2"]):
            monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
            got = vars(images.get_args([task] + argv))
            assert got.pop("task") == task
            assert got == vars(module.get_args())
    extra = {"denoising": ["--noise_level", "15"],
             "inpainting": ["--percentage", "20", "--no_compact_readback"]}
    for task, argv in extra.items():
        monkeypatch.setattr(sys, "argv", ["main.py", "ebsc"] + argv)
        module = _example("image-" + task)
        got = vars(images.get_args([task, "ebsc"] + argv))
        got.pop("task")
        assert got == vars(module.get_args())
    module = _example("feature-learning")
    for argv in ([], ["--model", "sssc", "-H", "20", "--sort_gfs", "--no_epochs", "5"]):
        monkeypatch.setattr(sys, "argv", ["main.py"] + argv)
        assert vars(feature_learning.get_args(argv)) == vars(module.get_args())
    with pytest.raises(SystemExit):
        images.get_args(["denoising"])
