"""The port's patch-file CLI, ``python -m evo_tpu_torch.apps.get_patches``,
against examples/feature-learning/get-patches.py (which runs evo_tpu): on
the same image, seed and patch size both write the same arrays bit for bit,
the CLI runs with jax and evo_tpu blocked, and the feature-learning app
trains on its file."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "feature-learning", "get-patches.py")
KEYS = ("data", "patch_height", "patch_width", "no_channels")

# runs the CLI as ``python -m`` does, with jax and evo_tpu blocked
BLOCKED_CLI = r"""
import runpy, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "evo_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["get_patches"] + sys.argv[1:]
runpy.run_module("evo_tpu_torch.apps.get_patches", run_name="__main__", alter_sys=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "evo_tpu")]
assert not bad, bad
"""


def _rgb_png(path):
    from evo_tpu_torch.apps.images import synthetic_image

    g = synthetic_image(48)
    rgb = np.stack([g, np.roll(g, 7, axis=0), np.roll(g, 11, axis=1)], axis=2).astype(np.uint8)
    from PIL import Image

    Image.fromarray(rgb).save(path)
    return path


def _run(cmd, env_extra):
    env = dict(os.environ, **env_extra)
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


@pytest.mark.parametrize("flags", [
    ["--seed", "0"],
    ["--seed", "3", "--patch_height", "6", "--patch_width", "10", "--no_patches", "500"],
    ["--seed", "1", "--patch_height", "4", "--no_patches", "300", "--image_file", "RGB"],
], ids=["defaults", "seed3-6x10", "rgb-file"])
def test_get_patches_cli_matches_the_example(tmp_path, flags):
    """The same .npz arrays (keys, dtypes, values) bit for bit from the
    example script and from the port's CLI run with jax and evo_tpu
    blocked; on the synthetic 256 x 256 image with two seeds and a
    non-square patch, and on an RGB file."""
    if "RGB" in flags:
        flags = [str(_rgb_png(tmp_path / "rgb.png")) if f == "RGB" else f for f in flags]
    want, got = str(tmp_path / "example" / "p.npz"), str(tmp_path / "port" / "p.npz")
    _run([sys.executable, EXAMPLE, *flags, "--output_file", want], {"JAX_PLATFORMS": "cpu"})
    said = _run([sys.executable, "-c", BLOCKED_CLI, *flags, "--output_file", got], {})
    assert said.startswith("Wrote ")
    with np.load(want) as w, np.load(got) as g:
        assert sorted(g.files) == sorted(w.files) == sorted(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["data"].dtype == np.float32
        np.testing.assert_allclose(g["data"].mean(axis=1), 0.0, atol=1e-3)
        C = 3 if "--image_file" in flags else 1
        assert int(g["no_channels"]) == C
        assert g["data"].shape[1] == int(g["patch_height"]) * int(g["patch_width"]) * C


def test_feature_learning_app_reads_the_cli_file(tmp_path, monkeypatch):
    """The feature-learning app trains on the CLI's file (6 x 10 patches):
    F finite over its epochs."""
    from evo_tpu_torch.apps import feature_learning, get_patches

    monkeypatch.setenv("EVO_PLATFORM", "cpu")
    path = str(tmp_path / "patches.npz")
    P = get_patches.main(["--patch_height", "6", "--patch_width", "10", "--no_patches", "200",
                          "--output_file", path])
    Y, ph, pw, C = feature_learning.load_patches(path)
    assert (ph, pw, C) == (6, 10, 1) and np.array_equal(Y, P)
    res = feature_learning.main(["--data_file", path, "-H", "6", "--Ksize", "5",
                                 "--no_epochs", "2", "--viz_every", "2",
                                 "--output_directory", str(tmp_path / "out")])
    assert np.isfinite(res["F"])
    assert tuple(res["params"].W.shape) == (60, 6)
