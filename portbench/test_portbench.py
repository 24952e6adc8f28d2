"""Tests of the benchmark harness, on the CPU with the port's plain path
(``python -m pytest portbench``).

Tiny cells of both models run the whole harness (set-up, window, checked
epoch, reference) in a temporary copy of the benchmark; the control and
faults planted in the program must come out not correct; a configuration,
a cell and a metric reader are added as files and found by name; the
yardstick's operation and byte counts are held against hand counts.  The
card test runs ``portbench/run.py`` itself and skips without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import run as runmod  # noqa: E402
from portbench import spec  # noqa: E402
from portbench.harness import Run  # noqa: E402
from portbench.reference import bounds  # noqa: E402

EA = dict(parent_selection="fit", mutation_algorithm="randflip", n_children=1, n_generations=1)
# limits of the tiny cells, between what sound runs and the control read at
# these sizes (the full cells' limits are set from the card, in PERF.md)
TINY_LIMITS = dict(lpj=2e-6, F=1e-5, merge=1e-6, dups=0, theta0=1e-5, states0=0, image=0.01,
                   psnr=1e-4, **{k: 3e-4 for k in ("W", "pi", "sigma", "pies", "mus", "Psi",
                                                     "sigma2")})
TINY = {
    "tiny_bsc.ea": dict(
        config=("tiny_bsc", dict(model="bsc", model_class="BSC", D=16, H=8, S=8,
                                 ea=dict(EA, n_parents=4))),
        cell=dict(generator="generative", profile_epochs=2, model="bsc",
                  traffic=dict(n_blocks=2, rows_per_block=64,
                               data_model=dict(kind="bsc", pi=0.25, sigma=1.0)))),
    "tiny_sssc.inpaint": dict(
        config=("tiny_sssc", dict(model="sssc", model_class="SSSC", app_algo="es3c", patch=3,
                                  H=6, S=6, ea=dict(EA, n_parents=3))),
        cell=dict(generator="image", profile_epochs=3, model="sssc_image",
                  traffic=dict(task="inpainting", missing=0.1, merge_every=3,
                               image=dict(kind="rgb", height=20, width=16)))),
    "tiny_sssc.denoise": dict(
        config=("tiny_sssc", None),
        cell=dict(generator="image", profile_epochs=3, model="sssc_image",
                  traffic=dict(task="denoising", noise=25.0, merge_every=3,
                               image=dict(kind="gray", size=24)))),
    "tiny_bsc.x2": dict(
        config=("tiny_bsc", None), chips=2,
        cell=dict(generator="generative", profile_epochs=2, model="bsc",
                  traffic=dict(n_blocks=2, rows_per_block=32,
                               data_model=dict(kind="bsc", pi=0.25, sigma=1.0)))),
}


def make_root(path: Path, extra_metric: str = None) -> Path:
    """A copy of the benchmark at ``path`` with the tiny cells and, with
    ``extra_metric``, a metric reader of that name added as a file."""
    shutil.copytree(REPO / "portbench", path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, t in TINY.items():
        cname, conf = t["config"]
        if conf is not None:
            (path / f"portbench/configs/{cname}.json").write_text(json.dumps(conf))
            bench["configs"].append(dict(name=cname, source="test", reduced=[],
                                         file=f"portbench/configs/{cname}.json"))
        cell = dict(t["cell"])
        names = (("W", "pi", "sigma", "pies") if cell.pop("model") == "bsc"
                 else ("W", "pies", "mus", "Psi", "sigma2", "image", "psnr"))
        cell["limits"] = {k: v for k, v in TINY_LIMITS.items()
                          if k in names or k in ("lpj", "F", "merge", "dups", "theta0", "states0")}
        (path / f"portbench/cells/{name}.json").write_text(json.dumps(cell))
        bench["workloads"].append(dict(name=name, config=cname, traffic=name.split(".")[1],
                                       chips=t.get("chips", 1), why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)  # every tiny cell reports every metric and reader
    if extra_metric:
        (path / f"portbench/metrics/{extra_metric}.py").write_text(
            "def read(ctx):\n    return ctx.epochs\n")
        bench["per_layer"].append(dict(name=extra_metric, unit="1", better="higher",
                                       source="program_counter", layer="trainer",
                                       moves="epoch_ms"))
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def tiny_run(root, cell, seconds=0.3, trace=False, seed=987654321987):
    run = Run(cell, seed, seconds, trace, torch.device("cpu"), time.time(), root=root)
    run.run()
    return run


@pytest.mark.parametrize("cell", ["tiny_bsc.ea", "tiny_sssc.inpaint", "tiny_sssc.denoise"])
def test_harness_runs_a_tiny_cell_correct(root, cell):
    run = tiny_run(root, cell)
    ok, table = runmod.judge(run.checks, run.cell["limits"])
    assert ok, table
    assert len(run.durations) >= 1 and run.bad_F == 0
    assert run.setup_s > 0 and run.window_s > 0


@pytest.mark.parametrize("cell", ["tiny_bsc.ea", "tiny_sssc.inpaint", "tiny_sssc.denoise"])
def test_control_is_not_correct(root, cell):
    """The reference in float32 with TF32 products, put in the program's
    place, fails the cell's limits; so do the planted half batch and an
    unchanged state."""
    run = tiny_run(root, cell, seconds=0.05)
    readings = run.control_readings()
    limits = run.cell["limits"]
    assert not runmod.judge(readings["control"], limits)[0], readings["control"]
    assert not runmod.judge(readings["half"], limits)[0], readings["half"]


def _fault_unchanged(orig):
    def em_step(self, params, estate, data, generator, cfg, do_reconstruction=False):
        _, _, stats, y_rec = orig(self, params, estate, data, generator, cfg, do_reconstruction)
        return params, estate, stats, y_rec
    return em_step


def _fault_half(orig):
    def em_step(self, params, estate, data, generator, cfg, do_reconstruction=False):
        keep = torch.arange(data.row_valid.shape[1]) % 2 == 0
        half = dataclasses.replace(data, row_valid=data.row_valid & keep)
        return orig(self, params, estate, half, generator, cfg, do_reconstruction)
    return em_step


def _fault_lpj(orig):
    def em_step(self, params, estate, data, generator, cfg, do_reconstruction=False):
        p, est, stats, y_rec = orig(self, params, estate, data, generator, cfg, do_reconstruction)
        lpj = est.lpj.clone()
        lpj[0, 0, -1] += 1e-3 * lpj[0, 0, -1].abs()
        return p, dataclasses.replace(est, lpj=lpj), stats, y_rec
    return em_step


@pytest.mark.parametrize("fault", [_fault_unchanged, _fault_half, _fault_lpj])
@pytest.mark.parametrize("cell,cls", [("tiny_bsc.ea", "BSC"), ("tiny_sssc.inpaint", "SSSC")])
def test_a_broken_step_is_not_correct(root, monkeypatch, cell, cls, fault):
    import evo_tpu_torch.models as models

    klass = getattr(models, cls)
    monkeypatch.setattr(klass, "em_step", fault(klass.em_step))
    run = tiny_run(root, cell, seconds=0.05)
    ok, table = runmod.judge(run.checks, run.cell["limits"])
    assert not ok, table


def test_an_altered_merged_image_is_not_correct(root, monkeypatch):
    from evo_tpu_torch.apps import images

    merge = images.host_merge

    def altered(b, clean, Y_rec):
        out = merge(b, clean, Y_rec)
        img, p = out["median"]
        img = img.copy()
        img.flat[0] += 1.0
        out["median"] = (img, p)
        return out

    monkeypatch.setattr(images, "host_merge", altered)
    run = tiny_run(root, "tiny_sssc.inpaint")
    ok, table = runmod.judge(run.checks, run.cell["limits"])
    assert not ok and table["image"]["value"] > 0.5, table


def _rank_main(root, rank, world, port, fault, out):
    """A worker of the two-rank tests (gloo on the CPU)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from evo_tpu_torch.parallel import distributed

    distributed.init_distributed(backend="gloo", device="cpu")
    if fault == "no_exchange":
        distributed.allreduce_sums = lambda *dicts: dicts
    run = Run("tiny_bsc.x2", 13579, 0.2, False, torch.device("cpu"), time.time(), root=root)
    run.run()
    if rank == 0:
        ok, table = runmod.judge(run.checks, run.cell["limits"])
        Path(out).write_text(json.dumps(dict(ok=ok, table=table, epochs=len(run.durations))))
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("fault", ["none", "no_exchange"])
def test_two_ranks(root, tmp_path, fault):
    """The multi-rank path on two gloo ranks: correct as it is, and not
    correct with the exchange between the ranks left out."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "rank0.json"
    procs = [subprocess.Popen([sys.executable, __file__, str(root), str(r), "2", str(port), fault,
                               str(out)]) for r in range(2)]
    for p in procs:
        p.wait(timeout=300)
    assert [p.returncode for p in procs] == [0, 0]
    res = json.loads(out.read_text())
    assert res["ok"] == (fault == "none"), res["table"]
    assert res["epochs"] >= 1


def test_cells_configs_and_metrics_are_found_by_name(tmp_path):
    """A configuration, a cell and a metric reader added as new files and
    new entries of BENCHMARK.json, with no file edited, run and report."""
    root = make_root(tmp_path, extra_metric="trainer.epochs_seen")
    sp = spec.load("tiny_sssc.denoise", root)
    assert sp["config"]["model"] == "sssc" and sp["cell"]["generator"] == "image"
    assert "trainer.epochs_seen" in [m["name"] for m in sp["per_layer"]]
    run = tiny_run(root, "tiny_sssc.denoise", trace=True)
    assert run.per_layer["trainer.epochs_seen"]["value"] == len(run.durations)
    assert {"trainer.log_ms", "trainer.callback_ms", "em_step.enqueue_ms", "window.epoch_ms",
            "window.epoch_ms_p95"} <= set(run.per_layer)
    assert run.per_layer["window.epoch_ms"]["value"] == 1e3 * run.window_s / len(run.durations)
    # no device on the CPU: the device readers find nothing and are left out
    assert "device.idle_share" not in run.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (REPO / "BENCHMARK.json").read_text())["workloads"]])
def test_each_cell_reports_what_its_metrics_move(cell):
    """Each cell of BENCHMARK.json has its files, reports setup_s, another
    end-to-end metric and a per-layer metric, and reports the end-to-end
    metric that each of its per-layer metrics moves; each reader exists."""
    sp = spec.load(cell)
    assert (REPO / "portbench" / "cells" / f"{cell}.json").is_file()
    e2e = {m["name"] for m in sp["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and sp["per_layer"]
    for m in sp["per_layer"]:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        assert callable(spec.reader(m["name"]))


def test_forbidden_modules_compare_whole_top_level_names():
    f = runmod.forbidden_modules
    assert f({"evo_tpu_torch": 1, "evo_tpu_torch.models": 1, "jaxtyping": 1, "numpy": 1}) == []
    assert f({"jax.numpy": 1, "evo_tpu.models.bsc": 1, "jaxlib": 1, "flax": 1}) == [
        "evo_tpu", "flax", "jax", "jaxlib"]


def test_the_harness_and_the_port_load_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r); import evo_tpu_torch, "
            "evo_tpu_torch.apps.images, evo_tpu_torch.apps.training, portbench.harness, "
            "portbench.generators.image, portbench.generators.generative; "
            "from portbench.run import forbidden_modules; print(forbidden_modules())") % str(REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_bound_counts_match_hand_counts():
    """Operations and bytes of each kernel call on small states, counted by
    hand from the formulas' definitions."""
    n = torch.tensor([0.0, 1.0, 2.0, 3.0], dtype=torch.float64)  # 2 datapoints x 2 states
    u = torch.tensor([1.0, 3.0], dtype=torch.float64)
    B, K, H = 2, 2, 8
    w = bounds.bsc_lpj(n, B, K, H)
    # adds n^2 + 2n: 0 + 3 + 8 + 15 = 26, plus 6 a state; key inserts: n
    assert w == dict(f32=26 + 24, int=6, bytes=4 * 8 + 4 * (16 + 2 + 64 + 4 + 4 * 1))
    w = bounds.bsc_lpj(n, B, K, 96)  # H > 64: 2 key words and the hash's ops
    assert w["int"] == 6 + 4 * (4 * 2 * 3 + 12)
    assert bounds.bsc_suffstat(n, B, K, H) == dict(
        f32=26, int=0, bytes=4 * 8 + 4 * (4 + 16 + 4 + 64))
    w = bounds.sssc_lpj(n, B, K, H)
    f = sum(8 / 3 * k**3 + 8 * k**2 + 6 * k for k in (0, 1, 2, 3))
    assert w["f32"] == pytest.approx(f)
    assert w["bytes"] == 4 * 8 + 4 * (16 + 2 + 128 + 16 + 8)
    w = bounds.sssc_suffstat(n, u, B, K, H)
    assert w["f32"] == sum(4 * k**3 + 9 * k**2 + 4 * k for k in (0, 1, 2, 3)) + 4 * (1 + 9)
    w = bounds.sssc_lpj_masked(n, u, B, K, H)
    assert w["f32"] == sum(4 * k**3 + 6 * k**2 + 8 * k for k in (0, 1, 2, 3))
    assert w["bytes"] == 4 * 8 + 4 * (16 + 2 + 64 + 16 + 8) + 4 * (1 + 9)
    # above the overflow cap (64 < H <= 128) a state is not solved
    capped = bounds.sssc_lpj(torch.tensor([17.0, 2.0], dtype=torch.float64), 1, 2, 100)
    assert capped["f32"] == pytest.approx(8 / 3 * 8 + 32 + 12)
    peaks = bounds.PEAKS["NVIDIA H100 80GB HBM3"]
    assert bounds.seconds(dict(f32=67e12, int=0, bytes=3.35e12), peaks) == pytest.approx(1.0)
    assert bounds.seconds(dict(f32=0, int=16.75e12 * 2, bytes=0), peaks) == pytest.approx(2.0)
    assert bounds.kernel_name("_ZN12_GLOBAL__N_114bsc_lpj_kernelILb1ELb0EEEvPKhPKf") == \
        "bsc_lpj_kernel<true, false>"
    assert bounds.is_port_kernel("void (anonymous namespace)::sssc_lpj_kernel<true>(signed char")


def test_epoch_work_counts_every_call():
    from portbench.reference import bsc, sssc

    n = torch.ones(3, 4, 5, dtype=torch.float64)  # 3 blocks, B = 4, S = 5, one bit a state
    u = torch.full((3, 4), 2.0, dtype=torch.float64)
    ea = dict(EA, n_parents=2, H=8)
    calls, dense = bsc.epoch_work(n, u, ea, 16, False, False)
    assert len(calls) == 3 * 3  # K^(n), children, suffstat per block
    assert calls[1]["f32"] == 4 * 2 * (1 + 2 + 6)
    assert dense == 3 * (2 * 16 * 64 + 4 * 4 * 16 * 8 + 2 * 4 * 16) + 2 * 512 + 2 * 64 * 16
    calls, dense_rec = sssc.epoch_work(n, u, ea, 16, True, True)
    assert len(calls) == 9 and dense_rec > sssc.epoch_work(n, u, ea, 16, True, False)[1]


@pytest.mark.card
def test_run_on_the_card():
    """portbench/run.py itself on a short window of the smallest cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, str(REPO / "portbench/run.py"), "--workload",
                          "es3c_p5h32.denoise", "--seed", "5", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
               sys.argv[6])
