#!/usr/bin/env python3
"""The benchmark of evo_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It sets up the cell from the seed, measures
EM epochs through the trainer for ``--seconds``, checks the epoch after the
window against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted`` (the window's epochs),
``failed`` (those with a non-finite F), ``metrics`` (the end-to-end metrics
with ``--trace 0``, the per-layer ones with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and ``checks`` (each number compared,
with its limit), which the last lines of standard error repeat.  A cell on
several cards starts one worker process per card (``portbench/launcher.py``)
and prints rank 0's line.  Without enough CUDA cards, or if JAX or evo_tpu
was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path[0] = str(REPO)  # import portbench as a package; shadow nothing of the library

FORBIDDEN = ("jax", "jaxlib", "flax", "evo_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names among ``modules`` (default: sys.modules) that the
    benchmark may not load, compared whole (evo_tpu_torch is not evo_tpu)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="also read the control and the planted faults (not in benchmark runs)")
    return p.parse_args(argv)


def judge(checks: dict, limits: dict):
    """(correct, {number: {value, limit}}): every number that has a limit is
    compared; a number that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name)
        good = v is not None and v == v and v <= limit
        ok &= good
        table[name] = {"value": v, "limit": limit}
    return ok, table


def execute(args, device, t_start: float):
    """Run the cell in this process; returns rank 0's result line (a dict)
    or None on the other ranks."""
    import torch

    from portbench.harness import Run

    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), device, t_start)
    run.run()
    control = run.control_readings() if args.control else None
    found = forbidden_modules()
    mine = dict(peak=run.peak, setup_s=run.setup_s, found=found,
                busy_s=getattr(run, "profile", {}).get("busy_s"),
                stretch_s=getattr(run, "profile", {}).get("stretch_s"))
    ranks = [mine]
    if run.world > 1:
        ranks = [None] * run.world
        torch.distributed.all_gather_object(ranks, mine)
    if run.rank != 0:
        return None
    found = sorted({m for r in ranks for m in r["found"]})
    if found:
        print(f"modules that the benchmark may not load are loaded: {found}", file=sys.stderr)
        raise SystemExit(3)
    correct, table = judge(run.checks, run.cell["limits"])
    print("set-up phases " + " ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items()),
          file=sys.stderr)
    for name, c in table.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    peak = max(r["peak"] for r in ranks)
    device_info = dict(platform="gpu" if device.type == "cuda" else device.type,
                       kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                       count=run.world, memory_peak_bytes=int(peak))
    line = dict(correct=bool(correct), attempted=len(run.durations), failed=run.bad_F)
    if args.trace:
        line["metrics"] = run.per_layer
        device_info.update(busy_s=statistics.mean(r["busy_s"] for r in ranks),
                           window_s=statistics.mean(r["stretch_s"] for r in ranks))
        line["device"] = device_info
        line["breakdown"] = dict(device_ops=run.profile["device_ops"],
                                 idle_gaps=run.profile["idle_gaps"])
    else:
        d = sorted(run.durations)
        e2e = dict(epoch_ms=1e3 * run.window_s / len(d),
                   epoch_ms_p95=1e3 * (statistics.quantiles(d, n=20)[-1] if len(d) > 1 else d[0]),
                   peak_mem_gib=peak / 2**30, setup_s=run.setup_s)
        units = {m["name"]: m["unit"] for m in run.sp["end_to_end"]}
        line["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        line["device"] = device_info
    if control is not None:
        line["control"] = control
    line["checks"] = table
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import spec

    chips = spec.load(args.workload)["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    worker = os.environ.get("PORTBENCH_WORKER") == "1"
    if chips > 1 and not worker:
        from portbench import launcher

        return launcher.launch(sys.argv[1:] if argv is None else argv, chips, T0)
    t_start = float(os.environ.get("PORTBENCH_T0", T0))
    if worker:
        from evo_tpu_torch.parallel import distributed

        device = distributed.process_device()
        distributed.init_distributed(device=device)
    else:
        device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    try:
        line = execute(args, device, t_start)
    finally:
        if worker and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if line is not None:
        sys.stderr.flush()
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
