"""What a run reads: ``BENCHMARK.json`` at the root of the checkout, the
cell's file ``portbench/cells/<cell>.json``, its configuration's file, and
the readers ``portbench/metrics/<metric>.py`` of the per-layer metrics that
the cell reports.  Everything is found by the names in BENCHMARK.json, so
a configuration, a cell or a metric is added as new files and new entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(workload: str, root: Path = None) -> dict:
    """{bench, workload (its entry), config (the file's content), cell (the
    cell file's content), end_to_end, per_layer (the entries this cell
    reports), root}."""
    root = Path(root) if root else HERE.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    cell = json.loads((root / "portbench" / "cells" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(bench=bench, workload=entry, config=config, cell=cell, end_to_end=e2e,
                per_layer=per_layer, root=root)


def reader(name: str, root: Path = None):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    root = Path(root) if root else HERE.parent
    path = root / "portbench" / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
