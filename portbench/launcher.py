"""The four-card launcher: one worker process per card, as torchrun starts
them.

Each worker is ``portbench/run.py`` with the same arguments and torchrun's
variables (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR=127.0.0.1 and a free
MASTER_PORT); the program brings its NCCL group up from them.  Rank 0
inherits standard output and error and prints the run's one result line;
the other ranks write theirs into files under TMPDIR, shown on standard
error only if a rank fails.  Every worker has the same deadline; at it,
or when one worker fails, all are stopped, and the launcher waits for each
to end.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DEADLINE_S = 1100  # a first run in a checkout also builds the kernels
RUN = Path(__file__).resolve().parent / "run.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: list, world: int, t0: float) -> int:
    port = free_port()
    logdir = tempfile.mkdtemp(prefix="portbench-ranks-")
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PORTBENCH_WORKER="1",
                   PORTBENCH_T0=repr(t0))
        if rank == 0:
            out = None
        else:
            out = open(os.path.join(logdir, f"rank{rank}.log"), "w")
            logs.append((rank, out))
        procs.append(subprocess.Popen([sys.executable, str(RUN), *argv], env=env, stdout=out,
                                      stderr=subprocess.STDOUT if out else None))
    deadline = time.time() + DEADLINE_S
    rcs = [None] * world
    try:
        while any(rc is None for rc in rcs):
            for i, p in enumerate(procs):
                if rcs[i] is None:
                    rcs[i] = p.poll()
            if any(rc not in (None, 0) for rc in rcs) or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            rcs[i] = p.wait()
        for _, f in logs:
            f.close()
    try:
        if any(rcs):
            print(f"ranks' exit codes {rcs}", file=sys.stderr)
            for rank, f in logs:
                with open(f.name) as fh:
                    tail = fh.read()[-3000:]
                print(f"--- rank {rank} ---\n{tail}", file=sys.stderr)
            return next(rc for rc in rcs if rc) or 1
        return 0
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
