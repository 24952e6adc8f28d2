"""The port's process group brought up from torchrun's environment on the
CPU.

Two worker processes (this file run as a script; see the end) get the
variables torchrun sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and a
free MASTER_PORT) and EVO_PLATFORM=cpu, and bring the group up with no
rank, world size or address: ``init_distributed(device="cpu")``, or the
apps' ``platform_device()``, which calls it.  Each must get (rank, 2), sum
one tensor over the ranks and find a second call a no-op.  Without a device
``init_distributed()`` means the card, and with none it raises rather than
fall back to the CPU.  Without torchrun's variables nothing is brought up.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
WORKER_TIMEOUT_S = 60
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "TORCHELASTIC_RUN_ID")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """This process's environment with torchrun's variables for ``rank``
    and EVO_PLATFORM=cpu (the apps' CPU switch), one thread a process."""
    env = {k: v for k, v in os.environ.items() if k not in TORCHRUN_VARS}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               EVO_PLATFORM="cpu", OMP_NUM_THREADS="1")
    return env


def start_ranks(script: str, args, outdir: str) -> list:
    """Start ``script`` with ``args`` as WORLD ranks under torchrun's
    variables, all at once (their output goes to <outdir>/rank<r>.log)."""
    port, procs = free_port(), []
    for rank in range(WORLD):
        log = open(os.path.join(outdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, script, *map(str, args)],
                                       env=torchrun_env(rank, WORLD, port), cwd=REPO,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs: list, outdir: str, timeout_s: float = WORKER_TIMEOUT_S):
    """Wait for ``start_ranks``' processes; kill every one on expiry of
    ``timeout_s``; fail unless all exit 0."""
    deadline = time.monotonic() + timeout_s
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
                pytest.fail(f"rank {rank} exited {p.returncode}:\n{f.read()[-4000:]}")


def _worker(outdir: str, how: str):
    """One rank: bring the group up from the environment (``how``: 'init'
    or 'platform'), sum rank + 1 over the ranks, call init_distributed()
    again, write the results to <outdir>/rank<RANK>.json."""
    sys.path.insert(0, REPO)
    from evo_tpu_torch.apps.common import platform_device
    from evo_tpu_torch.parallel import distributed, init_distributed

    dev = None
    if how == "init":
        if not torch.cuda.is_available():
            try:
                init_distributed()
                raise AssertionError("init_distributed() fell back to the CPU")
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
            assert not distributed.active()
        got = init_distributed(device="cpu")
    else:
        dev = str(platform_device())
        got = distributed.rank_world()
    t = torch.tensor([float(got[0] + 1)])
    torch.distributed.all_reduce(t)
    again = init_distributed(backend="gloo", rank=5, world_size=9)
    with open(os.path.join(outdir, f"rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(dict(got=list(got), sum=float(t), again=list(again), device=dev,
                       backend=torch.distributed.get_backend()), f)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("how", ["init", "platform"])
def test_group_from_torchrun_environment(tmp_path, how):
    """init_distributed(device="cpu") with no rank, world size or address,
    and platform_device() under WORLD_SIZE=2, bring up a 2-rank gloo group
    on the CPU from torchrun's variables: each rank gets (rank, 2), one
    all_reduce sums 1 + 2, and a second call returns the group as it is,
    whatever it is given."""
    wait_ranks(start_ranks(os.path.abspath(__file__), [tmp_path, how], str(tmp_path)),
               str(tmp_path))
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.json") as f:
            r = json.load(f)
        assert r["got"] == [rank, WORLD] and r["again"] == [rank, WORLD]
        assert r["sum"] == 3.0 and r["backend"] == "gloo"
        assert r["device"] == (None if how == "init" else "cpu")


def test_without_torchrun_environment_nothing_is_brought_up(monkeypatch):
    """No torchrun variable and no argument: init_distributed() and the
    apps' platform_device() bring up no group."""
    from evo_tpu_torch.apps.common import platform_device
    from evo_tpu_torch.parallel import distributed, init_distributed

    for k in TORCHRUN_VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EVO_PLATFORM", "cpu")
    assert init_distributed() == (0, 1)
    assert platform_device() == torch.device("cpu")
    assert not distributed.active() and distributed.rank_world() == (0, 1)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2])
