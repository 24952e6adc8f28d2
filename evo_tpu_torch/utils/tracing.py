"""Host tracepoints and the device profiler (counterpart:
evo_tpu/utils/tracing.py).

``set_tracefile`` opens a per-process trace file with relative timestamps,
``tracepoint(name)`` writes a marker, ``@traced`` wraps a function in
``<name>:begin``/``<name>:end``, and ``close()`` adds the file to a gzip tar
archive.  What runs on the card is invisible to host tracepoints:
``device_trace(logdir)`` records the enclosed block with torch.profiler and
writes a Chrome trace into ``logdir``, and ``annotate(name)`` names a region
in that trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tarfile
import time
from typing import Optional

import torch

_tracefile = None
_t0 = 0.0
_path: Optional[str] = None


def _proc_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def set_tracefile(path: str = "trace-%04d.txt"):
    """Enable tracing; a %d in ``path`` takes the process's rank."""
    global _tracefile, _t0, _path
    if "%" in path:
        path = path % _proc_index()
    _path = path
    _tracefile = open(path, "w")
    _t0 = time.perf_counter()
    _tracefile.write("# evo_tpu_torch trace, host=%s process=%d\n"
                     % (os.uname().nodename, _proc_index()))


def tracepoint(name: str):
    """Timestamped marker (a no-op unless set_tracefile was called)."""
    if _tracefile is not None:
        _tracefile.write("%.6f %s\n" % (time.perf_counter() - _t0, name))


def traced(fn):
    """Decorator writing ``<name>:begin`` / ``<name>:end`` tracepoints."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tracepoint(fn.__name__ + ":begin")
        try:
            return fn(*args, **kwargs)
        finally:
            tracepoint(fn.__name__ + ":end")

    return wrapper


def close(archive: Optional[str] = "traces.tgz"):
    """Close the trace file and, with ``archive``, move it into that gzip
    tar.  A tar.gz cannot be appended to, so the archive is rewritten with
    its old members (from several processes' files closed in turn)."""
    global _tracefile
    if _tracefile is None:
        return
    _tracefile.close()
    _tracefile = None
    if archive and _path and os.path.exists(_path):
        import io

        members = []
        if os.path.exists(archive):
            with tarfile.open(archive, "r:*") as old:
                for m in old.getmembers():
                    data = old.extractfile(m).read() if m.isfile() else None
                    members.append((m, data))
        with tarfile.open(archive, "w:gz") as tar:
            for m, data in members:
                tar.addfile(m, io.BytesIO(data) if data is not None else None)
            tar.add(_path)
        os.remove(_path)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record the enclosed block with torch.profiler (the host, and the
    card where there is one) and write it as a Chrome trace
    ``trace-<ns>.json`` into ``logdir``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{time.time_ns()}.json"))


def annotate(name: str):
    """Named region in a device_trace."""
    return torch.profiler.record_function(name)
