"""Host spans, counters and markers on the device profiler's clock, and the
device profiler (counterpart: evo_tpu/utils/tracing.py).

``set_tracefile(path)`` opens a session; until ``close()``:

- ``span(name, device=None)`` is a context manager that records its name,
  start and end, the innermost open span as its parent and the epoch last
  given to ``set_epoch``.  Under a recording torch.profiler it also opens a
  ``record_function`` of its name (a ``user_annotation`` in the Chrome
  trace), which lies within the span.  With a CUDA ``device`` it records a
  CUDA event on the current stream at its begin and at its end;
  ``resolve()`` turns those into the span's device time once the card has
  passed them, and waits for nothing.
  A CUDA span that opens right after its sibling closed, with no span
  opened between, begins at that sibling's end event instead of recording
  one: device work launched between the two would count to the second
  (the models launch none there), and an epoch records about 40% fewer
  events.
- ``count(name, n)`` adds the host integer ``n`` to the innermost open span.
- ``active()`` says whether a session is open (and not paused), for
  counters that cost a read of the card.
- ``tracepoint(name)`` records a single marker.
- ``paused()`` records nothing in the block it encloses (a CUDA graph's
  capture, which runs no work).

Times are ``time.time_ns()``, the clock of torch.profiler's Chrome trace
(``baseTimeNanoseconds + ts``).  The session stays in memory: ``records()``
gives its spans and markers, also after ``close()``.  The trace file gets a
header line with the origin (``t0_unix_ns=``), then one line a marker,
``"%.6f <name>"``, and two a span, ``"%.6f <name>:begin"`` and
``":end"``, in seconds from the origin and in time order, written in chunks
of ``FLUSH_LINES`` lines and at ``close()``.  Without a session ``span``
returns one shared no-op object, and ``count``, ``tracepoint`` and
``resolve`` return at once.

``device_trace(logdir)`` records the enclosed block with torch.profiler and
writes a Chrome trace into ``logdir``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import os
import tarfile
import time
from typing import Optional

import torch

FLUSH_LINES = 1 << 16

_on = False  # a session is open
_session: Optional["Records"] = None  # the open or last closed session
_epoch = None
_free_events = {}  # device index -> CUDA events for reuse
_streams = {}  # (device index, raw stream) -> torch.cuda.Stream
_profiling = torch._C._autograd._profiler_enabled
_now = time.time_ns

SpanRecord = collections.namedtuple("SpanRecord", (
    "name", "id", "parent", "epoch", "begin_ns", "end_ns", "host_self_ns", "counts",
    "device_ms", "device_self_ms"))
SpanRecord.__doc__ = """A span: ``parent`` is the id of the span it opened in (or None),
``host_self_ns`` its duration less its children's (its own event records
included), ``counts`` {name: n} or None, and with CUDA events ``device_ms``
(stream time from its begin event to its end event) and ``device_self_ms``
(less its children's); an open span's end and a span's unresolved device
times are None."""


class Records:
    """One session: ``t0_ns`` (the origin, Unix ns), ``spans`` (SpanRecords
    in begin order; a span's id is its index) and ``markers`` [(t_ns,
    name)].  The spans are kept as one list per field of plain numbers and
    strings, which the garbage collector does not track, so that a long
    session does not make it run."""

    def __init__(self, path: str, t0_ns: int):
        self.path, self.t0_ns = path, t0_ns
        self.markers = []
        self._fields = tuple([] for _ in range(len(SpanRecord._fields) - 1))  # all but id
        (self._name, self._parent, self._epoch, self._begin, self._end, self._self_ns,
         self._counts, self._dev_ms, self._dev_self_ms) = self._fields
        self._child_ns, self._child_ms = [], []
        self._stack = []  # ids of the open spans
        self._pending = {}  # stream -> ([span id], [begin event], [end event]), closing order
        self._uses = {}  # id of an event -> the span edges that read it (1 or 2)
        self._last = None  # (parent, stream, end event) of the last CUDA span, till a span opens
        self._times, self._texts = [], []  # the file's lines not yet written
        self._file = None

    @property
    def spans(self):
        return [SpanRecord(name, i, *rest) for i, (name, *rest) in enumerate(zip(*self._fields))]

    def _flush(self):
        t0 = self.t0_ns
        self._file.write("".join("%.6f %s\n" % ((t - t0) * 1e-9, text)
                                 for t, text in zip(self._times, self._texts)))
        self._file.flush()
        self._times.clear()
        self._texts.clear()

    def _line(self, t: int, text: str):
        self._times.append(t)
        self._texts.append(text)
        if len(self._times) >= FLUSH_LINES and self._file is not None:
            self._flush()


def _stream_key(device: torch.device):
    """(device index, raw pointer) of ``device``'s current stream."""
    idx = device.index if device.index is not None else torch._C._cuda_getDevice()
    return idx, torch._C._cuda_getCurrentRawStream(idx)


def _record(s: "Records", key):
    """A CUDA event recorded now on the stream ``key``; the stream object is
    made once per stream, not once per event."""
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(key[0])
    free = _free_events.setdefault(key[0], [])
    ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    s._uses[id(ev)] = 1
    return ev


class _Span:
    """The context manager of one span; what it records goes to its
    session's lists."""

    __slots__ = ("_s", "_name", "_device", "_id", "_begin_ev", "_rf")

    def __init__(self, s: Records, name: str, device):
        self._s, self._name, self._device, self._rf = s, name, device, None

    def __enter__(self):
        s = self._s
        last, s._last = s._last, None
        self._id = i = len(s._name)
        parent = s._stack[-1] if s._stack else None
        s._name.append(self._name)
        s._parent.append(parent)
        s._epoch.append(_epoch)
        s._end.append(None)
        s._self_ns.append(None)
        s._counts.append(None)
        s._dev_ms.append(None)
        s._dev_self_ms.append(None)
        s._child_ns.append(0)
        s._child_ms.append(0.0)
        s._stack.append(i)
        # the span is stamped before its annotation opens and after it
        # closes, so that the annotation lies within the span: the first
        # record_function of a profile takes about a millisecond to open
        t = _now()
        s._begin.append(t)
        if _profiling():
            self._rf = torch.profiler.record_function(self._name)
            self._rf.__enter__()
        if self._device is not None:
            key = _stream_key(self._device)
            if last is not None and last[0] == parent and last[1] == key:
                self._begin_ev = last[2]  # the sibling that just closed: its end is our begin
                s._uses[id(last[2])] += 1
            else:
                self._begin_ev = _record(s, key)
        s._line(t, self._name + ":begin")
        return self

    def __exit__(self, *exc):
        s, i = self._s, self._id
        if self._device is not None:
            key = _stream_key(self._device)
            end = _record(s, key)
            ids, begins, ends = s._pending.setdefault(key, ([], [], []))
            ids.append(i)
            begins.append(self._begin_ev)
            ends.append(end)
            s._last = (s._parent[i], key, end)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        s._end[i] = t = _now()
        dur = t - s._begin[i]
        s._self_ns[i] = dur - s._child_ns[i]
        s._stack.pop()
        parent = s._parent[i]
        if parent is not None:
            s._child_ns[parent] += dur
        s._line(t, self._name + ":end")
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _proc_index() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    return 0


def set_tracefile(path: str = "trace-%04d.txt"):
    """Open a session writing to ``path`` (a %d in it takes the process's
    rank); an open session is closed first, without an archive."""
    global _on, _session
    close(archive=None)
    if "%" in path:
        path = path % _proc_index()
    s = Records(path, _now())
    s._file = open(path, "w")
    s._file.write("# evo_tpu_torch trace, host=%s process=%d t0_unix_ns=%d\n"
                  % (os.uname().nodename, _proc_index(), s.t0_ns))
    _session, _on = s, True


def set_epoch(epoch: int):
    """The epoch that the spans opened from now on belong to."""
    global _epoch
    _epoch = epoch


def span(name: str, device: Optional[torch.device] = None):
    """A context manager recording the enclosed block as a span (see the
    module's docstring); ``device`` of type cuda adds its device time."""
    if not _on:
        return _NO_SPAN
    return _Span(_session, name, device if device is not None and device.type == "cuda" else None)


def active() -> bool:
    """Whether spans and counters are being recorded now."""
    return _on


def count(name: str, n: int):
    """Add the host integer ``n`` to the innermost open span's counter
    ``name`` (a no-op outside every span).  It reads no device tensor."""
    if not _on or not _session._stack:
        return
    counts = _session._counts
    i = _session._stack[-1]
    if counts[i] is None:
        counts[i] = {name: n}
    else:
        counts[i][name] = counts[i].get(name, 0) + n


def tracepoint(name: str):
    """A timestamped marker."""
    if _on:
        t = _now()
        _session.markers.append((t, name))
        _session._line(t, name)


def resolve():
    """Device times of the closed spans whose end event the card has
    passed, stream by stream in the order they closed; the events go back
    for reuse.  Call it after something has waited for the card (the
    trainer calls it after each epoch's stats transfer): it queries events
    and waits for none.  A stream runs its events in order, so when its last
    one is done, all are."""
    if not _on:
        return
    s = _session
    for (idx, _), (ids, begins, ends) in s._pending.items():
        done = len(ends)
        if done and not ends[-1].query():
            done = 0
            while ends[done].query():
                done += 1
        free = _free_events[idx]
        for i, begin, end in zip(ids[:done], begins, ends):
            ms = begin.elapsed_time(end)
            s._dev_ms[i], s._dev_self_ms[i] = ms, ms - s._child_ms[i]
            parent = s._parent[i]
            if parent is not None:
                s._child_ms[parent] += ms
            for ev in (begin, end):  # back for reuse once no unresolved edge reads it
                s._uses[id(ev)] -= 1
                if not s._uses[id(ev)]:
                    del s._uses[id(ev)]
                    free.append(ev)
                    if s._last is not None and s._last[2] is ev:
                        s._last = None
        for a in (ids, begins, ends):
            del a[:done]


@contextlib.contextmanager
def paused():
    """Spans, counters and markers record nothing in the enclosed block."""
    global _on
    was, _on = _on, False
    try:
        yield
    finally:
        _on = was


def records() -> Optional[Records]:
    """The open session, else the last one closed (None if there was none)."""
    return _session


def close(archive: Optional[str] = "traces.tgz"):
    """Close the session (a no-op without one): resolve what the card has
    finished, write the rest of the file and, with ``archive``, move it
    into that gzip tar.  A tar.gz cannot be appended to, so the archive is
    rewritten with its old members (from several processes' files closed in
    turn).  ``records()`` keeps the session."""
    global _on
    if not _on:
        return
    resolve()
    _on = False
    s = _session
    s._flush()
    s._file.close()
    s._file = None
    if archive and os.path.exists(s.path):
        members = []
        if os.path.exists(archive):
            with tarfile.open(archive, "r:*") as old:
                for m in old.getmembers():
                    data = old.extractfile(m).read() if m.isfile() else None
                    members.append((m, data))
        with tarfile.open(archive, "w:gz") as tar:
            for m, data in members:
                tar.addfile(m, io.BytesIO(data) if data is not None else None)
            tar.add(s.path)
        os.remove(s.path)


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
