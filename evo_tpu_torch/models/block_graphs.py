"""CUDA graphs of the phases of a data block, for the epoch runner
(``models/epoch.py``).

An epoch on complete data runs the same chain of small launches in every
block: ``block_gram`` and K^(n)'s lpj, the EA, the merge, the sufficient
statistics.  Launched op by op from Python, the chain costs the
host more time than the card spends on it.  ``PhaseGraphs`` captures each
phase of a block once as a CUDA graph and replays the graphs in every later
block, so that the host issues one launch a phase:

- the block's inputs are copied into static buffers before its replays, and
  its outputs are read from the graphs' static outputs after them;
- the runner copies Theta and its precomputed scalars into static buffers
  once an epoch; the accumulators are static and zeroed once an epoch
  (``begin_epoch``), and the epoch reads copies of them (``end_epoch``);
- the phases draw from one generator registered with the graphs, which
  takes the epoch generator's state before the epoch's first block and
  gives it back after the last, so that every block draws what it would
  draw eagerly;
- in the epoch that captures, the first block runs eagerly on the capture
  stream (the warm-up: the kernel library, cached sizes and the stream's
  cuBLAS workspace come to exist outside the capture), then the phases are
  captured in order into one memory pool.  Tracing records nothing during
  the capture, which runs no work; the replays run under the phases' spans.

Each replay adds the kernel launches its graph captured to the kernel
wrappers' launch counters, as the eager path counts them.
``engages`` holds the mechanism's own conditions; each model adds its own.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from evo_tpu_torch.utils import tracing


def engages(device, incomplete: bool, exact: bool, do_reconstruction: bool) -> bool:
    """Whether the mechanism can replay an epoch's blocks: on a CUDA
    device, on complete data without a reconstruction and in an EA epoch.
    The blocks of an epoch are slices of the blocked data, so they share
    one shape."""
    return (torch.device(device).type == "cuda" and not incomplete
            and not exact and not do_reconstruction)


class PhaseGraphs:
    """The captured phases of one block shape with their static buffers:
    ``io`` (the block's inputs, Theta's copies and, once captured, the
    phases' outputs) and ``acc`` (the epoch's accumulators), both namespaces
    of tensors made by the model.  ``key`` says what they were made for;
    ``counters`` lists the (function, attribute) launch counters that a
    replay advances."""

    def __init__(self, key, device, io: SimpleNamespace, acc: SimpleNamespace, counters):
        self.key, self.io, self.acc, self.counters = key, io, acc, counters
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.graphs = []  # [(graph, launches per counter)] once captured
        self._stream = self._pool = self._source = None

    @property
    def captured(self) -> bool:
        return bool(self.graphs)

    @property
    def stream(self) -> torch.cuda.Stream:
        """The stream the warm-up and the captures run on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def begin_epoch(self, generator) -> torch.Generator:
        """Zero the accumulators and give the graphs' generator the state of
        ``generator`` (None: the device's default generator); returns the
        generator the epoch's phases draw from."""
        if generator is None:
            generator = torch.cuda.default_generators[
                self.device.index if self.device.index is not None
                else torch.cuda.current_device()]
        self._source = generator
        self.generator.set_state(generator.get_state())
        for t in vars(self.acc).values():
            t.zero_()
        return self.generator

    def end_epoch(self) -> SimpleNamespace:
        """Give the epoch's generator the state its draws left, and return
        copies of the accumulators (the static ones are zeroed next epoch)."""
        self._source.set_state(self.generator.get_state())
        self._source = None
        return SimpleNamespace(**{k: v.clone() for k, v in vars(self.acc).items()})

    def warm_up(self, fn):
        """``fn()`` eagerly on the capture stream, ordered after the work
        enqueued so far and before what follows."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fns):
        """Capture each function of ``fns`` (the phases, in order) as one
        graph; the captures run no work and count no launch."""
        graphs = []  # kept only once every phase is captured
        with tracing.paused():
            for fn in fns:
                before = self._launches()
                try:
                    graph = self._capture_one(fn)
                finally:
                    launched = [a - b for a, b in zip(self._launches(), before)]
                    for (f, attr), n in zip(self.counters, before):
                        setattr(f, attr, n)
                graphs.append((graph, launched))
        self.graphs = graphs

    def _capture_one(self, fn):
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self._pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            fn()
        self._pool = graph.pool()  # the later phases share the first one's pool
        return graph

    def replay(self, k: int):
        """Replay phase ``k`` on the current stream."""
        graph, launched = self.graphs[k]
        graph.replay()
        for (f, attr), n in zip(self.counters, launched):
            if n:
                setattr(f, attr, getattr(f, attr) + n)

    def _launches(self):
        return [getattr(f, attr) for f, attr in self.counters]
