"""Pub-sub metrics router (counterpart: evo_tpu/utils/datalog.py).

Named tables are routed to registered handlers, with a "*" wildcard;
``assign`` overwrites; ``ignored()`` lets a caller skip collecting a value
nobody reads; ``progress()`` prints timestamped lines.  Only the primary
process (rank 0 of a torch.distributed group, or the only process) writes.

The public API (handler/table policy, method names) follows the
reference's evo/utils/datalog.py, itself derived from the prosper library
(https://github.com/ml-uol/prosper, Academic Free License v3.0).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from time import strftime

import torch

from evo_tpu_torch.utils.autotable import AutoTable


def _is_primary() -> bool:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank() == 0
    return True


class DataHandler(ABC):
    """Base class for DataLog sinks."""

    def register(self, tblname):
        pass

    @abstractmethod
    def append(self, tblname, value):
        ...

    def append_all(self, valdict):
        for key, val in valdict.items():
            self.append(key, val)

    def assign(self, tblname, value):
        raise NotImplementedError(f"{type(self).__name__} does not support assign")

    def remove(self, tblname):
        pass

    def close(self):
        pass


class StoreToH5(DataHandler):
    """Route tables into an HDF5 file through an AutoTable.

    ``destination`` is an AutoTable, a filename, or None (AutoTable picks a
    name); pass one AutoTable to several handlers to share a file."""

    def __init__(self, destination=None, warnings: bool = True, async_writes: bool = False):
        self.destination = destination
        if not _is_primary():
            self.autotbl = None
            return
        if isinstance(destination, AutoTable):
            self.autotbl = destination
        elif isinstance(destination, str) or destination is None:
            self.autotbl = AutoTable(destination, warnings=warnings, async_writes=async_writes)
        else:
            raise TypeError("expects an AutoTable instance, a filename, or None")

    def __repr__(self):
        return f"StoreToH5 into file {self.destination}"

    def append(self, tblname, value):
        self.autotbl.append(tblname, value)

    def append_all(self, valdict):
        self.autotbl.append_all(valdict)

    def assign(self, tblname, value):
        self.autotbl.assign(tblname, value)

    def close(self):
        if self.autotbl is not None:
            self.autotbl.close()


class StoreToTxt(DataHandler):
    """Plain-text ``name = value`` lines into ``destination`` (a path,
    required: guessing one could clobber a file)."""

    def __init__(self, destination):
        if not _is_primary():
            self.txt_file = None
            return
        if not isinstance(destination, str):
            raise TypeError("StoreToTxt needs an output path")
        self.txt_file = open(destination, "w")

    def append(self, tblname, value):
        self.txt_file.write(f"{tblname} = {value}\n")
        self.txt_file.flush()

    def close(self):
        if self.txt_file is not None:
            self.txt_file.close()


class TextPrinter(DataHandler):
    """Print tables to stdout."""

    def append(self, tblname, value):
        if _is_primary():
            print(f"\t{tblname} = {value}")


_PROGRESS_BAR_WIDTH = 25


class DataLog:
    """Routes appended values to every handler whose registered table name
    matches (exactly, or through the '*' wildcard)."""

    def __init__(self):
        self.policy = []  # ordered (tblname, handler) pairs
        self._cache = {}

    def _lookup(self, tblname):
        if tblname not in self._cache:
            self._cache[tblname] = [h for (t, h) in self.policy if t == tblname or t == "*"]
        return self._cache[tblname]

    def progress(self, message, completed=None):
        """Timestamped progress line; with ``completed`` in [0, 1] a
        fixed-width percent bar is appended."""
        if not _is_primary():
            return
        stamp = strftime("%H:%M:%S")
        if completed is None:
            print(f"[{stamp}] {message}")
        else:
            frac = min(max(float(completed), 0.0), 1.0)
            filled = round(_PROGRESS_BAR_WIDTH * frac)
            bar = "#" * filled + "." * (_PROGRESS_BAR_WIDTH - filled)
            print(f"[{stamp}] {message} |{bar}| {100 * frac:3.0f}%")

    def append(self, tblname, value):
        if not _is_primary():
            return
        for h in self._lookup(tblname):
            h.append(tblname, value)

    def assign(self, tblname, value):
        if not _is_primary():
            return
        for h in self._lookup(tblname):
            h.assign(tblname, value)

    def append_all(self, valdict):
        if not _is_primary():
            return
        handlers = set()
        for tblname in valdict:
            handlers.update(self._lookup(tblname))
        for h in handlers:
            h.append_all({t: v for t, v in valdict.items() if h in self._lookup(t)})

    def ignored(self, tblname) -> bool:
        """True if appending to ``tblname`` would reach no handler."""
        return self._lookup(tblname) == []

    def set_handler(self, tblname, handler_class, *args, **kwargs):
        if not _is_primary():
            return None
        if not issubclass(handler_class, DataHandler):
            raise TypeError("handler_class must be a DataHandler subclass")
        handler = handler_class(*args, **kwargs)
        handler.register(tblname)
        names = [tblname] if isinstance(tblname, str) else list(tblname)
        for t in names:
            self.policy.append((t, handler))
        self._cache = {}
        return handler

    def remove_handler(self, handler):
        if not _is_primary():
            return
        if not isinstance(handler, DataHandler):
            raise ValueError("expected a DataHandler")
        self.policy = [(t, h) for (t, h) in self.policy if h is not handler]
        handler.close()
        self._cache = {}

    def close(self):
        if not _is_primary():
            return
        for (_, handler) in self.policy:
            handler.close()
