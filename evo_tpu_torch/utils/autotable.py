"""Append-oriented HDF5 store (counterpart: evo_tpu/utils/autotable.py).

One resizable dataset per table name, created at its first append; gzip
level 1 with the byte shuffle; a flush after every write; ``assign``
overwrites.  h5py is imported, and the file created, at the first write, so
nothing that only constructs an AutoTable needs h5py.

``async_writes=True`` moves every HDF5 operation onto one writer thread
(an h5py handle must not be written from two threads at once):
``append``/``assign`` validate at the call site, snapshot the value and
enqueue; ``close()`` drains the queue, then closes the file.  A writer
error is raised again by the next call or by ``close()``.
"""

from __future__ import annotations

import queue
import threading
from time import strftime
from typing import Optional

import numpy as np


class AutoTable:
    """HDF5 writer that creates one resizable dataset per table name.

    append(name, value): ``value`` becomes a new row of dataset ``name``
    (created at first use with shape [0, *value.shape]).
    assign(name, value): the dataset holds exactly one row, the latest value.
    """

    def __init__(self, fname: Optional[str] = None, compression: str = "gzip",
                 warnings: bool = True, async_writes: bool = False):
        self.fname = fname or strftime("autotable-%Y%m%d-%H%M%S.h5")
        self.h5 = None
        self._closed = False
        self.compression = compression
        self.warnings = warnings
        self._assigned = set()
        # name -> (shape, is_string): lets the async path raise a shape
        # mismatch at the append() call site
        self._shapes = {}
        self._q = None
        self._worker = None
        self._exc = None
        if async_writes:
            self._q = queue.Queue(maxsize=16)  # back-pressure if the writer lags
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    def _file(self):
        if self.h5 is None:
            if self._closed:  # reopening in "w" mode would truncate the file
                raise ValueError(f"AutoTable {self.fname} is closed")
            import h5py

            self.h5 = h5py.File(self.fname, "w")
        return self.h5

    def close(self):
        if self._q is not None:
            self._q.put(None)
            self._worker.join()
            self._q = None
            self._worker = None
        if self.h5 is not None:
            self.h5.close()
            self.h5 = None
        self._closed = True
        self._raise_pending()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    # ---- async plumbing ----------------------------------------------------
    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            op, name, row = item
            if self._exc is not None:
                continue  # keep consuming so that producers never block
            try:
                if op == "append":
                    self._append_sync(name, row)
                else:
                    self._assign_sync(name, row)
            except Exception as e:  # raised again by _raise_pending
                self._exc = e

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    # ---- value handling ----------------------------------------------------
    @staticmethod
    def _to_array(value) -> np.ndarray:
        if isinstance(value, str):
            return np.asarray(value.encode())
        a = np.asarray(value)
        if a.dtype == object:
            raise TypeError("cannot store object arrays")
        return a

    def _create(self, name: str, row: np.ndarray):
        import h5py

        h5 = self._file()
        if row.dtype.kind in "SU":
            h5.create_dataset(name, shape=(0,), maxshape=(None,), dtype=h5py.string_dtype())
            return
        kwargs = {}
        if row.ndim > 0 or row.size > 1:
            kwargs["compression"] = self.compression
            if self.compression == "gzip":
                kwargs["compression_opts"] = 1
                kwargs["shuffle"] = True
            if row.nbytes >= 4096:
                # one row per chunk: h5py's own chunks span many rows along
                # the append axis, so every append would rewrite the gzip
                # chunks holding past rows, at a cost growing with the rows
                kwargs["chunks"] = (1,) + row.shape
        h5.create_dataset(name, shape=(0,) + row.shape, maxshape=(None,) + row.shape,
                          dtype=row.dtype, **kwargs)

    # ---- public API ----------------------------------------------------------
    def append(self, name: str, value):
        self._raise_pending()
        row = self._to_array(value)
        if self._q is None:
            return self._append_sync(name, row)
        known = self._shapes.get(name)
        if known is not None:
            shape, is_str = known
            if not is_str and shape != row.shape:
                raise ValueError(f"shape mismatch appending to '{name}': {row.shape} vs {shape}")
        else:
            self._shapes[name] = (row.shape, row.dtype.kind in "SU")
        self._q.put(("append", name, np.array(row, copy=True)))

    def _append_sync(self, name: str, row: np.ndarray):
        h5 = self._file()
        if name not in h5:
            self._create(name, row)
        ds = h5[name]
        # validate before resizing: a resize-then-raise would leave a
        # phantom all-zero row that shifts every later row's epoch
        if row.dtype.kind not in "SU" and ds.shape[1:] != row.shape:
            raise ValueError(f"shape mismatch appending to '{name}': {row.shape} vs {ds.shape[1:]}")
        n = ds.shape[0]
        ds.resize(n + 1, axis=0)
        if row.dtype.kind in "SU":
            ds[n] = row.item() if row.dtype.kind == "S" else str(row)
        else:
            ds[n] = row
        h5.flush()

    def append_all(self, valdict: dict):
        for k, v in valdict.items():
            self.append(k, v)

    def assign(self, name: str, value):
        """Overwrite: the dataset holds the latest value only."""
        self._raise_pending()
        row = self._to_array(value)
        if self._q is None:
            return self._assign_sync(name, row)
        self._shapes[name] = (row.shape, row.dtype.kind in "SU")
        self._q.put(("assign", name, np.array(row, copy=True)))

    def _assign_sync(self, name: str, row: np.ndarray):
        h5 = self._file()
        if name in h5 and (name not in self._assigned or h5[name].shape[1:] != row.shape):
            del h5[name]
        if name not in h5:
            self._create(name, row)
            h5[name].resize(1, axis=0)
        if row.dtype.kind in "SU":
            h5[name][0] = row.item() if row.dtype.kind == "S" else str(row)
        else:
            h5[name][0] = row
        self._assigned.add(name)
        h5.flush()
