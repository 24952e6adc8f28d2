"""The initial state sets K^(n), the first rows of them.

Frozen copy of the draw in evo_tpu_torch/variational/state_init.py
(``_pack_rows``, ``_mark_duplicate_rows``, ``draw_initial_states``, whose
draws are evo_tpu's and the reference's), cut to the first chunk of rows:
NumPy's default_rng(seed) draws S Bernoulli(1/H) states per datapoint,
8192 datapoints at a time, and redraws a state that repeats another of its
datapoint until none does.  The rows of the first chunk depend only on the
seed, S and H, so the start of the program's set-up can be checked on them
without drawing all N.  Later changes of the program do not reach this copy.
"""

from __future__ import annotations

import numpy as np

CHUNK = 8192


def _pack_rows(ss: np.ndarray) -> np.ndarray:
    H = ss.shape[-1]
    W = -(-H // 64)
    pad = W * 64 - H
    if pad:
        ss = np.concatenate([ss, np.zeros(ss.shape[:-1] + (pad,), bool)], axis=-1)
    packed = np.packbits(ss, axis=-1)
    return np.ascontiguousarray(packed).view(np.uint64).reshape(ss.shape[:-1] + (W,))


def _mark_duplicate_rows(keys: np.ndarray) -> np.ndarray:
    N, S, W = keys.shape
    n_idx = np.repeat(np.arange(N, dtype=np.uint64), S)
    flat = keys.reshape(N * S, W)
    order = np.lexsort(tuple(flat[:, w] for w in range(W)) + (n_idx,))
    sorted_flat = flat[order]
    sorted_n = n_idx[order]
    same = (sorted_flat[1:] == sorted_flat[:-1]).all(axis=1) & (sorted_n[1:] == sorted_n[:-1])
    dup = np.empty(N * S, dtype=bool)
    dup[order] = np.concatenate([[False], same])
    return dup.reshape(N, S)


def first_states(seed: int, rows: int, S: int, H: int, N: int) -> np.ndarray:
    """The first ``rows`` (at most one chunk) of N datapoints' initial
    states, bool [rows, S, H], with p = 1/H and no permanent state."""
    n = min(CHUNK, N)  # the first chunk is drawn whole
    if rows > n:
        raise ValueError(f"at most {n} rows")
    rng = np.random.default_rng(seed)
    p = 1.0 / H
    ss = rng.random((n, S, H), dtype=np.float32) < p
    active = np.arange(n)
    for _ in range(1000):
        sub = ss[active]
        bad = _mark_duplicate_rows(_pack_rows(sub))
        n_bad = int(bad.sum())
        if n_bad == 0:
            break
        sub[bad] = rng.random((n_bad, H), dtype=np.float32) < p
        ss[active] = sub
        active = active[bad.any(axis=1)]
    else:
        raise RuntimeError("could not draw unique initial states")
    return ss[:rows]
