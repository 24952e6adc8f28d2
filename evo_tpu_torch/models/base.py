"""Data container, blocking and per-epoch statistics.

Counterpart: evo_tpu/models/base.py (``Data``, ``pad_rows``, ``make_data``,
``blockify``, ``unblockify``, ``block_gram``, ``StepStats``, ``em_steps``).
Every per-datapoint tensor is blocked [nb, B, ...]; each model's ``em_step``
loops over the nb blocks.

Randomness: evo_tpu's epoch e draws from ``fold_in(key, e)``; here epoch e
draws from ``epoch_generator(seed, e, device)``, a ``torch.Generator``
seeded from a fixed 64-bit mix of (seed, e).  Epoch e's draws depend on the
seed and e only, so stepping epoch by epoch, ``em_steps`` over any window
and a resume from a checkpoint all give the same trajectory.

Several processes (``evo_tpu_torch.parallel``): each rank holds its own
rows of every block, draws the whole block's EA random numbers from the
same generator and keeps its rows', and each epoch sums its statistics over
the ranks in one all_reduce before the M-step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from evo_tpu_torch._device import resolve_device
from evo_tpu_torch.parallel import distributed


@dataclasses.dataclass
class Data:
    """Observations and masks, blocked [nb, B, ...].

    y:         [nb, B, D] observations, missing entries zeroed
    x_infr:    [nb, B, D] bool — entries reliable for inference/learning
    x:         [nb, B, D] bool — entries to keep as-is in a reconstruction
    row_valid: [nb, B] bool — False for the padding rows
    incomplete: whether any entry of x_infr is False
    """

    y: torch.Tensor
    x_infr: torch.Tensor
    x: torch.Tensor
    row_valid: torch.Tensor
    incomplete: bool = False

    @property
    def n_blocks(self) -> int:
        return self.y.shape[0]

    @property
    def D(self) -> int:
        return self.y.shape[-1]


def pad_rows(N: int, multiple: int) -> int:
    return (-N) % multiple


def make_data(y: np.ndarray, x: Optional[np.ndarray] = None, n_blocks: int = 1,
              pad_multiple: int = 1, dtype=torch.float32, device=None) -> Data:
    """Build blocked ``Data`` from raw observations [N, D] (NumPy).

    Missing entries of ``y`` are marked NaN; they are zeroed and tracked in
    x_infr.  ``x`` defaults to x_infr.  Rows are padded to a multiple of
    n_blocks * pad_multiple.  ``device`` None means the CUDA card."""
    dev = resolve_device(device)
    y = np.asarray(y)
    N, D = y.shape
    x_infr = ~np.isnan(y)
    incomplete = bool((~x_infr).any())
    y = np.where(x_infr, y, 0.0)
    x = x_infr.copy() if x is None else np.asarray(x).astype(bool)
    pad = pad_rows(N, n_blocks * pad_multiple)
    if pad:
        y = np.concatenate([y, np.zeros((pad, D), y.dtype)], axis=0)
        x_infr = np.concatenate([x_infr, np.ones((pad, D), bool)], axis=0)
        x = np.concatenate([x, np.ones((pad, D), bool)], axis=0)
    row_valid = np.arange(N + pad) < N

    def blk(a, dt=None):
        t = torch.from_numpy(np.ascontiguousarray(a.reshape((n_blocks, -1) + a.shape[1:])))
        return t.to(device=dev, dtype=dt)

    return Data(y=blk(y, dtype), x_infr=blk(x_infr), x=blk(x),
                row_valid=blk(row_valid), incomplete=incomplete)


def _map_leaves(fn, tree):
    """``fn`` on a tensor or NumPy array, or on every such field of a
    dataclass (``Data``, ``EState``, the params); other fields
    (``Data.incomplete``) stay as they are."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_leaves(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


def blockify(tree, n_blocks: int):
    """[N, ...] -> [nb, N/nb, ...] on every leaf."""
    return _map_leaves(
        lambda a: a.reshape((n_blocks, a.shape[0] // n_blocks) + tuple(a.shape[1:])), tree)


def unblockify(tree):
    """[nb, B, ...] -> [nb*B, ...] on every leaf."""
    return _map_leaves(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), tree)


def check_em_step(data: Data, do_reconstruction: bool):
    """Raise the ValueError evo_tpu raises for incomplete data without
    reconstruction (its M-step consumes the reconstruction:
    evo_tpu/models/bsc.py:341-348, sssc.py:348-354)."""
    if data.incomplete and not do_reconstruction:
        raise ValueError(
            "incomplete data requires do_reconstruction=True: the M-step "
            "consumes the reconstructed data for its W update")


def host_data(data: Data, D: int, y_host=None):
    """(y [N, D], m [N, D]) on the host as the models' ``standard_init``
    reads them (evo_tpu/models/bsc.py:110-122): from ``y_host`` with NaN
    marking the missing entries (then zeroed), else the valid rows of the
    data and of x_infr."""
    if y_host is not None:
        y_raw = np.asarray(y_host).reshape(-1, D)
        m = ~np.isnan(y_raw)
        return np.where(m, y_raw, 0.0), m
    valid = data.row_valid.reshape(-1).cpu().numpy()
    return (data.y.reshape(-1, D).cpu().numpy()[valid],
            data.x_infr.reshape(-1, D).cpu().numpy()[valid])


def sum_over_ranks(model, params, data: Data, pre: dict, *sums: dict) -> tuple:
    """(pre, *sums) over every rank: under a process group the tensors of
    ``sums`` and the data sums of ``pre`` (``model.DATA_SUMS``) are summed
    over the ranks in one all_reduce and ``pre`` is made again from the
    global data sums (``params`` are the checked parameters it was made
    from); without a group everything is returned as it is."""
    if not distributed.active():
        return (pre,) + sums
    *sums, counts = distributed.allreduce_sums(*sums, {k: pre[k] for k in model.DATA_SUMS})
    return (model._precompute(params, data, counts), *sums)


def total_free_energy(model, params, data: Data, pre: dict, Fsum: torch.Tensor):
    """F = ljc + Fsum / N, over every rank under a process group."""
    pre, tot = sum_over_ranks(model, params, data, pre, {"Fsum": Fsum})
    return pre["ljc"] + tot["Fsum"] / pre["N"]


def block_gram(W: torch.Tensor, y_b: torch.Tensor, xinf_b: torch.Tensor,
               incomplete: bool):
    """The lpj precomputation of one block, (G, Wty, y2):

        complete:   G = W^T W                 shared [H, H]
        incomplete: G_n = W^T diag(m_n) W     per datapoint [B, H, H]
        Wty_n = W^T (m_n * y_n) [B, H],   y2_n = ||m_n * y_n||^2 [B]

    with m_n = xinf_b[n] (missing entries of y_b are already 0).  True f32:
    the package turns TF32 off.  The caller builds G_n one block at a time."""
    if not incomplete:
        return W.T @ W, y_b @ W, (y_b * y_b).sum(dim=-1)
    m = xinf_b.to(W.dtype)
    G = (m[:, :, None] * W).transpose(1, 2) @ W
    ym = y_b * m
    return G, ym @ W, (ym * ym).sum(dim=-1)


@dataclasses.dataclass
class StepStats:
    """Per-epoch diagnostics (0-dim tensors): the free energy F, the mean
    number of new unique states and of substitutions per datapoint, and the
    lpj reset counters, as evo_tpu reports them.  The guard fields surface
    the f32 guard rails (evo_tpu/models/base.py:152-180); a model without
    a rail reports 0 for it:

      n_guard_sigma_floor: 1 if BSC's sigma floor (1e-3 of the data RMS)
          clamped the update this epoch
      n_guard_mus_freeze / n_guard_psi_freeze: number of SSSC latent units
          whose mus / Psi rows were frozen at their previous value because
          their activation mass collapsed
      guard_psi_renorm: size of the SSSC gauge renormalization,
          max_h |log d_h| with d = sqrt(diag(Psi)), f32
    """

    F: torch.Tensor
    S_nunique: torch.Tensor
    S_sub: torch.Tensor
    n_reset_nan: torch.Tensor
    n_reset_small: torch.Tensor
    n_reset_inf: torch.Tensor
    n_guard_sigma_floor: torch.Tensor
    n_guard_mus_freeze: torch.Tensor
    n_guard_psi_freeze: torch.Tensor
    guard_psi_renorm: torch.Tensor


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def epoch_generator(seed: int, e: int, device) -> torch.Generator:
    """The generator of epoch ``e`` of a run seeded with ``seed`` (both
    non-negative), on ``device``: seeded from SplitMix64(SplitMix64(seed) +
    e), computed on the host, so making it costs no device operation."""
    if seed < 0 or e < 0:
        raise ValueError(f"seed {seed} and epoch {e} must be non-negative")
    mixed = _splitmix64((_splitmix64(seed & _MASK64) + e) & _MASK64)
    return torch.Generator(device=device).manual_seed(mixed)


def em_steps(model, params, estate, data: Data, seed: int, cfg, n_epochs: int, e0: int = 0):
    """``n_epochs`` EM epochs with no host step between them: epoch e0 + e
    runs ``model.em_step`` with ``epoch_generator(seed, e0 + e)``, so the
    trajectory is the one of stepping the same epochs one by one with those
    generators, bit for bit.  Nothing in the loop waits for the card.

    Complete data only: incomplete data need the reconstruction of every
    epoch, so use ``em_step`` with ``do_reconstruction=True`` (raises here).

    Returns (params, estate, stats) with every ``StepStats`` field stacked
    into an [n_epochs] tensor on the device."""
    if data.incomplete:
        raise ValueError(
            "em_steps supports complete data only: incomplete data "
            "requires per-epoch reconstruction (use em_step with "
            "do_reconstruction=True)")
    dev = data.y.device
    per_epoch = []
    for e in range(n_epochs):
        params, estate, stats, _ = model.em_step(
            params, estate, data, epoch_generator(seed, e0 + e, dev), cfg)
        per_epoch.append(stats)
    stacked = StepStats(**{f.name: torch.stack([getattr(s, f.name) for s in per_epoch])
                           for f in dataclasses.fields(StepStats)})
    return params, estate, stacked
