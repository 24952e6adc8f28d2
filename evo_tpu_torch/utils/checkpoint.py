"""Train-state checkpoints with resume (counterpart:
evo_tpu/utils/checkpoint.py), in evo_tpu's file format.

One compressed .npz holds the parameters (``params/<field>``), the state
sets K^(n) and their lpj, the epoch and the run's seed, and a fingerprint
of the configuration, so that a killed run restarts where it stopped and a
resume under other flags fails loudly.  The keys:

  params/<field>     each parameter tensor
  estate_ss_packed   int8 states bit-packed along H (np.packbits, little bit
                     order) with estate_ss_H = H; or the lane-major packed
                     uint8 states as they are, with estate_ss_H = -1 and
                     packed_format = "lane"
  estate_lpj         the stored lpj
  epoch              epochs done
  rng_key            uint32 [hi, lo] of the seed: [0, seed], which is
                     jax.random.key_data(jax.random.key(seed)) in JAX's
                     default 32-bit mode
  fingerprint_json   cfg, model and data layout (when given)

A file written by either package loads in the other with equal params,
states, epoch and fingerprint.  evo_tpu's trainer saves its unfolded
``key(seed)``, which reads back here as the seed; after a resume across
packages each draws from its own generator.

Under a process group the file holds the global layout (each block's rows
[rank 0 | rank 1 | ...], as evo_tpu's multi-process checkpoint): every
rank takes part in gathering the states, rank 0 writes, and every rank
waits at a barrier; every rank reads the file and keeps its own rows.  So a
file written by K ranks loads in one process, in evo_tpu, or in K ranks.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Tuple

import numpy as np
import torch

from evo_tpu_torch.ops.bitpack import pack_bits_lane_host, pack_bits_u8, unpack_bits_u8
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.variational.state_init import EState

_SEP = "/"


def _fingerprint(cfg, model, data) -> dict:
    """Every setting whose silent change across a resume would alter the
    training dynamics (the EAConfig fields, the model's sizes and
    to_learn) or trip a shape error (the data's layout)."""
    fp = {}
    if cfg is not None:
        fp["cfg"] = dataclasses.asdict(cfg)
    if model is not None:
        fp["model"] = {"class": type(model).__name__, "D": int(model.D), "H": int(model.H),
                       "to_learn": sorted(model.to_learn)}
    if data is not None:  # the global shape: B of every rank together
        nb, B, D = data.y.shape
        fp["data"] = {"shape": [int(nb), int(B) * distributed.rank_world()[1], int(D)],
                      "incomplete": bool(data.incomplete)}
    return fp


def _check_fingerprint(saved: dict, now: dict, path: str) -> None:
    """Raise a ValueError naming every field that differs."""
    problems = []
    for section in now:
        if section not in saved:
            continue  # a file without this section: nothing to compare
        for k, v in now[section].items():
            old = saved[section].get(k, "<absent>")
            if old != v:
                problems.append(f"  {section}.{k}: checkpoint={old!r} current={v!r}")
    if problems:
        raise ValueError(
            f"checkpoint {path} was written by a run with a different "
            "configuration — resuming would silently change the training "
            "dynamics or trip shape errors:\n" + "\n".join(problems)
            + "\nStart a fresh run (or restore the original flags).")


def _atomic_savez(path: str, blobs: dict) -> None:
    """Write to a temporary file, then rename: a kill while writing leaves
    the previous checkpoint whole."""
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **blobs)
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, params: Any, estate: EState, epoch: int, seed: int,
                    cfg=None, model=None, data=None) -> None:
    """Write the checkpoint; pass cfg, model and data for the fingerprint
    that ``load_checkpoint`` checks.  ``seed`` is the run's uint32 seed.
    int8 states are packed on their own device.  Under a process group
    every rank must call it: the states are gathered into the global
    layout, rank 0 writes, and every rank returns once the file is there."""
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed {seed} is not a uint32")
    blobs = {f"params{_SEP}{f.name}": _host(getattr(params, f.name))
             for f in dataclasses.fields(params)}
    fp = _fingerprint(cfg, model, data)
    if fp:
        blobs["fingerprint_json"] = np.asarray(json.dumps(fp))
    if estate.ss.dtype == torch.uint8:  # lane-major packed (EAConfig.packed_states)
        blobs["estate_ss_packed"] = distributed.gather_global(estate.ss)
        blobs["estate_ss_H"] = np.asarray(-1)
        blobs["packed_format"] = np.asarray("lane")
    else:
        blobs["estate_ss_packed"] = distributed.gather_global(
            torch.stack([pack_bits_u8(b) for b in estate.ss]))
        blobs["estate_ss_H"] = np.asarray(estate.ss.shape[-1])
    blobs["estate_lpj"] = distributed.gather_global(estate.lpj)
    blobs["epoch"] = np.asarray(epoch)
    blobs["rng_key"] = np.asarray([0, seed], dtype=np.uint32)
    if distributed.rank_world()[0] == 0:
        _atomic_savez(path, blobs)
    distributed.barrier()


def load_checkpoint(path: str, params_like: Any, cfg=None, model=None,
                    data=None) -> Tuple[Any, EState, int, int]:
    """Returns (params, estate, epoch, seed), on the device of
    ``params_like`` (a params object of the run, which gives the fields).

    With cfg/model/data (as given to ``save_checkpoint``) the file's
    fingerprint is checked; a file without one skips the check.  States
    packed byte-major (``packed_format`` other than "lane") become
    lane-major.  Under a process group each rank keeps its own rows of the
    states and lpj."""
    fields = dataclasses.fields(params_like)
    dev = getattr(params_like, fields[0].name).device
    with np.load(path) as z:
        now = _fingerprint(cfg, model, data)
        if now and "fingerprint_json" in z:
            _check_fingerprint(json.loads(str(z["fingerprint_json"])), now, path)
        params = type(params_like)(**{
            f.name: torch.from_numpy(z[f"params{_SEP}{f.name}"]).to(dev) for f in fields})
        H = int(z["estate_ss_H"])
        packed = distributed.local_rows(torch.from_numpy(z["estate_ss_packed"])).numpy()
        if H == -1:
            fmt = str(z["packed_format"]) if "packed_format" in z else "byte"
            if fmt != "lane":
                # byte-major (np.packbits) packing: the pad bits are zero in
                # both layouts, so converting at the full byte width is exact
                bits = np.unpackbits(packed, axis=-1, bitorder="little").astype(bool)
                packed = pack_bits_lane_host(bits)
            ss = torch.from_numpy(packed).to(dev)
        else:
            ss = torch.stack([unpack_bits_u8(torch.from_numpy(b).to(dev), H).to(torch.int8)
                              for b in packed])
        lpj = distributed.local_rows(torch.from_numpy(z["estate_lpj"]))
        estate = EState(ss=ss, lpj=lpj.to(dev))
        epoch = int(z["epoch"])
        hi, lo = (int(w) for w in np.asarray(z["rng_key"], dtype=np.uint32))
    return params, estate, epoch, hi << 32 | lo
