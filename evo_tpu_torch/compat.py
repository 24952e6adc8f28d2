"""Drop-in compatibility layer with the reference's dict-based API
(counterpart: evo_tpu/compat.py).

The reference drives training as (examples/bars-test/main.py:66-167):

    model = BSC(D, H, S)                       # or SSSC
    my_suff_stat = init_states(my_N, S, H, "fit", "randflip", 10, 1, 1)
    theta = model.check_params(model.standard_init(my_data))
    F, S_nunique, S_sub, theta = model.step(theta, my_suff_stat, my_data)

This module gives that surface on top of the port's models, so that a
reference user switches by changing one import.  ``theta`` is a plain dict
of NumPy arrays with the reference's key names (a dict that evo_tpu's
compat returns works unchanged); ``my_data`` is the reference dict
({"y"} and optionally "x_infr" and "x"); ``my_suff_stat`` is a dict that
carries the EAConfig and the EState (its "ss" and "lpj" on the device).

Notes:
  - N is the global number of datapoints.
  - ``device`` None means the CUDA card, as at every entry point of the
    port; pass ``device="cpu"`` to the model and to ``init_states`` for
    the CPU.
  - step k draws from ``epoch_generator(my_suff_stat["seed"], k)``, the
    port's counterpart of evo_tpu's ``fold_in(key(seed), k)``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from evo_tpu_torch.models import base as _base
from evo_tpu_torch.models.bsc import BSC as _BSC, BSCParams
from evo_tpu_torch.models.sssc import SSSC as _SSSC, SSSCParams
from evo_tpu_torch.variational import state_init as _si


def init_states(
    N, S, H, parent_selection="fit", mutation_algorithm="randflip",
    no_parents=10, no_children=1, no_generations=1, bitflip_prob=None,
    Mprime=None, p_init_Kn=None, permanent=None, seed=0, n_blocks=1, device=None,
):
    """The reference's signature (evo/variational/utils.py:155-228);
    ``permanent`` is the reference dict {"allzero": bool, "background":
    bool}."""
    permanent = permanent or {}
    cfg, estate = _si.init_states(
        N=N, S=S, H=H, parent_selection=parent_selection,
        mutation_algorithm=mutation_algorithm, no_parents=no_parents,
        no_children=no_children, no_generations=no_generations,
        bitflip_prob=bitflip_prob, Mprime=Mprime, p_init_Kn=p_init_Kn,
        allzero=bool(permanent.get("allzero", False)),
        background=bool(permanent.get("background", False)),
        seed=seed, n_blocks=n_blocks, device=device,
    )
    return {"cfg": cfg, "estate": estate, "seed": seed, "step": 0,
            "S_perm": cfg.S_perm,
            "permanent": {"allzero": cfg.allzero, "background": cfg.background}}


class _CompatModel:
    def __init__(self, D, H, S):
        self.D, self.H, self.S = D, H, S
        self._data: Optional[_base.Data] = None
        self._y_sig = None
        self._y_host = None

    @property
    def device(self) -> torch.device:
        return self._core.device

    # -- dict <-> params ----------------------------------------------------
    def _tensor(self, a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=self.device)

    def _to_dict(self, params) -> dict:
        return {f.name: getattr(params, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(params)}

    # -- data ---------------------------------------------------------------
    def _get_data(self, my_data: dict, n_blocks: int = 1) -> _base.Data:
        """The Data of the reference dict, made again only when its content
        or ``n_blocks`` changed.  The reference reads y, x_infr and x fresh
        every step, so a user may change them in place between steps: the
        cache is keyed on a blake2b digest of the masked y (NaN where
        x_infr is False) and of x, never on object identity."""
        y = np.asarray(my_data["y"], dtype=float)
        if "x_infr" in my_data:
            y = np.where(np.asarray(my_data["x_infr"], bool), y, np.nan)
        x = my_data.get("x")
        x_arr = np.asarray(x, bool) if x is not None else None
        fp = hashlib.blake2b(digest_size=16)
        fp.update(np.ascontiguousarray(y))
        if x_arr is not None:
            fp.update(np.ascontiguousarray(x_arr))
        sig = (y.shape, None if x_arr is None else x_arr.shape, fp.hexdigest(), n_blocks)
        if self._data is None or sig != self._y_sig:
            self._data = _base.make_data(y, x=x_arr, n_blocks=n_blocks, device=self.device)
            self._y_sig = sig
            self._y_host = y
        return self._data

    # -- reference API ------------------------------------------------------
    def standard_init(self, my_data: dict, **kwargs) -> dict:
        data = self._get_data(my_data)
        return self._to_dict(self._core.standard_init(data, y_host=self._y_host, **kwargs))

    def check_params(self, theta: dict) -> dict:
        return self._to_dict(self._core.check_params(self._to_params(theta)))

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def generate_data(self, theta: dict, N: int, seed: int = 0) -> dict:
        out = self._core.generate_data(self._to_params(theta), N, self._generator(seed))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def generate_from_hidden(self, theta: dict, my_hdata: dict, seed: int = 0) -> dict:
        s = torch.as_tensor(np.asarray(my_hdata["s"], bool), device=self.device)
        out = self._core.generate_from_hidden(self._to_params(theta), s, self._generator(seed))
        return {k: v.cpu().numpy() for k, v in out.items()}

    def step(self, theta: dict, my_suff_stat: dict, my_data: dict,
             do_reconstruction: bool = False):
        """The reference's Model.step (evo/models/_models.py:162-203):
        returns (F, S_nunique, S_sub, theta_new); a reconstruction goes to
        my_data["y_reconstructed"]."""
        estate = my_suff_stat["estate"]
        data = self._get_data(my_data, n_blocks=int(estate.ss.shape[0]))
        gen = _base.epoch_generator(my_suff_stat["seed"], my_suff_stat["step"], self.device)
        params, estate, stats, y_rec = self._core.em_step(
            self._to_params(theta), estate, data, gen, my_suff_stat["cfg"],
            do_reconstruction=do_reconstruction)
        my_suff_stat["estate"] = estate
        my_suff_stat["step"] += 1
        if do_reconstruction and y_rec is not None:
            N = np.asarray(my_data["y"]).shape[0]
            my_data["y_reconstructed"] = y_rec.cpu().numpy().reshape(-1, self.D)[:N]
        # one transfer for the three scalars
        F, n_uni, n_sub = torch.stack(
            [stats.F, stats.S_nunique.to(stats.F.dtype), stats.S_sub.to(stats.F.dtype)]).tolist()
        return F, n_uni, n_sub, self._to_dict(params)

    def free_energy(self, my_data: dict, theta: dict, my_suff_stat: dict = None,
                    full: bool = True):
        """The reference's free_energy (evo/models/_models.py:334-451): the
        exact one with ``full``, else the truncated one of my_suff_stat's
        states."""
        n_blocks = 1 if my_suff_stat is None else int(my_suff_stat["estate"].ss.shape[0])
        data = self._get_data(my_data, n_blocks=n_blocks)
        params = self._to_params(theta)
        if full:
            return float(self._core.exact_free_energy(params, data))
        return float(self._core.free_energy(params, my_suff_stat["estate"], data))


class BSC(_CompatModel):
    def __init__(self, D, H, S, to_learn=("W", "pi", "sigma"), device=None):
        self._core = _BSC(D=int(D), H=int(H), to_learn=tuple(to_learn), device=device)
        super().__init__(int(D), int(H), int(S))

    def _to_params(self, theta: dict) -> BSCParams:
        pies = theta.get("pies")
        if pies is None:
            pies = np.full(self.H, float(np.asarray(theta["pi"])))
        return BSCParams(W=self._tensor(theta["W"]), pi=self._tensor(theta["pi"]),
                         sigma=self._tensor(theta["sigma"]), pies=self._tensor(pies))


class SSSC(_CompatModel):
    def __init__(self, D, H, S, to_learn=("W", "pies", "mus", "sigma2", "Psi"), device=None,
                 **_ignored):
        self._core = _SSSC(D=int(D), H=int(H), to_learn=tuple(to_learn), device=device)
        super().__init__(int(D), int(H), int(S))

    def _to_params(self, theta: dict) -> SSSCParams:
        return SSSCParams(W=self._tensor(theta["W"]), pies=self._tensor(theta["pies"]),
                          mus=self._tensor(theta["mus"]), Psi=self._tensor(theta["Psi"]),
                          sigma2=self._tensor(theta["sigma2"]))
