"""Data drawn from the model's own generative process, on the device.

Traffic keys: ``n_blocks``, ``rows_per_block`` (a rank's rows of a block;
N = n_blocks x rows_per_block x ranks) and ``data_model`` (D and H are the
configuration's):
``{"kind": "bsc", "pi": p, "sigma": s}`` (W_gen ~ N(0, 1) [D, H],
s_h ~ Bernoulli(p), y = W_gen s + N(0, s^2)) or ``{"kind": "sssc", "pi":
p, "sigma": s}`` (the slab z ~ N(0, 1) as well, y = W_gen (s z) + N(0,
s^2)).  Everything is drawn from one torch.Generator seeded with the
seed on the device, in a few large calls, then handed to the program's
set-up (``apps.common.rank_pieces``: make_data, standard_init,
init_states, this rank's rows) as the host array its users pass.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.generators.common import ea_args

_DRAW_ROWS = 1 << 16  # rows drawn per call, to bound the device's temporaries


def draw(traffic: dict, D: int, H: int, seed: int, device, world: int) -> np.ndarray:
    """Y [N, D] float32 on the host."""
    dm = traffic["data_model"]
    N = traffic["n_blocks"] * traffic["rows_per_block"] * world
    gen = torch.Generator(device=device).manual_seed(seed)
    W = torch.randn(D, H, generator=gen, device=device)
    out = np.empty((N, D), np.float32)
    for lo in range(0, N, _DRAW_ROWS):
        n = min(_DRAW_ROWS, N - lo)
        s = (torch.rand(n, H, generator=gen, device=device) < dm["pi"]).float()
        if dm["kind"] == "sssc":
            s = s * torch.randn(n, H, generator=gen, device=device)
        elif dm["kind"] != "bsc":
            raise ValueError(f"unknown data model {dm['kind']!r}")
        y = s @ W.T + dm["sigma"] * torch.randn(n, D, generator=gen, device=device)
        out[lo:lo + n] = y.cpu().numpy()
    return out


def make(traffic: dict, config: dict, seed: int, device, world: int = 1) -> dict:
    import evo_tpu_torch
    from evo_tpu_torch.apps.common import rank_pieces

    H = config["H"]
    D = config["D"]
    Y = draw(traffic, D, H, seed, device, world)
    model = getattr(evo_tpu_torch, config["model_class"])(D=D, H=H, device=device)
    pieces = rank_pieces(model, Y, ea_args(config, seed, traffic["n_blocks"]), device)
    return dict(model=model, reconstruct_at=None, make_callback=None, merge_every=None,
                init_seed=seed, ref=dict(Y=Y, image=None), **pieces)
