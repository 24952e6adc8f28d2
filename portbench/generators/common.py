"""What the generators share: the program's EA arguments from a
configuration, and the reference's view of the data rows."""

from __future__ import annotations

import argparse

import numpy as np


def ea_args(config: dict, seed: int, n_blocks: int) -> argparse.Namespace:
    """The apps' EA flags (``apps.common.variational_parser``) from a
    configuration, with the seed of Theta^0 and K^0."""
    ea = config["ea"]
    return argparse.Namespace(
        seed=seed, n_blocks=n_blocks, Ksize=config["S"],
        parent_selection=ea["parent_selection"], mutation_algorithm=ea["mutation_algorithm"],
        no_parents=ea["n_parents"], no_children=ea["n_children"],
        no_generations=ea["n_generations"], bitflip_prob=None)


def ea_flags(config: dict) -> list:
    """The same as command-line flags of the image apps."""
    ea = config["ea"]
    return ["-H", str(config["H"]), "--Ksize", str(config["S"]),
            "--parent_selection", ea["parent_selection"],
            "--mutation_algorithm", ea["mutation_algorithm"],
            "--no_parents", str(ea["n_parents"]), "--no_children", str(ea["n_children"]),
            "--no_generations", str(ea["n_generations"])]


def blocked_rows(N: int, n_blocks: int, rank: int, world: int) -> np.ndarray:
    """[n_blocks, B_local] global row indices of this rank's rows, in the
    port's layout (apps/common.py:rank_pieces): the rows padded to a
    multiple of n_blocks * world, block b of rank p holding rows
    b B + p B_local ... b B + (p + 1) B_local; indices >= N are padding."""
    total = N + (-N) % (n_blocks * world)
    B = total // n_blocks
    Bl = B // world
    return (np.arange(n_blocks)[:, None] * B + rank * Bl + np.arange(Bl)[None, :])
