"""Static configuration of the evolutionary E-step.

Counterpart: evo_tpu/variational/config.py:18-112, redeclared here with the
same fields, properties and checks (the port imports nothing of evo_tpu).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

SELECTIONS = ("fit", "rand")
MUTATIONS = ("randflip", "sparseflip", "cross", "cross_randflip", "cross_sparseflip")


@dataclasses.dataclass(frozen=True)
class EAConfig:
    S: int
    H: int
    n_parents: int
    n_children: int
    n_generations: int
    parent_selection: str = "fit"
    mutation_algorithm: str = "randflip"
    bitflip_prob: Optional[float] = None
    Mprime: Optional[int] = None  # max substitutions per datapoint; defaults to S
    # permanent states (reference: evo/variational/utils.py:39-54)
    allzero: bool = False
    background: bool = False
    # exact E-step mode: K^(n) = full 2^H_ enumeration, EA disabled
    exact: bool = False
    # number of blocks the batch is split into inside em_step
    n_blocks: int = 1
    # K^(n) stored lane-major bit-packed (uint8, 8x smaller; ops.bitpack)
    packed_states: bool = False
    # merge mode (reference vary_Kn params, utils.py:242-243): unification
    # merges the best children into K^(n); without it the children replace
    # the whole set, unconditionally or (reject_worse) only if the summed
    # lpj does not fall (utils.py:325-335)
    unification: bool = True
    reject_worse: bool = True
    # slot-stable unification merge (vary_Kn_swap): the same K^(n) set, the
    # surviving rows keep their slots
    swap_merge: bool = False

    def __post_init__(self):
        if self.parent_selection not in SELECTIONS:
            raise ValueError(f"parent_selection {self.parent_selection!r}")
        if self.mutation_algorithm not in MUTATIONS:
            raise ValueError(f"mutation_algorithm {self.mutation_algorithm!r}")
        if not self.exact and self.n_parents > self.S:
            raise ValueError("n_parents must be <= S (ref utils.py:209)")
        if "sparseflip" in self.mutation_algorithm and self.bitflip_prob is None:
            raise ValueError("sparseflip needs bitflip_prob")
        if "cross" in self.mutation_algorithm and self.n_parents < 2:
            raise ValueError(f"mutation '{self.mutation_algorithm}' needs "
                             f"n_parents >= 2 (got {self.n_parents})")
        if self.Mprime is not None and self.Mprime > self.S:
            raise ValueError("Mprime must be <= S")
        if self.allzero and self.background:
            raise ValueError("allzero and background exclude each other")
        if (not self.unification and not self.exact
                and self.children_per_gen * self.n_generations != self.S):
            raise ValueError(
                "non-unification mode needs n_new == S "
                f"(got {self.children_per_gen * self.n_generations} != {self.S})")

    @property
    def S_perm(self) -> int:
        return 1 if self.allzero else 0

    @property
    def H_mut(self) -> int:
        """Latent units the EA mutates (the background unit is excluded)."""
        return self.H - 1 if self.background else self.H

    @property
    def mprime(self) -> int:
        return self.S if self.Mprime is None else self.Mprime

    @property
    def children_per_gen(self) -> int:
        """Crossover yields n_parents*(n_parents-1) children, flip-based
        mutations n_parents*n_children."""
        if "cross" in self.mutation_algorithm:
            return self.n_parents * (self.n_parents - 1)
        return self.n_parents * self.n_children

    @property
    def n_new(self) -> int:
        """Total new candidate states per datapoint per E-step."""
        return 0 if self.exact else self.children_per_gen * self.n_generations
