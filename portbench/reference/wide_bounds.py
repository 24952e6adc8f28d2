"""The yardstick of the ES3C wide path: the operations and bytes that each
state's slab solve needs, as polynomials in its number of active units n,
and summed over a call through the program's counters (``wide.states``,
``wide.n1``, ``wide.n2``, ``wide.n3``: the states solved and the sums of
n, n^2 and n^3 over them; the empty state is not solved).

Per solved state, counted as ``bounds`` counts the kernels (an n x n LU
factorization 2n^3/3, a pair of triangular solves 2n^2 per right-hand
side, one operation per add, multiply, log):

- ``lpj`` (``wide.lpj``): u = Wty_A - G_AA a (2n^2 + n); Psi_AA's LU and
  inverse (2n^3/3 + 2n^3); M = s2inv G_AA + Psi_AA^-1 (2n^2); M's LU and
  M^-1 u (2n^3/3 + 2n^2); both log|det| (4n); ||y - W_A a||^2 from y2,
  a.Wty_A and a.(Wty_A - u) (5n + 3); u.M^-1 u (2n); the sum of pil_bar
  over A (n); the lpj (5): 10n^3/3 + 6n^2 + 13n + 8.  Bytes: the state as
  its n unit indices (int32), Wty_A and y2 in, lpj and bad out, 4 bytes
  each: 8n + 12.
- ``suffstat`` (``wide.suffstat``): the solve up to M^-1 u as above
  (10n^3/3 + 6n^2 + n); lambda = M^-1 (2n^3); kappa = s2inv M^-1 u + a
  (2n); r lambda added into the H^2 bins (2n^2): 16n^3/3 + 8n^2 + 3n.
  Bytes: the unit indices, Wty_A and r in, kappa_A out: 12n + 4.

G, Psi, mus and pil_bar are shared by every state and read once a call,
as are the statistics written once a call (moments over all states,
outside the solves); none is counted.  The count depends only on the
states solved, never on the code that solves them.
"""

from __future__ import annotations

from portbench.reference import bounds


def lpj(states, n1, n2, n3) -> dict:
    """Work of the wide lpj's solves: {f32, int, bytes}."""
    return dict(f32=10.0 / 3.0 * n3 + 6.0 * n2 + 13.0 * n1 + 8.0 * states, int=0,
                bytes=8.0 * n1 + 12.0 * states)


def suffstat(states, n1, n2, n3) -> dict:
    """Work of the wide suffstat's solves: {f32, int, bytes}."""
    return dict(f32=16.0 / 3.0 * n3 + 8.0 * n2 + 3.0 * n1, int=0,
                bytes=12.0 * n1 + 4.0 * states)


WORK = {"wide.lpj": lpj, "wide.suffstat": suffstat}
COUNTERS = ("wide.states", "wide.n1", "wide.n2", "wide.n3")


def least_seconds(span: str, counts: dict, peaks) -> float:
    """Least time on a card with ``peaks`` (``bounds.PEAKS``' entry) of the
    solves that the counters ``counts`` of the spans ``span`` describe."""
    work = WORK[span](*(counts.get(k, 0) for k in COUNTERS))
    return bounds.seconds(work, peaks)
