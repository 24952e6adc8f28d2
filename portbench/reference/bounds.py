"""The yardstick of the port's kernels: peak rates, the kernels' names, and
the operations and bytes each kernel call needs.

Frozen copies from chip_smoke.py (``PEAKS`` :215, ``PORT_KERNELS`` :223,
``kernel_name`` :275, ``bound_ms`` :328, ``lpj_bound`` :345,
``suffstat_bound`` :361, ``sssc_lpj_bound`` :731, ``sssc_suffstat_bound``
:746, ``gram_union_bytes``, ``masked_lpj_bound`` and
``masked_suffstat_bound`` :892-925), rewritten as functions of the states'
active-unit counts: n [rows] per state and u [datapoints] per datapoint
(the union of its states' units).  The count depends only on the shapes
and on the states evaluated, never on the code that evaluates them.  Later
changes of the program do not reach this copy.
"""

from __future__ import annotations

import torch

# (f32 FLOP/s outside the tensor cores, int32 op/s, bytes/s), NVIDIA's data
# sheets: SXM at 700 W and PCIe at 350 W
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 16.75e12, 3.35e12),
         "NVIDIA H100 PCIe": (51e12, 12.75e12, 2.0e12)}
# the kernels of evo_tpu_torch/csrc as a device trace names them
PORT_KERNELS = ("bsc_lpj_kernel", "bsc_lpj_dense", "bsc_suffstat_partial", "bsc_suffstat_reduce",
                "sssc_lpj_kernel", "sssc_suffstat_partial", "sssc_suffstat_reduce")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def kernel_name(mangled: str) -> str:
    """The innermost name of an Itanium-mangled kernel with its bool
    template arguments: _ZN..14bsc_lpj_kernelILb1ELb0EEEv.. ->
    bsc_lpj_kernel<true, false>; other names as they are."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while mangled[i:i + 2] == "Lb" and mangled[i + 3:i + 4] == "E":
            args.append("true" if mangled[i + 2] == "1" else "false")
            i += 4
    return name + (f"<{', '.join(args)}>" if args else "")


def seconds(work: dict, peaks) -> float:
    """Least time of one call's work on a card with these peaks: the larger
    of its operations (the f32 and int32 pipes taken as running side by
    side) and its bytes."""
    f32, ints, bw = peaks
    return max(work["f32"] / f32, work["int"] / ints, work["bytes"] / bw)


def _s(x) -> float:
    return float(x.sum()) if isinstance(x, torch.Tensor) else float(x)


def bsc_lpj(n, B: int, K: int, H: int, keys: bool = True) -> dict:
    """bsc_lpj on B datapoints' K int8 states each, n [B K] bits on: per
    state n^2 + 2n adds and 6 for the epilogue; keys: n bit inserts, and
    for H > 64 2 multiply-adds per halfword and stream plus 2 fmix32 of 6
    ops; bytes: states, Wty, y2, G, lpj and keys once."""
    rows = B * K
    key_words = -(-H // 32) if H <= 64 else 2
    f32 = _s(n * n + 2 * n) + 6 * rows
    ints = (_s(n) + (rows * (4 * 2 * -(-H // 32) + 12) if H > 64 else 0)) if keys else 0
    nbytes = rows * H + 4 * (B * H + B + H * H + rows + (rows * key_words if keys else 0))
    return dict(f32=f32, int=ints, bytes=nbytes)


def bsc_suffstat(n, B: int, S: int, H: int) -> dict:
    """bsc_suffstat on B datapoints' S int8 states: Wq adds r to the n^2
    active pairs of a state, rho and sabs n each; bytes: states, rs, the
    outputs rho [B, H], sabs [B, S] and Wq once."""
    return dict(f32=_s(n * n + 2 * n), int=0,
                bytes=B * S * H + 4 * (B * S + B * H + B * S + H * H))


def overflow_cap(H: int) -> int:
    return 0 if H <= 64 else 16


def sssc_lpj(n, B: int, K: int, H: int) -> dict:
    """sssc_lpj: per solved state with n units 2n^3 for Psi_AA G_AA, 2n^3/3
    for the LU, 8n^2 for G_AA a, Psi_AA u and two triangular solves, 6n for
    the sums (a state over the overflow cap is not solved); bytes: states,
    Wty, y2, G, Psi, mus, pil_bar, lpj and bad once."""
    cap = overflow_cap(H)
    if cap:
        n = torch.where(n <= cap, n, torch.zeros_like(n))
    f32 = _s(8.0 / 3.0 * n**3 + 8 * n**2 + 6 * n)
    return dict(f32=f32, int=0,
                bytes=B * K * H + 4 * (B * H + B + 2 * H * H + 2 * H + 2 * B * K))


def sssc_suffstat(n, u, B: int, S: int, H: int) -> dict:
    """sssc_suffstat: per solved state two n x n inversions (2n^3 each),
    4n^2 for G_AA mus and lambda u, n^2 for M, 4n^2 for the r shares, 4n
    for kappa and the sums (a flagged state n^2 + n); per datapoint 4u^2
    for the two outer products; bytes: inputs and outputs once."""
    cap = overflow_cap(H)
    solved = n <= cap if cap else torch.ones_like(n, dtype=torch.bool)
    f32 = _s(torch.where(solved, 4 * n**3 + 9 * n**2 + 4 * n, n**2 + n)) + _s(4 * u * u)
    return dict(f32=f32, int=0,
                bytes=B * S * H + 4 * (B * S + 3 * B * H + 2 * H * H + H + 4 * H * H))


def gram_union_bytes(u) -> float:
    """Bytes of G_n a masked kernel reads: u^2 f32 entries a datapoint."""
    return 4.0 * _s(u * u)


def sssc_lpj_masked(n, u, B: int, K: int, H: int) -> dict:
    """sssc_lpj_masked: per state two n x n Gauss-Jordan inversions (2n^3
    each), 6n^2 for M, G_AA a and lambda u, 8n for the sums; bytes: inputs
    once, G_n only on each datapoint's units, lpj and bad once."""
    return dict(f32=_s(4 * n**3 + 6 * n**2 + 8 * n), int=0,
                bytes=B * K * H + 4 * (B * H + B + H * H + 2 * H + 2 * B * K)
                + gram_union_bytes(u))


def sssc_suffstat_masked(n, u, B: int, S: int, H: int) -> dict:
    """sssc_suffstat_masked: the operations of sssc_suffstat, every state
    solved; bytes: inputs once (G_n on each datapoint's units), outputs
    once."""
    return dict(f32=_s(4 * n**3 + 9 * n**2 + 4 * n) + _s(4 * u * u), int=0,
                bytes=B * S * H + 4 * (B * S + 3 * B * H + H * H + H + 4 * H * H)
                + gram_union_bytes(u))
