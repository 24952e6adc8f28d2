"""The unification merge's CUDA kernel (evo_tpu_torch/ops/varykn_merge.py,
csrc/varykn_merge.cu) on the CPU: its envelope (which shapes and dtypes
``vary_Kn`` sends to the kernel on a card), the wrapper refusing what lies
outside it, ``vary_Kn`` running the plain twin on the CPU, the merge's
counter among both models' launch counters, and a model of the kernel's
selection (order keys, places by counting, the Mprime mask by counting and
IEEE compares, rows copied) held bit for bit against ``vary_Kn``.  The
card's ``chip_smoke.py merge`` holds the kernel itself to the plain twin."""

import pytest
import torch

from evo_tpu_torch import BSC, SSSC
from evo_tpu_torch.ops import varykn_merge as vm
from evo_tpu_torch.ops.bitpack import pack_bits_lane
from evo_tpu_torch.variational.varykn import vary_Kn

NAN, INF = float("nan"), float("inf")
NEG_NAN = torch.tensor([-0x400000], dtype=torch.int32).view(torch.float32)  # bits 0xffc00000

# name: (B, S, T, W, Mprime, row dtype); the cells' merges at a few datapoints
CASES = {
    "ebsc": (6, 64, 10, 256, 64, torch.int8),
    "ebsc_packed": (6, 64, 10, 32, 64, torch.uint8),
    "es3c_inpaint": (9, 20, 10, 32, 20, torch.int8),
    "es3c_wide": (5, 64, 10, 256, 64, torch.int8),
    "mprime": (7, 12, 10, 16, 3, torch.int8),
    "ties": (8, 12, 10, 16, 12, torch.int8),
    "nan": (8, 12, 10, 16, 4, torch.int8),
    "w25": (5, 8, 6, 25, 8, torch.int8),
    "w13": (5, 8, 6, 13, 2, torch.uint8),
    "w100": (5, 8, 6, 100, 8, torch.int8),
    "no_children": (4, 8, 0, 16, 8, torch.int8),
    "cap": (2, 1000, 24, 4, 1000, torch.int8),
    "cap_mprime": (2, 24, 1000, 4, 7, torch.int8),
}


def _lpjs(name, B, n, gen):
    """[B, n] f32 lpjs of case ``name``: normal values, or for the tie
    cases values from a few levels with -inf duplicates, signed zeros and
    (``nan``) NaN of both signs."""
    if name not in ("ties", "nan", "mprime", "cap_mprime", "w13"):
        return torch.randn((B, n), generator=gen)
    levels = torch.tensor([-INF, -INF, -1.5, -0.0, 0.0, 2.0, 2.0, 7.25])
    if name == "nan":
        levels = torch.cat([levels, torch.tensor([NAN]), NEG_NAN])
    pick = torch.randint(len(levels), (B, n), generator=gen)
    return levels[pick]


def _case(name, gen=None):
    B, S, T, W, Mprime, dtype = CASES[name]
    gen = gen or torch.Generator().manual_seed(sum(map(ord, name)))
    lpjs = _lpjs(name, B, S + T, gen)
    if name == "ties":  # equal lpjs across old and new rows: the old row must win
        lpjs[:, S:S + 3] = lpjs[:, :3]
    rows = torch.randint(0, 256, (B, S + T, W), generator=gen, dtype=torch.int32)
    rows = rows.to(torch.uint8).view(dtype) if dtype == torch.int8 else rows.to(dtype)
    if name == "ebsc_packed":  # lane-major packed states of 256 units
        bits = torch.rand((B, S + T, 256), generator=gen) < 2 / 256
        rows = pack_bits_lane(bits.to(torch.int8))
    return (rows[:, :S].contiguous(), lpjs[:, :S].contiguous(), rows[:, S:].contiguous(),
            lpjs[:, S:].contiguous(), Mprime)


def _order_key(v):
    """The kernel's order keys of f32 values: ints that order as torch's
    sort orders the values (NaN above +inf, every NaN alike, -0.0 = +0.0)."""
    bits = v.view(torch.int32).to(torch.int64)
    mag = bits & 0x7FFFFFFF
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    key = torch.where(mag == 0, 0, key)
    return torch.where(mag > 0x7F800000, 2**31 - 1, key)


def _places(keys):
    """[B, n] keys -> [B, n] places in the stable descending order: the
    candidates before each one, by counting as the kernel does."""
    j = torch.arange(keys.shape[-1])
    kj, ki = keys[:, None, :], keys[:, :, None]
    return ((kj > ki) | ((kj == ki) & (j < j[:, None]))).sum(-1)


def kernel_model(ss, lpj, children, child_lpj, Mprime):
    """The kernel's steps on the CPU (csrc/varykn_merge.cu, steps 1-3)."""
    B, S, W = ss.shape
    T = children.shape[1]
    child = child_lpj.clone()
    if Mprime < T:
        rank = _places(_order_key(child))
        kth = child[rank == Mprime - 1][:, None]  # one child a row holds each rank
        greater, tie = child > kth, child == kth
        n_greater = greater.sum(-1, keepdim=True)
        tie_rank = torch.cumsum(tie.to(torch.int64), -1)
        keep = greater | (tie & (tie_rank <= Mprime - n_greater))
        child = torch.where(keep, child, -INF)
    raw = torch.cat([lpj, child], -1)
    places = _places(_order_key(raw))
    src = torch.empty((B, S), dtype=torch.int64)
    for b in range(B):
        kept = places[b] < S
        src[b, places[b][kept]] = torch.nonzero(kept)[:, 0]
    rows = torch.cat([ss, children], 1)
    ss_new = rows[torch.arange(B)[:, None], src]
    return ss_new, torch.gather(raw, -1, src), (src >= S).sum(-1), src


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:  # bits, so that -0.0 and NaN count
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_model_equals_vary_Kn(name):
    args = _case(name)
    _same(kernel_model(*args), vary_Kn(*args))


@pytest.mark.parametrize("seed", range(4))
def test_kernel_model_equals_vary_Kn_at_every_mprime(seed):
    gen = torch.Generator().manual_seed(seed)
    ss, lpj, children, child_lpj, _ = _case("mprime", gen)
    for Mprime in range(1, children.shape[1] + 2):
        args = (ss, lpj, children, child_lpj, Mprime)
        _same(kernel_model(*args), vary_Kn(*args))


def _meta(B, S, T, W, dtype=torch.int8, child_dtype=None, lpj_dtype=torch.float32,
          child_lpj_dtype=None, lpj_shape=None):
    """Tensors with the shapes and dtypes of a merge and no storage."""
    def e(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    return (e((B, S, W), dtype), e(lpj_shape or (B, S), lpj_dtype),
            e((B, T, W), child_dtype or dtype), e((B, T), child_lpj_dtype or lpj_dtype))


OUTSIDE = {
    "f64_lpjs": dict(lpj_dtype=torch.float64),
    "f64_child_lpjs": dict(child_lpj_dtype=torch.float64),
    "f16_rows": dict(dtype=torch.float16),
    "int32_rows": dict(dtype=torch.int32),
    "mixed_rows": dict(dtype=torch.int8, child_dtype=torch.uint8),
    "lpj_shape": dict(lpj_shape=(4, 9)),
}


@pytest.mark.parametrize("shape,opts,want", [
    *[((B, S, T, W), dict(dtype=dt), True) for B, S, T, W, _, dt in CASES.values()],
    ((4096, 64, 10, 256), {}, True),  # the EBSC cell's block
    ((4096, 64, 10, 32), dict(dtype=torch.uint8), True),  # its packed form
    ((151209, 20, 10, 32), {}, True),  # ES3C inpainting's one block
    ((62001, 64, 10, 256), {}, True),  # the wide cell's block
    ((4, 8, 6, 16), dict(dtype=torch.bool), True),  # any 1-byte dtype
    ((4, 1000, 24, 4), {}, True),  # S + T at the cap
    ((4, 1000, 25, 4), {}, False),  # past it
    ((4, 0, 6, 16), {}, False),  # no old state
    ((0, 8, 6, 16), {}, False),  # no datapoint
    ((4, 8, 6, 0), {}, False),  # empty rows
    *[((4, 8, 6, 16), opts, False) for opts in OUTSIDE.values()],
])
def test_fits_takes_the_kernels_shapes_and_dtypes(shape, opts, want):
    assert vm.fits(*_meta(*shape, **opts)) is want


@pytest.mark.parametrize("name", list(OUTSIDE) + ["past_the_cap"])
def test_the_wrapper_raises_outside_the_envelope(name):
    args = _meta(4, 1000, 25, 4) if name == "past_the_cap" else _meta(4, 8, 6, 16, **OUTSIDE[name])
    before = vm.varykn_merge.launches
    with pytest.raises(ValueError, match="envelope"):
        vm.varykn_merge(*args, 3)
    assert vm.varykn_merge.launches == before


def test_the_wrapper_wants_a_card_and_mprime_from_1():
    args = _case("w25")
    with pytest.raises(ValueError, match="CUDA"):
        vm.varykn_merge(*args)
    with pytest.raises(ValueError, match="Mprime"):
        vm.varykn_merge(*args[:4], 0)


@pytest.mark.parametrize("name", ["ebsc", "ebsc_packed", "es3c_inpaint"])
def test_vary_Kn_runs_the_plain_twin_on_the_cpu(name):
    args = _case(name)
    before = vm.varykn_merge.launches
    _same(vary_Kn(*args), vm.vary_Kn_plain(*args))
    assert vm.varykn_merge.launches == before


@pytest.mark.parametrize("model", [BSC, SSSC])
def test_replays_advance_the_merge_kernels_counter(model):
    assert model.LAUNCH_COUNTERS[0] == (vm.varykn_merge, "launches")
    assert len(set(model.LAUNCH_COUNTERS)) == len(model.LAUNCH_COUNTERS)
