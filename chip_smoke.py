#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (evo_tpu_torch) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one line each with its seconds:
  1. device    torch/CUDA versions and the card's name and power limit
  2. build     nvcc builds every kernel source of the package
  3. kernels   each kernel against its plain PyTorch version on the card, at
               the main path's shapes, with its time, the plain version's
               and the card's bound
  4. exact     one exact-mode epoch (H = 10, S = 2^10) through the kernels on
               the card against the same epoch on the CPU's plain path
  5. main      the main path at full width (N = 102,400, D = H = 256, S = 64,
               25 blocks, 10 parents x 1 child x 1 generation): 1 warm-up and
               3 timed EM epochs, with the kernels' launch counts checked,
               then one more epoch under torch.profiler: its kernel time,
               idle share and heaviest kernels
Then a JSON line with the kernels' numbers and, last, the result line.

Any failed check raises and the script exits non-zero; it also exits
non-zero without a result when no CUDA card is present.  The whole run is
under a self-enforced 600 s deadline.  It imports only evo_tpu_torch,
torch and numpy (so it fails at once outside the repository), and starts no
process but nvcc and nvidia-smi.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from evo_tpu_torch import BSC, init_states, make_data
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj, bsc_lpj_plain, key_words
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat, bsc_suffstat_plain

DEADLINE_S = 600
DEVICE = "cuda"
CARD = {"phase": "start"}

# Peak rates of the H100 (NVIDIA data sheets, SXM at 700 W, PCIe at 350 W):
# f32 outside the tensor cores (an FMA counts two), int32 (64 of the 128
# lanes of an SM, an op each, so a quarter of the f32 FLOP rate), memory.
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 16.75e12, 3.35e12),
         "NVIDIA H100 PCIe": (51e12, 12.75e12, 2.0e12)}

# bench.py's primary configuration (bench.py:25-34)
N_BLOCKS, B, H, S, D = 25, 4096, 256, 64, 256
N_PARENTS, N_CHILDREN, N_GENERATIONS = 10, 1, 1
WARM_EPOCHS, TIMED_EPOCHS = 1, 3


def _watchdog():
    print(f"DEADLINE: {DEADLINE_S} s passed in phase {CARD['phase']!r}; aborting",
          flush=True)
    os._exit(3)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        CARD["phase"] = self.name
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.name}] ok in {time.perf_counter() - self.t0:.1f} s", flush=True)


def say(msg):
    print(f"  {msg}", flush=True)


def peaks(name):
    if name not in PEAKS:
        raise RuntimeError(f"no peak rates known for {name!r}")
    return PEAKS[name]


def kernel_name(mangled):
    """The innermost name of an Itanium-mangled kernel, with a bool template
    argument shown: _ZN..14bsc_lpj_kernelILb1EEEv.. -> bsc_lpj_kernel<true>."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while j < len(mangled) and mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    return name + {"ILb1E": "<true>", "ILb0E": "<false>"}.get(mangled[i:i + 5], "")


def cuda_ms(fn, reps=10, warm=2):
    """Mean time of fn() on the card, by CUDA events over `reps` calls."""
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(f32_ops, int_ops, nbytes):
    """Least time for the work on this card: the larger of the operations
    (f32 and int32 pipes taken as running side by side) and the bytes."""
    peak_f32, peak_int, bw = peaks(CARD["name"])
    t_ops, t_bytes = max(f32_ops / peak_f32, int_ops / peak_int), nbytes / bw
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def binary_ops(ss):
    """f32 adds that binary states need, from this run's data: per state
    row with n bits on, s^T X s is a sum of the n^2 entries of X at its
    active pairs, and a sum over s or its weights takes n adds each (two
    such sums per row).  Returns (total adds, total bits on)."""
    n = ss.sum(-1, dtype=torch.float64)
    return float((n * n + 2 * n).sum()), float(n.sum())


def lpj_bound(ss, emit):
    """bound_ms of bsc_lpj on these states: the adds of binary_ops plus 6
    per row for the epilogue; keys need n bit inserts per row and, for the
    hash (H > 64), 2 multiply-adds per halfword and stream plus 2 fmix32 of
    6 ops; bytes are each input read once and each output written once."""
    Bk, K, Hk = ss.shape
    rows = Bk * K
    adds, bits = binary_ops(ss)
    W = key_words(Hk)
    int_ops = (bits + (rows * (4 * 2 * -(-Hk // 32) + 12) if Hk > 64 else 0)) if emit else 0
    nbytes = rows * Hk + 4 * (Bk * Hk + Bk + Hk * Hk + rows + (rows * W if emit else 0))
    return bound_ms(adds + 6 * rows, int_ops, nbytes)


def dense_f32_ms(flops):
    """Time of the dense f32 work the kernels do (not a bound of the
    function: binary states need far less, see binary_ops)."""
    return 1e3 * flops / peaks(CARD["name"])[0]


def lpj_inputs(Bk, K, Hk, gen, device):
    """Random inputs at main-path scale: states at the EA's sparsity
    (about 2 bits on), the first 64 datapoints' rows dense (half on)."""
    p = torch.full((Bk, 1, 1), 2.0 / Hk)
    p[:64] = 0.5
    ss = (torch.rand(Bk, K, Hk, generator=gen) < p).to(torch.int8)
    W = torch.randn(D, Hk, generator=gen)
    y = torch.randn(Bk, D, generator=gen) * 2
    return [t.to(device) for t in (ss, y @ W, (y * y).sum(-1), W.T @ W,
                                   torch.tensor(-0.5), torch.tensor(-5.54))]


def lpj_tolerance(ss, Wty, y2, G, pre1, pil_bar):
    """1e-5 of the magnitudes each lpj sums (the acceptance tolerance)."""
    sf = ss.double()
    sGs = ((sf @ G.double()) * sf).sum(-1)
    sW = (sf * Wty.double()[:, None, :]).sum(-1).abs()
    return 1e-5 * (abs(float(pre1)) * (y2.double()[:, None] + 2 * sW + sGs)
                   + abs(float(pil_bar)) * sf.sum(-1))


def check_kernels(device):
    gen = torch.Generator().manual_seed(0)
    rows = {}
    for Hk, K in ((256, 64), (256, 10), (64, 64), (40, 64)):
        args = lpj_inputs(B, K, Hk, gen, device)
        tol = lpj_tolerance(*args)
        for emit in (False, True):
            got, want = bsc_lpj(*args, emit_keys=emit), bsc_lpj_plain(*args, emit_keys=emit)
            torch.cuda.synchronize()
            if emit:
                (got, gk), (want, wk) = got, want
                if not torch.equal(gk, wk):
                    raise AssertionError(f"bsc_lpj keys differ at H={Hk} K={K}")
            err = (got.double() - want.double()).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"bsc_lpj H={Hk} K={K} emit={emit}: max err "
                                     f"{err.max().item():.3g} over tolerance")
            ms = cuda_ms(lambda: bsc_lpj(*args, emit_keys=emit))
            plain = cuda_ms(lambda: bsc_lpj_plain(*args, emit_keys=emit))
            bnd, by = lpj_bound(args[0], emit)
            dense = dense_f32_ms(2.0 * B * K * Hk * Hk + 4.0 * B * K * Hk)
            say(f"bsc_lpj H={Hk} K={K} keys={emit}: max_abs_err {err.max().item():.3g} "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), "
                f"dense f32 {dense:.4f} ms")
            if (Hk, K, emit) == (256, 64, True):  # the K^(n) launch of the main path
                rows["bsc_lpj"] = dict(max_abs_err=err.max().item(), ms=ms, plain_ms=plain,
                                       bound_ms=bnd, bound_by=by)

    p = torch.full((B, 1, 1), 2.0 / H)
    p[:64] = 0.5
    ss = (torch.rand(B, S, H, generator=gen) < p).to(torch.int8).to(device)
    rs = torch.softmax(torch.randn(B, S, generator=gen) * 3, -1).to(device)
    got, want = bsc_suffstat(ss, rs), bsc_suffstat_plain(ss, rs)
    torch.cuda.synchronize()
    errs = []
    for name, g, w, rel in zip(("rho", "sabs", "Wq"), got, want, (1e-5, 0.0, 1e-5)):
        err = (g - w).abs()
        if not bool((err <= rel * w.abs()).all()):
            raise AssertionError(f"bsc_suffstat {name}: max err {err.max().item():.3g} "
                                 f"over rel {rel}")
        errs.append(err.max().item())
    ms = cuda_ms(lambda: bsc_suffstat(ss, rs))
    plain = cuda_ms(lambda: bsc_suffstat_plain(ss, rs))
    # Wq adds rs to the n^2 active pairs of each row, rho and sabs take n each
    nbytes = B * S * H + 4 * (B * S + B * H + B * S + H * H)
    bnd, by = bound_ms(binary_ops(ss)[0], 0, nbytes)
    dense = dense_f32_ms(2.0 * B * S * H * H + 2.0 * B * S * H)
    say(f"bsc_suffstat H={H} S={S}: max_abs_err {max(errs):.3g} {ms:.4f} ms, "
        f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), dense f32 {dense:.4f} ms")
    rows["bsc_suffstat"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                                bound_ms=bnd, bound_by=by)
    return rows


def bars_data(Hx, N, seed):
    """Bars-test data (H/2 horizontal and H/2 vertical bars, amplitude 10,
    pi = 2/H, sigma = 1), made on the host."""
    R = Hx // 2
    W = np.zeros((R, R, Hx))
    for i in range(R):
        W[i, :, i] = 10.0
        W[:, i, R + i] = 10.0
    W = W.reshape(R * R, Hx)
    rng = np.random.default_rng(seed)
    s = rng.random((N, Hx)) <= 2.0 / Hx
    return (s @ W.T + rng.standard_normal((N, R * R))).astype(np.float32)


def exact_epoch(launches):
    Hx, Nx = 10, 4096
    Y = bars_data(Hx, Nx, seed=1)
    F, Ws = {}, {}
    for dev in ("cpu", DEVICE):
        model = BSC(D=Y.shape[1], H=Hx, device=dev)
        data = make_data(Y, n_blocks=2, device=dev)
        cfg, estate = init_states(N=Nx, S=2**Hx, H=Hx, n_blocks=2, device=dev)
        params = model.standard_init(data, seed=1, y_host=Y)
        if dev == DEVICE:
            launches.reset()
        params, estate, stats, _ = model.em_step(
            params, estate, data, torch.Generator(device=dev).manual_seed(0), cfg)
        F[dev], Ws[dev] = float(stats.F), params.W.cpu()
        if dev == DEVICE:
            launches.expect(lpj=2, suffstat=2)
    werr = (Ws[DEVICE] - Ws["cpu"]).abs().max().item()
    say(f"exact H={Hx} N={Nx}: F card {F[DEVICE]:.6f}, F cpu {F['cpu']:.6f}, "
        f"max |dW| {werr:.3g}")
    if not abs(F[DEVICE] - F["cpu"]) <= 1e-4 * abs(F["cpu"]):
        raise AssertionError("exact-mode F differs between the card and the CPU")
    if not werr <= 1e-3 * Ws["cpu"].abs().max().item():
        raise AssertionError("exact-mode W differs between the card and the CPU")


def primary_setup(device):
    """(model, data, cfg, estate, params) of the primary configuration, with
    synthetic data made on the host from seed 0 as bench.py:90-100 makes
    it, and initial states and Theta^0 from seed 0."""
    N = N_BLOCKS * B
    rng = np.random.default_rng(0)
    W_gen = rng.standard_normal((D, H)).astype(np.float32)
    s_gen = rng.random((N, H)) <= 2.0 / H
    Y = s_gen.astype(np.float32) @ W_gen.T + rng.standard_normal((N, D)).astype(np.float32)
    model = BSC(D=D, H=H, device=device)
    data = make_data(Y, n_blocks=N_BLOCKS, device=device)
    cfg, estate = init_states(N=N, S=S, H=H, no_parents=N_PARENTS, no_children=N_CHILDREN,
                              no_generations=N_GENERATIONS, n_blocks=N_BLOCKS, seed=0,
                              device=device)
    return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_epoch(model, params, estate, data, gen, cfg, median_ms):
    """One more epoch under torch.profiler (device activity only, to keep
    its host overhead small): its wall time, the summed time of its kernels
    (one stream, so they do not overlap), the idle share of its wall time,
    and the heaviest kernels by device time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.em_step(params, estate, data, gen, cfg)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    dev = sum(_device_us(e) for e in evts) / 1e3
    if not dev > 0:
        raise AssertionError("the profiler saw no kernel time on the card")
    say(f"profiled epoch: wall {wall:.1f} ms, kernels {dev:.1f} ms, idle share "
        f"{1 - dev / wall:.3f} (kernels over the unprofiled median: {dev / median_ms:.3f})")
    for e in sorted(evts, key=_device_us, reverse=True)[:8]:
        say(f"  {_device_us(e) / 1e3:8.2f} ms {e.count:5d}x {e.key[:70]}")


def main_path(launches):
    t0 = time.perf_counter()
    model, data, cfg, estate, params = primary_setup(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    say(f"set-up (host data, unique initial states, transfer) {time.perf_counter() - t0:.1f} s")

    launches.reset()
    Fs, ms = [], []
    for e in range(WARM_EPOCHS + TIMED_EPOCHS):
        t = time.perf_counter()
        params, estate, stats, _ = model.em_step(params, estate, data, gen, cfg)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        Fs.append(float(stats.F))
    counts = launches.expect(lpj=2 * N_BLOCKS * (WARM_EPOCHS + TIMED_EPOCHS),
                             suffstat=N_BLOCKS * (WARM_EPOCHS + TIMED_EPOCHS))
    timed = ms[WARM_EPOCHS:]
    say(f"F per epoch {[round(f, 4) for f in Fs]}")
    say(f"ms per epoch {[round(m, 1) for m in ms]} (first is warm-up); "
        f"timed median {sorted(timed)[len(timed) // 2]:.1f} ms on {CARD['smi']}")
    say(f"S_nunique {float(stats.S_nunique):.3f}, S_sub {float(stats.S_sub):.3f}, "
        f"resets {[int(x) for x in (stats.n_reset_nan, stats.n_reset_small, stats.n_reset_inf)]}")
    if not all(np.isfinite(Fs)):
        raise AssertionError(f"non-finite F: {Fs}")
    if not Fs[-1] > Fs[0]:
        raise AssertionError(f"F did not rise over the epochs: {Fs}")
    if tuple(estate.ss.shape) != (N_BLOCKS, B, S, H) or not bool(torch.isfinite(params.W).all()):
        raise AssertionError("malformed state or parameters after the epochs")
    profile_epoch(model, params, estate, data, gen, cfg, sorted(timed)[len(timed) // 2])
    return counts


class Launches:
    """Reads and resets the kernel wrappers' launch counters."""

    def __init__(self):
        self.fns = {"lpj": bsc_lpj, "suffstat": bsc_suffstat}

    def reset(self):
        for f in self.fns.values():
            f.launches = 0

    def expect(self, **want):
        got = {k: f.launches for k, f in self.fns.items()}
        if got != want:
            raise AssertionError(f"kernel launches {got}, expected {want}")
        return got


def main():
    timer = threading.Timer(DEADLINE_S, _watchdog)
    timer.daemon = True
    timer.start()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    with Phase("device"):
        CARD["name"] = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
        CARD["smi"] = smi
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} card(s)")
        print(smi, flush=True)
    with Phase("build"):
        info = _build.build()
        fn = "?"
        for ln in info["log"].splitlines():
            if "entry function" in ln:
                fn = kernel_name(ln.split("'")[1])
            elif "registers" in ln:
                say(f"{fn}: {ln.split('info    :')[-1].strip()}")
        say(f"nvcc, all sources in one call: {info['seconds']:.1f} s")
    launches = Launches()
    with Phase("kernels"):
        rows = check_kernels(DEVICE)
    with Phase("exact"):
        exact_epoch(launches)
    with Phase("main"):
        counts = main_path(launches)

    kernels = [
        dict(name="bsc_lpj", route="cuda", source="evo_tpu_torch/csrc/bsc_lpj.cu",
             replaces="evo_tpu/ops/pallas_lpj.py:97", launches=counts["lpj"],
             library_ms=None, **rows["bsc_lpj"]),
        dict(name="bsc_suffstat", route="cuda", source="evo_tpu_torch/csrc/bsc_suffstat.cu",
             replaces="evo_tpu/ops/pallas_suffstat.py:60", launches=counts["suffstat"],
             library_ms=None, **rows["bsc_suffstat"]),
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": CARD["name"],
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    timer.cancel()
    return 0


if __name__ == "__main__":
    sys.exit(main())
