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
  5. main      the EBSC main path at full width (N = 102,400, D = H = 256,
               S = 64, 25 blocks, 10 parents x 1 child x 1 generation): 1
               warm-up and 3 timed EM epochs, with the kernels' launch counts
               checked, then one more epoch under torch.profiler: its kernel
               time, idle share and heaviest kernels
  6. exact_sssc   one exact-mode ES3C epoch (H = 8, S = 2^8) on the card
               against the same epoch on the CPU's plain path
  7. sssc_fl   ES3C at the reference's feature-learning widths (bench.py:
               233-243: N = 2048, D = 64, H = 100, S = 15, 5 parents x 2
               children): 1 warm-up and 3 timed epochs, launch counts checked
  8. sssc_primary  the repo's ES3C benchmark size (bench.py:181-191:
               N = 65,536 in 16 blocks, D = 25, H = 32, S = 20, 10 parents x
               1 child): the same, then one more epoch under torch.profiler
  9. exact_sssc_incomplete, exact_bsc_incomplete   one exact-mode epoch
               with 15% of the entries missing and reconstruction on the card
               against the same epoch on the CPU's plain path
 10. sssc_inpaint  ES3C inpainting at full width: a synthetic 321 x 481 RGB
               image from seed 0 with 10% of its entries missing, 5 x 5
               patches (N = 151,209, D = 75) in one block, H = 32, S = 20,
               10 parents x 1 child, learning W, pies and sigma2, the
               reconstruction every epoch: 1 warm-up and 3 timed epochs, one
               more under torch.profiler, then the mean and median merge of
               the last reconstruction on the card and their PSNR
 11. bsc_inpaint   EBSC (H = 32) on the same data: 1 warm-up, 2 timed epochs
 12. exact_packed  phase 4 with packed states, and with the permanent
               all-zero state, each on the card against the CPU
 13. main_packed   phase 5 with packed states (EAConfig.packed_states, from
               init_states(packed_states=True)): the packed-input kernels'
               launch counts checked, F per epoch equal to phase 5's, one
               more epoch under torch.profiler
 14. eopts     short EA runs of both models at bars size with the other
               E-step options (background with swap_merge, allzero with the
               whole-set merge, packed states with the whole-set merge that
               rejects nothing), each checked well formed
 15. trainer   phase 5's configuration through the training entry point,
               apps.training.EMTrainer, logging F to a text DataLog: run A
               steps 4 epochs one by one with a checkpoint every 2; run B
               resumes from A's epoch-2 checkpoint and runs epochs 3-4 as one
               chunk (em_steps); B's F per epoch, parameters and states must
               equal A's bit for bit, as must em_steps over the 4 epochs and
               the bare em_step loop, each with its launch counts checked;
               ms per epoch of the three, and the seconds to write and read
               the full-width checkpoint
 16. bars_app  the bars test's setup at the CLI defaults (H = 8, N = 500,
               S = 20) through EMTrainer: EBSC 40 epochs in chunks of 4, ES3C
               10 epochs; F finite and rising, printed against the exact
               likelihood L_gen, launch counts checked
 17. denoise_app  both models through apps/images.py's build and epoch
               callback (the merge on the card) and EMTrainer, at the
               denoising CLI's defaults on the synthetic 256 x 256 image
               (rescale 1.0, sigma = 25; N = 63,504, D = 25, H = 32): ES3C 1
               warm-up and 4 epochs, EBSC 2, a merge every epoch; ms per
               epoch, the merge's ms and PSNR, which must beat the noisy
               image's; launch counts checked
 18. inpaint_app  ES3C inpainting through the same code on phase 10's image
               and mask: 1 warm-up and 3 epochs, the reconstruction and merge
               on the card every epoch, the PSNR on the missing pixels beside
               phase 10's; the compact read-back of the last y_rec equal to
               the full gather bit for bit, and the host merge's PSNR within
               1e-3 dB of the card's
 19. feature_app  BSC and SSSC through apps/feature_learning.py's build on
               the synthetic patch file (N = 2000, D = 64, H = 100, S = 15,
               5 x 2): 5 epochs each, F finite and rising
 20. wide      the widths past the kernels' envelope, on the wide path: ES3C
               at H = 256 on phase 19's patches (no ES3C kernel launched),
               ES3C inpainting at H = 100 of a 128 x 128 synthetic image with
               10% missing (N = 15,376; no masked kernel launched), EBSC at
               H = 1280 (N = 4096, D = 256, S = 32; no bsc_lpj launch, one
               bsc_suffstat a block), with ms per epoch and peak memory, and
               2 epochs at the first width past each limit (ES3C inpainting
               at H = 65, EBSC at H = 1025); ES3C
               at H = 128 (kernels) and 129 (wide) on phase 7's data, for
               what the wide path costs, each with one more epoch under
               torch.profiler; the wide ES3C lpj on the card
               against the same function on the CPU at H = 256 and H = 100
 21. parallel  (run right after trainer, on its set-up) data parallelism
               over torch.distributed on the one card, the workers started
               with the spawn method: the EBSC primary at full width split
               over 2 gloo ranks (25 blocks of 2048 rows each; 1 + 3 epochs
               with epoch_generator(0, e) from this process's Theta^0 and
               states), the ranks' parameters equal bit for bit every
               epoch, F within rtol 2e-4 and W within rtol 1e-3, atol 1e-4
               of the same epochs in this process with no group, the number
               of first-epoch states that differ printed; rank 0's
               checkpoint after epoch 2 read here in one process, params
               and both ranks' rows of the states equal; then the ES3C
               primary over the same 2 ranks (1 + 2 epochs, F within rtol
               2e-4); then a one-rank NCCL group, 1 + 1 EBSC epochs equal to
               the no-group run bit for bit.  Per rank: ms per epoch and
               the all_reduce's ms per epoch (two processes sharing one
               card: no scaling figure), launch counts checked
 22. parallel_apps  the image apps over 2 ranks on the one card, each rank
               started as torchrun starts one (RANK, WORLD_SIZE, LOCAL_RANK,
               MASTER_ADDR and a free MASTER_PORT set; the group brought up
               by init_distributed(backend="gloo") from them alone) and
               running the apps' own build, epoch callback and EMTrainer on
               its own rows: ES3C denoising at the CLI's --rescale 1.0
               (N = 63,504, D = 25, H = 32, S = 20, sigma = 25; 1 + 2 epochs,
               a merge at the first and the last) and ES3C inpainting on
               phase 10's image and mask (N = 151,209 in one block padded to
               151,210; 1 + 2 epochs, a merge every epoch), the merges on the
               host of every rank after the reconstruction's gather; F per
               epoch within rtol 2e-4 and the mean merge's PSNR within
               0.05 dB of the same jobs in this process with pad_multiple=2,
               2 lpj and 1 suffstat launches per rank and epoch; per rank the
               ms per epoch, the all_reduce's, the gather's and the host
               merge's, and the gap to this process's pad_multiple=1 run
 23. compat    the reference's driver pattern (bars test, init_states,
               standard_init, check_params, step) through
               evo_tpu_torch.compat: 15 steps, F rising, the compat's exact
               free energy equal to the core model's
 24. epoch_graph  EBSC EA epochs whose blocks replay CUDA graphs of their
               phases against the same epochs run eagerly, at phase 5's
               widths in 4 blocks of 4,096 (the cell's shapes, an uneven last
               block, packed states): 3 epochs bit for bit alike, launch
               counts alike, one capture each; incomplete data and exact mode
               run eagerly; host ms per epoch of both paths; the merge
               kernel launched once a block on both paths, inside the
               captured merge graph on the graphed one
 25. merge     the unification merge's kernel (csrc/varykn_merge.cu)
               against its plain twin vary_Kn_plain bit for bit (K^(n),
               lpj bits, n_sub, idx; then relaunched): the EBSC block
               (4,096 x 64 + 10 x 256 int8) and its packed form (32-byte
               rows), ES3C inpainting's block (151,209 x 20 + 10 x 32), the
               wide cell's (62,001 x 64 + 10 x 256), Mprime < T, ties (-inf
               duplicates, equal lpjs across old and new rows, signed
               zeros, NaN), widths 25, 13, 100 and 50, a row pointer off
               16-byte alignment, S + T past a warp's 256 (a block a
               datapoint), at the cap and no children; each
               timed per call and from a CUDA graph beside its bytes bound
               and the plain twin's time; then 3 graphed EBSC epochs at
               phase 24's cell shapes with the kernel, bit for bit the same
               epochs with the plain twin
`python3 chip_smoke.py epoch_graph` runs phases 1, 2 and 24 alone;
`python3 chip_smoke.py merge` phases 1, 2 and 25;
`python3 chip_smoke.py suffstat` phases 1 and 2 and the EBSC suffstat
kernel's density checks and timings of phase 3.
The kernels phase also holds the ES3C kernels, the masked ones (incomplete
data) included, against their plain versions at those paths' shapes, and
the packed-input EBSC kernels against their plain versions and, bit for
bit, against the int8 kernels on the same states, and both EBSC kernels at
the ends of their density range (rows with no bit or every bit on, one
dense row among sparse ones, a ragged H = 100, H = 1024; the suffstat also
H = 10 with S = 1024, H = 32 and 40, a B that fills no whole unit, rows
with rs exactly 0, the bsc_inpaint block, and two launches bit for bit
alike) with their times on states at the EA's sparsity only and on states
all half on, the suffstat also on EA-converged states (each datapoint's
states one- and two-bit flips of a 2-unit core, checked as the others) and
beside Wq's dense product in cuBLAS.  Both
ES3C suffstat kernels are also held to their plain versions where their
paths meet (states at the sparse path's threshold and one past it, |s| =
H - 1 and H, rows with no bit on or r exactly 0, equal states, a B that
fills no whole unit, a masked datapoint whose states are all dense at
H = 64, the overflow cap at H = 100 and 128, S = 600, S = 1 and H = 13),
and every ES3C suffstat check relaunches the kernel and wants the outputs
bit for bit.  Both ES3C lpj kernels are held to their plain versions at the
same kind of edges (|s| = 8, 9, H - 1 and H, rows with no bit on, equal
states, K = 1 and 300, H = 13, the cap at H = 100 and 128, the poisoned
Psi, a dense masked datapoint at H = 64, pivots of M' at 1.5e-6 and 0.5e-6
and a masked Psi_AA pivot of 1e-8), each relaunched bit for bit.
Every kernel's time (`ms`) is that of a call, by CUDA events around calls;
every kernel also has its device time (`device_ms`, calls replayed from a
CUDA graph, so the host's launch cost is left out).  Then a JSON line with
the kernels' numbers and, last, the result line.

Any failed check raises and the script exits non-zero, as does a worker
of the parallel or parallel_apps phase that fails or overruns its time
limit (all of them are then killed); it also exits non-zero without a
result when no CUDA card is present.  The whole run is under a self-enforced 600 s deadline,
which also kills the workers.  It imports only evo_tpu_torch, torch and
numpy (so it fails at once outside the repository), needs neither h5py nor
matplotlib, writes only under the temporary directory, and starts no
process but nvcc, nvidia-smi and the two parallel phases' workers (two at
most at a time, each under a wall-clock limit).
"""

import contextlib
import dataclasses
import hashlib
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from evo_tpu_torch import BSC, SSSC, SSSCParams, init_states, make_data
from evo_tpu_torch.apps import bars, feature_learning, images
from evo_tpu_torch.apps.common import chunking_kwargs
from evo_tpu_torch.apps.training import EMTrainer
from evo_tpu_torch.models import block_graphs
from evo_tpu_torch.models.base import StepStats, block_gram, em_steps, epoch_generator
from evo_tpu_torch.ops import _build
from evo_tpu_torch.ops.bitpack import (
    n_bytes_lane, pack_bits_lane, pack_bits_u8, unpack_bits_lane, unpack_bits_u8)
from evo_tpu_torch.ops.bsc_lpj import bsc_lpj, bsc_lpj_plain, key_words
from evo_tpu_torch.ops.bsc_suffstat import bsc_suffstat, bsc_suffstat_plain
from evo_tpu_torch.ops.sssc_lpj import (
    overflow_cap,
    sssc_lpj,
    sssc_lpj_masked,
    sssc_lpj_masked_plain,
    sssc_lpj_plain,
)
from evo_tpu_torch.ops.sssc_suffstat import (
    SPARSE_N,
    sssc_suffstat,
    sssc_suffstat_masked,
    sssc_suffstat_plain,
)
from evo_tpu_torch.ops.varykn_merge import vary_Kn_plain, varykn_merge
from evo_tpu_torch.models.sssc import sssc_lpj_wide
from evo_tpu_torch.prepost import MultiDimOverlappingPatches, psnr
from evo_tpu_torch.prepost.device_merge import DeviceMerger
from evo_tpu_torch.utils.checkpoint import load_checkpoint
from evo_tpu_torch.utils import tracing
from evo_tpu_torch.utils.datalog import DataLog, StoreToTxt
from evo_tpu_torch.variational import varykn
from evo_tpu_torch.variational.state_init import EState

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
# the epoch_graph phase: the main path's block shape, fewer blocks
GRAPH_BLOCKS, GRAPH_EPOCHS = 4, 3
# the kernels of evo_tpu_torch/csrc, as the profiler names them
PORT_KERNELS = ("bsc_lpj_kernel", "bsc_lpj_dense", "bsc_suffstat_partial", "bsc_suffstat_reduce",
                "sssc_lpj_kernel", "sssc_suffstat_partial", "sssc_suffstat_reduce")
# bench.py's two ES3C configurations: its N = 65,536 benchmark
# (bench.py:181-191) and the reference's feature-learning default
# (bench.py:233-243, with slab noise in its data); each (n_blocks, B, D, H,
# S, parents, children, slab noise)
SSSC_PRIMARY = (16, 4096, 25, 32, 20, 10, 1, False)
SSSC_FL = (1, 2048, 64, 100, 15, 5, 2, True)
# ES3C inpainting at the size PARITY.md runs it (castle.jpg, 321 x 481 RGB;
# the image apps' defaults, evo_tpu/apps/common.py:75,151 and images.py:63-68):
# 5 x 5 patches, one block, H, S, parents x children, 10% missing
INPAINT_IMAGE, INPAINT_PATCH, INPAINT_MISSING = (321, 481, 3), 5, 0.10
INPAINT_H, INPAINT_S, INPAINT_PARENTS, INPAINT_CHILDREN = 32, 20, 10, 1
INPAINT_N = (INPAINT_IMAGE[0] - INPAINT_PATCH + 1) * (INPAINT_IMAGE[1] - INPAINT_PATCH + 1)
INPAINT_D = INPAINT_PATCH**2 * INPAINT_IMAGE[2]
# the wide phase's EBSC: (H, N), past bsc_lpj's H <= 1024
WIDE_BSC = (1280, 4096)


def _watchdog():
    print(f"DEADLINE: {DEADLINE_S} s passed in phase {CARD['phase']!r}; aborting",
          flush=True)
    for p in CHILDREN:
        if p.is_alive():
            p.kill()
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
    """The innermost name of an Itanium-mangled kernel, with its bool
    template arguments shown: _ZN..14bsc_lpj_kernelILb1ELb0EEEv.. ->
    bsc_lpj_kernel<true, false>."""
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


def graph_ms(fn, reps=10):
    """Mean time of fn() on the card with the host's launch cost left out:
    `reps` calls captured in one CUDA graph, replayed between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def lpj_bound(ss, emit, packed=False):
    """bound_ms of bsc_lpj on these states (int8, or with ``packed`` their
    lane-major bytes): the adds of binary_ops plus 6 per row for the
    epilogue; keys need n bit inserts per row and, for the hash (H > 64), 2
    multiply-adds per halfword and stream plus 2 fmix32 of 6 ops; bytes are
    each input read once and each output written once."""
    Bk, K, Hk = ss.shape
    rows = Bk * K
    adds, bits = binary_ops(ss)
    W = key_words(Hk)
    int_ops = (bits + (rows * (4 * 2 * -(-Hk // 32) + 12) if Hk > 64 else 0)) if emit else 0
    state_bytes = rows * (n_bytes_lane(Hk) if packed else Hk)
    nbytes = state_bytes + 4 * (Bk * Hk + Bk + Hk * Hk + rows + (rows * W if emit else 0))
    return bound_ms(adds + 6 * rows, int_ops, nbytes)


def suffstat_bound(ss, packed=False):
    """bound_ms of bsc_suffstat on these states (int8, or with ``packed``
    their bytes): Wq adds rs to the n^2 active pairs of each row, rho and
    sabs take n each; bytes are each input read once and each output
    written once."""
    Bk, S_, Hk = ss.shape
    state_bytes = Bk * S_ * (n_bytes_lane(Hk) if packed else Hk)
    nbytes = state_bytes + 4 * (Bk * S_ + Bk * Hk + Bk * S_ + Hk * Hk)
    return bound_ms(binary_ops(ss)[0], 0, nbytes)


def dense_f32_ms(flops):
    """Time of the dense f32 work the kernels do (not a bound of the
    function: binary states need far less, see binary_ops)."""
    return 1e3 * flops / peaks(CARD["name"])[0]


def lpj_inputs(Bk, K, Hk, gen, device, dense=64):
    """Random inputs at main-path scale: states at the EA's sparsity
    (about 2 bits on), the first ``dense`` datapoints' rows dense (half on)."""
    p = torch.full((Bk, 1, 1), 2.0 / Hk)
    p[:dense] = 0.5
    ss = (torch.rand(Bk, K, Hk, generator=gen) < p).to(torch.int8)
    return lpj_args(ss, gen, device)


def lpj_args(ss, gen, device):
    """bsc_lpj's arguments for int8 states ss [B, K, H]: random data of
    width D under a random W, and the main path's pre1 and pil_bar."""
    W = torch.randn(D, ss.shape[-1], generator=gen)
    y = torch.randn(ss.shape[0], D, generator=gen) * 2
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
            dev_ms = graph_ms(lambda: bsc_lpj(*args, emit_keys=emit))
            plain = cuda_ms(lambda: bsc_lpj_plain(*args, emit_keys=emit))
            bnd, by = lpj_bound(args[0], emit)
            dense = dense_f32_ms(2.0 * B * K * Hk * Hk + 4.0 * B * K * Hk)
            say(f"bsc_lpj H={Hk} K={K} keys={emit}: max_abs_err {err.max().item():.3g} "
                f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms "
                f"({by}), dense f32 {dense:.4f} ms")
            if (Hk, K, emit) == (256, 64, True):  # the K^(n) launch of the main path
                rows["bsc_lpj"] = dict(max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms,
                                       plain_ms=plain, bound_ms=bnd, bound_by=by)

    p = torch.full((B, 1, 1), 2.0 / H)
    p[:64] = 0.5
    ss = (torch.rand(B, S, H, generator=gen) < p).to(torch.int8).to(device)
    rs = torch.softmax(torch.randn(B, S, generator=gen) * 3, -1).to(device)
    got, want = bsc_suffstat(ss, rs), bsc_suffstat_plain(ss, rs)
    torch.cuda.synchronize()
    errs = suffstat_errors_bsc("H=256", got, want)
    ms = cuda_ms(lambda: bsc_suffstat(ss, rs))
    dev_ms = graph_ms(lambda: bsc_suffstat(ss, rs))
    plain = cuda_ms(lambda: bsc_suffstat_plain(ss, rs))
    bnd, by = suffstat_bound(ss)
    dense = dense_f32_ms(2.0 * B * S * H * H + 2.0 * B * S * H)
    say(f"bsc_suffstat H={H} S={S}: max_abs_err {max(errs):.3g} {ms:.4f} ms (device "
        f"{dev_ms:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}), dense f32 "
        f"{dense:.4f} ms")
    rows["bsc_suffstat"] = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms, plain_ms=plain,
                                bound_ms=bnd, bound_by=by)
    return rows


def suffstat_errors_bsc(label, got, want):
    """rho and Wq of bsc_suffstat within relative 1e-5 of the plain
    version's, entry by entry, and sabs equal; returns the largest absolute
    errors."""
    errs = []
    for name, g, w, rel in zip(("rho", "sabs", "Wq"), got, want, (1e-5, 0.0, 1e-5)):
        err = (g - w).abs()
        if not bool((err <= rel * w.abs()).all()):
            raise AssertionError(f"bsc_suffstat {label} {name}: max err {err.max().item():.3g} "
                                 f"over rel {rel}")
        errs.append(err.max().item())
    return errs


def check_packed_kernels(device, gen):
    """The packed-input modes of both EBSC kernels on lane-major packed
    states: bit for bit against the int8 kernels on the same states (lpj,
    keys, rho, sabs and Wq: only the staging differs), and against their
    plain versions within the int8 rows' tolerances, at the main path's
    blocks (H = 256: K = 64 and the 10 children; S = 64), at a ragged
    H = 100 (13 bytes a row, 4 pad bits) and at H <= 64 (exact key words),
    the lpj in both emit_keys settings."""
    rows = {}
    for Hk, K in ((256, 64), (256, 10), (100, 64), (64, 64), (40, 64)):
        args = lpj_inputs(B, K, Hk, gen, device)
        pk = pack_bits_lane(args[0])
        if not torch.equal(unpack_bits_lane(pk, Hk).to(torch.int8), args[0]):
            raise AssertionError(f"packing does not round-trip at H={Hk}")
        tol = lpj_tolerance(*args)
        for emit in (False, True):
            got = bsc_lpj(pk, *args[1:], emit_keys=emit)
            ref = bsc_lpj(*args, emit_keys=emit)
            want = bsc_lpj_plain(pk, *args[1:], emit_keys=emit)
            torch.cuda.synchronize()
            if emit:
                (got, gk), (ref, rk), (want, wk) = got, ref, want
                if not (torch.equal(gk, rk) and torch.equal(gk, wk)):
                    raise AssertionError(f"bsc_lpj packed keys differ at H={Hk} K={K}")
            if not torch.equal(got, ref):
                raise AssertionError(f"bsc_lpj packed H={Hk} K={K} emit={emit}: not "
                                     "bit-identical to the int8 kernel")
            err = (got.double() - want.double()).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"bsc_lpj packed H={Hk} K={K} emit={emit}: max err "
                                     f"{err.max().item():.3g} over tolerance")
            ms = cuda_ms(lambda: bsc_lpj(pk, *args[1:], emit_keys=emit))
            dev_ms = graph_ms(lambda: bsc_lpj(pk, *args[1:], emit_keys=emit))
            plain = cuda_ms(lambda: bsc_lpj_plain(pk, *args[1:], emit_keys=emit))
            bnd, by = lpj_bound(args[0], emit, packed=True)
            say(f"bsc_lpj packed H={Hk} K={K} keys={emit}: bit-identical to int8, max_abs_err "
                f"{err.max().item():.3g}; {ms:.4f} ms (device {dev_ms:.4f} ms), plain "
                f"{plain:.4f} ms, bound {bnd:.4f} ms ({by})")
            if (Hk, K, emit) == (256, 64, False):  # the K^(n) launch of main_packed
                rows["bsc_lpj_packed"] = dict(max_abs_err=err.max().item(), ms=ms,
                                              device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                                              bound_by=by)

    for Hk in (256, 100, 64):
        p = torch.full((B, 1, 1), 2.0 / Hk)
        p[:64] = 0.5
        ss = (torch.rand(B, S, Hk, generator=gen) < p).to(torch.int8).to(device)
        rs = torch.softmax(torch.randn(B, S, generator=gen) * 3, -1).to(device)
        pk = pack_bits_lane(ss)
        errs = check_suffstat_case(f"mixed H={Hk}", ss, rs)
        ms = cuda_ms(lambda: bsc_suffstat(pk, rs, H=Hk))
        dev_ms = graph_ms(lambda: bsc_suffstat(pk, rs, H=Hk))
        plain = cuda_ms(lambda: bsc_suffstat_plain(pk, rs, H=Hk))
        bnd, by = suffstat_bound(ss, packed=True)
        say(f"bsc_suffstat packed H={Hk} S={S}: bit-identical to int8, max_abs_err "
            f"{max(errs):.3g}; {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain:.4f} ms, "
            f"bound {bnd:.4f} ms ({by})")
        if Hk == H:
            rows["bsc_suffstat_packed"] = dict(max_abs_err=max(errs), ms=ms, device_ms=dev_ms,
                                               plain_ms=plain, bound_ms=bnd, bound_by=by)
    return rows


def check_suffstat_case(label, ss, rs):
    """bsc_suffstat on int8 states ss and on their packed bytes: each within
    suffstat_errors_bsc of the plain version, the packed mode bit for bit
    the int8 mode, and a second int8 launch bit for bit the first.  Returns
    the largest absolute errors (rho, sabs, Wq)."""
    Hk = ss.shape[-1]
    pk = pack_bits_lane(ss)
    got, again = bsc_suffstat(ss, rs), bsc_suffstat(ss, rs)
    got_pk = bsc_suffstat(pk, rs, H=Hk)
    want = bsc_suffstat_plain(ss, rs)
    torch.cuda.synchronize()
    for name, g, a, p in zip(("rho", "sabs", "Wq"), got, again, got_pk):
        if not torch.equal(g, a):
            raise AssertionError(f"bsc_suffstat {label} {name}: two launches differ")
        if not torch.equal(g, p):
            raise AssertionError(f"bsc_suffstat {label} {name}: packed not bit-identical to int8")
    return suffstat_errors_bsc(label, got, want)


def suffstat_states(Bk, S_, Hk, gen, dense=64, p=None):
    """States at the EA's sparsity (2/H bits on, or p), the first ``dense``
    datapoints' rows half on, and softmax responsibilities."""
    q = torch.full((Bk, 1, 1), 2.0 / Hk if p is None else p)
    q[:dense] = 0.5
    ss = (torch.rand(Bk, S_, Hk, generator=gen) < q).to(torch.int8)
    rs = torch.softmax(torch.randn(Bk, S_, generator=gen) * 3, -1)
    return ss, rs


def ea_converged_states(Bk, S_, Hk, gen):
    """States as the EA leaves them once it has converged, and softmax
    responsibilities: each datapoint's S_ unique states are one- and
    two-bit flips of its own 2-unit core (the units q_0 .. q_{S_/2 - 1},
    then the pairs q_i, q_{i+1}, of a random order q), so that its core
    units are on in most of its rows.  Needs Hk > S_ / 2."""
    perm = torch.argsort(torch.rand(Bk, Hk, generator=gen), dim=1)
    core = torch.zeros(Bk, Hk, dtype=torch.int8).scatter_(1, perm[:, :2], 1)
    q = torch.argsort(torch.rand(Bk, Hk, generator=gen), dim=1)
    half, j = S_ // 2, torch.arange(S_ - S_ // 2)
    flips = torch.zeros(Bk, S_, Hk, dtype=torch.int8)
    flips[:, :half].scatter_(2, q[:, :half, None], 1)
    flips[:, half:].scatter_(2, q[:, j, None], 1)
    flips[:, half:].scatter_(2, q[:, j + 1, None], 1)
    rs = torch.softmax(torch.randn(Bk, S_, generator=gen) * 3, -1)
    return core[:, None, :] ^ flips, rs


def check_suffstat_densities(device, gen):
    """The active-bits suffstat kernel at the ends of its range, each case as
    check_suffstat_case: rows with no bit or every bit on, one dense row
    among the sparse rows of one chunk, a ragged H = 100, H = 10 (S = 1024:
    a datapoint's rows in pieces), 32, 40 and 1024 (Wq in tiles over
    blocks), a B that is not a multiple of a unit or a chunk, rows with rs
    exactly 0, and the bsc_inpaint block; then its time on the mixed inputs
    of the kernels row, on states at the EA's sparsity only, on states all
    half on and on EA-converged states (ea_converged_states: a few units of
    each datapoint on in most of its rows), beside Wq's dense product in
    cuBLAS (a yardstick only: it lacks rho and sabs)."""
    cases = []
    for Hk in (40, 256):
        cases.append((f"no bit on H={Hk}", torch.zeros(256, 8, Hk, dtype=torch.int8)))
        cases.append((f"every bit on H={Hk}", torch.ones(256, 8, Hk, dtype=torch.int8)))
    for Hk, fill in ((256, 0.5), (256, 1.0), (100, 0.5), (1024, 0.5)):
        ss = (torch.rand(256, 8, Hk, generator=gen) < 2.0 / Hk).to(torch.int8)
        ss[4, 3] = (torch.rand(Hk, generator=gen) < fill).to(torch.int8)
        cases.append((f"one dense row ({fill}) among sparse rows H={Hk}", ss))
    for label, (Bk, S_, Hk) in (("ragged H=100", (512, 16, 100)), ("H=10 S=1024", (64, 1024, 10)),
                                ("H=32", (4096, 20, 32)), ("H=40", (1024, 64, 40)),
                                ("H=1024", (64, 16, 1024)), ("B=4099 S=20", (4099, 20, 64)),
                                ("B=1001 S=64", (1001, 64, 256))):
        cases.append((label, (torch.rand(Bk, S_, Hk, generator=gen)
                              < torch.rand(Bk, 1, 1, generator=gen)).to(torch.int8)))
    for label, ss in cases:
        rs = torch.softmax(torch.randn(ss.shape[:2], generator=gen) * 3, -1)
        errs = check_suffstat_case(label, ss.to(device), rs.to(device))
        say(f"bsc_suffstat {label}: plain within rel 1e-5 (sabs exact), packed and a second "
            f"launch bit-identical, max_abs_err {max(errs):.3g}")
    ss, rs = suffstat_states(B, S, H, gen)
    rs[::7] = 0.0  # invalid datapoints
    rs[:, S // 2:] *= (torch.rand(B, S - S // 2, generator=gen) < 0.5)  # underflowed tail
    errs = check_suffstat_case("rs exactly 0", ss.to(device), rs.to(device))
    say(f"bsc_suffstat rows with rs exactly 0: within tolerance, bit-identical, max_abs_err "
        f"{max(errs):.3g}")
    ss, rs = suffstat_states(INPAINT_N, INPAINT_S, INPAINT_H, gen, dense=0, p=0.1)
    errs = check_suffstat_case("bsc_inpaint block", ss.to(device), rs.to(device))
    say(f"bsc_suffstat bsc_inpaint block {tuple(ss.shape)}: within tolerance, bit-identical, "
        f"max_abs_err {max(errs):.3g}")
    del ss, rs

    for what in ("mixed", "EA sparsity only", "all half on", "EA-converged"):
        if what == "EA-converged":
            inputs = ea_converged_states(B, S, H, gen)
        else:
            dense = {"mixed": 64, "EA sparsity only": 0, "all half on": B}[what]
            inputs = suffstat_states(B, S, H, gen, dense=dense)
        ss, rs = (t.to(device) for t in inputs)
        errs = check_suffstat_case(what, ss, rs)
        pk = pack_bits_lane(ss)
        ms, dev_ms = cuda_ms(lambda: bsc_suffstat(ss, rs)), graph_ms(lambda: bsc_suffstat(ss, rs))
        ms_pk = cuda_ms(lambda: bsc_suffstat(pk, rs, H=H))
        dev_pk = graph_ms(lambda: bsc_suffstat(pk, rs, H=H))
        bnd, by = suffstat_bound(ss)
        bnd_pk, by_pk = suffstat_bound(ss, packed=True)
        say(f"bsc_suffstat {what} H={H} S={S}: max_abs_err {max(errs):.3g}; int8 {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms, bound {bnd:.4f} ms, {by}); packed {ms_pk:.4f} ms "
            f"(device {dev_pk:.4f} ms, bound {bnd_pk:.4f} ms, {by_pk})")
    torch.backends.cuda.matmul.allow_tf32 = False
    w = (rs[..., None] * ss).reshape(-1, H)
    sf = ss.float().reshape(-1, H)
    say(f"yardstick, Wq's dense product in cuBLAS (torch.mm(w.T, sf), f32 [{B * S}, {H}], "
        f"TF32 off): {cuda_ms(lambda: torch.mm(w.T, sf)):.4f} ms")


def check_lpj_case(label, args):
    """bsc_lpj on int8 states and on their packed bytes, in both emit_keys
    settings: each within lpj_tolerance of the plain version with keys
    equal, and the packed mode bit for bit the int8 mode.  Returns the
    largest error."""
    pk = pack_bits_lane(args[0])
    tol = lpj_tolerance(*args)
    worst = 0.0
    for emit in (False, True):
        got = bsc_lpj(*args, emit_keys=emit)
        got_pk = bsc_lpj(pk, *args[1:], emit_keys=emit)
        want = bsc_lpj_plain(*args, emit_keys=emit)
        torch.cuda.synchronize()
        if emit:
            (got, gk), (got_pk, pkk), (want, wk) = got, got_pk, want
            if not (torch.equal(gk, wk) and torch.equal(pkk, wk)):
                raise AssertionError(f"bsc_lpj {label}: keys differ")
        if not torch.equal(got_pk, got):
            raise AssertionError(f"bsc_lpj {label} emit={emit}: packed not bit-identical to int8")
        err = (got.double() - want.double()).abs()
        if not bool((err <= tol).all()):
            raise AssertionError(f"bsc_lpj {label} emit={emit}: max err "
                                 f"{err.max().item():.3g} over tolerance")
        worst = max(worst, err.max().item())
    return worst


def check_lpj_densities(device, gen):
    """The active-bits lpj kernel at the ends of the density range, each
    case as check_lpj_case: rows with no bit on, rows with every bit on,
    one dense row among sparse ones in a 32-row group, a ragged H = 100,
    H = MAX_H, and dense rows with G at an offset of one float (not 16-byte
    aligned); then its time on states at the EA's sparsity only (the main
    path's two launch shapes) and on states all half on."""
    cases = []
    for Hk in (40, 256):
        cases.append((f"no bit on H={Hk}", torch.zeros(256, 8, Hk, dtype=torch.int8)))
        cases.append((f"every bit on H={Hk}", torch.ones(256, 8, Hk, dtype=torch.int8)))
    for Hk, fill in ((256, 0.5), (256, 1.0), (100, 0.5), (1024, 0.5)):
        ss = (torch.rand(256, 8, Hk, generator=gen) < 2.0 / Hk).to(torch.int8)
        ss[4, 3] = (torch.rand(Hk, generator=gen) < fill).to(torch.int8)  # row 35: group 1
        cases.append((f"one dense row ({fill}) in a sparse group H={Hk}", ss))
    cases.append(("int8 ragged H=100", (torch.rand(512, 16, 100, generator=gen)
                                        < torch.rand(512, 1, 1, generator=gen)).to(torch.int8)))
    cases.append(("H=1024", (torch.rand(64, 16, 1024, generator=gen)
                             < torch.rand(64, 1, 1, generator=gen)).to(torch.int8)))
    for label, ss in cases:
        err = check_lpj_case(label, lpj_args(ss, gen, device))
        say(f"bsc_lpj {label}: plain within tolerance, keys equal, packed bit-identical, "
            f"max_abs_err {err:.3g}")
    args = lpj_inputs(256, 8, H, gen, device, dense=8)
    G = torch.empty(H * H + 1, device=device)[1:].view(H, H)
    G.copy_(args[3])
    args[3] = G
    err = check_lpj_case("G offset", args)
    say(f"bsc_lpj dense rows, G at an offset of one float H={H}: plain within tolerance, "
        f"keys equal, packed bit-identical, max_abs_err {err:.3g}")

    for K, dense, what in ((64, 0, "EA sparsity only"), (10, 0, "EA sparsity only"),
                           (64, B, "all half on")):
        args = lpj_inputs(B, K, H, gen, device, dense=dense)
        err = check_lpj_case(f"{what} K={K}", args)
        pk = pack_bits_lane(args[0])
        ms = cuda_ms(lambda: bsc_lpj(*args, emit_keys=True))
        dev_ms = graph_ms(lambda: bsc_lpj(*args, emit_keys=True))
        ms_pk = cuda_ms(lambda: bsc_lpj(pk, *args[1:]))
        dev_pk = graph_ms(lambda: bsc_lpj(pk, *args[1:]))
        bnd, by = lpj_bound(args[0], True)
        bnd_pk, by_pk = lpj_bound(args[0], False, packed=True)
        say(f"bsc_lpj {what} H={H} K={K}: max_abs_err {err:.3g}; int8 keys {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms, bound {bnd:.4f} ms, {by}); packed {ms_pk:.4f} ms "
            f"(device {dev_pk:.4f} ms, bound {bnd_pk:.4f} ms, {by_pk}); dense f32 "
            f"{dense_f32_ms(2.0 * B * K * H * H):.4f} ms")


def sssc_inputs(Bk, K, Hk, gen, device):
    """Inputs of the ES3C kernels at the ES3C paths' scale: states at the
    EA's sparsity (2/H bits on) with unit 0 left out, plus
      - at H <= 64, datapoints 0-31 with |s| from 1 up to H - 1 in slot 0
        (dense states stay exact);
      - at H > 64, datapoints 0-31 with 8 < |s| <= 16 in slot 0 (exact) and
        32-35 with |s| > 16 (flagged: the overflow rule);
      - the last datapoint's slot 0 the single unit 0, under a Psi whose
        entry Psi[0, 0] = -1/(s2inv G[0, 0]) makes its M' singular (flagged,
        lpj NaN).  Unit 0 is in no other state.
    Returns the lpj's arguments (dict) and the unpoisoned Psi."""
    Dk = 25 if Hk <= 64 else 64
    ss = (torch.rand(Bk, K, Hk, generator=gen) < 2.0 / Hk).to(torch.int8)
    ss[..., 0] = 0
    sizes = ([1 + i * (Hk - 2) // 31 for i in range(32)] if Hk <= 64
             else [9 + i % 8 for i in range(32)] + [17 + 5 * i for i in range(4)])
    for i, n in enumerate(sizes):
        ss[i, 0] = 0
        ss[i, 0, 1 + torch.randperm(Hk - 1, generator=gen)[:n]] = 1
    ss[-1, 0] = 0
    ss[-1, 0, 0] = 1
    W = torch.randn(Dk, Hk, generator=gen)
    y = torch.randn(Bk, Dk, generator=gen) * 2
    A = torch.randn(Hk, Hk, generator=gen)
    Psi = A @ A.T / Hk + torch.eye(Hk)
    pies = (1.0 + 2.0 * torch.rand(Hk, generator=gen)) / Hk
    s2inv = torch.tensor(1.25)
    G = W.T @ W
    poisoned = Psi.clone()
    poisoned[0, 0] = -1.0 / (s2inv * G[0, 0])
    args = dict(ss=ss, Wty=y @ W, y2=(y * y).sum(-1), G=G, Psi=poisoned,
                mus=torch.randn(Hk, generator=gen), pil_bar=torch.log(pies / (1 - pies)),
                s2inv=s2inv)
    return {k: v.to(device) for k, v in args.items()}, Psi.to(device)


def sssc_lpj_bound(ss):
    """bound_ms of sssc_lpj on these states: per state with n active units
    that is solved, 2n^3 flops for Psi_AA G_AA, 2n^3/3 for the LU, 2n^2
    each for G_AA a, Psi_AA u and the two triangular solves, 6n for the
    sums; a state flagged by the overflow rule is not solved.  Bytes: each
    input read once, lpj and bad written once."""
    Bk, K, Hk = ss.shape
    n = ss.sum(-1, dtype=torch.float64)
    cap = overflow_cap(Hk)
    n = torch.where(n <= cap, n, 0.0) if cap else n
    flops = float((8.0 / 3.0 * n**3 + 8 * n**2 + 6 * n).sum())
    nbytes = Bk * K * Hk + 4 * (Bk * Hk + Bk + 2 * Hk * Hk + 2 * Hk + 2 * Bk * K)
    return bound_ms(flops, 0, nbytes)


def sssc_suffstat_bound(ss):
    """bound_ms of sssc_suffstat: per solved state with n active units two
    n x n inversions (2n^3 flops each), 2n^2 each for G_AA mus and
    lambda u, n^2 for M, 4n^2 for the r (lambda + kappa kappa^T) and r s s^T
    shares and 4n for kappa and the per-datapoint sums (a flagged state
    only its n^2 + n); per datapoint with u distinct active units, 4u^2
    for the two outer products.  Bytes: inputs read once, outputs written
    once."""
    Bk, S_, Hk = ss.shape
    n = ss.sum(-1, dtype=torch.float64)
    cap = overflow_cap(Hk)
    solved = n <= cap if cap else torch.ones_like(n, dtype=torch.bool)
    flops = torch.where(solved, 4 * n**3 + 9 * n**2 + 4 * n, n**2 + n).sum()
    u = (ss != 0).any(1).sum(-1, dtype=torch.float64)
    flops = float(flops + (4 * u**2).sum())
    nbytes = Bk * S_ * Hk + 4 * (Bk * S_ + 3 * Bk * Hk + 2 * Hk * Hk + Hk + 4 * Hk * Hk)
    return bound_ms(flops, 0, nbytes)


def suffstat_errors(ss_args, label):
    """sssc_suffstat (the masked kernel for a per-datapoint G) against its
    plain version: each output's largest error over its largest magnitude,
    which must be within 4e-5, and the largest absolute error; a second
    launch must give every output bit for bit."""
    got, again = sssc_suffstat(**ss_args), sssc_suffstat(**ss_args)
    want = sssc_suffstat_plain(**ss_args)
    torch.cuda.synchronize()
    errs = []
    for name, g, a, w in zip(("xpt_sz", "xpt_s", "xpt_ss", "xpt_szsz", "s_sz", "sz_sz"),
                             got, again, want):
        if not torch.equal(g, a):
            raise AssertionError(f"sssc_suffstat {label} {name}: two launches differ")
        e = ((g - w).abs().max() / w.abs().max().clamp(min=1e-30)).item()
        if not e <= 4e-5:
            raise AssertionError(f"sssc_suffstat {label} {name}: relative err {e:.3g}")
        errs.append(e)
    return errs, max((g - w).abs().max().item() for g, w in zip(got, want))


def zero_pivot_suffstat(ss_args):
    """sssc_suffstat against its plain version where the unpivoted
    elimination meets a zero pivot: Psi[0, 0] = 0, with the last
    datapoint's slot 0 the single unit 0 (lambda = 0, kappa = mus_0) and
    its slot 1 the units {0, 5} (left out of the solve), both with
    responsibility 0.5."""
    args = dict(ss_args, ss=ss_args["ss"].clone(), Psi=ss_args["Psi"].clone(),
                rs=ss_args["rs"].clone())
    args["Psi"][0, 0] = 0.0
    args["ss"][-1, 1] = 0
    args["ss"][-1, 1, [0, 5]] = 1
    args["rs"][-1, :2] = 0.5
    errs, _ = suffstat_errors(args, "H=32 zero-pivot")
    say(f"sssc_suffstat zero-pivot Psi: max err / max value {max(errs):.3g}")


def check_sssc_kernels(device, gen):
    """Both ES3C kernels against their plain versions on the card, at the
    shapes of the sssc_primary (H = 32) and sssc_fl (H = 100) paths.
    Tolerances of evo_tpu's own tests (tests/test_pallas_sssc.py): lpj
    within 2e-3 + 2e-4 |lpj| with identical bad flags and NaN exactly on
    the flagged states; each suffstat output within 4e-5 of its largest
    magnitude.  The suffstat runs under the unpoisoned Psi, with
    responsibilities zero on the states the lpj flags (as the E-step's
    reset_lpj leaves them)."""
    rows = {}
    for Bk, K, Hk in ((4096, 20, 32), (4096, 10, 32), (2048, 15, 100), (2048, 10, 100)):
        args, clean_psi = sssc_inputs(Bk, K, Hk, gen, device)
        (lpj, bad), (lpj_p, bad_p) = sssc_lpj(**args), sssc_lpj_plain(**args)
        torch.cuda.synchronize()
        flagged = bad > 0
        if not (torch.equal(bad, bad_p) and torch.equal(torch.isnan(lpj), flagged)
                and torch.equal(torch.isnan(lpj_p), flagged)):
            raise AssertionError(f"sssc_lpj B={Bk} K={K} H={Hk}: bad flags or NaNs differ")
        err = (lpj - lpj_p).abs()[~flagged]
        if not bool((err <= 2e-3 + 2e-4 * lpj_p.abs()[~flagged]).all()):
            raise AssertionError(f"sssc_lpj H={Hk} K={K}: max err {err.max().item():.3g} "
                                 "over tolerance")
        ms = cuda_ms(lambda: sssc_lpj(**args))
        dev_ms = graph_ms(lambda: sssc_lpj(**args))
        plain = cuda_ms(lambda: sssc_lpj_plain(**args))
        bnd, by = sssc_lpj_bound(args["ss"])
        say(f"sssc_lpj B={Bk} K={K} H={Hk}: max_abs_err {err.max().item():.3g}, "
            f"{int(flagged.sum())} flagged, max |s| {int(args['ss'].sum(-1).max())}; "
            f"{ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms "
            f"({by})")
        if (Bk, K, Hk) == (4096, 20, 32):  # the K^(n) launch of sssc_primary
            rows["sssc_lpj"] = dict(max_abs_err=err.max().item(), ms=ms, device_ms=dev_ms,
                                    plain_ms=plain, bound_ms=bnd, bound_by=by)
        if K == 10:
            continue
        ss_args = dict(ss=args["ss"], Wty=args["Wty"], G=args["G"], Psi=clean_psi,
                       mus=args["mus"], s2inv=args["s2inv"])
        rs = torch.softmax(torch.randn(Bk, K, generator=gen) * 3, -1).to(device)
        ss_args["rs"] = torch.where(flagged, 0.0, rs).contiguous()
        errs, abs_err = suffstat_errors(ss_args, f"H={Hk}")
        if Hk == 32:
            zero_pivot_suffstat(ss_args)
        ms = cuda_ms(lambda: sssc_suffstat(**ss_args))
        dev_ms = graph_ms(lambda: sssc_suffstat(**ss_args))
        plain = cuda_ms(lambda: sssc_suffstat_plain(**ss_args))
        bnd, by = sssc_suffstat_bound(args["ss"])
        say(f"sssc_suffstat B={Bk} S={K} H={Hk}: max err / max value {max(errs):.3g} "
            f"(max_abs_err {abs_err:.3g}), {int(flagged.sum())} flagged; {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        if Hk == 32:
            rows["sssc_suffstat"] = dict(max_abs_err=abs_err, ms=ms, device_ms=dev_ms,
                                         plain_ms=plain, bound_ms=bnd, bound_by=by)
    return rows


def masked_inputs(Bk, K, Hk, gen, device):
    """Inputs of the masked ES3C kernels at the inpainting path's scale
    (D = 75, 10% of the entries missing, G_n from the port's block_gram on
    the card): states at the EA's sparsity (2/H bits on) with unit 0 left
    out, datapoints 0-31 with |s| = 1 + i (H - 1) // 31 in slot 0 (up to
    |s| = H, all units on), and the last datapoint's slot 0 the single unit
    0.  Returns the lpj's arguments under a well-conditioned Psi, and a Psi
    with a zero row and column for unit 0, under which exactly the states
    that hold unit 0 (those two) have a singular Psi_AA."""
    Dk = INPAINT_D
    ss = (torch.rand(Bk, K, Hk, generator=gen) < 2.0 / Hk).to(torch.int8)
    ss[..., 0] = 0
    for i in range(32):
        n = 1 + i * (Hk - 1) // 31
        ss[i, 0] = 0
        units = torch.arange(Hk) if n == Hk else 1 + torch.randperm(Hk - 1, generator=gen)[:n]
        ss[i, 0, units] = 1
    ss[-1, 0] = 0
    ss[-1, 0, 0] = 1
    W = torch.randn(Dk, Hk, generator=gen)
    m = torch.rand(Bk, Dk, generator=gen) >= INPAINT_MISSING
    y = torch.randn(Bk, Dk, generator=gen) * 2 * m
    A = torch.randn(Hk, Hk, generator=gen)
    Psi = A @ A.T / Hk + torch.eye(Hk)
    pies = (1.0 + 2.0 * torch.rand(Hk, generator=gen)) / Hk
    poisoned = Psi.clone()
    poisoned[0, :] = 0.0
    poisoned[:, 0] = 0.0
    G, Wty, y2 = block_gram(W.to(device), y.to(device), m.to(device), True)
    args = dict(ss=ss.to(device), Wty=Wty, y2=y2, G=G, Psi=Psi.to(device),
                mus=torch.randn(Hk, generator=gen).to(device),
                pil_bar=torch.log(pies / (1 - pies)).to(device),
                s2inv=torch.tensor(1.25, device=device))
    return args, poisoned.to(device)


def gram_union_bytes(ss):
    """Bytes of G_n a masked kernel must read: per datapoint the f32 entries
    of G_n on the union of its states' active units, u^2 for u units."""
    u = (ss != 0).any(1).sum(-1, dtype=torch.float64)
    return 4.0 * float((u * u).sum())


def masked_lpj_bound(ss):
    """bound_ms of sssc_lpj_masked: per state with n active units two n x n
    Gauss-Jordan inversions (2n^3 flops each), 2n^2 each for forming M,
    G_AA a and lambda u, 8n for the sums; bytes: each input read once (G_n
    only on the union of each datapoint's active units), lpj and bad
    written once."""
    Bk, K, Hk = ss.shape
    n = ss.sum(-1, dtype=torch.float64)
    flops = float((4 * n**3 + 6 * n**2 + 8 * n).sum())
    g = gram_union_bytes(ss)
    nbytes = Bk * K * Hk + 4 * (Bk * Hk + Bk + Hk * Hk + 2 * Hk + 2 * Bk * K) + g
    return bound_ms(flops, 0, nbytes) + (g,)


def masked_suffstat_bound(ss):
    """bound_ms of sssc_suffstat_masked: the flops of sssc_suffstat_bound
    (no state is over a cap); bytes: inputs read once (G_n only on the
    union of each datapoint's active units), outputs written once."""
    Bk, S_, Hk = ss.shape
    n = ss.sum(-1, dtype=torch.float64)
    u = (ss != 0).any(1).sum(-1, dtype=torch.float64)
    flops = float((4 * n**3 + 9 * n**2 + 4 * n).sum() + (4 * u**2).sum())
    g = gram_union_bytes(ss)
    nbytes = Bk * S_ * Hk + 4 * (Bk * S_ + 3 * Bk * Hk + Hk * Hk + Hk + 4 * Hk * Hk) + g
    return bound_ms(flops, 0, nbytes) + (g,)


def check_masked_lpj(args, label):
    """sssc_lpj_masked against its plain version: identical bad flags, NaN
    exactly on them, the rest within 2e-3 + 2e-4 |lpj|.  Returns (max abs
    error, flagged count)."""
    (lpj, bad), (lpj_p, bad_p) = sssc_lpj_masked(**args), sssc_lpj_masked_plain(**args)
    torch.cuda.synchronize()
    flagged = bad > 0
    if not (torch.equal(bad, bad_p) and torch.equal(torch.isnan(lpj), flagged)
            and torch.equal(torch.isnan(lpj_p), flagged)):
        raise AssertionError(f"sssc_lpj_masked {label}: bad flags or NaNs differ")
    err = (lpj - lpj_p).abs()[~flagged]
    if not bool((err <= 2e-3 + 2e-4 * lpj_p.abs()[~flagged]).all()):
        raise AssertionError(f"sssc_lpj_masked {label}: max err {err.max().item():.3g} "
                             "over tolerance")
    return err.max().item(), int(flagged.sum())


def check_masked_kernels(device, gen):
    """Both masked ES3C kernels against their plain versions on the card:
    at (B, K, H) = (4096, 20, 32), (4096, 10, 32) and (2048, 8, 64) with
    dense states up to |s| = H, and at the inpainting path's own block
    (151,209 datapoints, K = 20 and the 10 children), each under a
    well-conditioned Psi (no state may be flagged) and under the poisoned
    Psi of masked_inputs (the flags must be identical).  The suffstat runs
    under both, with softmax responsibilities (nonzero on the poisoned
    states too, so that the sanitizing is compared).  Tolerances of
    evo_tpu's kernel tests, as for the complete-data kernels.  The plain
    versions step through every elimination from Python and are timed over
    3 calls, the kernels over 10."""
    rows = {}
    for Bk, K, Hk in ((4096, 20, 32), (4096, 10, 32), (2048, 8, 64),
                      (INPAINT_N, INPAINT_S, INPAINT_H),
                      (INPAINT_N, INPAINT_PARENTS * INPAINT_CHILDREN, INPAINT_H)):
        label = f"B={Bk} K={K} H={Hk}"
        args, poisoned = masked_inputs(Bk, K, Hk, gen, device)
        err, nflag = check_masked_lpj(args, label)
        if nflag:
            raise AssertionError(f"sssc_lpj_masked {label}: {nflag} states flagged under a "
                                 "well-conditioned Psi")
        perr, pflag = check_masked_lpj(dict(args, Psi=poisoned), label + " poisoned")
        want_flag = int(((args["ss"][..., 0] != 0)).sum())
        if pflag != want_flag:
            raise AssertionError(f"sssc_lpj_masked {label}: {pflag} flagged under the poisoned "
                                 f"Psi, expected {want_flag}")
        ms = cuda_ms(lambda: sssc_lpj_masked(**args))
        dev_ms = graph_ms(lambda: sssc_lpj_masked(**args))
        plain = cuda_ms(lambda: sssc_lpj_masked_plain(**args), reps=3, warm=1)
        bnd, by, gbytes = masked_lpj_bound(args["ss"])
        say(f"sssc_lpj_masked {label}: max_abs_err {max(err, perr):.3g}, {pflag} flagged under "
            f"the poisoned Psi, max |s| {int(args['ss'].sum(-1).max())}; {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms), plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}; G_n read "
            f"{gbytes / 1e6:.3f} MB)")
        if (Bk, K) == (INPAINT_N, INPAINT_S):  # the K^(n) launch of sssc_inpaint
            rows["sssc_lpj_masked"] = dict(max_abs_err=max(err, perr), ms=ms, device_ms=dev_ms,
                                           plain_ms=plain, bound_ms=bnd, bound_by=by)
        if K == 10:
            continue
        rs = torch.softmax(torch.randn(Bk, K, generator=gen) * 3, -1).to(device)
        ss_args = dict(ss=args["ss"], rs=rs, Wty=args["Wty"], G=args["G"], Psi=args["Psi"],
                       mus=args["mus"], s2inv=args["s2inv"])
        rel, abs_err = suffstat_errors(ss_args, label)
        prel, pabs = suffstat_errors(dict(ss_args, Psi=poisoned), label + " poisoned")
        ms = cuda_ms(lambda: sssc_suffstat_masked(**ss_args))
        dev_ms = graph_ms(lambda: sssc_suffstat_masked(**ss_args))
        plain = cuda_ms(lambda: sssc_suffstat_plain(**ss_args), reps=3, warm=1)
        bnd, by, gbytes = masked_suffstat_bound(args["ss"])
        say(f"sssc_suffstat_masked {label}: max err / max value {max(rel + prel):.3g} "
            f"(max_abs_err {max(abs_err, pabs):.3g}); {ms:.4f} ms (device {dev_ms:.4f} ms), "
            f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by}; G_n read {gbytes / 1e6:.3f} MB)")
        if Bk == INPAINT_N:
            rows["sssc_suffstat_masked"] = dict(max_abs_err=max(abs_err, pabs), ms=ms,
                                                device_ms=dev_ms, plain_ms=plain, bound_ms=bnd,
                                                bound_by=by)
    return rows


def suffstat_edge_inputs(Bk, S_, Hk, gen, device, masked=False, sizes=(), lpj=False):
    """Inputs of the ES3C suffstat kernels: states at the EA's sparsity
    (2/H bits on), then the states (datapoint, slot, |s|) of ``sizes`` drawn
    with that many units; data of width D = 25 (H <= 64) or 64 under a
    random W, with 10% of the entries missing and G_n from block_gram on
    the card when ``masked``; a well-conditioned Psi; softmax
    responsibilities.  With ``lpj`` the lpj kernels' arguments instead (y2,
    and pil_bar from pies drawn in (1/H, 3/H), in place of rs)."""
    Dk = 25 if Hk <= 64 else 64
    ss = (torch.rand(Bk, S_, Hk, generator=gen) < 2.0 / Hk).to(torch.int8)
    for b, k, n in sizes:
        ss[b, k] = 0
        ss[b, k, torch.randperm(Hk, generator=gen)[:n]] = 1
    W = torch.randn(Dk, Hk, generator=gen)
    y = torch.randn(Bk, Dk, generator=gen) * 2
    A = torch.randn(Hk, Hk, generator=gen)
    args = dict(ss=ss.to(device), Psi=(A @ A.T / Hk + torch.eye(Hk)).to(device),
                mus=torch.randn(Hk, generator=gen).to(device),
                rs=torch.softmax(torch.randn(Bk, S_, generator=gen) * 3, -1).to(device),
                s2inv=torch.tensor(1.25, device=device))
    if masked:
        m = torch.rand(Bk, Dk, generator=gen) >= INPAINT_MISSING
        args["G"], args["Wty"], y2 = block_gram(W.to(device), (y * m).to(device), m.to(device),
                                                True)
    else:
        args["G"], args["Wty"] = (W.T @ W).to(device), (y @ W).to(device)
        y2 = (y * y).sum(-1).to(device)
    if lpj:
        pies = (1.0 + 2.0 * torch.rand(Hk, generator=gen)) / Hk
        del args["rs"]
        args.update(y2=y2, pil_bar=torch.log(pies / (1 - pies)).to(device))
    return args


def check_sssc_suffstat_edges(device, gen):
    """Both ES3C suffstat kernels where their paths meet, each against its
    plain version within suffstat_errors (4e-5 of each output's largest
    magnitude, a relaunch bit for bit): states at the sparse path's
    threshold (SPARSE_N units, a thread each) and one past it (a warp each),
    |s| = H - 1 and H, datapoints with no bit on, rows with r exactly 0
    (dense ones too), every state of a datapoint the same (sparse, and
    dense), a B that fills no whole unit of datapoints; masked, a datapoint
    whose S states are all dense at H = 64; H = 100 and 128 with |s| = 16
    and 17 (the overflow cap); S = 600 (a datapoint's rows in pieces),
    S = 1, and H = 13 (rows that start off 16-byte boundaries, and G_n
    copied a float at a time)."""
    thr = [(3 + 5 * i, i % 20, SPARSE_N + i % 2) for i in range(40)]
    wide = [(300, 0, 31), (301, 5, 32), (302, 19, 31)]
    for masked in (False, True):
        fn = "sssc_suffstat_masked" if masked else "sssc_suffstat"
        args = suffstat_edge_inputs(4099, 20, 32, gen, device, masked, thr + wide)
        args["ss"][400:403] = 0  # no bit on
        args["ss"][410] = args["ss"][410, 0]  # every state the same (sparse)
        args["ss"][411] = args["ss"][301, 5]  # every state the same, all units on
        zero = torch.zeros(4099, 20, dtype=torch.bool, device=device)
        zero[3, 0] = zero[8, 1] = zero[301, 5] = True  # r exactly 0, dense rows too
        zero[500] = zero[1000:3000:7, 4] = True
        args["rs"] = torch.where(zero, 0.0, args["rs"]).contiguous()
        n = args["ss"].sum(-1)
        assert bool((n == SPARSE_N).any() and (n == SPARSE_N + 1).any() and (n == 32).any())
        errs, abs_err = suffstat_errors(args, f"edges H=32 masked={masked}")
        say(f"{fn} edges (B=4099 S=20 H=32: |s| = {SPARSE_N}, {SPARSE_N + 1}, 31, 32, rows "
            f"with no bit or r = 0, equal states): max err / max value {max(errs):.3g}")
    dense = [(6, k, 40 + 3 * k) for k in range(7)] + [(6, 7, 64), (9, 2, SPARSE_N + 1)]
    args = suffstat_edge_inputs(1001, 8, 64, gen, device, True, dense)
    errs, _ = suffstat_errors(args, "masked H=64 dense datapoint")
    say(f"sssc_suffstat_masked B=1001 S=8 H=64, a datapoint's 8 states |s| 40-64: "
        f"max err / max value {max(errs):.3g}")
    caps = [(3 * i + 1, i % 15, n) for i, n in
            enumerate((16, 17, 16, 17, SPARSE_N, SPARSE_N + 1, 12, 40))]
    for Bk, Hk in ((2051, 100), (1000, 128)):
        args = suffstat_edge_inputs(Bk, 15, Hk, gen, device, False, caps)
        errs, _ = suffstat_errors(args, f"H={Hk} cap")
        say(f"sssc_suffstat B={Bk} S=15 H={Hk}, |s| = 16, 17, {SPARSE_N}, {SPARSE_N + 1}: "
            f"max err / max value {max(errs):.3g}")
    for Bk, S_, Hk in ((40, 600, 12), (5000, 1, 32), (500, 7, 13)):
        for masked in (False, True):
            args = suffstat_edge_inputs(Bk, S_, Hk, gen, device, masked)
            errs, _ = suffstat_errors(args, f"B={Bk} S={S_} H={Hk} masked={masked}")
            say(f"{'sssc_suffstat_masked' if masked else 'sssc_suffstat'} B={Bk} S={S_} "
                f"H={Hk}: max err / max value {max(errs):.3g}")


def check_lpj_edge(args, label):
    """An ES3C lpj kernel (the masked one for a per-datapoint G) against its
    plain version: identical bad flags, NaN exactly on them, the rest within
    2e-3 + 2e-4 |lpj|; a second launch must give lpj and bad bit for bit.
    Returns the largest absolute error and the flags [B, K]."""
    masked = args["G"].dim() == 3
    fn, plain = (sssc_lpj_masked, sssc_lpj_masked_plain) if masked else (sssc_lpj, sssc_lpj_plain)
    (lpj, bad), (again, bad_again) = fn(**args), fn(**args)
    lpj_p, bad_p = plain(**args)
    torch.cuda.synchronize()
    name = f"{fn.__name__} {label}"
    if not (torch.equal(lpj.view(torch.int32), again.view(torch.int32))
            and torch.equal(bad, bad_again)):
        raise AssertionError(f"{name}: two launches differ")
    flagged = bad > 0
    if not (torch.equal(bad, bad_p) and torch.equal(torch.isnan(lpj), flagged)
            and torch.equal(torch.isnan(lpj_p), flagged)):
        raise AssertionError(f"{name}: bad flags or NaNs differ")
    err = (lpj - lpj_p).abs()[~flagged]
    if not bool((err <= 2e-3 + 2e-4 * lpj_p.abs()[~flagged]).all()):
        raise AssertionError(f"{name}: max err {err.max().item():.3g} over tolerance")
    return (err.max().item() if err.numel() else 0.0), flagged


def check_sssc_lpj_edges(device, gen):
    """Both ES3C lpj kernels where their paths meet, each against its plain
    version within check_lpj_edge (flags identical, NaN exactly on them,
    2e-3 + 2e-4 |lpj|, a relaunch bit for bit): states at the sparse path's
    threshold (SPARSE_N units, a thread each) and one past it (a warp each),
    |s| = H - 1 and H, datapoints with no bit on, every state of a datapoint
    the same (sparse, and dense), a B that fills no whole block of
    datapoints; K = 1 and K = 300 (a datapoint's rows in pieces), H = 13
    (rows off 16-byte boundaries, G_n copied a float at a time); masked, a
    datapoint whose 8 states are all dense at H = 64; H = 100 and 128 with
    |s| = 16 and 17 (flagged exactly past the overflow cap); the poisoned
    Psi of sssc_inputs and masked_inputs (the masked one also in a dense
    state); on complete data single-unit states whose pivot of M' is
    1.5e-6 (kept) and 0.5e-6 (flagged), and, masked, states with a pivot
    of Psi_AA of 1e-8 (kept: that kernel flags only non-finite values)."""
    thr = [(3 + 5 * i, i % 20, SPARSE_N + i % 2) for i in range(40)]
    wide = [(300, 0, 31), (301, 5, 32), (302, 19, 31)]
    for masked in (False, True):
        args = suffstat_edge_inputs(4099, 20, 32, gen, device, masked, thr + wide, lpj=True)
        args["ss"][400:403] = 0  # no bit on
        args["ss"][410] = args["ss"][410, 0]  # every state the same (sparse)
        args["ss"][411] = args["ss"][301, 5]  # every state the same, all units on
        n = args["ss"].sum(-1)
        assert bool((n == SPARSE_N).any() and (n == SPARSE_N + 1).any() and (n == 32).any())
        err, flagged = check_lpj_edge(args, f"edges H=32 masked={masked}")
        say(f"{'sssc_lpj_masked' if masked else 'sssc_lpj'} edges (B=4099 K=20 H=32: |s| = "
            f"{SPARSE_N}, {SPARSE_N + 1}, 31, 32, rows with no bit on, equal states): max_abs_err "
            f"{err:.3g}, {int(flagged.sum())} flagged")
    for Bk, K, Hk in ((5000, 1, 32), (40, 300, 32), (500, 7, 13)):
        for masked in (False, True):
            args = suffstat_edge_inputs(Bk, K, Hk, gen, device, masked, lpj=True)
            err, flagged = check_lpj_edge(args, f"B={Bk} K={K} H={Hk} masked={masked}")
            say(f"{'sssc_lpj_masked' if masked else 'sssc_lpj'} B={Bk} K={K} H={Hk}: max_abs_err "
                f"{err:.3g}, {int(flagged.sum())} flagged")
    dense = [(6, k, 40 + 3 * k) for k in range(7)] + [(6, 7, 64), (9, 2, SPARSE_N + 1)]
    args = suffstat_edge_inputs(1001, 8, 64, gen, device, True, dense, lpj=True)
    err, flagged = check_lpj_edge(args, "H=64 dense datapoint")
    say(f"sssc_lpj_masked B=1001 K=8 H=64, a datapoint's 8 states |s| 40-64: max_abs_err "
        f"{err:.3g}, {int(flagged.sum())} flagged")
    caps = [(3 * i + 1, i % 15, n) for i, n in
            enumerate((16, 17, 16, 17, SPARSE_N, SPARSE_N + 1, 12, 40))]
    for Bk, Hk in ((2051, 100), (1000, 128)):
        args = suffstat_edge_inputs(Bk, 15, Hk, gen, device, False, caps, lpj=True)
        err, flagged = check_lpj_edge(args, f"H={Hk} cap")
        if not torch.equal(flagged, args["ss"].sum(-1) > 16):
            raise AssertionError(f"sssc_lpj H={Hk}: flags are not the states past the cap")
        say(f"sssc_lpj B={Bk} K=15 H={Hk}, |s| = 16, 17, {SPARSE_N}, {SPARSE_N + 1}: max_abs_err "
            f"{err:.3g}, {int(flagged.sum())} flagged (the states past the cap)")
    args, _ = sssc_inputs(1000, 20, 32, gen, device)
    err, flagged = check_lpj_edge(args, "poisoned Psi")
    if not bool(flagged[-1, 0]):
        raise AssertionError("sssc_lpj: the poisoned single-unit state is not flagged")
    say(f"sssc_lpj B=1000 K=20 H=32, poisoned Psi: max_abs_err {err:.3g}, "
        f"{int(flagged.sum())} flagged")
    args, poisoned = masked_inputs(1000, 20, 32, gen, device)
    args = dict(args, Psi=poisoned, ss=args["ss"].clone())
    args["ss"][40, 3] = 0  # a dense state that holds unit 0
    args["ss"][40, 3, :12] = 1
    err, flagged = check_lpj_edge(args, "poisoned Psi")
    if not torch.equal(flagged, args["ss"][..., 0] != 0):
        raise AssertionError("sssc_lpj_masked: flags are not the states that hold unit 0")
    say(f"sssc_lpj_masked B=1000 K=20 H=32, poisoned Psi (a dense state too): max_abs_err "
        f"{err:.3g}, {int(flagged.sum())} flagged")
    for masked in (False, True):
        args = suffstat_edge_inputs(600, 20, 32, gen, device, masked, lpj=True)
        ss, Psi = args["ss"], args["Psi"]
        ss[..., :4] = 0
        Psi[:4, :] = Psi[:, :4] = 0.0
        Psi[2:4, 2:4] = torch.eye(2, device=device)
        s2inv = float(args["s2inv"])
        if masked:  # Psi_AA's first pivot 1e-8, in {2} and {2, 3}
            Psi[2, 2] = 1e-8
            ss[2:4, 0] = 0
            ss[2, 0, 2] = ss[3, 0, 2] = ss[3, 0, 3] = 1
            rows, want = [(2, 0), (3, 0)], [False, False]
        else:  # M' = 1 + s2inv Psi_hh G_hh of {h} at 1.5e-6 and 0.5e-6
            for h, t in ((0, 1.5e-6), (1, 0.5e-6)):
                Psi[h, h] = (t - 1.0) / (s2inv * float(args["G"][h, h]))
                ss[h, 0] = 0
                ss[h, 0, h] = 1
            rows, want = [(0, 0), (1, 0)], [False, True]
        err, flagged = check_lpj_edge(args, "small pivots")
        got = [bool(flagged[r]) for r in rows]
        if got != want:
            raise AssertionError(f"small pivots masked={masked}: flags {got}, expected {want}")
        say(f"{'sssc_lpj_masked' if masked else 'sssc_lpj'} small pivots: flags {got} as "
            f"expected, max_abs_err {err:.3g}")


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


def exact_epoch(launches, **opts):
    """One exact-mode EBSC epoch (H = 10, S = 2^10, N = 4096 in 2 blocks,
    bars data) on the card against the CPU's plain path, with the
    init_states options ``opts`` (packed_states, allzero): F within 1e-4
    |F|, W within 1e-3 of its largest magnitude."""
    Hx, Nx = 10, 4096
    Y = bars_data(Hx, Nx, seed=1)
    F, Ws = {}, {}
    for dev in ("cpu", DEVICE):
        model = BSC(D=Y.shape[1], H=Hx, device=dev)
        data = make_data(Y, n_blocks=2, device=dev)
        cfg, estate = init_states(N=Nx, S=2**Hx, H=Hx, n_blocks=2, device=dev, **opts)
        params = model.standard_init(data, seed=1, y_host=Y)
        if dev == DEVICE:
            launches.reset()
        params, estate, stats, _ = model.em_step(
            params, estate, data, torch.Generator(device=dev).manual_seed(0), cfg)
        F[dev], Ws[dev] = float(stats.F), params.W.cpu()
        if dev == DEVICE:
            if cfg.packed_states:
                launches.expect(lpj_packed=2, suffstat_packed=2)
            else:
                launches.expect(lpj=2, suffstat=2)
    werr = (Ws[DEVICE] - Ws["cpu"]).abs().max().item()
    say(f"exact H={Hx} N={Nx} {opts}: F card {F[DEVICE]:.6f}, F cpu {F['cpu']:.6f}, "
        f"max |dW| {werr:.3g}")
    if not abs(F[DEVICE] - F["cpu"]) <= 1e-4 * abs(F["cpu"]):
        raise AssertionError("exact-mode F differs between the card and the CPU")
    if not werr <= 1e-3 * Ws["cpu"].abs().max().item():
        raise AssertionError("exact-mode W differs between the card and the CPU")


def primary_setup(device, packed_states=False):
    """(model, data, cfg, estate, params) of the primary configuration, with
    synthetic data made on the host from seed 0 as bench.py:90-100 makes
    it, and initial states (lane-major packed with ``packed_states``, the
    switch bench.py:103-104 names) and Theta^0 from seed 0."""
    N = N_BLOCKS * B
    rng = np.random.default_rng(0)
    W_gen = rng.standard_normal((D, H)).astype(np.float32)
    s_gen = rng.random((N, H)) <= 2.0 / H
    Y = s_gen.astype(np.float32) @ W_gen.T + rng.standard_normal((N, D)).astype(np.float32)
    model = BSC(D=D, H=H, device=device)
    data = make_data(Y, n_blocks=N_BLOCKS, device=device)
    cfg, estate = init_states(N=N, S=S, H=H, no_parents=N_PARENTS, no_children=N_CHILDREN,
                              no_generations=N_GENERATIONS, n_blocks=N_BLOCKS, seed=0,
                              device=device, packed_states=packed_states)
    return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)


def primary_packed_setup(device):
    return primary_setup(device, packed_states=True)


def exact_sssc(launches):
    """One exact-mode ES3C epoch (H = 8, S = 2^8, N = 2048 in 2 blocks,
    data from SSSC.generate_data) on the card against the CPU's plain
    path: F within 1e-5 |F|, each parameter within 1e-4 of its largest
    magnitude."""
    Hx, Dx, Nx = 8, 16, 2048
    g = torch.Generator().manual_seed(1)
    A = torch.randn(Hx, Hx, generator=g) * 0.3
    gen_params = SSSCParams(W=2 * torch.randn(Dx, Hx, generator=g),
                            pies=torch.full((Hx,), 2.0 / Hx), mus=torch.randn(Hx, generator=g),
                            Psi=A @ A.T + torch.eye(Hx), sigma2=torch.tensor(0.5))
    Y = SSSC(D=Dx, H=Hx, device="cpu").generate_data(gen_params, Nx, g)["y"].numpy()
    F, P = {}, {}
    for dev in ("cpu", DEVICE):
        model = SSSC(D=Dx, H=Hx, device=dev)
        data = make_data(Y, n_blocks=2, device=dev)
        cfg, estate = init_states(N=Nx, S=2**Hx, H=Hx, n_blocks=2, device=dev)
        params = model.standard_init(data, seed=1, y_host=Y)
        if dev == DEVICE:
            launches.reset()
        params, estate, stats, _ = model.em_step(
            params, estate, data, torch.Generator(device=dev).manual_seed(0), cfg)
        F[dev], P[dev] = float(stats.F), {k: v.cpu() for k, v in vars(params).items()}
        if dev == DEVICE:
            launches.expect(sssc_lpj=2, sssc_suffstat=2)
    errs = {k: ((P[DEVICE][k] - v).abs().max() / v.abs().max()).item()
            for k, v in P["cpu"].items()}
    say(f"exact ES3C H={Hx} N={Nx}: F card {F[DEVICE]:.6f}, F cpu {F['cpu']:.6f}, "
        f"max |d| / max value {({k: float(f'{e:.3g}') for k, e in errs.items()})}")
    if not abs(F[DEVICE] - F["cpu"]) <= 1e-5 * abs(F["cpu"]):
        raise AssertionError("exact-mode ES3C F differs between the card and the CPU")
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"exact-mode ES3C parameters differ: {errs}")


def exact_incomplete(kind, launches):
    """One exact-mode epoch with 15% of the entries missing (MCAR) and
    do_reconstruction=True on the card against the same epoch on the CPU's
    plain path: ES3C at H = 8 (S = 2^8, N = 2048, data from
    SSSC.generate_data) or EBSC at H = 10 (S = 2^10, N = 4096, bars data),
    2 blocks.  F within 1e-5 |F|; each parameter and y_rec within 1e-4 of
    its largest magnitude."""
    if kind == "sssc":
        Hx, Nx = 8, 2048
        g = torch.Generator().manual_seed(2)
        A = torch.randn(Hx, Hx, generator=g) * 0.3
        gen_params = SSSCParams(W=2 * torch.randn(16, Hx, generator=g),
                                pies=torch.full((Hx,), 2.0 / Hx),
                                mus=torch.randn(Hx, generator=g), Psi=A @ A.T + torch.eye(Hx),
                                sigma2=torch.tensor(0.5))
        Y = SSSC(D=16, H=Hx, device="cpu").generate_data(gen_params, Nx, g)["y"].numpy()
        expect = dict(sssc_lpj_masked=2, sssc_suffstat_masked=2)
    else:
        Hx, Nx = 10, 4096
        Y = bars_data(Hx, Nx, seed=2)
        expect = dict(suffstat=2)
    Y = np.where(np.random.default_rng(3).random(Y.shape) < 0.15, np.nan, Y)
    F, P, R = {}, {}, {}
    for dev in ("cpu", DEVICE):
        model = (SSSC if kind == "sssc" else BSC)(D=Y.shape[1], H=Hx, device=dev)
        data = make_data(Y, n_blocks=2, device=dev)
        cfg, estate = init_states(N=Nx, S=2**Hx, H=Hx, n_blocks=2, device=dev)
        params = model.standard_init(data, seed=1, y_host=Y)
        if dev == DEVICE:
            launches.reset()
        params, estate, stats, y_rec = model.em_step(
            params, estate, data, torch.Generator(device=dev).manual_seed(0), cfg,
            do_reconstruction=True)
        F[dev], R[dev] = float(stats.F), y_rec.cpu()
        P[dev] = {k: v.cpu() for k, v in vars(params).items()}
        if dev == DEVICE:
            launches.expect(**expect)
    errs = {k: ((P[DEVICE][k] - v).abs().max() / v.abs().max()).item()
            for k, v in P["cpu"].items()}
    errs["y_rec"] = ((R[DEVICE] - R["cpu"]).abs().max() / R["cpu"].abs().max()).item()
    say(f"exact incomplete {kind} H={Hx} N={Nx}: F card {F[DEVICE]:.6f}, F cpu {F['cpu']:.6f}, "
        f"max |d| / max value {({k: float(f'{e:.3g}') for k, e in errs.items()})}")
    if not abs(F[DEVICE] - F["cpu"]) <= 1e-5 * abs(F["cpu"]):
        raise AssertionError(f"exact-mode incomplete {kind} F differs between card and CPU")
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"exact-mode incomplete {kind} results differ: {errs}")


def synthetic_image(seed=0):
    """A piecewise-smooth RGB image of INPAINT_IMAGE's size in [0, 255],
    made with NumPy from ``seed`` (in the spirit of evo_tpu's
    apps/images.py:synthetic_image): a smooth colour field per channel,
    flat rectangles and a shaded triangle, and a little pixel noise."""
    h, w, c = INPAINT_IMAGE
    rng = np.random.default_rng(seed)
    i, j = np.mgrid[0:h, 0:w].astype(float) / max(h, w)
    img = np.empty((h, w, c))
    for ch in range(c):
        f1, f2 = rng.uniform(1.5, 4.0, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        img[..., ch] = 110 + 70 * np.cos(f1 * np.pi * i + p1) * np.sin(f2 * np.pi * j + p2)
    for _ in range(6):
        r0, c0 = rng.integers(0, 2 * h // 3), rng.integers(0, 2 * w // 3)
        img[r0:r0 + rng.integers(h // 16, h // 3), c0:c0 + rng.integers(w // 16, w // 3)] = \
            rng.uniform(20, 235, c)
    tri = i + j < 0.35
    img[tri] = (160 - 200 * (i + j)[tri])[:, None] * rng.uniform(0.6, 1.0, c)
    return np.clip(img + rng.normal(scale=2.0, size=img.shape), 0, 255)


def inpaint_data():
    """The inpainting input as the image apps make it (evo_tpu/apps/
    images.py:77-93): the clean image, a copy with INPAINT_MISSING of its
    entries NaN (MCAR, seed 0), its overlapping patches [N, D] centred on
    each patch's mean over its observed pixels, that DC [N, 1], and the
    patch geometry."""
    clean = synthetic_image(0)
    corrupted = clean.copy()
    corrupted[np.random.default_rng(0).random(clean.shape) < INPAINT_MISSING] = np.nan
    ovp = MultiDimOverlappingPatches(corrupted, INPAINT_PATCH, INPAINT_PATCH, 1)
    Y = ovp.get().T
    with np.errstate(invalid="ignore"):
        dc = np.nanmean(Y, axis=1, keepdims=True)
    dc = np.where(np.isfinite(dc), dc, 0.0)
    return clean, corrupted, Y - dc, dc, ovp


def inpaint_setup(kind, inp):
    """A set-up function for ``drive``: ES3C (learning W, pies and sigma2,
    as the image apps do for incomplete data) or EBSC on the inpainting
    data, one block, x = x_infr, initial states and Theta^0 from seed 0.
    F need not rise here: on incomplete data evo_tpu's sigma update adds
    sum_d times the old sigma^2 (evo_tpu/models/bsc.py:530-532, sssc.py:
    715-718), and evo_tpu's own F falls over the first epochs on such data
    too, so the paths are held to finite values only."""
    _, _, Y, _, _ = inp

    def setup(device):
        N, D = Y.shape
        if kind == "sssc":
            model = SSSC(D=D, H=INPAINT_H, to_learn=("W", "pies", "sigma2"), device=device)
        else:
            model = BSC(D=D, H=INPAINT_H, device=device)
        data = make_data(Y, n_blocks=1, device=device)
        cfg, estate = init_states(N=N, S=INPAINT_S, H=INPAINT_H, no_parents=INPAINT_PARENTS,
                                  no_children=INPAINT_CHILDREN, no_generations=1, n_blocks=1,
                                  seed=0, device=device)
        return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)

    return setup


def merge_and_psnr(inp, y_rec):
    """Mean and median merge of the reconstruction on the card with the DC
    added back, their PSNR over the whole image and over the missing
    pixels, and the merge's time.  Returns {merger: (PSNR, PSNR on the
    missing pixels)}."""
    clean, corrupted, _, dc, ovp = inp
    dm = DeviceMerger(ovp, clean, data_range=255.0, device=DEVICE)
    dc_t = torch.as_tensor(dc, dtype=torch.float32, device=DEVICE)
    out = dm(y_rec, dc_t)
    miss = torch.as_tensor(np.isnan(corrupted), device=DEVICE)
    clean_t = torch.as_tensor(clean, dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(lambda: dm(y_rec, dc_t), reps=3, warm=1)
    res = {}
    for key in ("mean", "median"):
        img = out[key]
        if tuple(img.shape) != clean.shape or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"the {key} merge is malformed")
        mse = torch.mean((clean_t - img)[miss] ** 2)
        res[key] = (float(out[f"psnr_{key}"]), float(10 * torch.log10(255.0**2 / mse)))
    say(f"merge on the card: {ms:.2f} ms; PSNR mean merge {res['mean'][0]:.3f} dB (missing "
        f"pixels {res['mean'][1]:.3f} dB), median merge {res['median'][0]:.3f} dB (missing "
        f"pixels {res['median'][1]:.3f} dB)")
    return res


def sssc_setup(conf):
    """A set-up function for ``drive``: an ES3C configuration (n_blocks,
    B, D, H, S, parents, children, slab noise) with data made on the host
    from seed 0 as bench.py makes it (the slab noise as bench.py:234-237),
    initial states and Theta^0 from seed 0."""
    nb, Bk, Dk, Hk, Sk, parents, children, slab_noise = conf

    def setup(device):
        N = nb * Bk
        rng = np.random.default_rng(0)
        if slab_noise:
            zf = 1.0 + 0.3 * rng.standard_normal((N, Hk)).astype(np.float32)
            s = ((rng.random((N, Hk)) <= 2 / Hk) * zf).astype(np.float32)
        else:
            s = (rng.random((N, Hk)) <= 2 / Hk).astype(np.float32)
        Y = s @ rng.standard_normal((Dk, Hk)).astype(np.float32).T \
            + rng.standard_normal((N, Dk)).astype(np.float32)
        model = SSSC(D=Dk, H=Hk, device=device)
        data = make_data(Y, n_blocks=nb, device=device)
        cfg, estate = init_states(N=N, S=Sk, H=Hk, no_parents=parents, no_children=children,
                                  no_generations=1, n_blocks=nb, seed=0, device=device)
        return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)

    return setup


def _device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_epoch(model, params, estate, data, gen, cfg, median_ms, do_reconstruction):
    """One more epoch under torch.profiler (device activity only, to keep
    its host overhead small): its wall time, the summed time of its kernels
    (one stream, so they do not overlap), the idle share of its wall time,
    the heaviest kernels by device time, and the port's own kernels among
    the rest (bsc_lpj_dense, for one, which finds no dense row on the main
    path)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.em_step(params, estate, data, gen, cfg, do_reconstruction=do_reconstruction)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    evts = [e for e in prof.key_averages() if _device_us(e) > 0]
    dev = sum(_device_us(e) for e in evts) / 1e3
    if not dev > 0:
        raise AssertionError("the profiler saw no kernel time on the card")
    say(f"profiled epoch: wall {wall:.1f} ms, kernels {dev:.1f} ms, idle share "
        f"{1 - dev / wall:.3f} (kernels over the unprofiled median: {dev / median_ms:.3f})")
    ranked = sorted(evts, key=_device_us, reverse=True)
    for e in ranked[:8]:
        say(f"  {_device_us(e) / 1e3:8.2f} ms {e.count:5d}x {e.key[:70]}")
    for e in ranked[8:]:
        if any(f"::{name}" in e.key for name in PORT_KERNELS):
            say(f"  {_device_us(e) / 1e3:8.4f} ms {e.count:5d}x {e.key[:70]} (a port kernel)")


def drive(setup, launches, expect, profile=False, do_reconstruction=False,
          timed_epochs=TIMED_EPOCHS, rising=True):
    """Drive one configuration on the card through its public entry points:
    set-up, then 1 warm-up and ``timed_epochs`` timed EM epochs with the
    launch counts set to 0 just before and checked just after, F finite
    (and with ``rising`` higher after the epochs than after the first), the
    state (int8 or packed), its stored lpj, the parameters and any
    reconstruction well formed; with ``profile`` one more epoch under
    torch.profiler.  Returns the launch counts of the epochs, the last
    reconstruction (or None) and the run's last state: a dict with keys
    counts, y_rec, F (per epoch), params, estate, cfg and the last epoch's
    stats."""
    t0 = time.perf_counter()
    model, data, cfg, estate, params = setup(DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    torch.cuda.synchronize()
    say(f"set-up (host data, unique initial states, transfer) {time.perf_counter() - t0:.1f} s")

    launches.reset()
    Fs, ms = [], []
    n_epochs = WARM_EPOCHS + timed_epochs
    for e in range(n_epochs):
        t = time.perf_counter()
        params, estate, stats, y_rec = model.em_step(params, estate, data, gen, cfg,
                                                     do_reconstruction=do_reconstruction)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        Fs.append(float(stats.F))
    counts = launches.expect(**{k: v * n_epochs for k, v in expect.items()})
    timed = ms[WARM_EPOCHS:]
    say(f"F per epoch {[round(f, 4) for f in Fs]}")
    say(f"ms per epoch {[round(m, 1) for m in ms]} (first is warm-up); "
        f"timed median {sorted(timed)[len(timed) // 2]:.1f} ms on {CARD['smi']}")
    say(f"S_nunique {float(stats.S_nunique):.3f}, S_sub {float(stats.S_sub):.3f}, "
        f"resets {[int(x) for x in (stats.n_reset_nan, stats.n_reset_small, stats.n_reset_inf)]}")
    say(f"guards: sigma_floor {int(stats.n_guard_sigma_floor)}, mus_freeze "
        f"{int(stats.n_guard_mus_freeze)}, psi_freeze {int(stats.n_guard_psi_freeze)}, "
        f"psi_renorm {float(stats.guard_psi_renorm):.4g}")
    if not all(np.isfinite(Fs)):
        raise AssertionError(f"non-finite F: {Fs}")
    if rising and not Fs[-1] > Fs[0]:
        raise AssertionError(f"F did not rise over the epochs: {Fs}")
    width = n_bytes_lane(cfg.H) if cfg.packed_states else cfg.H
    shape = (data.n_blocks, data.y.shape[1], cfg.S, width)
    if tuple(estate.ss.shape) != shape or tuple(estate.lpj.shape) != shape[:2] + (
            cfg.S_perm + cfg.S,) or not all(
            bool(torch.isfinite(v).all()) for v in vars(params).values()):
        raise AssertionError("malformed state or parameters after the epochs")
    if do_reconstruction and not (
            y_rec.shape == data.y.shape and bool(torch.isfinite(y_rec).all())
            and torch.equal(y_rec[data.x], data.y[data.x])):
        raise AssertionError("malformed reconstruction: not finite, or observed entries changed")
    if profile:
        profile_epoch(model, params, estate, data, gen, cfg, sorted(timed)[len(timed) // 2],
                      do_reconstruction)
    return dict(counts=counts, y_rec=y_rec, F=Fs, params=params, estate=estate, cfg=cfg,
                stats=stats)


def eopts_setup(kind, swap_merge=False, **opts):
    """A set-up function for ``drive``: bars-size data (EBSC: bars data at
    H = 8, D = 16; ES3C: data from SSSC.generate_data at H = 8, D = 16),
    N = 4096 in 2 blocks, S = 8, 4 parents x 2 children (n_new = S, as the
    whole-set merge needs), with the init_states options ``opts`` and
    ``swap_merge``; initial states and Theta^0 from seed 0."""
    Hx, Nx = 8, 4096

    def setup(device):
        if kind == "sssc":
            g = torch.Generator().manual_seed(3)
            A = torch.randn(Hx, Hx, generator=g) * 0.3
            gen_params = SSSCParams(W=2 * torch.randn(16, Hx, generator=g),
                                    pies=torch.full((Hx,), 2.0 / Hx),
                                    mus=torch.randn(Hx, generator=g),
                                    Psi=A @ A.T + torch.eye(Hx), sigma2=torch.tensor(0.5))
            Y = SSSC(D=16, H=Hx, device="cpu").generate_data(gen_params, Nx, g)["y"].numpy()
            model = SSSC(D=16, H=Hx, device=device)
        else:
            Y = bars_data(Hx, Nx, seed=3)
            model = BSC(D=Y.shape[1], H=Hx, device=device)
        data = make_data(Y, n_blocks=2, device=device)
        cfg, estate = init_states(N=Nx, S=8, H=Hx, no_parents=4, no_children=2,
                                  no_generations=1, n_blocks=2, seed=0, device=device, **opts)
        cfg = dataclasses.replace(cfg, swap_merge=swap_merge)
        return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)

    return setup


def eopts(launches):
    """Short EA runs (1 warm-up, 3 epochs) of both models with the other
    E-step options, each held to drive's checks and to what the option
    promises: the background unit on in every state and its pies at
    1 - 1.1e-5, the permanent state's lpj stored first (drive checks the
    width), and with the whole-set merge that rejects nothing every set
    replaced (S_sub = S_nunique)."""
    runs = (dict(background=True, swap_merge=True),
            dict(allzero=True, unification=False),
            dict(packed_states=True, unification=False, reject_worse=False))
    for kind in ("bsc", "sssc"):
        for opts in runs:
            say(f"{kind} {opts}:")
            if kind == "sssc":
                expect = dict(sssc_lpj=4, sssc_suffstat=2)
            elif opts.get("packed_states"):
                expect = dict(lpj_packed=4, suffstat_packed=2)
            else:
                expect = dict(lpj=4, suffstat=2)
            run = drive(eopts_setup(kind, **opts), launches, expect, rising=False)
            cfg, ss, params = run["cfg"], run["estate"].ss, run["params"]
            states = unpack_bits_lane(ss, cfg.H) if cfg.packed_states else ss != 0
            if cfg.background and not (bool(states[..., -1].all()) and abs(
                    float(params.pies[-1]) - (1.0 - 1.1e-5)) < 1e-7):
                raise AssertionError(f"{kind} {opts}: background unit not kept on")
            st = run["stats"]
            if not cfg.unification and not cfg.reject_worse and not (
                    float(st.S_sub) == float(st.S_nunique)):
                raise AssertionError(f"{kind} {opts}: S_sub {float(st.S_sub)} != S_nunique "
                                     f"{float(st.S_nunique)} with nothing rejected")


METRICS = ("F", "S_nunique", "S_sub")


def metrics_log(outdir):
    """A DataLog writing the per-epoch metrics as text into
    outdir/metrics.txt (Theta reaches no handler)."""
    os.makedirs(outdir, exist_ok=True)
    dlog = DataLog()
    dlog.set_handler(list(METRICS), StoreToTxt, os.path.join(outdir, "metrics.txt"))
    return dlog


def logged_F(outdir):
    """F per epoch as the DataLog wrote it (repr of a float: exact)."""
    with open(os.path.join(outdir, "metrics.txt")) as f:
        return [float(ln.split(" = ")[1]) for ln in f if ln.startswith("F = ")]


def trace_spans(outdir, name):
    """Seconds between each ``name:begin`` and ``name:end`` in the trainer's
    trace archive."""
    with tarfile.open(os.path.join(outdir, "traces.tgz")) as tar:
        lines = tar.extractfile(tar.getmembers()[0]).read().decode().splitlines()
    t = {}
    for ln in lines[1:]:
        stamp, point = ln.split(" ", 1)
        t.setdefault(point, []).append(float(stamp))
    return [b - a for a, b in zip(t[f"{name}:begin"], t[f"{name}:end"])]


def same_run(label, a, b):
    """Params and states of two runs equal bit for bit."""
    (pa, ea), (pb, eb) = a, b
    for name in vars(pa):
        if not torch.equal(getattr(pa, name), getattr(pb, name)):
            raise AssertionError(f"{label}: {name} differs")
    if not (torch.equal(ea.ss, eb.ss) and torch.equal(ea.lpj, eb.lpj)):
        raise AssertionError(f"{label}: the states or their lpj differ")


def trainer(launches):
    """The EBSC primary through EMTrainer (run A: 4 epochs one by one, a
    checkpoint every 2; run B: A's epoch-2 checkpoint resumed, epochs 3-4
    as one em_steps chunk), then em_steps over the 4 epochs and the bare
    em_step loop with epoch_generator, all from the same Theta^0 and states;
    every run's F, parameters and states equal bit for bit, 2 lpj and 1
    suffstat launches per block and epoch.  Returns the set-up (model,
    data, cfg, states, Theta^0) for the parallel phase."""
    t0 = time.perf_counter()
    model, data, cfg, estate0, params0 = primary_setup(DEVICE)
    torch.cuda.synchronize()
    say(f"set-up {time.perf_counter() - t0:.1f} s")
    seed, n = 7, 4
    per_epoch = dict(lpj=2 * N_BLOCKS, suffstat=N_BLOCKS)

    def counts(epochs):
        return {k: v * epochs for k, v in per_epoch.items()}

    with tempfile.TemporaryDirectory() as tmp:
        dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        kept = os.path.join(tmp, "epoch2.npz")

        def keep_epoch2(epoch, **_):
            # the epoch-2 checkpoint is replaced after epoch 4; keep a link
            if epoch == 3:
                os.link(os.path.join(dir_a, "checkpoint.npz"), kept)

        dlog = metrics_log(dir_a)
        run_a = EMTrainer(model, cfg, params0, estate0, data, dlog, dir_a, seed=seed,
                          checkpoint_every=2, tracefile="trace-%04d.txt")
        launches.reset()
        t = time.perf_counter()
        p_a, e_a, _ = run_a.run(n, epoch_callback=keep_epoch2)
        wall_a = time.perf_counter() - t
        launches.expect(**counts(n))
        dlog.close()
        F_a = logged_F(dir_a)
        step_s, ckpt_s = trace_spans(dir_a, "em_step"), trace_spans(dir_a, "checkpoint")
        size = os.path.getsize(kept) / 1e6

        dlog = metrics_log(dir_b)
        t = time.perf_counter()
        # seed 0 here: the checkpoint's seed (7) must take its place
        run_b = EMTrainer(model, cfg, params0, estate0, data, dlog, dir_b, seed=0, resume=kept,
                          theta_append=False, chunk_epochs=2)
        read_s = time.perf_counter() - t
        if (run_b.start_epoch, run_b.seed) != (2, seed):
            raise AssertionError(f"resumed at {run_b.start_epoch} with seed {run_b.seed}")
        launches.reset()
        p_b, e_b, _ = run_b.run(n)
        launches.expect(**counts(2))
        dlog.close()
        F_b = logged_F(dir_b)
    say(f"run A F per epoch {F_a}; run B (resumed at epoch 2, one chunk) {F_b}")
    if len(F_a) != n or not all(np.isfinite(F_a)) or F_b != F_a[2:]:
        raise AssertionError("run B's F per epoch differs from run A's epochs 3-4")
    same_run("run B against run A", (p_a, e_a), (p_b, e_b))
    del p_b, e_b

    # the part of a checkpoint write before NumPy compresses it
    torch.cuda.synchronize()
    t = time.perf_counter()
    packed = [pack_bits_u8(b).cpu() for b in e_a.ss]
    pack_s = time.perf_counter() - t
    del packed

    launches.reset()
    torch.cuda.synchronize()
    t = time.perf_counter()
    p_s, e_s, st = em_steps(model, params0, estate0, data, seed, cfg, n)
    torch.cuda.synchronize()
    steps_ms = 1e3 * (time.perf_counter() - t) / n
    launches.expect(**counts(n))
    if st.F.cpu().tolist() != F_a:
        raise AssertionError(f"em_steps F {st.F.cpu().tolist()} differs from run A's")
    same_run("em_steps against run A", (p_a, e_a), (p_s, e_s))
    del p_s, e_s

    launches.reset()
    t = time.perf_counter()
    p, e = params0, estate0
    for k in range(n):
        p, e, _, _ = model.em_step(p, e, data, epoch_generator(seed, k, DEVICE), cfg)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t) / n
    launches.expect(**counts(n))
    same_run("the bare em_step loop against run A", (p_a, e_a), (p, e))
    say(f"run A per epoch (em_step and its stats' one transfer) "
        f"{[round(1e3 * x, 1) for x in step_s]} ms, whole run {wall_a:.2f} s with "
        f"{len(ckpt_s)} checkpoints; em_steps {steps_ms:.1f} ms an epoch; bare em_step "
        f"loop {bare_ms:.1f} ms an epoch; on {CARD['smi']}")
    say(f"checkpoint of {e_a.ss.numel() / 1e9:.2f} GB of int8 states ({size:.0f} MB on "
        f"disk): write {[round(x, 2) for x in ckpt_s]} s (of which packing on the card and "
        f"copying to the host {pack_s:.2f} s), read (resume) {read_s:.2f} s on {CARD['smi']}")
    return model, data, cfg, estate0, params0


def bars_app(launches):
    """The bars test at the CLI's defaults (H = 8, N = 500, S = 20; EBSC 40
    epochs in chunks of 4, as chunking_kwargs sets them; ES3C 10 epochs),
    built by apps.bars.build and trained by EMTrainer with a text DataLog:
    F finite and rising, against L_gen; launch counts: the exact oracle's
    one, then 2 lpj and 1 suffstat per epoch."""
    for argv in (["ebsc", "--chunk_epochs", "4"], ["es3c", "--no_epochs", "10"]):
        args = bars.get_args(argv)
        launches.reset()
        b = bars.build(args, DEVICE)
        with tempfile.TemporaryDirectory() as tmp:
            dlog = metrics_log(tmp)
            tr = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog, tmp,
                           seed=args.seed + 1, **chunking_kwargs(args))
            tr.run(args.no_epochs)
            dlog.close()
            F = logged_F(tmp)
        E = args.no_epochs
        if args.algo == "ebsc":
            launches.expect(lpj=2 * E + 1, suffstat=E)
        else:
            launches.expect(sssc_lpj=2 * E + 1, sssc_suffstat=E)
        say(f"{args.algo} H={args.H} N={args.no_data_points} S={args.Ksize} "
            f"chunk_epochs={args.chunk_epochs}: F {F[0]:.4f} -> {F[-1]:.4f} over {E} "
            f"epochs, L_gen {b['L_gen']:.4f}")
        if len(F) != E or not all(np.isfinite(F)) or not F[-1] > F[0]:
            raise AssertionError(f"{args.algo}: F not finite or not rising: {F}")


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def app_train(b, launches, expect, n_epochs, outdir, dlog, epoch_callback=None,
              reconstruct_at=None, **trainer_kw):
    """An app's pieces (``build``'s dict) trained by EMTrainer for
    ``n_epochs`` with ``dlog`` and host tracepoints, the launch counts set
    to 0 just before and checked just after (``expect`` per epoch).
    Returns (F per epoch, ms per epoch, the launch counts, final params)."""
    tr = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog, outdir,
                   tracefile="trace-%04d.txt", **trainer_kw)
    launches.reset()
    params, _, _ = tr.run(n_epochs, reconstruct_at=reconstruct_at,
                          epoch_callback=epoch_callback)
    counts = launches.expect(**{k: v * n_epochs for k, v in expect.items()})
    dlog.close()
    F = logged_F(outdir)
    if len(F) != n_epochs or not all(np.isfinite(F)):
        raise AssertionError(f"F not finite: {F}")
    return F, [round(1e3 * x, 1) for x in trace_spans(outdir, "em_step")], counts, params


def timed_callback(callback, last, merges, keep=None):
    """``callback`` with its wall time (the merge, its read-back and the
    log) and the PSNR it left in ``last`` appended to ``merges``; with
    ``keep`` the epoch's y_rec is kept there."""
    def run(**kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        callback(**kw)
        torch.cuda.synchronize()
        merges.append((round(1e3 * (time.perf_counter() - t), 1), last.get("psnr")))
        if keep is not None and kw.get("y_rec") is not None:
            keep["y_rec"] = kw["y_rec"].clone()
    return run


def denoise_app(launches):
    """Both models through apps/images.py at the denoising CLI's defaults on
    the synthetic 256 x 256 image (what the CLI reads at --rescale 1.0
    without ./img/house.png), a merge on the card every epoch; the last
    merge's PSNR must beat the noisy image's."""
    dev = torch.device(DEVICE)
    clean = images.synthetic_image(256)
    total = {}
    for algo, n, expect in (("es3c", 5, dict(sssc_lpj=2, sssc_suffstat=1)),
                            ("ebsc", 2, dict(lpj=2, suffstat=1))):
        args = images.get_args(["denoising", algo, "--rescale", "1.0", "--no_epochs", str(n),
                                "--merge_every", "1"])
        noisy = images.add_noise(clean, args)
        t = time.perf_counter()
        b = images.build(args, clean, noisy, None, dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        with tempfile.TemporaryDirectory() as tmp:
            dlog = metrics_log(tmp)
            callback, last = images.make_epoch_callback(args, b, clean, dlog, dev)
            if last["route"] != "device":
                raise AssertionError(f"merge route {last['route']} on the card")
            merges = []
            F, ms, counts, _ = app_train(
                b, launches, expect, n, tmp, dlog, timed_callback(callback, last, merges),
                b["reconstruct_at"], seed=args.seed + 1,
                **chunking_kwargs(args, theta_append=False, auto_overwrite=False))
        add_counts(total, counts)
        p_noisy = psnr(clean, noisy, 255.0)
        say(f"{algo} N={b['N']} D={b['D']} H={args.H} S={args.Ksize}: set-up {setup_s:.1f} s; "
            f"F per epoch {[round(f, 4) for f in F]}; ms per epoch {ms} (first is warm-up) "
            f"on {CARD['smi']}")
        say(f"  merge on the card and its read-back, ms per epoch {[m for m, _ in merges]}; "
            f"PSNR per merge {[round(p, 3) for _, p in merges]} dB; noisy image {p_noisy:.3f} dB")
        if not merges[-1][1] > p_noisy:
            raise AssertionError(f"{algo}: PSNR {merges[-1][1]} does not beat the noisy image's")
    return total


def inpaint_app(launches, inp, inpaint_res):
    """ES3C inpainting through apps/images.py on sssc_inpaint's image and
    mask (the app's patches and centring must be inpaint_data's): 1
    warm-up and 3 epochs with the merge on the card every epoch; the
    compact read-back of the last y_rec equals the full gather bit for bit
    and the host merge's PSNR is within 1e-3 dB of the card's."""
    dev = torch.device(DEVICE)
    clean, corrupted, Y_ref, _, _ = inp
    n = 4
    args = images.get_args(["inpainting", "es3c", "--no_epochs", str(n)])
    b = images.build(args, clean, corrupted, images.observed(corrupted, args), dev)
    if not np.array_equal(b["Y"], Y_ref, equal_nan=True):
        raise AssertionError("the app's patches differ from inpaint_data's")
    keep, merges = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        dlog = metrics_log(tmp)
        callback, last = images.make_epoch_callback(args, b, clean, dlog, dev)
        F, ms, counts, _ = app_train(
            b, launches, dict(sssc_lpj_masked=2, sssc_suffstat_masked=1), n, tmp, dlog,
            timed_callback(callback, last, merges, keep), b["reconstruct_at"],
            seed=args.seed + 1, **chunking_kwargs(args, theta_append=False,
                                                  auto_overwrite=False))
    y_rec = keep["y_rec"]
    read = images.compact_reader(b, dev)
    t = time.perf_counter()
    full = images.full_readback(b, y_rec)
    full_s = time.perf_counter() - t
    t = time.perf_counter()
    compact = read(y_rec)
    compact_s = time.perf_counter() - t
    if not np.array_equal(full, compact):
        raise AssertionError("the compact read-back differs from the full gather")
    t = time.perf_counter()
    host = images.host_merge(b, clean, full)
    host_s = time.perf_counter() - t
    out = DeviceMerger(b["ovp"], clean, data_range=255.0, device=DEVICE)(
        y_rec, torch.as_tensor(b["dc"], dtype=torch.float32, device=DEVICE))
    miss = np.isnan(corrupted)
    rec = out["mean"].cpu().numpy().astype(np.float64)
    p_miss = float(10 * np.log10(255.0**2 / np.mean((clean - rec)[miss] ** 2)))
    say(f"es3c N={b['N']} D={b['D']} H={args.H} S={args.Ksize}: F per epoch "
        f"{[round(f, 4) for f in F]}; ms per epoch {ms} (first is warm-up) on {CARD['smi']}")
    say(f"  merge on the card and its read-back, ms per epoch {[m for m, _ in merges]}; PSNR "
        f"per merge {[round(p, 3) for _, p in merges]} dB; on the missing pixels {p_miss:.3f} "
        f"dB (sssc_inpaint's {inpaint_res['mean'][1]:.3f} dB)")
    say(f"  last y_rec: full read-back {full_s:.3f} s, compact {compact_s:.3f} s (equal bit "
        f"for bit; the compact reader's set-up not counted); host merge {host_s:.2f} s")
    for name in ("mean", "median"):
        card = float(out[f"psnr_{name}"])
        say(f"  {name} merge PSNR: card {card:.4f} dB, host {host[name][1]:.4f} dB")
        if not abs(card - host[name][1]) <= 1e-3:
            raise AssertionError(f"the {name} merge's PSNR differs between card and host")
    return counts


def feature_app(launches):
    """BSC and SSSC through apps/feature_learning.py's build on the
    synthetic patch file (the CLI's fallback without the reference's patch
    file), at the CLI's defaults, 5 epochs each: F finite and rising.
    Returns (launch counts, the patches)."""
    dev = torch.device(DEVICE)
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = feature_learning.synthetic_patchfile(os.path.join(tmp, "patches.npz"))
        Y = feature_learning.load_patches(path)[0]
        for model, expect in (("bsc", dict(lpj=2, suffstat=1)),
                              ("sssc", dict(sssc_lpj=2, sssc_suffstat=1))):
            args = feature_learning.get_args(["--model", model, "--no_epochs", "5",
                                              "--data_file", path])
            b = feature_learning.build(args, Y, dev)
            out = os.path.join(tmp, model)
            F, ms, counts, _ = app_train(b, launches, expect, args.no_epochs, out,
                                         metrics_log(out), seed=args.seed + 1,
                                         **chunking_kwargs(args))
            add_counts(total, counts)
            say(f"{model} N={Y.shape[0]} D={Y.shape[1]} H={args.H} S={args.Ksize}: F per epoch "
                f"{[round(f, 4) for f in F]}; ms per epoch {ms} on {CARD['smi']}")
            if not F[-1] > F[0]:
                raise AssertionError(f"{model}: F did not rise: {F}")
    return total, Y


def app_setup(build, args, *inputs):
    """A set-up function for ``drive`` from an app's ``build``."""
    def setup(device):
        b = build(args, *inputs, torch.device(device))
        return b["model"], b["data"], b["cfg"], b["estate"], b["params"]
    return setup


def wide_bsc_setup(Hw, Nw):
    """A set-up function for ``drive``: EBSC at H = Hw past bsc_lpj's 1024,
    N = Nw in one block, D = 256, S = 32, 10 parents x 1 child, data made
    as primary_setup makes it."""

    def setup(device):
        rng = np.random.default_rng(0)
        W_gen = rng.standard_normal((D, Hw)).astype(np.float32)
        s_gen = rng.random((Nw, Hw)) <= 2.0 / Hw
        Y = s_gen.astype(np.float32) @ W_gen.T + rng.standard_normal((Nw, D)).astype(np.float32)
        model = BSC(D=D, H=Hw, device=device)
        data = make_data(Y, n_blocks=1, device=device)
        cfg, estate = init_states(N=Nw, S=32, H=Hw, no_parents=10, no_children=1,
                                  no_generations=1, n_blocks=1, seed=0, device=device)
        return model, data, cfg, estate, model.standard_init(data, seed=0, y_host=Y)

    return setup


def wide_lpj_check(setup, run, label, rows=1024):
    """The wide ES3C lpj of the run's last states (the first ``rows``
    datapoints of block 0) on the card against the same function on the
    CPU: the same bad flags, lpj within 1e-3 relative."""
    model, data = setup(DEVICE)[:2]
    p = model.check_params(run["params"])
    pre = model._precompute(p, data)
    G, Wty, y2 = block_gram(p.W, data.y[0, :rows], data.x_infr[0, :rows], data.incomplete)
    args = (run["estate"].ss[0, :rows].contiguous(), Wty, y2, G, p.Psi, p.mus,
            pre["pil_bar"], pre["sigma2_inv"])
    lpj, bad = sssc_lpj_wide(*args)
    lpj_c, bad_c = sssc_lpj_wide(*(a.cpu() for a in args))
    ms = cuda_ms(lambda: sssc_lpj_wide(*args), reps=3, warm=1)
    lpj, bad = lpj.cpu(), bad.cpu()
    if not torch.equal(bad, bad_c):
        raise AssertionError(f"{label}: the wide lpj's bad flags differ between card and CPU")
    ok = bad == 0
    err = ((lpj[ok] - lpj_c[ok]).abs() / lpj_c[ok].abs().clamp(min=1e-30)).max().item()
    say(f"{label}: wide lpj of {args[0].shape[0]} x {args[0].shape[1]} states, card against "
        f"CPU: max relative error {err:.3g}, {int((~ok).sum())} flagged; {ms:.2f} ms a call")
    if not err <= 1e-3:
        raise AssertionError(f"{label}: the wide lpj differs between card and CPU")


def wide(launches, Y_fl):
    """The widths past the kernels' envelope, each on the wide path with
    the kernels it must not launch checked, ms per epoch and peak memory;
    then ES3C at H = 128 (kernels) and 129 (wide) on sssc_fl's data."""
    total = {}
    inp_args = images.get_args(["inpainting", "es3c", "-H", "100", "--no_epochs", "3"])
    clean = images.synthetic_image(128)
    corrupted = images.remove_values(clean, inp_args)
    edge_args = images.get_args(["inpainting", "es3c", "-H", "65", "--no_epochs", "2"])
    edge_clean = images.synthetic_image(48)
    edge_corrupted = images.remove_values(edge_clean, edge_args)
    runs = (
        ("es3c H=256 N=2000 D=64", app_setup(feature_learning.build, feature_learning.get_args(
            ["--model", "sssc", "-H", "256"]), Y_fl), {}, False, 2),
        ("es3c inpainting H=100 N=15376 D=25", app_setup(
            images.build, inp_args, clean, corrupted, images.observed(corrupted, inp_args)),
         {}, True, 2),
        ("ebsc H=1280 N=4096 D=256", wide_bsc_setup(*WIDE_BSC), dict(suffstat=1), False, 1),
        # the first widths past each limit: ES3C on incomplete data, EBSC
        ("es3c inpainting H=65 N=1936 D=25", app_setup(
            images.build, edge_args, edge_clean, edge_corrupted,
            images.observed(edge_corrupted, edge_args)), {}, True, 1),
        ("ebsc H=1025 N=1024 D=256", wide_bsc_setup(1025, 1024), dict(suffstat=1), False, 1),
    )
    for label, setup, expect, rec, timed in runs:
        torch.cuda.reset_peak_memory_stats()
        run = drive(setup, launches, expect, do_reconstruction=rec, timed_epochs=timed,
                    rising=False)
        add_counts(total, run["counts"])
        say(f"{label}: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if label.startswith(("es3c H=256", "es3c inpainting H=100")):
            wide_lpj_check(setup, run, label)
        del run
    for Hx, expect in ((128, dict(sssc_lpj=2, sssc_suffstat=1)), (129, {})):
        conf = SSSC_FL[:3] + (Hx,) + SSSC_FL[4:]
        say(f"es3c at H={Hx} on sssc_fl's data ({'kernels' if expect else 'wide path'}):")
        add_counts(total, drive(sssc_setup(conf), launches, expect, timed_epochs=2,
                                profile=True, rising=False)["counts"])
    return total


# the parallel phase: worker processes and their wall-clock limit
WORKER_TIMEOUT_S = 180
CHILDREN = []


def spawn(fn, argsets):
    """Run fn(*args) for each of ``argsets`` in processes started with the
    spawn method (CUDA does not survive fork), all at once; kill every one
    of them if any overruns WORKER_TIMEOUT_S, and raise unless all exit 0."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=fn, args=a, daemon=True) for a in argsets]
    CHILDREN.extend(procs)
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORKER_TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [p for p in procs if p.is_alive()]
        for p in late:
            p.kill()
            p.join()
    if late:
        raise AssertionError(f"{len(late)} worker(s) overran {WORKER_TIMEOUT_S} s; all killed")
    bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise AssertionError(f"worker(s) failed (index, exit code): {bad}")


def state_digest(estate, lo=0, hi=None):
    """blake2b of rows lo:hi of every block of an int8 EState's states
    (bit-packed) and lpj."""
    h = hashlib.blake2b(digest_size=16)
    for b in range(estate.ss.shape[0]):
        h.update(pack_bits_u8(estate.ss[b, lo:hi].contiguous()).cpu().numpy().tobytes())
        h.update(estate.lpj[b, lo:hi].cpu().numpy().tobytes())
    return h.hexdigest()


def host_params(params):
    return {f: v.cpu().numpy() for f, v in vars(params).items()}


def save_inputs(tmp, kind, model, data, cfg, estate, params):
    """A run's inputs for the workers: y [nb, B, D] and the states,
    bit-packed [nb, B, S, ceil(H/8)], as .npy files (read with mmap, so
    that each worker reads its rows only), Theta^0 as an .npz; returns the
    settings."""
    np.save(os.path.join(tmp, f"{kind}-y.npy"), data.y.cpu().numpy())
    np.save(os.path.join(tmp, f"{kind}-ss.npy"),
            torch.stack([pack_bits_u8(b) for b in estate.ss]).cpu().numpy())
    np.savez(os.path.join(tmp, f"{kind}-theta.npz"), **host_params(params))
    return dict(kind=kind, D=model.D, H=model.H, to_learn=model.to_learn, cfg=cfg)


def one_process_run(model, data, cfg, estate, params, n_epochs, launches, expect):
    """The no-group run the ranks are held to: epochs with
    epoch_generator(0, e), with F, parameters, the first epoch's packed
    states and each epoch's state digest; launch counts checked."""
    run = dict(F=[], params=[], digest=[])
    launches.reset()
    for e in range(n_epochs):
        params, estate, stats, _ = model.em_step(params, estate, data,
                                                 epoch_generator(0, e, DEVICE), cfg)
        run["F"].append(float(stats.F))
        run["params"].append(host_params(params))
        run["digest"].append(state_digest(estate))
        if e == 0:
            run["ss0"] = torch.stack([pack_bits_u8(b) for b in estate.ss]).cpu().numpy()
    launches.expect(**{k: v * n_epochs for k, v in expect.items()})
    return run


def timed(fn, spans):
    """``fn`` with each call's wall time in ms, between two
    torch.cuda.synchronize, appended to the list ``spans``."""
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        spans.append(1e3 * (time.perf_counter() - t))
        return out
    return run


def parallel_worker(tmp, rank, world, backend, jobs):
    """One rank of a data-parallel group on the card: for each job (the
    inputs of ``save_inputs`` and its epochs), this rank's rows through
    make_global_data, Theta^0 from global sums against the parent's, the
    epochs with epoch_generator(0, e), each epoch's host time (ending in
    torch.cuda.synchronize) and its all_reduce's, F, parameters, state
    digests and launch counts to <tmp>/<kind>-<backend>-rank<rank>.npz."""
    from evo_tpu_torch import BSCParams
    from evo_tpu_torch.parallel import distributed, init_distributed, make_global_data
    from evo_tpu_torch.utils.checkpoint import save_checkpoint

    init_distributed(backend=backend, rank=rank, world_size=world, device=DEVICE,
                     init_method="file://" + os.path.join(tmp, f"store-{backend}"))
    ar_ms = []
    # the models call it through the module
    distributed.allreduce_sums = timed(distributed.allreduce_sums, ar_ms)
    launches = Launches()
    for job in jobs:
        kind, n_epochs = job["kind"], job["epochs"]
        y = np.load(os.path.join(tmp, f"{kind}-y.npy"), mmap_mode="r")
        nb, Bg, D_ = y.shape
        Bl = Bg // world
        y_loc = np.ascontiguousarray(y[:, rank * Bl:(rank + 1) * Bl]).reshape(-1, D_)
        data = make_global_data(y_loc, n_blocks=nb, device=DEVICE)
        packed = np.load(os.path.join(tmp, f"{kind}-ss.npy"), mmap_mode="r")
        cfg = job["cfg"]
        ss = torch.stack([unpack_bits_u8(torch.from_numpy(packed[b, rank * Bl:(rank + 1) * Bl]
                                                          .copy()).to(DEVICE), cfg.H)
                          for b in range(nb)]).to(torch.int8)
        estate = EState(ss=ss, lpj=torch.zeros((nb, Bl, cfg.S_perm + cfg.S), device=DEVICE))
        model = (BSC if kind == "bsc" else SSSC)(D=job["D"], H=job["H"],
                                                 to_learn=job["to_learn"], device=DEVICE)
        with np.load(os.path.join(tmp, f"{kind}-theta.npz")) as z:
            theta0 = {f: z[f] for f in z.files}
        params = (BSCParams if kind == "bsc" else SSSCParams)(
            **{f: torch.as_tensor(v, device=DEVICE) for f, v in theta0.items()})
        mine = host_params(model.standard_init(data, seed=0, y_host=y_loc))
        theta_err = max(float(np.abs(mine[f] - theta0[f]).max() / (np.abs(theta0[f]).max()))
                        for f in theta0)
        if not all(np.allclose(mine[f], theta0[f], rtol=1e-4, atol=1e-5) for f in theta0):
            raise AssertionError(f"rank {rank}: Theta^0 from global sums differs ({theta_err})")
        res, ms = dict(theta_err=theta_err), []
        del ar_ms[:]
        launches.reset()
        for e in range(n_epochs):
            t = time.perf_counter()
            params, estate, stats, _ = model.em_step(params, estate, data,
                                                     epoch_generator(0, e, DEVICE), cfg)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            res[f"F{e}"] = float(stats.F)
            res.update({f"p{e}/{f}": v for f, v in host_params(params).items()})
            res[f"digest{e}"] = state_digest(estate)
            if e == 0 and job.get("first_states"):
                res["ss0"] = torch.stack([pack_bits_u8(b) for b in estate.ss]).cpu().numpy()
            if e + 1 == job.get("checkpoint_after"):
                t = time.perf_counter()
                save_checkpoint(os.path.join(tmp, f"{kind}-ckpt.npz"), params, estate, e + 1, 0,
                                cfg, model, data)
                res["ckpt_s"] = time.perf_counter() - t
        res.update(ms=np.asarray(ms), allreduce_ms=np.asarray(ar_ms),
                   counts=json.dumps({k: getattr(f, a) for k, (f, a) in launches.fns.items()}))
        np.savez(os.path.join(tmp, f"{kind}-{backend}-rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()


def rank_results(tmp, kind, backend, world):
    out = []
    for rank in range(world):
        with np.load(os.path.join(tmp, f"{kind}-{backend}-rank{rank}.npz")) as z:
            r = {k: z[k] for k in z.files}
        r["counts"] = json.loads(str(r["counts"]))
        out.append(r)
    return out


def check_counts(label, got, want):
    """A worker's launch counts: those of ``want`` and no other kernel."""
    got = {k: v for k, v in got.items() if v or k in want}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def check_ranks(label, ranks, one, n_epochs, expect, w_tol=True):
    """The ranks' results against each other (parameters bit for bit every
    epoch) and against the no-group run (F within rtol 2e-4, W within rtol
    1e-3, atol 1e-4 with ``w_tol``); per-rank epoch and all_reduce ms and
    launch counts.  Returns the ranks' summed launch counts."""
    total = {}
    for rank, r in enumerate(ranks):
        check_counts(f"{label} rank {rank}", r["counts"],
                     {k: v * n_epochs for k, v in expect.items()})
        add_counts(total, r["counts"])
        say(f"{label} rank {rank}: ms per epoch {[round(float(m), 1) for m in r['ms']]} "
            f"(first is warm-up), all_reduce ms per epoch "
            f"{[round(float(m), 2) for m in r['allreduce_ms']]}; Theta^0 from global sums "
            f"within {float(r['theta_err']):.2g} of the parent's")
    for e in range(n_epochs):
        for f in one["params"][e]:
            if not np.array_equal(ranks[0][f"p{e}/{f}"], ranks[1][f"p{e}/{f}"]):
                raise AssertionError(f"{label}: the ranks' {f} differ after epoch {e + 1}")
    F = [float(ranks[0][f"F{e}"]) for e in range(n_epochs)]
    dW = max(float(np.abs(ranks[0][f"p{e}/W"] - one["params"][e]["W"]).max())
             for e in range(n_epochs))
    say(f"{label}: F per epoch, 2 ranks {F}; one process {one['F'][:n_epochs]}; "
        f"max |dW| {dW:.3g}")
    if not np.allclose(F, one["F"][:n_epochs], rtol=2e-4, atol=0):
        raise AssertionError(f"{label}: F of the 2 ranks is not within rtol 2e-4")
    if w_tol and not all(np.allclose(ranks[0][f"p{e}/W"], one["params"][e]["W"], rtol=1e-3,
                                     atol=1e-4) for e in range(n_epochs)):
        raise AssertionError(f"{label}: W of the 2 ranks is not within rtol 1e-3, atol 1e-4")
    return total


def parallel(launches, primary):
    """Data parallelism on the one card: the EBSC primary at full width
    split over 2 gloo ranks (each 25 blocks of 2048 rows; 1 + 3 epochs, a
    checkpoint by rank 0 after epoch 2, read back here in one process), then
    the ES3C primary over the same 2 ranks (1 + 2 epochs), then a one-rank
    NCCL group on the EBSC primary (1 + 1 epochs, bit for bit the no-group
    run).  Both ranks start from this process's Theta^0 and full states.
    Two processes share the card, so their times are no scaling figure.
    Returns the workers' launch counts."""
    model, data, cfg, estate0, params0 = primary
    B_loc = B // 2
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bsc_job = dict(save_inputs(tmp, "bsc", model, data, cfg, estate0, params0), epochs=4,
                       checkpoint_after=2, first_states=True)
        s_model, s_data, s_cfg, s_estate, s_params = sssc_setup(SSSC_PRIMARY)(DEVICE)
        sssc_job = dict(save_inputs(tmp, "sssc", s_model, s_data, s_cfg, s_estate, s_params),
                        epochs=3)
        say(f"inputs to files {time.perf_counter() - t0:.1f} s")
        one = one_process_run(model, data, cfg, estate0, params0, 4, launches,
                              dict(lpj=2 * N_BLOCKS, suffstat=N_BLOCKS))
        one_s = one_process_run(s_model, s_data, s_cfg, s_estate, s_params, 3, launches,
                                dict(sssc_lpj=2 * SSSC_PRIMARY[0], sssc_suffstat=SSSC_PRIMARY[0]))
        del s_model, s_data, s_estate, s_params
        torch.cuda.synchronize()

        t0 = time.perf_counter()
        spawn(parallel_worker, [(tmp, r, 2, "gloo", [bsc_job, sssc_job]) for r in range(2)])
        say(f"2 gloo ranks on the one card (two processes sharing it, not a scaling figure): "
            f"{time.perf_counter() - t0:.1f} s with their start")
        ranks = rank_results(tmp, "bsc", "gloo", 2)
        total = check_ranks("ebsc 2 ranks", ranks, one, 4, dict(lpj=2 * N_BLOCKS,
                                                                suffstat=N_BLOCKS))
        differ = sum(int((r["ss0"] != one["ss0"][:, k * B_loc:(k + 1) * B_loc]).any(-1).sum())
                     for k, r in enumerate(ranks))
        say(f"first epoch: {differ} of {N_BLOCKS * B * S} states differ from the one-process "
            f"run's")
        t = time.perf_counter()
        p_ck, e_ck, epoch, _ = load_checkpoint(os.path.join(tmp, "bsc-ckpt.npz"), params0,
                                               cfg, model, data)
        read_s = time.perf_counter() - t
        if epoch != 2 or any(not np.array_equal(v, ranks[0][f"p1/{f}"])
                             for f, v in host_params(p_ck).items()):
            raise AssertionError("the 2-rank checkpoint's epoch or params differ from the ranks'")
        for k, r in enumerate(ranks):
            if state_digest(e_ck, k * B_loc, (k + 1) * B_loc) != str(r["digest1"]):
                raise AssertionError(f"the 2-rank checkpoint's rows of rank {k} differ")
        say(f"checkpoint after epoch 2 by rank 0: written in {float(ranks[0]['ckpt_s']):.2f} s "
            f"(gather and write), read in one process in {read_s:.2f} s; params and both "
            f"ranks' rows of the states equal")
        del p_ck, e_ck
        add_counts(total, check_ranks("es3c 2 ranks", rank_results(tmp, "sssc", "gloo", 2),
                                      one_s, 3, dict(sssc_lpj=2 * SSSC_PRIMARY[0],
                                                     sssc_suffstat=SSSC_PRIMARY[0]),
                                      w_tol=False))

        t0 = time.perf_counter()
        spawn(parallel_worker, [(tmp, 0, 1, "nccl", [dict(bsc_job, epochs=2,
                                                          checkpoint_after=None,
                                                          first_states=False)])])
        (r,) = rank_results(tmp, "bsc", "nccl", 1)
        for e in range(2):
            same = (float(r[f"F{e}"]) == one["F"][e] and str(r[f"digest{e}"]) == one["digest"][e]
                    and all(np.array_equal(r[f"p{e}/{f}"], v)
                            for f, v in one["params"][e].items()))
            if not same:
                raise AssertionError(f"the one-rank NCCL group differs from the no-group run "
                                     f"in epoch {e + 1}")
        check_counts("nccl rank", r["counts"], dict(lpj=4 * N_BLOCKS, suffstat=2 * N_BLOCKS))
        add_counts(total, r["counts"])
        say(f"one-rank NCCL group: epochs 1-2 equal the no-group run bit for bit (F, params, "
            f"states); ms per epoch {[round(float(m), 1) for m in r['ms']]}, all_reduce ms "
            f"{[round(float(m), 2) for m in r['allreduce_ms']]}; "
            f"{time.perf_counter() - t0:.1f} s with its start")
    return total


# parallel_apps: the image apps' jobs and their launches per epoch (the
# denoising CLI at --rescale 1.0, a merge at the first and the last epoch;
# inpainting on inpaint_data's image and mask, a merge every epoch)
APP_JOBS = {"denoise": (["denoising", "es3c", "--rescale", "1.0", "--no_epochs", "3",
                         "--merge_every", "3"], dict(sssc_lpj=2, sssc_suffstat=1)),
            "inpaint": (["inpainting", "es3c", "--no_epochs", "3"],
                        dict(sssc_lpj_masked=2, sssc_suffstat_masked=1))}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def app_inputs(job, inp=None):
    """(args, clean image, corrupted image, x) of a parallel_apps job."""
    args = images.get_args(APP_JOBS[job][0])
    if job == "denoise":  # the synthetic 256 x 256 image without ./img/house.png
        clean = images.get_image(args.clean_image, args.rescale)
        return args, clean, images.add_noise(clean, args), None
    clean, corrupted, _, _, _ = inp or inpaint_data()
    return args, clean, corrupted, images.observed(corrupted, args)


def app_run(job, launches, device, inp=None, pad_multiple=1, spans=None):
    """A parallel_apps job through images.build (this process's rows, padded
    to ``pad_multiple`` with no group), its epoch callback and EMTrainer
    with a text log and host tracepoints: F per epoch, ms per epoch (the
    em_step spans), (epoch, callback ms, mean-merge PSNR) of each merge, the
    callback's route, N, the block size and the launch counts of the
    epochs; the lists of ``spans`` are emptied just before the epochs and
    returned with the result."""
    args, clean, corrupted, x_keep = app_inputs(job, inp)
    b = images.build(args, clean, corrupted, x_keep, device, pad_multiple=pad_multiple)
    out = dict(F=[], merges=[], N=b["N"], B=int(b["data"].y.shape[1]))
    with tempfile.TemporaryDirectory() as tmp:
        dlog = metrics_log(tmp)
        callback, last = images.make_epoch_callback(args, b, clean, dlog, device)
        out["route"] = last["route"]

        def record(epoch, F, **kw):
            out["F"].append(F)
            last.pop("psnr", None)
            torch.cuda.synchronize()
            t = time.perf_counter()
            callback(epoch=epoch, F=F, **kw)
            torch.cuda.synchronize()
            if "psnr" in last:
                out["merges"].append((epoch, 1e3 * (time.perf_counter() - t), last["psnr"]))

        tr = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog, tmp,
                       seed=args.seed + 1, tracefile="trace-%04d.txt",
                       **chunking_kwargs(args, theta_append=False, auto_overwrite=False))
        for v in (spans or {}).values():
            del v[:]
        launches.reset()
        tr.run(args.no_epochs, reconstruct_at=b["reconstruct_at"], epoch_callback=record)
        out["counts"] = launches.counts()
        dlog.close()
        out["ms"] = [1e3 * x for x in trace_spans(tmp, "em_step")]
    out.update({k: list(v) for k, v in (spans or {}).items()})
    return out


def apps_worker(tmp, rank, world, port):
    """One rank of parallel_apps, started as torchrun starts one: its
    variables set, the group brought up by init_distributed(backend="gloo")
    from them (no rank, world size or address given), the app's device from
    platform_device(); then each
    APP_JOBS job through app_run on the card, with the all_reduce, the
    reconstruction's gather (full_readback) and the host merge timed;
    results to <tmp>/apps-rank<rank>.json."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from evo_tpu_torch.apps.common import platform_device
    from evo_tpu_torch.parallel import distributed, init_distributed

    got = init_distributed(backend="gloo", device=DEVICE)
    if got != (rank, world):
        raise AssertionError(f"init_distributed() from the environment gave {got}")
    device = platform_device()
    spans = dict(allreduce_ms=[], gather_ms=[], merge_ms=[])
    distributed.allreduce_sums = timed(distributed.allreduce_sums, spans["allreduce_ms"])
    images.full_readback = timed(images.full_readback, spans["gather_ms"])
    images.host_merge = timed(images.host_merge, spans["merge_ms"])
    launches = Launches()
    res = {job: app_run(job, launches, device, spans=spans) for job in APP_JOBS}
    with open(os.path.join(tmp, f"apps-rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


def parallel_apps(launches, inp):
    """The image apps over 2 ranks on the one card, started as torchrun
    starts them (apps_worker): ES3C denoising (N = 63,504) and inpainting
    (N = 151,209, one block padded to 151,210), 1 + 2 epochs each, against
    the same jobs in this process with no group and pad_multiple=2 (the
    same padded rows; merged on the card): F per epoch within rtol 2e-4,
    the mean merge's PSNR within 0.05 dB at every merge, the launch counts
    of each rank; the gap to this process's run with pad_multiple=1 is
    printed only (the card's draws depend on the tensors' sizes).  Returns
    the workers' launch counts."""
    dev, one, total = torch.device(DEVICE), {}, {}
    for job, (_, expect) in APP_JOBS.items():
        one[job] = app_run(job, launches, dev, inp, pad_multiple=2)
        check_counts(f"{job} one process", one[job]["counts"],
                     {k: 3 * v for k, v in expect.items()})
        if one[job]["B"] == one[job]["N"]:
            one[job]["pad1"] = None  # nothing padded: pad_multiple=1 is the same run
        else:
            one[job]["pad1"] = app_run(job, launches, dev, inp)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        port = free_port()
        spawn(apps_worker, [(tmp, r, 2, port) for r in range(2)])
        say(f"2 gloo ranks from torchrun's variables on the one card (two processes sharing "
            f"it, not a scaling figure): {time.perf_counter() - t0:.1f} s with their start")
        ranks = []
        for r in range(2):
            with open(os.path.join(tmp, f"apps-rank{r}.json")) as f:
                ranks.append(json.load(f))
    for job, (_, expect) in APP_JOBS.items():
        o, rs = one[job], [r[job] for r in ranks]
        label = f"{job} N={o['N']} (B={o['B']}, {rs[0]['B']} a rank)"
        for rank, r in enumerate(rs):
            if r["route"] != "full":
                raise AssertionError(f"{label} rank {rank}: merge route {r['route']}")
            check_counts(f"{label} rank {rank}", r["counts"],
                         {k: 3 * v for k, v in expect.items()})
            add_counts(total, r["counts"])
            say(f"{label} rank {rank}: ms per epoch {[round(m, 1) for m in r['ms']]} (first "
                f"is warm-up), all_reduce ms {[round(m, 2) for m in r['allreduce_ms']]}; per "
                f"merge epoch {[e for e, _, _ in r['merges']]}: gather ms "
                f"{[round(m, 1) for m in r['gather_ms']]}, host merge ms "
                f"{[round(m, 1) for m in r['merge_ms']]}, callback ms "
                f"{[round(m, 1) for _, m, _ in r['merges']]} on {CARD['smi']}")
        psnr2, psnr_r1, psnr1 = ([p for _, _, p in r["merges"]] for r in (*rs, o))
        if rs[0]["F"] != rs[1]["F"] or psnr2 != psnr_r1:
            raise AssertionError(f"{label}: the ranks' F or PSNR differ")
        say(f"{label}: F per epoch, 2 ranks {rs[0]['F']}; one process, pad_multiple=2 "
            f"{o['F']}; PSNR per merge {[round(p, 4) for p in psnr2]} dB against "
            f"{[round(p, 4) for p in psnr1]} dB (merge route {o['route']!r}, ms per epoch "
            f"{[round(m, 1) for m in o['ms']]})")
        if not np.allclose(rs[0]["F"], o["F"], rtol=2e-4, atol=0):
            raise AssertionError(f"{label}: F of the 2 ranks is not within rtol 2e-4")
        if [e for e, _, _ in rs[0]["merges"]] != [e for e, _, _ in o["merges"]] or not all(
                abs(a - b) <= 0.05 for a, b in zip(psnr2, psnr1)):
            raise AssertionError(f"{label}: the mean merge's PSNR is not within 0.05 dB")
        p1 = o["pad1"]
        if p1 is None:
            say(f"{label}: pad_multiple=1 pads nothing here, so it is the same run (gap 0)")
        else:
            say(f"{label}: gap to one process with pad_multiple=1 (printed, not checked): "
                f"F {[float(f'{a - b:.4g}') for a, b in zip(rs[0]['F'], p1['F'])]}, PSNR "
                f"{[round(a - p, 4) for a, (_, _, p) in zip(psnr2, p1['merges'])]} dB")
    return total


def graph_problem(n_rows):
    """(model, data, params): the main path's widths on ``n_rows`` rows of
    synthetic data made on the host from seed 5 (as ``primary_setup`` makes
    it) in GRAPH_BLOCKS blocks, the last padded as make_data pads it for the
    apps, and Theta^0 from seed 0."""
    rng = np.random.default_rng(5)
    W_gen = rng.standard_normal((D, H)).astype(np.float32)
    s_gen = rng.random((n_rows, H)) <= 2.0 / H
    Y = s_gen.astype(np.float32) @ W_gen.T + rng.standard_normal((n_rows, D)).astype(np.float32)
    model = BSC(D=D, H=H, device=DEVICE)
    data = make_data(Y, n_blocks=GRAPH_BLOCKS, device=DEVICE)
    return model, data, model.standard_init(data, seed=0, y_host=Y)


def graph_epochs(model, data, cfg, estate, params, launches, n_epochs=GRAPH_EPOCHS, rec=False):
    """``n_epochs`` epochs from the same inputs, each em_step in a traced
    span (epoch e draws from epoch_generator(11, e)).  Returns (params,
    estate, stats) per epoch, the span's counters per epoch, the launch
    counts, the host ms per epoch until em_step returned and until the card
    finished, and the peak memory of the epochs after the first above what
    was allocated before them (bytes)."""
    tmp = tempfile.mkdtemp(prefix="epoch_graph-")
    tracing.set_tracefile(os.path.join(tmp, "trace.txt"))
    launches.reset()
    varykn_merge.launches = 0
    out, host_ms, card_ms, base = [], [], [], 0
    for e in range(n_epochs):
        if e == 1:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with tracing.span("em_step"):
            params, estate, stats, _ = model.em_step(params, estate, data,
                                                     epoch_generator(11, e, DEVICE), cfg,
                                                     do_reconstruction=rec)
        host_ms.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        card_ms.append(1e3 * (time.perf_counter() - t))
        out.append((params, estate, stats))
    peak = torch.cuda.max_memory_allocated() - base
    tracing.close(archive=None)
    counts = [s.counts for s in tracing.records().spans if s.name == "em_step"]
    return out, counts, dict(launches.counts(), merge=varykn_merge.launches), host_ms, card_ms, \
        peak


def same_epochs(label, graphed, eager):
    """Raise unless every epoch's K^(n), lpj, Theta and stats of the
    graphed run equal the eager run's bit for bit; print the largest
    relative gap of each leaf that differs."""
    for e, ((pg, eg, sg), (pe, ee, se)) in enumerate(zip(graphed, eager)):
        leaves = [("K", eg.ss, ee.ss), ("lpj", eg.lpj, ee.lpj)]
        leaves += [(f"theta.{k}", v, getattr(pe, k)) for k, v in vars(pg).items()]
        leaves += [(f"stats.{f.name}", getattr(sg, f.name), getattr(se, f.name))
                   for f in dataclasses.fields(StepStats)]
        bad = {name: float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(
            min=1e-300)) for name, a, b in leaves if not torch.equal(a, b)}
        if bad:
            raise AssertionError(f"{label}: epoch {e}: graphed differs from eager in {bad}")


def epoch_graph(launches):
    """EBSC EA epochs with the blocks' phases replayed from CUDA graphs
    against the same epochs run eagerly (``block_graphs.engages`` patched
    to say no), from the same Theta^0, K^0, data and epoch generators, at
    the main path's widths in GRAPH_BLOCKS blocks of B: the cell's shapes,
    an uneven last block (3 padding rows) and packed states.  K^(n), lpj,
    Theta and every stat bit for bit alike each epoch, the launch counts
    alike, one capture per shape (in the first epoch, whose first block
    runs eagerly), the merge kernel once a block on both paths; then
    incomplete data with reconstruction and exact mode run eagerly.
    Prints host ms per epoch of both paths and the peak memory above the
    epochs' inputs."""
    cfg, estate = init_states(N=GRAPH_BLOCKS * B, S=S, H=H, no_parents=N_PARENTS,
                              no_children=N_CHILDREN, no_generations=N_GENERATIONS,
                              n_blocks=GRAPH_BLOCKS, seed=0, device=DEVICE)
    packed = (dataclasses.replace(cfg, packed_states=True),
              EState(ss=pack_bits_lane(estate.ss), lpj=estate.lpj))
    nb = GRAPH_BLOCKS
    kernel = {"em_step.blocks": nb, "merge.kernel_blocks": nb}
    want = [dict(kernel, **{"em_step.graph_blocks": nb - 1, "em_step.graph_captures": 1})]
    want += [dict(kernel, **{"em_step.graph_blocks": nb})] * (GRAPH_EPOCHS - 1)
    for label, n_rows, cfg_c, est in (("cell", nb * B, cfg, estate),
                                      ("uneven", nb * B - 3, cfg, estate),
                                      ("packed", nb * B, *packed)):
        _, data, params = graph_problem(n_rows)
        runs = {}
        for path in ("eager", "graphed"):
            off = mock.patch.object(block_graphs, "engages", lambda *a: False)
            with off if path == "eager" else contextlib.nullcontext():
                runs[path] = graph_epochs(BSC(D=D, H=H, device=DEVICE), data, cfg_c, est, params,
                                          launches)
        (g_out, g_counts, g_launch, g_host, g_card, g_peak) = runs["graphed"]
        (e_out, e_counts, e_launch, e_host, e_card, e_peak) = runs["eager"]
        same_epochs(label, g_out, e_out)
        if g_counts != want or e_counts != [kernel] * GRAPH_EPOCHS:
            raise AssertionError(f"{label}: counters graphed {g_counts}, eager {e_counts}")
        if g_launch != e_launch or g_launch["merge"] != nb * GRAPH_EPOCHS:
            raise AssertionError(f"{label}: launches graphed {g_launch}, eager {e_launch}")
        say(f"{label}: {nb} blocks x {B} rows, packed {cfg_c.packed_states}: bit for bit alike "
            f"over {GRAPH_EPOCHS} epochs; F {[round(float(s.F), 4) for *_, s in g_out]}")
        say(f"  host ms per epoch until em_step returned: eager "
            f"{[round(m, 2) for m in e_host]}, graphed {[round(m, 2) for m in g_host]} "
            f"(first: the capture); until the card finished: eager "
            f"{[round(m, 2) for m in e_card]}, graphed {[round(m, 2) for m in g_card]}")
        say(f"  peak memory above the inputs, epochs 2-{GRAPH_EPOCHS}: eager "
            f"{e_peak / 2**20:.1f} MiB, graphed {g_peak / 2**20:.1f} MiB; on {CARD['smi']}")
        del runs, g_out, e_out
    # incomplete data (with reconstruction) and exact mode stay eager
    Y = bars_data(10, 4096, seed=2)
    Y_missing = np.where(np.random.default_rng(3).random(Y.shape) < 0.15, np.nan, Y)
    for label, Yc, S_c, rec, want_c in (
            ("incomplete", Y_missing, 20, True, {"em_step.blocks": 2, "merge.kernel_blocks": 2}),
            ("exact", Y, 2**10, False, {"em_step.blocks": 2})):
        model = BSC(D=Y.shape[1], H=10, device=DEVICE)
        data = make_data(Yc, n_blocks=2, device=DEVICE)
        cfg_c, est = init_states(N=4096, S=S_c, H=10, n_blocks=2, device=DEVICE)
        counts = graph_epochs(model, data, cfg_c, est, model.standard_init(data, seed=1, y_host=Yc),
                              launches, n_epochs=2, rec=rec)[1]
        if counts != [want_c] * 2 or model.__dict__.get("_graphs") is not None:
            raise AssertionError(f"{label}: the blocks did not run eagerly: {counts}")
        say(f"{label}: eager, as it should be (counters {counts[0]})")


# the merge phase's cases: (label, B, S, T, W, Mprime, row dtype, lpjs, byte offset of the rows)
MERGE_CASES = (
    ("ebsc block", B, S, N_PARENTS * N_CHILDREN, H, S, torch.int8, "ea", 0),
    ("ebsc packed", B, S, N_PARENTS * N_CHILDREN, n_bytes_lane(H), S, torch.uint8, "ea", 0),
    ("es3c inpaint", INPAINT_N, INPAINT_S, INPAINT_PARENTS * INPAINT_CHILDREN, INPAINT_H,
     INPAINT_S, torch.int8, "ea", 0),
    ("es3c wide", 62001, 64, 10, 256, 64, torch.int8, "ea", 0),
    ("mprime < T", B, 20, 10, 32, 3, torch.int8, "ties", 0),
    ("ties", B, S, 10, H, S, torch.int8, "ties", 0),
    ("w25", B, 20, 10, 25, 20, torch.int8, "ea", 0),
    ("w13", B, 20, 10, 13, 4, torch.uint8, "ties", 0),
    ("w100", B, 20, 10, 100, 20, torch.int8, "ea", 0),
    ("w50", B, 20, 10, 50, 20, torch.int8, "ea", 0),
    ("offset", B, S, 10, H, S, torch.int8, "ea", 8),
    ("past a warp", B, 200, 100, 32, 200, torch.int8, "ea", 0),
    ("past a warp, ties", 512, 200, 300, 32, 150, torch.int8, "levels", 0),
    ("cap", 256, 1000, 24, 16, 1000, torch.int8, "ties", 0),
    ("cap mprime", 256, 24, 1000, 16, 7, torch.int8, "ea", 0),
    ("no children", B, 16, 0, 32, 16, torch.int8, "ea", 0),
)


def merge_inputs(Bm, Sm, T, W, dtype, kind, offset, gen):
    """(ss, lpj, children, child_lpj) drawn on the card from ``gen``:
    random rows (the states ``offset`` bytes into a larger buffer), lpjs
    as the EA leaves them (``ea``: about -1000, a fifth of the children
    -inf duplicates, a tenth equal to an old state's lpj) or drawn from a
    few levels (``ties``: -inf, -0.0, +0.0, NaN and repeated values;
    ``levels`` the same without NaN)."""
    n = Sm + T

    def rows(count):
        return torch.randint(-128, 128, (count,), generator=gen, dtype=torch.int8,
                             device=DEVICE).view(dtype)

    ss = rows(Bm * Sm * W + offset)[offset:].view(Bm, Sm, W)
    children = rows(Bm * T * W).view(Bm, T, W)
    if kind == "ea":
        lpjs = torch.randn((Bm, n), generator=gen, device=DEVICE) * 50.0 - 1000.0
        u = torch.rand((Bm, T), generator=gen, device=DEVICE)
        old = lpjs[:, torch.randint(0, Sm, (T,), generator=gen, device=DEVICE)]
        lpjs[:, Sm:] = torch.where(u < 0.2, -float("inf"), torch.where(u < 0.3, old, lpjs[:, Sm:]))
    else:
        levels = torch.tensor([-float("inf"), -float("inf"), -3.5, -0.0, 0.0, 0.0, 1.25, 1.25,
                               float("nan")][:None if kind == "ties" else -1], device=DEVICE)
        lpjs = levels[torch.randint(len(levels), (Bm, n), generator=gen, device=DEVICE)]
    return ss, lpjs[:, :Sm].contiguous(), children, lpjs[:, Sm:].contiguous()


def merge_phase(launches):
    """The merge kernel against its plain twin on the card, bit for bit
    (lpjs as their bits, so that -0.0 and NaN count), relaunched bit for
    bit, at MERGE_CASES; each timed per call and from a CUDA graph beside
    its bytes bound (the kept rows read and written, the lpjs, vals, idx
    and n_sub) and the plain twin's time; then the cell's graphed EBSC
    epochs (epoch_graph's shapes) with the kernel against the same epochs
    with ``vary_Kn`` sent to the plain twin, bit for bit."""
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    varykn_merge.launches = 0
    for label, Bm, Sm, T, W, Mprime, dtype, kind, offset in MERGE_CASES:
        args = (*merge_inputs(Bm, Sm, T, W, dtype, kind, offset, gen), Mprime)
        got, again, want = varykn_merge(*args), varykn_merge(*args), vary_Kn_plain(*args)
        for name, g, a, w in zip(("K", "lpj", "n_sub", "idx"), got, again, want):
            if g.dtype == torch.float32:
                g, a, w = (x.view(torch.int32) for x in (g, a, w))
            if not (torch.equal(g, w) and torch.equal(a, g)):
                raise AssertionError(f"merge {label}: {name} differs from the plain twin's "
                                     f"({int((g != w).sum())} entries) or between launches")
        ptr = args[0].data_ptr() | (args[2].data_ptr() if T else 0) | W
        word = next(v for v in (16, 8, 4, 2, 1) if ptr % v == 0)
        nbytes = Bm * (2 * Sm * W + 4 * (Sm + T) + 4 * Sm + 8 * Sm + 8)
        bound = bound_ms(0, 0, nbytes)[0]
        ms, dev_ms = cuda_ms(lambda: varykn_merge(*args)), graph_ms(lambda: varykn_merge(*args))
        plain_ms = cuda_ms(lambda: vary_Kn_plain(*args))
        say(f"merge {label}: B={Bm} S={Sm} T={T} W={W} Mprime={Mprime} {str(dtype)[6:]}, "
            f"{word}-byte words: bit for bit; ms {ms:.4f} [{dev_ms:.4f}], bound {bound:.4f} "
            f"({nbytes / 1e6:.1f} MB), plain {plain_ms:.4f}; children kept "
            f"{float(got[2].double().mean()):.3f} a datapoint")
        del args, got, again, want
    say(f"merge: {varykn_merge.launches} launches; on {CARD['smi']}")
    # the cell's graphed EBSC epochs with the kernel against the same epochs with the plain twin
    cfg, estate = init_states(N=GRAPH_BLOCKS * B, S=S, H=H, no_parents=N_PARENTS,
                              no_children=N_CHILDREN, no_generations=N_GENERATIONS,
                              n_blocks=GRAPH_BLOCKS, seed=0, device=DEVICE)
    _, data, params = graph_problem(GRAPH_BLOCKS * B)
    runs = {}
    for path in ("kernel", "plain"):
        plain = mock.patch.object(varykn, "fits", lambda *a: False)
        with plain if path == "plain" else contextlib.nullcontext():
            runs[path] = graph_epochs(BSC(D=D, H=H, device=DEVICE), data, cfg, estate, params,
                                      launches)
    same_epochs("merge: kernel against plain twin", runs["kernel"][0], runs["plain"][0])
    merges = (runs["kernel"][2]["merge"], runs["plain"][2]["merge"])
    if merges != (GRAPH_BLOCKS * GRAPH_EPOCHS, 0):
        raise AssertionError(f"merge: kernel launches {merges}, expected one a block and none")
    say(f"merge: {GRAPH_EPOCHS} graphed EBSC epochs of {GRAPH_BLOCKS} blocks x {B} rows with the "
        f"kernel bit for bit those with the plain twin (K, lpj, Theta, stats); host ms per epoch "
        f"until the card finished: kernel {[round(m, 2) for m in runs['kernel'][4]]}, plain "
        f"{[round(m, 2) for m in runs['plain'][4]]}")


def compat(launches):
    """The reference driver pattern (tests/test_compat.py:11-33: the bars
    test, init_states, standard_init, check_params, step) on the card
    through evo_tpu_torch.compat: the compat's exact free energy equals the
    core model's, F rises over the steps, launch counts checked."""
    from evo_tpu_torch import compat as cp

    Hx, Sx, Nx, steps = 6, 12, 200, 15
    R = Hx // 2
    W_gen = np.zeros((R, R, Hx))
    for i in range(R):
        W_gen[i, :, i] = 8.0
        W_gen[:, i, R + i] = 8.0
    model = cp.BSC(R * R, Hx, Sx)
    theta_gen = {"W": W_gen.reshape(R * R, Hx), "pi": 2.0 / Hx, "sigma": 1.0}
    Y = model.generate_data(theta_gen, Nx, seed=0)["y"]
    my_data = {"y": Y, "x_infr": ~np.isnan(Y)}
    theta = model.check_params(model.standard_init(my_data, seed=0))
    my_suff_stat = cp.init_states(Nx, Sx, Hx, "fit", "randflip", 6, 1, 1, seed=0)
    launches.reset()
    L_gen = model.free_energy(my_data, dict(theta_gen), my_suff_stat, full=True)
    core = BSC(D=R * R, H=Hx, device=DEVICE)
    F_core = float(core.exact_free_energy(model._to_params(theta_gen),
                                          make_data(Y, device=DEVICE)))
    Fs = []
    for _ in range(steps):
        F, _, _, theta = model.step(theta, my_suff_stat, my_data)
        Fs.append(F)
    counts = launches.expect(lpj=2 + 2 * steps, suffstat=steps)
    say(f"compat BSC H={Hx} N={Nx}: F {Fs[0]:.4f} -> {Fs[-1]:.4f} over {steps} steps; exact "
        f"free energy of theta_gen: compat {L_gen:.6f}, core {F_core:.6f}")
    if not abs(L_gen - F_core) <= 1e-6 * abs(F_core):
        raise AssertionError("the compat's exact free energy differs from the core model's")
    if not (np.isfinite(Fs).all() and Fs[-1] > Fs[0] and Fs[-1] <= L_gen + 1.0):
        raise AssertionError(f"compat F did not rise to below L_gen + 1: {Fs}")
    return counts


class Launches:
    """Reads and resets the kernel wrappers' launch counters (the packed
    modes of the EBSC kernels count apart from their int8 modes)."""

    def __init__(self):
        self.fns = {"lpj": (bsc_lpj, "launches"), "lpj_packed": (bsc_lpj, "packed_launches"),
                    "suffstat": (bsc_suffstat, "launches"),
                    "suffstat_packed": (bsc_suffstat, "packed_launches"),
                    "sssc_lpj": (sssc_lpj, "launches"),
                    "sssc_suffstat": (sssc_suffstat, "launches"),
                    "sssc_lpj_masked": (sssc_lpj_masked, "launches"),
                    "sssc_suffstat_masked": (sssc_suffstat_masked, "launches")}

    def reset(self):
        for f, attr in self.fns.values():
            setattr(f, attr, 0)

    def counts(self):
        return {k: getattr(f, attr) for k, (f, attr) in self.fns.items()}

    def expect(self, **want):
        """Check every count: the kernels not named must not have run."""
        want = {k: want.get(k, 0) for k in self.fns}
        got = self.counts()
        if got != want:
            raise AssertionError(f"kernel launches {got}, expected {want}")
        return got


def main(argv=()):
    """Every phase in order; with phase names in ``argv`` (of STANDALONE)
    only device, build and those."""
    unknown = set(argv) - set(STANDALONE)
    if unknown:
        print(f"chip_smoke: no standalone phase {sorted(unknown)}; "
              f"phases that run alone: {sorted(STANDALONE)}", file=sys.stderr)
        return 2
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
    if argv:
        for name in argv:
            with Phase(name):
                STANDALONE[name](launches)
        print(json.dumps({"ok": True, "phases": list(argv), "device": {
            "platform": "gpu", "kind": CARD["name"], "count": torch.cuda.device_count()}}),
            flush=True)
        timer.cancel()
        return 0
    with Phase("kernels"):
        rows = check_kernels(DEVICE)
        rows.update(check_sssc_kernels(DEVICE, torch.Generator().manual_seed(1)))
        rows.update(check_masked_kernels(DEVICE, torch.Generator().manual_seed(2)))
        rows.update(check_packed_kernels(DEVICE, torch.Generator().manual_seed(3)))
        check_lpj_densities(DEVICE, torch.Generator().manual_seed(4))
        check_suffstat_densities(DEVICE, torch.Generator().manual_seed(5))
        check_sssc_suffstat_edges(DEVICE, torch.Generator().manual_seed(6))
        check_sssc_lpj_edges(DEVICE, torch.Generator().manual_seed(7))
    with Phase("exact"):
        exact_epoch(launches)
    with Phase("main"):
        main = drive(primary_setup, launches, dict(lpj=2 * N_BLOCKS, suffstat=N_BLOCKS),
                     profile=True)
        counts = main["counts"]
        del main["params"], main["estate"]
    with Phase("exact_sssc"):
        exact_sssc(launches)
    with Phase("sssc_fl"):
        fl = drive(sssc_setup(SSSC_FL), launches, dict(sssc_lpj=2, sssc_suffstat=1))["counts"]
    with Phase("sssc_primary"):
        prim = drive(sssc_setup(SSSC_PRIMARY), launches,
                     dict(sssc_lpj=2 * SSSC_PRIMARY[0], sssc_suffstat=SSSC_PRIMARY[0]),
                     profile=True)["counts"]
    with Phase("exact_sssc_incomplete"):
        exact_incomplete("sssc", launches)
    with Phase("exact_bsc_incomplete"):
        exact_incomplete("bsc", launches)
    inp = inpaint_data()
    with Phase("sssc_inpaint"):
        run = drive(inpaint_setup("sssc", inp), launches,
                    dict(sssc_lpj_masked=2, sssc_suffstat_masked=1), profile=True,
                    do_reconstruction=True, rising=False)
        inpaint = run["counts"]
        inpaint_res = merge_and_psnr(inp, run["y_rec"])
        del run
    with Phase("bsc_inpaint"):
        bsc_inp = drive(inpaint_setup("bsc", inp), launches, dict(suffstat=1),
                        do_reconstruction=True, timed_epochs=2, rising=False)["counts"]
    with Phase("exact_packed"):
        exact_epoch(launches, packed_states=True)
        exact_epoch(launches, allzero=True)
    with Phase("main_packed"):
        packed = drive(primary_packed_setup, launches,
                       dict(lpj_packed=2 * N_BLOCKS, suffstat_packed=N_BLOCKS), profile=True)
        say(f"F per epoch, int8 states {main['F']}; packed states {packed['F']}")
        if packed["F"] != main["F"]:
            raise AssertionError("F per epoch of the packed main path differs from main's")
        packed_counts = packed["counts"]
        del packed
    with Phase("eopts"):
        eopts(launches)
    with Phase("trainer"):
        primary = trainer(launches)
    with Phase("parallel"):
        par = parallel(launches, primary)
        del primary
    with Phase("parallel_apps"):
        par_apps = parallel_apps(launches, inp)
    with Phase("bars_app"):
        bars_app(launches)
    apps = {}
    with Phase("denoise_app"):
        add_counts(apps, denoise_app(launches))
    with Phase("inpaint_app"):
        add_counts(apps, inpaint_app(launches, inp, inpaint_res))
    with Phase("feature_app"):
        counts_fl, Y_fl = feature_app(launches)
        add_counts(apps, counts_fl)
    with Phase("wide"):
        add_counts(apps, wide(launches, Y_fl))
    with Phase("compat"):
        add_counts(apps, compat(launches))
    with Phase("epoch_graph"):
        epoch_graph(launches)
    with Phase("merge"):
        merge_phase(launches)

    add_counts(apps, par)  # the workers' launches
    add_counts(apps, par_apps)
    kernels = [
        dict(name="bsc_lpj", route="cuda", source="evo_tpu_torch/csrc/bsc_lpj.cu",
             replaces="evo_tpu/ops/pallas_lpj.py:97", launches=counts["lpj"] + apps["lpj"],
             library_ms=None, **rows["bsc_lpj"]),
        dict(name="bsc_lpj_packed", route="cuda", source="evo_tpu_torch/csrc/bsc_lpj.cu",
             replaces="evo_tpu/ops/pallas_lpj.py:47", launches=packed_counts["lpj_packed"],
             library_ms=None, **rows["bsc_lpj_packed"]),
        # launches: the EBSC main path, bsc_inpaint, the app phases, parallel's
        # workers and compat together
        dict(name="bsc_suffstat", route="cuda", source="evo_tpu_torch/csrc/bsc_suffstat.cu",
             replaces="evo_tpu/ops/pallas_suffstat.py:60",
             launches=counts["suffstat"] + bsc_inp["suffstat"] + apps["suffstat"],
             library_ms=None, **rows["bsc_suffstat"]),
        dict(name="bsc_suffstat_packed", route="cuda",
             source="evo_tpu_torch/csrc/bsc_suffstat.cu",
             replaces="evo_tpu/ops/pallas_suffstat.py:30",
             launches=packed_counts["suffstat_packed"], library_ms=None,
             **rows["bsc_suffstat_packed"]),
        # launches: the complete-data ES3C paths' runs, the app phases and
        # the workers of parallel and parallel_apps together
        dict(name="sssc_lpj", route="cuda", source="evo_tpu_torch/csrc/sssc_lpj.cu",
             replaces="evo_tpu/ops/pallas_sssc.py:676",
             launches=fl["sssc_lpj"] + prim["sssc_lpj"] + apps["sssc_lpj"], library_ms=None,
             **rows["sssc_lpj"]),
        dict(name="sssc_suffstat", route="cuda", source="evo_tpu_torch/csrc/sssc_suffstat.cu",
             replaces="evo_tpu/ops/pallas_sssc.py:1015",
             launches=fl["sssc_suffstat"] + prim["sssc_suffstat"] + apps["sssc_suffstat"],
             library_ms=None, **rows["sssc_suffstat"]),
        # launches: sssc_inpaint, inpaint_app and parallel_apps' workers
        dict(name="sssc_lpj_masked", route="cuda", source="evo_tpu_torch/csrc/sssc_lpj_masked.cu",
             replaces="evo_tpu/ops/pallas_sssc.py:606",
             launches=inpaint["sssc_lpj_masked"] + apps["sssc_lpj_masked"],
             library_ms=None, **rows["sssc_lpj_masked"]),
        dict(name="sssc_suffstat_masked", route="cuda",
             source="evo_tpu_torch/csrc/sssc_suffstat_masked.cu",
             replaces="evo_tpu/ops/pallas_sssc.py:939",
             launches=inpaint["sssc_suffstat_masked"] + apps["sssc_suffstat_masked"],
             library_ms=None, **rows["sssc_suffstat_masked"]),
    ]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": CARD["name"],
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    timer.cancel()
    return 0


# the phases that run alone: python3 chip_smoke.py <phase> ...
def suffstat_phase(launches):
    """The EBSC suffstat kernel's checks and timings of the kernels phase
    (check_suffstat_densities, with the same seed), alone."""
    check_suffstat_densities(DEVICE, torch.Generator().manual_seed(5))


STANDALONE = {"epoch_graph": epoch_graph, "suffstat": suffstat_phase, "merge": merge_phase}

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
