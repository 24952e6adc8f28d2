"""Shared experiment scaffolding of the apps (counterpart:
evo_tpu/apps/common.py): the device choice, this rank's data, Theta^0 and
states, a timestamped output directory, training.h5 through
DataLog/StoreToH5, the stdout tee to terminal.txt, and the argparse parent
parsers with evo_tpu's flag names and defaults.

Under torchrun (``torchrun --nproc_per_node=K -m
evo_tpu_torch.apps.<app>``) every rank makes the whole host data from the
same seed and keeps its own rows of every block (``rank_pieces``); rank 0
alone writes the output directory."""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import sys
import time
import warnings

import numpy as np
import torch

from evo_tpu_torch.models.base import make_data
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.parallel.mesh import make_mesh, shard_blocked
from evo_tpu_torch.utils.datalog import DataLog, StoreToH5
from evo_tpu_torch.variational.state_init import init_states


def platform_device() -> torch.device:
    """The apps' device: ``EVO_PLATFORM=cpu`` (the variable evo_tpu's apps
    read) means the CPU; unset, this process's card, and no card raises
    (there is no quiet fallback to the CPU).  Under torchrun with
    WORLD_SIZE > 1 it brings up the process group first, where evo_tpu's
    apps call ``init_distributed`` (evo_tpu/apps/common.py:36-38); the card
    is then cuda:{LOCAL_RANK % device_count}."""
    plat = os.environ.get("EVO_PLATFORM")
    if plat not in (None, "cpu"):
        raise ValueError(f"EVO_PLATFORM={plat!r}: the port runs on the CUDA card "
                         "(leave it unset) or on the CPU ('cpu')")
    if plat is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set EVO_PLATFORM=cpu "
                           "to run on the CPU")
    dev = distributed.process_device(plat)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed.init_distributed(device=dev)
    return dev


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 of a process
    group, or the only process."""
    return distributed.rank_world()[0] == 0


def rank_pieces(model, Y, args, device, x=None, pad_multiple: int = 1) -> dict:
    """This rank's data, Theta^0 (params), cfg and estate for ``model`` on
    the whole host data Y [N, D] (NaN marking missing entries) and x (the
    entries a reconstruction keeps; None: the observed ones), from
    args.seed, args.n_blocks, args.Ksize and the EA flags of
    ``variational_parser``.

    The rows are padded to a multiple of n_blocks * lcm(pad_multiple, K)
    for K ranks, and each rank keeps its rows of every block: block b of
    rank p holds the global rows b*B + p*B_local ... b*B + (p+1)*B_local,
    the layout of parallel/distributed.py.  So a K-rank run's blocked data
    is, row for row, a one-rank run's with pad_multiple K; the padding rows
    (row_valid false) sit at the end of the last block, with the last
    ranks.  Theta^0 comes from the sums over every rank's valid rows; the
    states are drawn for the global padded N and each rank keeps its rows.
    With one process and pad_multiple 1 these are make_data, standard_init
    and init_states of the whole data."""
    world = distributed.rank_world()[1]
    full = make_data(Y, x=x, n_blocks=args.n_blocks, pad_multiple=int(np.lcm(pad_multiple, world)),
                     device="cpu" if world > 1 else device)
    if world == 1:
        data, y_host = full, Y
    else:
        rows = distributed.local_rows(torch.arange(full.row_valid.numel()).reshape(
            full.row_valid.shape)).reshape(-1).numpy()
        data, y_host = shard_blocked(full, make_mesh(device)), np.asarray(Y)[rows[rows < len(Y)]]
    params = model.standard_init(data, seed=args.seed, y_host=y_host)
    cfg, estate = init_states(
        N=full.row_valid.numel(), S=args.Ksize, H=model.H,
        parent_selection=args.parent_selection, mutation_algorithm=args.mutation_algorithm,
        no_parents=args.no_parents, no_children=args.no_children,
        no_generations=args.no_generations, bitflip_prob=args.bitflip_prob,
        n_blocks=args.n_blocks, seed=args.seed, device=device)
    return dict(data=data, params=params, cfg=cfg,
                estate=distributed.distribute_estate(estate, device))


def merge_dict(*dicts):
    merged = {}
    for d in dicts:
        merged.update(d)
    return merged


class stdout_logger:
    """Tee stdout to terminal.txt (reference bars-test/utils.py:56-78)."""

    def __init__(self, txt_file):
        self.terminal = sys.stdout
        self.log = open(txt_file, "w")

    def write(self, message):
        self.terminal.write(message)
        self.terminal.flush()
        self.log.write(message)
        self.log.flush()

    def flush(self):
        pass


def restore_stdout():
    """Unwind every stdout tee and close its terminal.txt."""
    while isinstance(sys.stdout, stdout_logger):
        sys.stdout.log.close()
        sys.stdout = sys.stdout.terminal


def output_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--output_directory", type=str, default=None,
                   help="Directory to write training output and visualizations to "
                        "(output/<TIMESTAMP> if not specified)")
    return p


def variational_parser(Ksize=20, no_parents=10, no_children=1, no_generations=1):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--Ksize", type=int, default=Ksize, help="Size of the K sets (i.e., S=|K|)")
    p.add_argument("--parent_selection", type=str, choices=["fit", "rand"], default="fit",
                   help="Selection operator")
    p.add_argument("--mutation_algorithm", type=str,
                   choices=["randflip", "sparseflip", "cross", "cross_randflip",
                            "cross_sparseflip"],
                   default="randflip", help="Mutation strategy")
    p.add_argument("--no_parents", type=int, default=no_parents,
                   help="Number of parental states to select per generation")
    p.add_argument("--no_children", type=int, default=no_children,
                   help="Number of children to evolve per parent")
    p.add_argument("--no_generations", type=int, default=no_generations,
                   help="Number of generations to evolve")
    p.add_argument("--bitflip_prob", type=float, default=None,
                   help="Bitflip probability (sparseflip-based mutations)")
    return p


def experiment_parser(no_epochs=40):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--no_epochs", type=int, default=no_epochs, help="Number of epochs to train")
    p.add_argument("--seed", type=int, default=0,
                   help="Seed for data generation / parameter init / EA")
    p.add_argument("--n_blocks", type=int, default=1,
                   help="Number of blocks an epoch loops over (bounds device memory at large N)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="Save a resumable checkpoint every X epochs (0=off)")
    p.add_argument("--resume", type=str, default=None,
                   help="Path to a checkpoint.npz to resume from")
    p.add_argument("--tracefile", type=str, default=None,
                   help="Enable host tracepoints; bare filenames land in the "
                        "output directory, archived to traces.tgz at the end")
    p.add_argument("--device_trace_every", type=int, default=0,
                   help="Record one epoch every X epochs with torch.profiler into "
                        "<outdir>/device_trace (0=off)")
    p.add_argument("--chunk_epochs", type=int, default=1,
                   help="Run X epochs with no host step between them "
                        "(models.base.em_steps; bit-identical trajectory). "
                        "Viz/Theta logging then happens at chunk ends, and "
                        "Theta tables switch to overwrite mode (only the "
                        "latest parameters are kept in training.h5)")
    return p


def patch_parser():
    """The image-denoising and image-inpainting apps' patch flags."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--patch_height", type=int, default=5, help="Patch height")
    p.add_argument("--patch_width", type=int, default=None,
                   help="Patch width (defaults to patch_height)")
    p.add_argument("--no_dc_center", dest="dc_center", action="store_false", default=True,
                   help="Disable per-patch DC centering (reference-style raw patches)")
    return p


def image_experiment_parser():
    """The image-denoising and image-inpainting apps' experiment flags."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-H", type=int, default=32, help="Dictionary size")
    p.add_argument("--no_epochs", type=int, default=50)
    p.add_argument("--merge_every", type=int, default=None,
                   help="Merge reconstructed patches every Xth epoch (defaults to viz_every)")
    p.add_argument("--save_theta_all_epochs", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_blocks", type=int, default=1)
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--tracefile", type=str, default=None)
    p.add_argument("--device_trace_every", type=int, default=0)
    p.add_argument("--chunk_epochs", type=int, default=1,
                   help="Run X epochs with no host step between them "
                        "(incompatible with --save_theta_all_epochs; "
                        "reconstruction epochs still run solo)")
    return p


def awgn_parser():
    """The image-denoising app's input flags (examples/image-denoising/main.py)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--clean_image", type=str, default="./img/house.png",
                   help="Full path to clean image (synthetic fallback if missing)")
    p.add_argument("--rescale", type=float, default=0.4,
                   help="Rescale factor for the clean image")
    p.add_argument("--noise_level", type=float, default=25,
                   help="Std of the additive white Gaussian noise")
    return p


def mcar_parser():
    """The image-inpainting app's input flags (examples/image-inpainting/main.py)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--clean_image", type=str, default="./img/castle.jpg",
                   help="Full path to clean image (synthetic fallback if missing)")
    p.add_argument("--percentage_missing", type=float, default=None,
                   help="Fraction of pixels set to missing (MCAR)")
    p.add_argument("--percentage", type=int, default=10,
                   help="Percentage of missing pixels (the reference's flag; "
                        "--percentage_missing takes precedence)")
    p.add_argument("--rescale", type=float, default=0.1,
                   help="Rescale factor for the clean image")
    p.add_argument("--no_compact_readback", dest="compact_readback",
                   action="store_false", default=True,
                   help="Read back the full [N, D] reconstruction at merges instead "
                        "of only the missing values (the same result bit for bit)")
    return p


def viz_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--viz_every", type=int, default=1,
                   help="Create visualizations every X'th epoch")
    p.add_argument("--gif_framerate", type=str, default=None,
                   help="Frames per second for gif animation (e.g. 2/1); no gif if unspecified")
    p.add_argument("--host_merge", action="store_true", default=False,
                   help="Merge reconstructed patches on the host (NumPy f64) "
                        "instead of on the device")
    return p


def chunking_kwargs(args, theta_append: bool = True, auto_overwrite: bool = True) -> dict:
    """The EMTrainer arguments of --chunk_epochs.  Chunked epochs cannot log
    Theta per epoch (their parameters stay on the device), so apps whose
    Theta mode is implicit (bars: theta_append defaults to True) switch to
    the overwrite mode with a warning; apps where the user set the mode
    pass auto_overwrite=False and let EMTrainer reject the conflict."""
    chunk = max(1, int(getattr(args, "chunk_epochs", 1)))
    if chunk > 1 and theta_append and auto_overwrite:
        warnings.warn(
            f"chunk_epochs={chunk} switches Theta logging to overwrite "
            "mode: training.h5 will hold only the LATEST parameters, not "
            "the per-epoch history the default (chunk_epochs=1) records",
            stacklevel=2)
        print(f"chunk_epochs={chunk}: Theta tables in overwrite mode")
        theta_append = False
    return dict(chunk_epochs=chunk, theta_append=theta_append)


def setup_experiment(args, name: str):
    """Create the output directory, the DataLog with an asynchronous
    training.h5 handler, and the stdout tee (``restore_stdout`` ends it);
    returns (dlog, output_directory).  Under a process group the default
    directory is named from rank 0's clock, rank 0 alone creates it and
    tees, and the other ranks wait for it."""
    start = [time.time()]
    if distributed.active():
        torch.distributed.broadcast_object_list(start, src=0)
    timestamp = datetime.datetime.fromtimestamp(start[0]).strftime("%y-%m-%d_%H-%M-%S")
    outdir = args.output_directory or f"./output/{timestamp}"
    training_file = os.path.join(outdir, "training.h5")
    txt_file = os.path.join(outdir, "terminal.txt")
    # a tee left by an earlier experiment in this process would receive
    # this run's output and keep its file open
    restore_stdout()
    if is_writer():
        os.makedirs(outdir, exist_ok=True)
        sys.stdout = stdout_logger(txt_file)
        print(f"Will write training output to {training_file}")
        print(f"Will write terminal output to {txt_file}")
        print("Hyperparameters used:")
        for k in sorted(vars(args), key=lambda s: s.lower()):
            print("{: <25} : {}".format(k, vars(args)[k]))
    distributed.barrier()
    dlog = DataLog()
    dlog.set_handler(["*"], StoreToH5, training_file, async_writes=True)
    return dlog, outdir


def to_host(tensors: dict) -> dict:
    """{name: tensor} -> {name: np.ndarray}: the copies are queued without
    waiting, then one synchronize."""
    host = {k: v.detach().to("cpu", non_blocking=True) for k, v in tensors.items()}
    if any(v.is_cuda for v in tensors.values()):
        torch.cuda.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def params_to_dict(params) -> dict:
    """Model params dataclass -> {name: np.ndarray} for logging."""
    return to_host({f.name: getattr(params, f.name) for f in dataclasses.fields(params)})
