"""Patch-based image denoising and inpainting (counterpart:
evo_tpu/apps/images.py, examples/image-denoising/main.py and
examples/image-inpainting/main.py).

    python -m evo_tpu_torch.apps.images {denoising|inpainting} {ebsc|es3c} [flags]

runs on the CUDA card, or on the CPU with ``EVO_PLATFORM=cpu``; the flags
are those of the two examples.  A corrupted image is cut into overlapping
patches, each patch centred on the mean of its observed pixels, and a model
is trained on them by EMTrainer; the reconstruction is merged back into an
image (mean and median) and scored by its PSNR.

``build`` makes the pieces on a device, ``make_epoch_callback`` the merge
that runs after each epoch, and ``run_experiment`` wires both to EMTrainer
with training.h5 and the visualizer; a caller without h5py or matplotlib
can drive ``build`` and the callback with a DataLog of its own and no
visualizer.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from evo_tpu_torch.apps.common import (
    awgn_parser,
    chunking_kwargs,
    image_experiment_parser,
    is_writer,
    mcar_parser,
    output_parser,
    params_to_dict,
    patch_parser,
    platform_device,
    rank_pieces,
    restore_stdout,
    setup_experiment,
    to_host,
    variational_parser,
    viz_parser,
)
from evo_tpu_torch.apps.training import EMTrainer
from evo_tpu_torch.apps.viz import ReconstructionVisualizer
from evo_tpu_torch.models.bsc import BSC
from evo_tpu_torch.models.sssc import SSSC
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.prepost import (
    MultiDimOverlappingPatches,
    OverlappingPatches,
    mean_merger,
    median_merger,
    psnr,
)
from evo_tpu_torch.prepost.device_merge import DeviceMerger
from evo_tpu_torch.utils import tracing

MERGERS = {"mean": mean_merger, "median": median_merger}


def get_image(image_file: str, rescale: float = 1.0) -> np.ndarray:
    """The image in ``image_file`` (read with PIL), rescaled; if the file
    does not exist, ``synthetic_image(int(256 * rescale))``."""
    if os.path.exists(image_file):
        from PIL import Image

        img = Image.open(image_file)
        if rescale != 1.0:
            img = img.resize((int(img.width * rescale), int(img.height * rescale)),
                             Image.BICUBIC)
        arr = np.asarray(img, dtype=float)
        if arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[:, :, :3]
        return arr
    print(f"NOTE: {image_file} not found; using a synthetic test image")
    return synthetic_image(int(256 * rescale))


def synthetic_image(size: int = 128) -> np.ndarray:
    """A piecewise-smooth grayscale test image [size, size] in [0, 255], the
    same as evo_tpu's."""
    i, j = np.mgrid[0:size, 0:size].astype(float) / size
    img = 90 + 100 * np.cos(3.1 * i) * np.sin(2.3 * j)
    img[int(0.2 * size):int(0.55 * size), int(0.25 * size):int(0.6 * size)] = 210
    img[int(0.3 * size):int(0.45 * size), int(0.35 * size):int(0.5 * size)] = 40
    tri = (i + j < 0.5)
    img[tri] = 160 - 120 * (i + j)[tri]
    return np.clip(img, 0, 255)


def _make_model(algo, D, H, device, incomplete_es3c_subset=False):
    """EBSC, or ES3C learning W, pies and sigma2 only on incomplete data
    (``incomplete_es3c_subset``) and every parameter otherwise."""
    if algo == "ebsc":
        return BSC(D=D, H=H, device=device)
    to_learn = (("W", "pies", "sigma2") if incomplete_es3c_subset
                else ("W", "pies", "mus", "sigma2", "Psi"))
    return SSSC(D=D, H=H, to_learn=to_learn, device=device)


def _patches(image, args):
    ph, pw = args.patch_height, args.patch_width or args.patch_height
    OVP = MultiDimOverlappingPatches if image.ndim == 3 else OverlappingPatches
    return OVP(image, ph, pw, patch_shift=1)


def observed(corrupted: np.ndarray, args) -> np.ndarray:
    """x for inpainting: the patch entries [N, D] that are observed, which
    the reconstruction keeps."""
    return ~np.isnan(_patches(corrupted, args).get().T)


def build(args, clean, corrupted, x_keep, device, pad_multiple: int = 1) -> dict:
    """The experiment's pieces on ``device``: the patches of ``corrupted``
    (ovp, Y [N, D] with NaN at missing pixels, each row centred on its
    observed mean unless --no_dc_center, that dc [N, 1]), model, this
    rank's data with x = ``x_keep`` (None: reconstruct every entry, as in
    denoising), Theta^0 (params), cfg and estate (``rank_pieces``), and
    reconstruct_at(e), which is true for every epoch when inpainting (the
    M-step reads the reconstruction), else for the first, every
    merge_every-th and the last.

    The batch is not padded for a tile: evo_tpu pads it to 1024 rows on a
    TPU only, for Mosaic's tiles (evo_tpu/apps/images.py:108-114), and the
    CUDA kernels take any B."""
    isrgb = clean.ndim == 3 and clean.shape[2] == 3
    ovp = _patches(corrupted, args)
    Y = ovp.get().T  # [N, D]
    N, D = Y.shape
    # per-patch DC centring on the observed pixels; the reconstructions get
    # it back before the merge
    if getattr(args, "dc_center", True):
        with np.errstate(invalid="ignore"):
            dc = np.nanmean(Y, axis=1, keepdims=True)
        dc = np.where(np.isfinite(dc), dc, 0.0)
        Y = Y - dc
    else:
        dc = np.zeros((N, 1))
    ph, pw = args.patch_height, args.patch_width or args.patch_height
    no_channels = 3 if isrgb else 1
    assert D == ph * pw * no_channels
    print(f"{N} patches of dimension {D}")

    inpainting = bool(np.isnan(corrupted).any())
    model = _make_model(args.algo, D, args.H, device,
                        incomplete_es3c_subset=inpainting and args.algo == "es3c")
    x = np.zeros_like(Y, dtype=bool) if x_keep is None else x_keep
    pieces = rank_pieces(model, Y, args, device, x=x, pad_multiple=pad_multiple)
    merge_every = getattr(args, "merge_every", None) or args.viz_every or args.no_epochs

    def reconstruct_at(e):
        # the last epoch always reconstructs, so that the final PSNR and
        # image are those of the final parameters
        return inpainting or e == 0 or (e + 1) % merge_every == 0 or e + 1 == args.no_epochs

    return dict(ovp=ovp, Y=Y, dc=dc, N=N, D=D, inpainting=inpainting, merge_every=merge_every,
                patch_shape=(no_channels, ph, pw) if isrgb else (ph, pw), model=model,
                reconstruct_at=reconstruct_at, **pieces)


def full_readback(b, y_rec) -> np.ndarray:
    """The reconstruction [N, D] in Y's row order (f64, DC added back):
    every rank's blocked y_rec gathered into the global layout, whose flat
    rows are Y's followed by the padding rows."""
    return distributed.gather_global(y_rec).reshape(-1, b["D"])[:b["N"]] + b["dc"]


def compact_reader(b, device):
    """A function y_rec -> ``full_readback(b, y_rec)`` that copies only the
    missing values to the host.  The observed entries of y_rec are the data
    themselves (y_rec = where(x, y, est)), so they come from the host's Y,
    rounded through f32 as the device holds it: the result equals the full
    read-back bit for bit, at about a tenth of the traffic at 10% missing."""
    Y, dc, N, D = b["Y"], b["dc"], b["N"], b["D"]
    miss = np.isnan(Y)
    flat_idx = np.flatnonzero(miss.ravel())
    base = np.where(miss, 0.0, Y.astype(np.float32).astype(np.float64) + dc)
    dc_missing = np.broadcast_to(dc, miss.shape).ravel()[flat_idx]
    idx = torch.as_tensor(flat_idx, device=device)

    def read(y_rec):
        vals = to_host({"v": y_rec.reshape(-1)[:N * D][idx]})["v"]
        out = base.copy()
        out.ravel()[flat_idx] = vals.astype(np.float64) + dc_missing
        return out

    return read


def host_merge(b, clean, Y_rec) -> dict:
    """{merger: (image, PSNR)} of the reconstruction [N, D] merged on the
    host in f64 (the reference path)."""
    out = {}
    for name, merger in MERGERS.items():
        img = b["ovp"].set_and_merge(Y_rec.T, merge_method=merger)
        out[name] = (img, psnr(clean, img, data_range=255.0))
    return out


def merge_route(args, b, device) -> str:
    """'device': merge and PSNR on the card (DeviceMerger), unless
    --host_merge; else the host merge of a 'compact' read-back of the
    missing values (inpainting, unless --no_compact_readback) or of the
    'full' reconstruction.  Under a process group of several ranks only
    'full' (the gathered reconstruction), as evo_tpu/apps/images.py:173,183
    choose."""
    single = distributed.rank_world()[1] == 1
    if single and device.type == "cuda" and not getattr(args, "host_merge", False):
        return "device"
    if single and b["inpainting"] and getattr(args, "compact_readback", True):
        return "compact"
    return "full"


def make_epoch_callback(args, b, clean, dlog, device, visualizer=None):
    """The trainer's epoch callback: at a merge epoch (the first, every
    merge_every-th and the last that carries a reconstruction) it merges
    y_rec by ``merge_route``, logs psnr_<merger> and reco_img_<merger> for
    the mean and median merge and keeps the mean merge's image and PSNR in
    ``last`` (rec, psnr); then it hands the epoch to ``visualizer``, if
    any.  Returns (callback, last)."""
    route = merge_route(args, b, device)
    last = {"route": route}
    if route == "device":
        merger = DeviceMerger(b["ovp"], clean, data_range=255.0, device=device)
        dc_dev = torch.as_tensor(b["dc"], dtype=torch.float32, device=device)
    elif route == "compact":
        read = compact_reader(b, device)

    def callback(epoch, F, params, y_rec=None, **_):
        do_merge = y_rec is not None and (epoch == 1 or epoch % b["merge_every"] == 0
                                          or epoch == args.no_epochs)
        if do_merge:
            if route == "device":
                with tracing.span("device_merge"):
                    out = to_host(merger(y_rec, dc_dev))  # one transfer for all four
                merged = {name: (out[name], float(out[f"psnr_{name}"])) for name in MERGERS}
            else:
                Y_rec = read(y_rec) if route == "compact" else full_readback(b, y_rec)
                merged = host_merge(b, clean, Y_rec)
            for name, (img, p) in merged.items():
                dlog.append(f"psnr_{name}", p)
                dlog.append(f"reco_img_{name}", img)
                print(f"\tpsnr_{name} = {p:.3f}")
            last.update(rec=merged["mean"][0], psnr=merged["mean"][1])
        if visualizer is not None:
            with tracing.span("viz"):
                visualizer.process_epoch(epoch=epoch, F=F, params=params, rec=last.get("rec"),
                                         psnr_val=last.get("psnr"))

    return callback, last


def run_experiment(args, clean, corrupted, x_keep, name, device) -> dict:
    """The whole experiment: ``build``, Theta^0 into training.h5, EMTrainer
    with the epoch callback and a ReconstructionVisualizer.  Theta is
    overwritten in training.h5 unless --save_theta_all_epochs (reference
    image-denoising/main.py:55-61), which --chunk_epochs rejects."""
    dlog, outdir = setup_experiment(args, name)
    try:
        b = build(args, clean, corrupted, x_keep, device)
        dlog.append_all({f"{k}_init": v for k, v in params_to_dict(b["params"]).items()})
        visualizer = None
        if is_writer():
            visualizer = ReconstructionVisualizer(
                viz_every=args.viz_every or args.no_epochs, output_directory=outdir,
                clean_image=clean, corrupted_image=np.where(np.isnan(corrupted), 0.0, corrupted),
                patch_shape=b["patch_shape"], gif_framerate=args.gif_framerate)
        callback, last = make_epoch_callback(args, b, clean, dlog, device, visualizer)
        trainer = EMTrainer(
            b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog, outdir,
            seed=args.seed + 1, checkpoint_every=args.checkpoint_every, resume=args.resume,
            tracefile=getattr(args, "tracefile", None),
            device_trace_every=getattr(args, "device_trace_every", 0),
            **chunking_kwargs(args, theta_append=getattr(args, "save_theta_all_epochs", False),
                              auto_overwrite=False))
        params, _, stats = trainer.run(args.no_epochs, reconstruct_at=b["reconstruct_at"],
                                       epoch_callback=callback)
        if visualizer is not None:
            visualizer.finalize()
        print("Finished")
        return {"F": float(stats.F), "psnr": last.get("psnr"), "rec": last.get("rec"),
                "params": params, "outdir": outdir}
    finally:
        dlog.close()
        restore_stdout()


def add_noise(clean, args) -> np.ndarray:
    """clean + N(0, noise_level^2) from ``args.seed``."""
    rng = np.random.default_rng(args.seed)
    return clean + rng.normal(scale=args.noise_level, size=clean.shape)


def remove_values(clean, args) -> np.ndarray:
    """A copy of ``clean`` with a fraction of its values NaN (MCAR, from
    ``args.seed``), drawn over the image's whole shape: for RGB per channel
    entry, as the reference draws it (image-inpainting/main.py:83).  The
    fraction is --percentage_missing, else --percentage / 100."""
    frac = getattr(args, "percentage_missing", None)
    if frac is None:
        frac = float(getattr(args, "percentage", 10)) / 100.0
    corrupted = clean.astype(float).copy()
    corrupted[np.random.default_rng(args.seed).random(clean.shape) < frac] = np.nan
    print(f"Set {100 * frac:.0f}% of values to missing")
    return corrupted


def run_denoising(args) -> dict:
    """AWGN denoising (reference examples/image-denoising/main.py:78-95)."""
    device = platform_device()
    clean = get_image(args.clean_image, args.rescale)
    noisy = add_noise(clean, args)
    print(f"Added white Gaussian noise with sigma={args.noise_level}")
    return run_experiment(args, clean, noisy, None, "image-denoising", device)


def run_inpainting(args) -> dict:
    """MCAR inpainting (reference examples/image-inpainting/main.py:78-111)."""
    device = platform_device()
    clean = get_image(args.clean_image, args.rescale)
    corrupted = remove_values(clean, args)
    return run_experiment(args, clean, corrupted, observed(corrupted, args),
                          "image-inpainting", device)


def get_args(argv=None):
    parser = argparse.ArgumentParser(prog="Image denoising and inpainting")
    tasks = parser.add_subparsers(help="Select the experiment", dest="task")
    for task, inputs in (("denoising", awgn_parser), ("inpainting", mcar_parser)):
        common = [inputs(), patch_parser(), variational_parser(Ksize=20),
                  image_experiment_parser(), output_parser(), viz_parser()]
        algos = tasks.add_parser(task, help=f"Image {task}").add_subparsers(
            help="Select algorithm to run", dest="algo")
        for algo in ("ebsc", "es3c"):
            algos.add_parser(algo, parents=common,
                             formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    args = parser.parse_args(argv)
    if args.task is None:
        parser.error("choose an experiment: denoising or inpainting")
    if getattr(args, "algo", None) is None:
        parser.error("choose an algorithm: ebsc or es3c")
    return args


def main(argv=None):
    args = get_args(argv)
    return {"denoising": run_denoising, "inpainting": run_inpainting}[args.task](args)


if __name__ == "__main__":
    main()
