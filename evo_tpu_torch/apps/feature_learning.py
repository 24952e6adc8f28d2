"""Feature learning on image patches (counterpart:
evo_tpu/apps/feature_learning.py and examples/feature-learning/main.py).

    python -m evo_tpu_torch.apps.feature_learning [flags]

runs on the CUDA card, or on the CPU with ``EVO_PLATFORM=cpu``; the flags
are those of the example.  The patches come from an .npz file with the keys
data, patch_height, patch_width and no_channels; if the file is missing, a
synthetic patch set is written there first.  BSC or SSSC is trained on
them, with the generative fields and the lower bound drawn per epoch.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from evo_tpu_torch.apps.common import (
    chunking_kwargs,
    is_writer,
    params_to_dict,
    platform_device,
    rank_pieces,
    restore_stdout,
    setup_experiment,
    variational_parser,
)
from evo_tpu_torch.apps.images import synthetic_image
from evo_tpu_torch.apps.training import EMTrainer
from evo_tpu_torch.apps.viz import GFVisualizer
from evo_tpu_torch.models.bsc import BSC
from evo_tpu_torch.models.sssc import SSSC
from evo_tpu_torch.parallel import distributed
from evo_tpu_torch.prepost import extract_random_patches


def load_patches(data_file: str):
    """(data [N, D] f32, patch_height, patch_width, no_channels)."""
    with np.load(data_file) as d:
        for key in ["data", "patch_height", "patch_width", "no_channels"]:
            assert key in d, f"{data_file}: could not find {key} key"
        assert np.ndim(d["data"]) == 2, "expected 2-dim data (N, D)"
        return (np.asarray(d["data"], dtype=np.float32), int(d["patch_height"]),
                int(d["patch_width"]), int(d["no_channels"]))


def synthetic_patchfile(path: str, N: int = 2000, ph: int = 8, pw: int = 8, seed: int = 0):
    """Write N random ph x pw patches of a noisy ``synthetic_image(128)``,
    each centred on its mean, to ``path`` (the same arrays as evo_tpu's)."""
    rng = np.random.default_rng(seed)
    img = synthetic_image(128) + rng.normal(scale=8.0, size=(128, 128))
    P = extract_random_patches(img[None], ph, pw, N, rng=rng)
    P = P - P.mean(axis=1, keepdims=True)
    np.savez(path, data=P.astype(np.float32), patch_height=ph, patch_width=pw, no_channels=1)
    return path


def build(args, Y, device, pad_multiple: int = 1) -> dict:
    """The experiment's pieces on ``device`` for patches Y [N, D]: model and
    this rank's data, Theta^0 (params), cfg and estate (``rank_pieces``;
    not padded for a tile: evo_tpu pads to 1024 rows on a TPU only, for
    Mosaic's tiles)."""
    N, D = Y.shape
    model = {"bsc": BSC, "sssc": SSSC}[args.model](D=D, H=args.H, device=device)
    return dict(rank_pieces(model, Y, args, device, pad_multiple=pad_multiple), model=model)


def run(args) -> dict:
    device = platform_device()
    # rank 0 writes a missing patch file; the other ranks read it after
    if is_writer() and not os.path.exists(args.data_file):
        print(f"NOTE: {args.data_file} not found; generating synthetic patches")
        os.makedirs(os.path.dirname(args.data_file) or ".", exist_ok=True)
        synthetic_patchfile(args.data_file)
    distributed.barrier()
    Y, ph, pw, no_channels = load_patches(args.data_file)
    dlog, outdir = setup_experiment(args, "feature-learning")
    try:
        N, D = Y.shape
        assert D == ph * pw * no_channels
        print(f"{N} patches of dimension {D}")
        b = build(args, Y, device)
        dlog.append_all({f"{k}_init": v for k, v in params_to_dict(b["params"]).items()})
        visualizer, callback = None, None
        if is_writer():
            visualizer = GFVisualizer(
                viz_every=getattr(args, "viz_every", 1) or 1, output_directory=outdir,
                patch_shape=(no_channels, ph, pw) if no_channels > 1 else (ph, pw),
                sort_gfs=args.sort_gfs, gif_framerate=getattr(args, "gif_framerate", None))

            def callback(epoch, F, params, **kw):
                visualizer.process_epoch(epoch=epoch, F=F, params=params)
        trainer = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog,
                            outdir, seed=args.seed + 1, checkpoint_every=args.checkpoint_every,
                            resume=args.resume, tracefile=getattr(args, "tracefile", None),
                            device_trace_every=getattr(args, "device_trace_every", 0),
                            **chunking_kwargs(args))
        params, _, stats = trainer.run(args.no_epochs, epoch_callback=callback)
        if visualizer is not None:
            visualizer.finalize()
        print("Finished")
        return {"F": float(stats.F), "params": params, "outdir": outdir}
    finally:
        dlog.close()
        restore_stdout()


def get_args(argv=None):
    io = argparse.ArgumentParser(add_help=False)
    io.add_argument("--data_file", type=str, default="./data/barbara-2k-patches.npz",
                    help=".npz file with training data (keys: data, patch_height, "
                         "patch_width, no_channels); a synthetic patch set is "
                         "generated if missing")
    io.add_argument("--output_directory", type=str, default=None)

    model = argparse.ArgumentParser(add_help=False)
    model.add_argument("--model", type=str, choices=["bsc", "sssc"], default="bsc",
                       help="Generative model")
    model.add_argument("-H", type=int, default=100, help="Number of generative fields to learn")

    exp = argparse.ArgumentParser(add_help=False)
    exp.add_argument("--no_epochs", type=int, default=200)
    exp.add_argument("--seed", type=int, default=0)
    exp.add_argument("--n_blocks", type=int, default=1)
    exp.add_argument("--checkpoint_every", type=int, default=0)
    exp.add_argument("--resume", type=str, default=None)

    viz = argparse.ArgumentParser(add_help=False)
    viz.add_argument("--sort_gfs", action="store_true", default=False,
                     help="Sort generative fields by prior activation")
    viz.add_argument("--viz_every", type=int, default=1)
    viz.add_argument("--gif_framerate", type=str, default=None)

    parser = argparse.ArgumentParser(
        description="Feature Learning",
        parents=[io, model, variational_parser(Ksize=15, no_parents=5, no_children=2), exp, viz],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    return parser.parse_args(argv)


def main(argv=None):
    return run(get_args(argv))


if __name__ == "__main__":
    main()
