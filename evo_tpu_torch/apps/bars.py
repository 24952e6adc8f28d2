"""Bars-test experiment: ground-truth recovery with the exact-likelihood
oracle (counterpart: evo_tpu/apps/bars.py and examples/bars-test/main.py).

    python -m evo_tpu_torch.apps.bars {ebsc|es3c} [flags]

runs on the CUDA card, or on the CPU with ``EVO_PLATFORM=cpu``; the flags
are those of examples/bars-test/main.py."""

from __future__ import annotations

import argparse

import torch

from evo_tpu_torch.apps.common import (
    chunking_kwargs,
    experiment_parser,
    is_writer,
    output_parser,
    params_to_dict,
    platform_device,
    rank_pieces,
    restore_stdout,
    setup_experiment,
    variational_parser,
    viz_parser,
)
from evo_tpu_torch.apps.training import EMTrainer
from evo_tpu_torch.apps.viz import BarsVisualizer
from evo_tpu_torch.models.bsc import BSC, BSCParams
from evo_tpu_torch.models.sssc import SSSC, SSSCParams
from evo_tpu_torch.utils.bars import generate_bars_dict


def build_theta_gen(algo: str, H: int, args, device):
    """The generating parameters of the bars test (pi = 2/H unless given)."""
    pi_gen = args.pi_gen if args.pi_gen is not None else 2.0 / H
    f32 = dict(dtype=torch.float32, device=device)
    W = torch.as_tensor(args.bar_amp * generate_bars_dict(H, args.neg_bars), **f32)
    if algo == "ebsc":
        return BSCParams(W=W, pi=torch.tensor(pi_gen, **f32),
                         sigma=torch.tensor(args.sigma_gen, **f32),
                         pies=torch.full((H,), pi_gen, **f32))
    return SSSCParams(W=W, pies=torch.full((H,), pi_gen, **f32),
                      mus=torch.full((H,), args.mu_gen, **f32),
                      Psi=torch.eye(H, **f32) * args.psi_gen**2,
                      sigma2=torch.tensor(args.sigma_gen**2, **f32))


def run(args) -> dict:
    device = platform_device()
    dlog, outdir = setup_experiment(args, "bars-test")
    try:
        return _run(args, device, dlog, outdir)
    finally:
        dlog.close()
        restore_stdout()


def build(args, device, pad_multiple: int = 1) -> dict:
    """The bars test's pieces on ``device``: model, theta_gen, Y (host, all
    rows), this rank's data, Theta^0 (params), cfg and estate
    (``rank_pieces``), and L_gen (the exact likelihood of theta_gen for
    H <= 10, else None)."""
    H = args.H
    D = (H // 2) ** 2
    model = {"ebsc": BSC, "es3c": SSSC}[args.algo](D=D, H=H, device=device)
    theta_gen = build_theta_gen(args.algo, H, args, device)
    gen = model.generate_data(theta_gen, args.no_data_points,
                              torch.Generator(device=device).manual_seed(args.seed))
    Y = gen["y"].cpu().numpy()
    b = rank_pieces(model, Y, args, device, pad_multiple=pad_multiple)
    L_gen = float(model.exact_free_energy(theta_gen, b["data"])) if H <= 10 else None
    return dict(b, model=model, theta_gen=theta_gen, Y=Y, L_gen=L_gen)


def _run(args, device, dlog, outdir) -> dict:
    print("Generating data, Theta^0, the initial states and the exact likelihood")
    b = build(args, device)
    L_gen = b["L_gen"]
    dlog.append("model", args.algo.upper())
    dlog.append_all({f"{k}_gen": v for k, v in params_to_dict(b["theta_gen"]).items()})
    dlog.append("Y", b["Y"])
    dlog.append_all({f"{k}_init": v for k, v in params_to_dict(b["params"]).items()})
    if L_gen is not None:
        dlog.append("L_gen", L_gen)
        print(f"\tL_gen = {L_gen:.4f}")
    else:
        print(f"Did not compute exact likelihood (too expensive for H={args.H})")

    visualizer, callback = None, None
    if is_writer():
        visualizer = BarsVisualizer(viz_every=args.viz_every or args.no_epochs,
                                    output_directory=outdir,
                                    theta_gen_W=params_to_dict(b["theta_gen"])["W"],
                                    L_gen=L_gen, gif_framerate=args.gif_framerate)

        def callback(epoch, F, params, **kw):
            visualizer.process_epoch(epoch=epoch, F=F, params=params)
    trainer = EMTrainer(b["model"], b["cfg"], b["params"], b["estate"], b["data"], dlog, outdir,
                        seed=args.seed + 1, checkpoint_every=args.checkpoint_every,
                        resume=args.resume, tracefile=getattr(args, "tracefile", None),
                        device_trace_every=getattr(args, "device_trace_every", 0),
                        **chunking_kwargs(args))
    params, estate, stats = trainer.run(args.no_epochs, epoch_callback=callback)
    if visualizer is not None:
        visualizer.finalize()
    print("Finished")
    return {"F": float(stats.F), "L_gen": L_gen, "params": params, "outdir": outdir}


def bars_parser():
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("-H", type=int, default=8, help="Number of bars")
    p.add_argument("--bar_amp", type=float, default=10.0, help="Bar amplitude")
    p.add_argument("--neg_bars", action="store_true", default=False,
                   help="Randomly make bar amplitudes negative")
    p.add_argument("--no_data_points", type=int, default=500, help="Number of datapoints")
    return p


def gen_parser(sssc: bool):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--pi_gen", type=float, default=None,
                   help="Sparsity for data generation (defaults to 2/H)")
    p.add_argument("--sigma_gen", type=float, default=1.0, help="Noise level for data generation")
    if sssc:
        p.add_argument("--mu_gen", type=float, default=0.0, help="Generative latent mean")
        p.add_argument("--psi_gen", type=float, default=1.0,
                       help="Generative latent standard deviation")
    return p


def get_args(argv=None):
    parser = argparse.ArgumentParser(prog="Standard Bars Test")
    algos = parser.add_subparsers(help="Select algorithm to run", dest="algo")
    common = [output_parser(), bars_parser(), variational_parser(),
              experiment_parser(no_epochs=40), viz_parser()]
    algos.add_parser("ebsc", help="Run experiment with EBSC", parents=common + [gen_parser(False)],
                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    algos.add_parser("es3c", help="Run experiment with ES3C", parents=common + [gen_parser(True)],
                     formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    args = parser.parse_args(argv)
    if args.algo is None:
        parser.error("choose an algorithm: ebsc or es3c")
    return args


def main(argv=None):
    return run(get_args(argv))


if __name__ == "__main__":
    main()
