"""Per-epoch visualizers of the apps (counterpart: evo_tpu/apps/viz.py):
generative-field grids, the free-energy trajectory with the exact
likelihood's line, reconstruction panels and an optional training gif.

``process_epoch`` copies its inputs to the host on the caller's thread and
queues them; one worker thread owns all matplotlib state and renders the
PNGs, off the training loop.  ``finalize()`` drains the queue, then builds
the gif; a worker's exception is raised again by the next call or by
``finalize``.  ``async_render=False`` renders inline.  matplotlib (Agg
backend) is imported at the first render, so constructing a visualizer
does not need it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np

from evo_tpu_torch.apps.common import to_host
from evo_tpu_torch.prepost.viz import make_grid


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host_params(params):
    """The fields the renderers read (W, and pies where there are), on the
    host after one synchronize."""
    fields = {name: getattr(params, name) for name in ("W", "pies") if hasattr(params, name)}

    class _P:  # attribute view
        pass

    p = _P()
    for k, v in to_host(fields).items():
        setattr(p, k, v)
    return p


class BaseVisualizer:
    def __init__(self, viz_every: int, output_directory: str,
                 gif_framerate: Optional[str] = None, async_render: bool = True):
        self.viz_every = viz_every
        self.outdir = output_directory
        self.gif_framerate = gif_framerate
        self.frames = []
        self.F_log = []
        self._q = None
        self._worker = None
        self._exc = None
        if async_render:
            self._q = queue.Queue(maxsize=4)  # back-pressure bounds the snapshots held
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()

    # ---- async plumbing --------------------------------------------------
    def _drain(self):
        while True:
            task = self._q.get()
            if task is None:
                return
            if self._exc is not None:
                continue
            try:
                self._render_epoch(**task)
            except Exception as e:  # raised again by _raise_pending
                self._exc = e

    def _raise_pending(self):
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def _join(self):
        if self._q is not None:
            self._q.put(None)
            self._worker.join()
            self._q = None
            self._worker = None
        self._raise_pending()

    # ---- public ------------------------------------------------------------
    def process_epoch(self, epoch, F, params, **kw):
        self.F_log.append(float(F))
        if epoch % self.viz_every:
            return
        task = self._snapshot(epoch=epoch, params=params, **kw)
        task["F_hist"] = np.asarray(self.F_log, dtype=float)
        if self._q is None:
            self._render_epoch(**task)
        else:
            self._raise_pending()
            self._q.put(task)

    def _snapshot(self, *, epoch, params, **kw) -> dict:
        """Host copies of what the worker renders; subclasses extend."""
        return {"epoch": epoch, "params": _host_params(params)}

    def _render_epoch(self, **task):  # pragma: no cover - abstract
        raise NotImplementedError

    def _save_frame(self, fig, epoch):
        path = os.path.join(self.outdir, f"training_{epoch:04d}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        self.frames.append(path)

    def finalize(self):
        """Drain pending renders, then assemble the frames into
        training.gif (PIL, no ffmpeg)."""
        self._join()
        if not self.gif_framerate or not self.frames:
            return
        from PIL import Image

        num, den = (self.gif_framerate.split("/") + ["1"])[:2]
        fps = max(float(num) / float(den), 0.1)
        imgs = [Image.open(f).convert("P") for f in self.frames]
        imgs[0].save(os.path.join(self.outdir, "training.gif"), save_all=True,
                     append_images=imgs[1:], duration=int(1000 / fps), loop=0)
        print(f"Wrote {self.outdir}/training.gif")


def _gf_grid(ax, W, patch_shape, title):
    H = W.shape[1]
    gfs = W.T.reshape((H,) + tuple(patch_shape))
    if gfs.ndim == 4 and gfs.shape[-1] not in (1, 3):  # [H, C, h, w] -> channel 0
        gfs = gfs[:, 0]
    grid = make_grid(gfs, ncol=int(np.ceil(np.sqrt(H))), pad=1, pad_value=0.0)
    ax.imshow(grid, cmap="gray", interpolation="nearest")
    ax.set_title(title)
    ax.axis("off")


class BarsVisualizer(BaseVisualizer):
    """Learned against generating bars, and the free-energy trajectory
    (reference examples/bars-test/viz.py)."""

    def __init__(self, viz_every, output_directory, theta_gen_W=None, L_gen=None,
                 gif_framerate=None, patch_shape=None, async_render=True):
        super().__init__(viz_every, output_directory, gif_framerate, async_render)
        self.W_gen = theta_gen_W
        self.L_gen = L_gen
        self.patch_shape = patch_shape

    def _render_epoch(self, epoch, params, F_hist, **_):
        plt = _plt()
        W = params.W
        D = W.shape[0]
        shp = self.patch_shape or (int(np.sqrt(D)), int(np.sqrt(D)))
        ncols = 3 if self.W_gen is not None else 2
        fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
        _gf_grid(axes[0], W, shp, f"W (epoch {epoch})")
        if self.W_gen is not None:
            _gf_grid(axes[1], self.W_gen, shp, "W_gen")
        ax = axes[-1]
        ax.plot(np.arange(1, len(F_hist) + 1), F_hist, label="F")
        if self.L_gen is not None:
            ax.axhline(self.L_gen, color="r", ls="--", label="L(theta_gen)")
        ax.set_xlabel("epoch")
        ax.legend()
        self._save_frame(fig, epoch)
        plt.close(fig)


class GFVisualizer(BaseVisualizer):
    """Generative-field grids and the lower bound (reference
    feature-learning main.py)."""

    def __init__(self, viz_every, output_directory, patch_shape, sort_gfs=False,
                 gif_framerate=None, async_render=True):
        super().__init__(viz_every, output_directory, gif_framerate, async_render)
        self.patch_shape = patch_shape
        self.sort_gfs = sort_gfs

    def _render_epoch(self, epoch, params, F_hist, **_):
        plt = _plt()
        W = params.W
        if self.sort_gfs and hasattr(params, "pies"):
            W = W[:, np.argsort(params.pies)[::-1]]
        fig, axes = plt.subplots(1, 2, figsize=(9, 4.5))
        _gf_grid(axes[0], W, self.patch_shape, f"generative fields (epoch {epoch})")
        axes[1].plot(np.arange(1, len(F_hist) + 1), F_hist)
        axes[1].set_xlabel("epoch")
        axes[1].set_ylabel("F")
        self._save_frame(fig, epoch)
        plt.close(fig)


class ReconstructionVisualizer(BaseVisualizer):
    """Clean, corrupted and reconstructed image, the GF grid and the PSNR
    (reference image-denoising/viz.py, image-inpainting/viz.py)."""

    def __init__(self, viz_every, output_directory, clean_image, corrupted_image,
                 patch_shape, gif_framerate=None, async_render=True):
        super().__init__(viz_every, output_directory, gif_framerate, async_render)
        self.clean = clean_image
        self.corrupted = corrupted_image
        self.patch_shape = patch_shape

    def _snapshot(self, *, epoch, params, rec=None, psnr_val=None, **kw):
        task = super()._snapshot(epoch=epoch, params=params)
        task["rec"] = None if rec is None else np.asarray(rec)
        task["psnr_val"] = psnr_val
        return task

    def _render_epoch(self, epoch, params, F_hist, rec=None, psnr_val=None, **_):
        plt = _plt()
        fig, axes = plt.subplots(1, 5, figsize=(19, 4))
        for ax, (img, title) in zip(
                axes[:3],
                [(self.clean, "clean"), (self.corrupted, "corrupted"),
                 (rec, "reconstruction" + (f" (psnr {psnr_val:.2f})" if psnr_val else ""))]):
            if img is not None:
                ax.imshow(np.squeeze(img), cmap="gray", vmin=0, vmax=255)
            ax.set_title(title)
            ax.axis("off")
        _gf_grid(axes[3], params.W, self.patch_shape, f"W (epoch {epoch})")
        axes[4].plot(np.arange(1, len(F_hist) + 1), F_hist)
        axes[4].set_xlabel("epoch")
        axes[4].set_ylabel("F")
        self._save_frame(fig, epoch)
        plt.close(fig)
