"""Sample-accumulation checkpoint and resume.

The reference has no checkpoint: the BMP it rewrites after every block
(``main.cpp:263-265``) is a progress snapshot, and a crash recomputes
everything.  Here the checkpoint is the estimator's state: each pixel's
radiance sum and the number of samples folded into it.  A resumed render
continues at the next global sample id, and the counter RNG draws what an
uninterrupted run would, so a preempted job loses at most one chunk.

The file is the JAX package's (``opencl_ray_tracer_tpu.parallel.checkpoint``):
an npz with ``acc`` (H, W, 3) float32, ``n_samples`` int64 and ``seed``
uint32, so a checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .._fp import div
from ..config import RenderConfig
from ..scene import Scene
from ..tracer.render import render_window, resolve_device


def save_state(path: str, acc, n_samples: int, seed: int) -> None:
    """Write the accumulation state to ``path`` atomically: a temporary
    file beside it, then ``os.replace``.  acc: (H, W, 3) sums, a tensor on
    any device or an array."""
    if isinstance(acc, torch.Tensor):
        acc = acc.detach().cpu().numpy()
    # the suffix must be ".npz": np.savez appends it to any other name, and
    # the file replaced would be the empty one
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, acc=np.asarray(acc, np.float32),
                 n_samples=np.int64(n_samples), seed=np.uint32(seed))
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_state(path: str):
    """(acc (H, W, 3) float32 array, n_samples, seed) from ``path``."""
    with np.load(path) as z:
        return z["acc"], int(z["n_samples"]), int(z["seed"])


def render_checkpointed(scene: Scene, cfg: RenderConfig, path: str,
                        seed: int = 0, chunk_spp: int = 8, progress=None,
                        device=None):
    """Render cfg.spp samples in windows of chunk_spp, writing the state to
    ``path`` after each; the (H, W, 3) mean image on ``device`` (None: the
    card, which raises when there is none).

    If ``path`` exists the render resumes from the samples it holds; its
    size and seed must be this render's.  Each window runs through
    ``render``'s route (``tracer.render.render_window``): the mesh
    megakernel, the sphere megakernel or the plain tracer, with the sums so
    far as acc0 and the raw sum returned, so the NaN running-sum policy
    sees every earlier sample and the windows' sums are the one-shot sum.
    The sums stay on the device; the final mean divides there as the
    kernels do (``_fp.div``), so a checkpointed render equals ``render``'s
    image.  ``progress(done_spp, total_spp, mean_img)`` runs after each
    window with the mean so far on the device (the reference's per-block
    progress line and BMP, ``main.cpp:263-267``)."""
    device = resolve_device(device)
    if chunk_spp < 1:
        raise ValueError("chunk_spp must be at least 1")
    h, w = cfg.height, cfg.width
    done = 0
    acc = None
    if os.path.exists(path):
        saved, done, saved_seed = load_state(path)
        if saved.shape != (h, w, 3):
            raise ValueError(f"checkpoint {path} holds a {saved.shape} sum, "
                             f"not ({h}, {w}, 3)")
        if saved_seed != (seed & 0xFFFFFFFF):
            raise ValueError(f"checkpoint {path} was rendered with seed "
                             f"{saved_seed}, not {seed}")
        if done > cfg.spp:
            raise ValueError(f"checkpoint {path} holds {done} samples, more "
                             f"than spp={cfg.spp}")
        acc = torch.as_tensor(saved, dtype=torch.float32).to(device)
    while done < cfg.spp:
        n = min(chunk_spp, cfg.spp - done)
        acc = render_window(scene, cfg.replace(spp=n), seed, device,
                            sample_offset=done, mean=False, acc0=acc)
        done += n
        save_state(path, acc, done, seed)
        if progress is not None:
            progress(done, cfg.spp, div(acc, done))
    if acc is None:
        acc = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    return div(acc, cfg.spp)
