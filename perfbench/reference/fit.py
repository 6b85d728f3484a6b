"""The reference's fit step: the image of the scene, the mean squared error
to the target, the gradient of the fitted leaves and Adam's first update,
worked out from the scene's leaves alone.

The image's mean is linear in the samples, so the gradient is taken a
block of pixels at a time: the whole image first, without autograd, for
the loss and its cotangent, then each block again with autograd, its
sum weighted by that cotangent.  The gradient treats a NaN sample as 0,
as the program's fit does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .tracer import RenderSettings, Scene, render_pixels

ADAM_BETA1, ADAM_BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def fit_step(leaves: dict, sky_kind: int, cfg: RenderSettings, target,
             param_paths, seed: int, lr: float, device, counts=None,
             dtype=torch.float32, rays_per_block: int = 2**22,
             keep_blocks=None, image_fn=None):
    """(loss, {path: gradient}, {path: parameter after one Adam step}) of
    one step of the fit at ``seed``, on ``device``.  ``keep_blocks``
    (a function of the block's index) drops the blocks it rejects from the
    gradient and scales the rest to the whole image: the faults that leave
    part of the batch out; ``image_fn`` alters each image where it is
    rendered: the fault of an altered answer."""
    image_fn = image_fn or (lambda img: img)
    cfg = dataclasses.replace(cfg, nan_policy="zero")
    params = {p: torch.as_tensor(np.asarray(leaves[p])).to(
        device=device, dtype=dtype).requires_grad_() for p in param_paths}
    scene = Scene(leaves, sky_kind, device, dtype, params)
    target = torch.as_tensor(target).to(device=device, dtype=dtype)
    target = target.reshape(-1, 3)
    n_pix = cfg.width * cfg.height
    n_blocks = -(-n_pix * cfg.spp // rays_per_block)
    size = -(-n_pix // n_blocks)
    blocks = [torch.arange(b, min(b + size, n_pix), device=device)
              for b in range(0, n_pix, size)]
    with torch.no_grad():
        img = image_fn(torch.cat([render_pixels(scene, cfg, pix, seed,
                                                counts)
                                  for pix in blocks]))
        loss = torch.mean((img - target) ** 2)
        cot = 2.0 * (img - target) / img.numel()
    kept = [i for i in range(len(blocks))
            if keep_blocks is None or keep_blocks(i)]
    scale = n_pix / sum(blocks[i].numel() for i in kept)
    leaves_ = [params[p] for p in param_paths]
    grads = [torch.zeros_like(x) for x in leaves_]
    for i in kept:
        pix = blocks[i]
        part = image_fn(render_pixels(scene, cfg, pix, seed,
                                      rays=rays_per_block))
        weighted = (part * cot[pix]).sum() * scale
        for g, gi in zip(grads, torch.autograd.grad(
                weighted, leaves_, retain_graph=True, allow_unused=True)):
            if gi is not None:
                g += gi
    grads = {p: g.detach() for p, g in zip(param_paths, grads)}
    with torch.no_grad():
        # Adam's first step: m_hat = g, v_hat = g^2
        updated = {p: params[p] - lr * g / (g.abs() + ADAM_EPS)
                   for p, g in grads.items()}
    return float(loss), grads, updated
