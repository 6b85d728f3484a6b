"""Full-image rendering.

``render`` runs on the card unless the caller asks for the CPU: on CUDA a
scene that the sphere megakernel covers goes through it, and any other
scene raises ``NotImplementedError`` naming the slice of the port that
will cover it.  With ``device="cpu"`` the plain tracer below renders
(``render_rows``), the oracle the kernel is held against.

Pixel conventions are the reference kernel's (``gpu_kernel.cl:626-627``):
u = (col + jitter)/W, v = (row + jitter)/H with row 0 at the image
*bottom*; the io writers handle display order.
"""

from __future__ import annotations

import torch

from .._fp import div
from ..config import RenderConfig
from ..rng import SLOT_PIXEL_U, uniform4
from ..scene import Scene, camera_frame, rays_from_frame
from .estimator import accumulate_sample, trace
from .wavefront import render_rows_wavefront


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to render "
                "with the plain PyTorch tracer")
        device = "cuda"
    return torch.device(device)


def render_rows(scene: Scene, cfg: RenderConfig, row_start: int, n_rows: int,
                seed: int):
    """Plain-tracer render of n_rows rows from row_start on the scene's
    device: (n_rows, W, 3) mean radiance.  The RNG is keyed on global pixel
    ids, so row blocks compose into the full image exactly."""
    width = cfg.width
    n_samples = cfg.spp
    dev = scene.spheres.center.device
    rows = torch.arange(row_start, row_start + n_rows, device=dev)
    rows = rows[:, None].expand(n_rows, width).reshape(-1)
    cols = torch.arange(width, device=dev).repeat(n_rows)
    pixel_ids = rows * width + cols
    frame = camera_frame(scene.camera)

    if cfg.early_stop:
        acc = render_rows_wavefront(scene, cfg, rows, cols, pixel_ids, seed,
                                    0, n_samples, frame=frame)
    else:
        acc = torch.zeros((n_rows * width, 3), device=dev)
        for s in range(n_samples):
            u0, u1, u2, u3 = uniform4(seed, pixel_ids, s, SLOT_PIXEL_U)
            uu = div(cols.to(torch.float32) + u0, width)
            vv = div(rows.to(torch.float32) + u1, cfg.height)
            o, d = rays_from_frame(frame, uu, vv, u2, u3)
            colour = trace(scene, o, d, pixel_ids, s, seed, cfg.max_depth,
                           t_min=cfg.t_min)
            acc = accumulate_sample(acc, colour, cfg.nan_policy,
                                    cfg.clamp_samples)
    return div(acc, n_samples).reshape(n_rows, width, 3)


def render(scene: Scene, cfg: RenderConfig, seed: int = 0, device=None):
    """Render the full image: (H, W, 3) f32 radiance on ``device``, row 0 =
    image bottom.  device None means CUDA, and raises when there is none."""
    device = resolve_device(device)
    if device.type == "cuda":
        from ..kernels.megakernel import render_megakernel, unsupported_reason
        reason = unsupported_reason(scene)
        if reason is not None:
            raise NotImplementedError(reason)
        return render_megakernel(scene.to(device), cfg, seed)
    scene = scene.to(device)
    chunk = cfg.row_chunk or cfg.height
    if cfg.height % chunk:
        raise ValueError("row_chunk must divide height")
    out = [render_rows(scene, cfg, r0, chunk, seed)
           for r0 in range(0, cfg.height, chunk)]
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)
