"""Wavefront estimator with path regeneration.

One loop iteration advances every ray by one bounce, and the moment a
ray's path ends it is reloaded with that pixel's next camera sample.  The
counter RNG (keyed on global pixel id, sample id and bounce slot) makes a
regenerated path draw exactly what a sequential run would, and each pixel
finishes its samples in order, so clamp-before-average and the NaN
running sum (``gpu_kernel.cl:632-642``) come out as in the per-sample loop.
The CUDA kernel runs this same loop with one thread per pixel.
"""

from __future__ import annotations

import torch

from .._fp import div
from ..rng import SLOT_PIXEL_U, uniform4
from ..scene import camera_frame, rays_from_frame, sky_colour
from .estimator import bounce_uniforms
from .intersect import closest_hit
from .scatter import scatter


def render_rows_wavefront(scene, cfg, rows, cols, pixel_ids, seed,
                          sample_offset, n_samples, frame=None,
                          bounces=None):
    """Radiance sum over n_samples samples per pixel, (R,3); divide by
    n_samples for the mean.  rows/cols/pixel_ids: (R,) int64.

    frame: the camera frame (``camera_frame``), taken from scene.camera
    when None.  bounces: an optional int64 tensor of one element to which
    the number of ray bounces traced (the active rays of every iteration)
    is added.
    """
    if frame is None:
        frame = camera_frame(scene.camera)
    r = pixel_ids.shape[0]
    dev = pixel_ids.device
    sample_end = sample_offset + n_samples

    def camera_ray(sample_id):
        u0, u1, u2, u3 = uniform4(seed, pixel_ids, sample_id, SLOT_PIXEL_U)
        uu = div(cols.to(torch.float32) + u0, cfg.width)
        vv = div(rows.to(torch.float32) + u1, cfg.height)
        return rays_from_frame(frame, uu, vv, u2, u3)

    sample = torch.full((r,), sample_offset, dtype=torch.int64, device=dev)
    depth = torch.zeros((r,), dtype=torch.int64, device=dev)
    o, d = camera_ray(sample)
    throughput = torch.ones((r, 3), device=dev)
    acc = torch.zeros((r, 3), device=dev)
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)

    for _ in range(n_samples * cfg.max_depth + 1):
        active = sample < sample_end
        if not bool(active.any()):
            break
        if bounces is not None:
            bounces += active.sum()
        h = closest_hit(scene, o, d, cfg.t_min)
        sc = scatter(d, h.normal, h.front_face, h.albedo, h.fuzz, h.ior,
                     h.mat_type, bounce_uniforms(seed, pixel_ids, sample,
                                                 depth))
        miss_now = active & ~h.hit
        emit_now = active & h.hit & sc.emitted
        would_cont = active & h.hit & ~sc.emitted & ~sc.absorbed
        # a scatter at depth max_depth-1 ends the path black
        # (gpu_kernel.cl:337-340)
        cont = would_cont & ~(depth + 1 >= cfg.max_depth)
        term = active & ~cont

        sky = sky_colour(scene.sky, d)
        c = torch.where(miss_now[:, None], throughput * sky,
                        torch.where(emit_now[:, None],
                                    throughput * h.albedo, zero))
        if cfg.clamp_samples:
            c = torch.clamp(c, 0.0, 1.0)
        if cfg.nan_policy == "running_sum":
            c = torch.where(torch.isnan(c), acc, c)
        elif cfg.nan_policy == "zero":
            c = torch.where(torch.isnan(c), zero, c)
        else:
            raise ValueError(f"unknown nan_policy: {cfg.nan_policy}")
        acc = acc + torch.where(term[:, None], c, zero)

        sample = torch.where(term, sample + 1, sample)
        regen = (term & (sample < sample_end))[:, None]
        co, cd = camera_ray(sample)
        cn = cont[:, None]
        o = torch.where(regen, co, torch.where(cn, h.point, o))
        d = torch.where(regen, cd, torch.where(cn, sc.direction, d))
        throughput = torch.where(
            regen, one,
            torch.where(cn, throughput * sc.attenuation, throughput))
        depth = torch.where(regen[:, 0], 0,
                            torch.where(cont, depth + 1, depth))
    return acc
