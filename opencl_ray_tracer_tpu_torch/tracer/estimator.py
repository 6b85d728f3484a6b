"""Path-tracing estimator: the bounce loop of one sample, and the per-sample
accumulation with the reference's quirks.

- ``trace`` is ``RayColour`` (``gpu_kernel.cl:266-348``) for a ray batch.
  A ray that scatters at bounce max_depth-1 leaves the loop and returns
  black (``:337-340``); a miss samples the sky with the accumulated
  throughput (``:342-347``); a metal absorb returns black (``:309``); an
  emissive hit returns throughput * albedo (``:326-329``).
- ``accumulate_sample`` clamps each sample to [0,1] before averaging
  (``:632-638``) and applies the NaN policy (``:640-642``).
"""

from __future__ import annotations

import torch

from .._fp import clip01
from ..rng import BOUNCE_BASE, BOUNCE_STRIDE, uniform4
from ..scene import sky_colour
from .intersect import closest_hit
from .scatter import scatter

ALIVE = 0
DONE_BLACK = 1   # absorbed, emissive (result set) or exhausted
DONE_MISS = 2    # sky applied after the loop


def bounce_uniforms(seed, pixel_ids, sample_id, depth):
    """The eight uniforms of one bounce, (R,8), from two pcg4d hashes."""
    slot = BOUNCE_BASE + depth * BOUNCE_STRIDE
    a = uniform4(seed, pixel_ids, sample_id, slot)
    b = uniform4(seed, pixel_ids, sample_id, slot + 1)
    return torch.stack(a + b, dim=-1)


def trace(scene, o, d, pixel_ids, sample_id, seed, max_depth, t_min=1e-3,
          hit_fn=None, first_bounce=0, throughput=None):
    """Trace a ray batch to the end of its paths; per-ray radiance (R,3).
    The loop ends after max_depth bounces or when no ray is alive.

    hit_fn(o, d) -> HitInfo replaces ``closest_hit`` (the winner-only
    differentiable hit of ``diffhit.make_grad_hit_fn``).  first_bounce
    offsets the bounces' RNG slots (the soft renderer draws bounce 0's
    itself); throughput (R,3) seeds the path throughput (default ones)."""
    r = o.shape[0]
    dev = o.device
    if throughput is None:
        throughput = torch.ones((r, 3), device=dev)
    result = torch.zeros((r, 3), device=dev)
    miss_dir = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(r, 3)
    status = torch.zeros((r,), dtype=torch.int32, device=dev)
    for depth in range(max_depth):
        alive = status == ALIVE
        if not bool(alive.any()):
            break
        h = (hit_fn(o, d) if hit_fn is not None
             else closest_hit(scene, o, d, t_min))
        sc = scatter(d, h.normal, h.front_face, h.albedo, h.fuzz, h.ior,
                     h.mat_type, bounce_uniforms(seed, pixel_ids, sample_id,
                                                 depth + first_bounce))
        miss_now = alive & ~h.hit
        emit_now = alive & h.hit & sc.emitted
        absorb_now = alive & h.hit & sc.absorbed & ~sc.emitted
        cont = (alive & h.hit & ~sc.emitted & ~sc.absorbed)[:, None]
        o = torch.where(cont, h.point, o)
        result = torch.where(emit_now[:, None], throughput * h.albedo, result)
        throughput = torch.where(cont, throughput * sc.attenuation, throughput)
        miss_dir = torch.where(miss_now[:, None], d, miss_dir)
        d = torch.where(cont, sc.direction, d)
        status = torch.where(
            miss_now, DONE_MISS,
            torch.where(emit_now | absorb_now, DONE_BLACK, status)
        ).to(torch.int32)
    # rays still alive after max_depth bounces stay black
    sky = sky_colour(scene.sky, miss_dir)
    is_miss = (status == DONE_MISS)[:, None]
    return torch.where(is_miss, result + throughput * sky, result)


def accumulate_sample(acc, colour, nan_policy: str, clamp: bool):
    """acc + this sample's contribution.  acc: (R,3) running sum; colour:
    (R,3).  NaN passes through the clamp, as in the C compares; then
    "running_sum" replaces it with the running-sum channel and "zero" with
    0."""
    c = clip01(colour) if clamp else colour
    if nan_policy == "running_sum":
        c = torch.where(torch.isnan(c), acc, c)
    elif nan_policy == "zero":
        c = torch.where(torch.isnan(c), torch.zeros_like(c), c)
    else:
        raise ValueError(f"unknown nan_policy: {nan_policy}")
    return acc + c
