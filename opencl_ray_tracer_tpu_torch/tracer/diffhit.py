"""Winner-only differentiable closest hit (the backward path's hit).

The gradient of a path-traced image flows only through the *winning*
sphere of each ray segment: the argmin selection itself carries none (the
interior-derivative convention).  Differentiating the whole closest-hit
fold would record O(rays x spheres) work whose cotangents are all zero, so
the hit is split in two, as in the JAX package's ``tracer/diffhit.py``:

1. the winner search (``intersect.closest_fold``) under
   ``torch.no_grad()``;
2. the winner's hit record recomputed differentiably with the fold's own
   expressions (same quadratic, same root), so values equal those of
   ``closest_hit`` and gradients those of autograd through it.

Only the choice of root is discrete.  The triangle branch is slice 3b's
(with the mesh backward kernel, K5).
"""

from __future__ import annotations

import torch

from .._fp import dot3, fma
from .intersect import BIG, HitInfo, closest_fold, closest_hit


def winner_hitinfo(scene, o, d, best_kind, best_idx, hit, t_min) -> HitInfo:
    """Differentiable hit record for known winners.  best_kind/best_idx/hit
    are (R,) integer and bool tensors from ``closest_fold``."""
    if scene.triangles.count > 0:
        raise NotImplementedError(
            "the differentiable triangle hit is not ported yet: slice 3b "
            "ports it with the mesh backward kernel (K5)")
    spheres = scene.spheres
    if spheres.count == 0:
        # nothing to win: every ray misses
        return closest_hit(scene, o, d, t_min)
    sidx = torch.where(hit, best_idx, torch.zeros_like(best_idx))
    c = spheres.center[sidx]
    rad = spheres.radius[sidx]
    oc = o - c
    a = dot3(d, d)
    half_b = dot3(oc, d)
    cc = dot3(oc, oc) - rad * rad
    disc = fma(half_b, half_b, -(a * cc))
    sqrtd = torch.sqrt(torch.maximum(disc, torch.full_like(disc, 1e-30)))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    # the fold's root selection (gpu_kernel.cl:471-477); only the choice is
    # discrete
    ok0 = (disc >= 0.0) & (root0 >= t_min)
    t = torch.where(ok0, root0, root1)
    # miss lanes: finite placeholders, never consumed
    t = torch.where(hit, t, torch.ones_like(t))
    point = fma(t[:, None], d, o)
    outward = (point - c) / rad[:, None]
    outward = torch.where(hit[:, None], outward,
                          torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                                       device=o.device))
    front_face = dot3(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitInfo(hit=hit, t=t, point=point, normal=normal,
                   front_face=front_face, albedo=spheres.albedo[sidx],
                   fuzz=spheres.fuzz[sidx], ior=spheres.ior[sidx],
                   mat_type=spheres.mat_type[sidx])


def make_grad_hit_fn(scene, t_min: float = 1e-3,
                     winner_backend: str = "plain"):
    """hit_fn(o, d) for gradient renders: the winner search without
    autograd, then the winner-only differentiable recompute.  Gradients
    reach ``scene``'s leaves through the recompute.

    winner_backend "plain" searches with ``closest_fold``; the JAX
    package's "pallas" search (the closest-triangle kernel, K3) joins the
    triangle branch in slice 3b."""
    if winner_backend == "pallas":
        raise NotImplementedError(
            "the closest-triangle kernel (K3) becomes the winner search in "
            "slice 3b, with the differentiable triangle hit")
    if winner_backend != "plain":
        raise ValueError(f"unknown winner_backend: {winner_backend}")

    def hit_fn(o, d):
        with torch.no_grad():
            best_t, kind, idx = closest_fold(scene, o, d, t_min)
        return winner_hitinfo(scene, o, d, kind, idx, best_t < BIG, t_min)

    return hit_fn
