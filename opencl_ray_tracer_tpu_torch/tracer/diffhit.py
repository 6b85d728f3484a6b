"""Winner-only differentiable closest hit (the backward path's hit).

The gradient of a path-traced image flows only through the *winning*
primitive of each ray segment: the argmin selection itself carries none
(the interior-derivative convention).  Differentiating the whole
closest-hit fold would record O(rays x primitives) work whose cotangents
are all zero, so the hit is split in two, as in the JAX package's
``tracer/diffhit.py``:

1. the winner search under ``torch.no_grad()``: ``intersect.closest_fold``
   ("plain"), or the closest-triangle kernel (K3,
   ``kernels/intersect_mm.py::closest_tri``) for the triangles beside the
   plain fold for the spheres ("pallas", the JAX package's name);
2. the winner's hit record recomputed differentiably with the fold's own
   expressions (the same quadratic and root for a sphere, the same
   Moller-Trumbore for a triangle), so values equal those of
   ``closest_hit`` and gradients those of autograd through it.

Only the choice of root, and of winner, is discrete.
"""

from __future__ import annotations

import numpy as np
import torch

from .._fp import dot3, fma
from .intersect import BIG, TRI_EPS, HitInfo, closest_fold, cross


def winner_hitinfo(scene, o, d, best_kind, best_idx, hit, t_min) -> HitInfo:
    """Differentiable hit record for known winners.  best_kind/best_idx/hit
    are (R,) integer and bool tensors from ``closest_fold`` (kind 0 a
    sphere, 1 a triangle)."""
    spheres, tris = scene.spheres, scene.triangles
    r = o.shape[0]
    is_tri = best_kind == 1
    zero_i = torch.zeros_like(best_idx)
    ones = torch.ones((r,), dtype=o.dtype, device=o.device)

    # ---- sphere branch: the selected quadratic root ----
    if spheres.count > 0:
        sidx = torch.where(hit & ~is_tri, best_idx, zero_i)
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
        # the fold's root selection (gpu_kernel.cl:471-477); only the
        # choice is discrete
        ok0 = (disc >= 0.0) & (root0 >= t_min)
        t = torch.where(ok0, root0, root1)
        albedo, fuzz = spheres.albedo[sidx], spheres.fuzz[sidx]
        ior, mat_type = spheres.ior[sidx], spheres.mat_type[sidx]
    else:
        t = ones
        albedo, fuzz, ior = torch.zeros_like(o), ones * 0.0, ones * 0.0
        mat_type = torch.zeros((r,), dtype=torch.int32, device=o.device)

    # ---- triangle branch: Moller-Trumbore for the winner ----
    if tris.count > 0:
        tidx = torch.where(hit & is_tri, best_idx, zero_i)
        p0 = tris.p0[tidx]
        e0 = tris.p1[tidx] - p0
        e1 = tris.p2[tidx] - p0
        a_t = dot3(e0, cross(d, e1))
        f = 1.0 / torch.where(torch.abs(a_t) < TRI_EPS, ones, a_t)
        t_t = f * dot3(e1, cross(o - p0, e0))
        n = cross(e0, e1)
        t_normal = n / torch.clamp(torch.sqrt(dot3(n, n)), min=1e-20)[:, None]
        t = torch.where(is_tri, t_t, t)
        it = is_tri[:, None]
        albedo = torch.where(it, tris.albedo[tidx], albedo)
        fuzz = torch.where(is_tri, tris.fuzz[tidx], fuzz)
        ior = torch.where(is_tri, tris.ior[tidx], ior)
        mat_type = torch.where(is_tri, tris.mat_type[tidx], mat_type)

    # miss lanes: finite placeholders, never consumed
    t = torch.where(hit, t, ones)
    point = fma(t[:, None], d, o)
    if spheres.count > 0:
        outward = (point - c) / rad[:, None]
    else:
        outward = torch.zeros_like(o)
    if tris.count > 0:
        outward = torch.where(is_tri[:, None], t_normal, outward)
    outward = torch.where(hit[:, None], outward,
                          torch.tensor([0.0, 0.0, 1.0], dtype=o.dtype,
                                       device=o.device))
    front_face = dot3(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitInfo(hit=hit, t=t, point=point, normal=normal,
                   front_face=front_face, albedo=albedo, fuzz=fuzz, ior=ior,
                   mat_type=mat_type)


def make_grad_hit_fn(scene, t_min: float = 1e-3,
                     winner_backend: str = "plain"):
    """hit_fn(o, d) for gradient renders: the winner search without
    autograd, then the winner-only differentiable recompute.  Gradients
    reach ``scene``'s leaves through the recompute.

    winner_backend: "plain" searches with ``closest_fold``; "pallas"
    searches the triangles with the closest-triangle kernel
    (``closest_tri``: K3 for CUDA tensors, its plain version for CPU
    tensors) on the scene's mesh tables, maps its plan-order winner back
    to the scene's triangle ids, and searches the spheres with
    ``closest_fold`` (a sphere wins a tie); a scene without triangles in
    gating boxes takes "plain".  "auto" is "pallas" for a scene with
    triangles on CUDA, else "plain"."""
    if winner_backend == "auto":
        on_card = scene.triangles.p0.device.type == "cuda"
        winner_backend = ("pallas" if on_card and scene.triangles.count > 0
                          else "plain")
    if winner_backend not in ("plain", "pallas"):
        raise ValueError(f"unknown winner_backend: {winner_backend}")
    use_kernel = (winner_backend == "pallas" and scene.triangles.count > 0
                  and scene.boxes.count > 0)
    if use_kernel:
        from ..kernels.intersect_mm import closest_tri, mesh_tables
        from ..scene import detached
        from .mesh_accel import sphere_only
        frozen = detached(scene)
        tab = mesh_tables(frozen)
        spheres = sphere_only(frozen)
        perm = torch.as_tensor(np.maximum(tab.plan.perm, 0).astype(np.int64),
                               device=tab.tri.device)

    def hit_fn(o, d):
        with torch.no_grad():
            if use_kernel:
                o_s, d_s = o.detach().contiguous(), d.detach().contiguous()
                s_t, _, s_idx = closest_fold(spheres, o_s, d_s, t_min)
                tri_t, tri_idx = closest_tri(tab, o_s, d_s, t_min)
                tri_idx = perm[tri_idx.clamp(0, perm.shape[0] - 1)]
                take_tri = (tri_t < BIG) & (tri_t < s_t)
                best_t = torch.minimum(tri_t, s_t)
                kind = take_tri.to(torch.int32)
                idx = torch.where(take_tri, tri_idx, s_idx)
            else:
                best_t, kind, idx = closest_fold(scene, o, d, t_min)
        return winner_hitinfo(scene, o, d, kind, idx, best_t < BIG, t_min)

    return hit_fn
