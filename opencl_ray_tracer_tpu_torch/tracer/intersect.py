"""Batched ray-sphere intersection (``HitAnything``, ``gpu_kernel.cl:358-394``).

- Sphere test: the RTiOW half-b quadratic with near/far root selection and
  an inclusive lower bound t_min (``HitSphere``, ``gpu_kernel.cl:455-487``).
- Closest hit: the first index of the smallest t, as the reference's
  closest-so-far fold with a strict ``<`` picks it.
- Front-face normals (``SetFaceNormal``, ``gpu_kernel.cl:352-356``).

Dot products and the discriminant are fused multiply-add chains
(``_fp.py``), as in the JAX reference and the CUDA kernel.  Triangles and
their gating boxes are the mesh slice's work: a scene with triangles
raises here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._fp import dot3, fma

BIG = 3.4e38


class HitInfo(NamedTuple):
    """Per-ray closest-hit record (``HitRecord``, gpu_kernel.cl:44-51)."""
    hit: torch.Tensor         # (R,) bool
    t: torch.Tensor           # (R,) f32
    point: torch.Tensor       # (R,3)
    normal: torch.Tensor      # (R,3) front-facing
    front_face: torch.Tensor  # (R,) bool
    albedo: torch.Tensor      # (R,3)
    fuzz: torch.Tensor        # (R,)
    ior: torch.Tensor         # (R,)
    mat_type: torch.Tensor    # (R,) i32


def hit_spheres(o, d, center, radius, t_min):
    """t of each ray against each sphere.  o,d: (R,3); center: (S,3);
    radius: (S,).  Returns (R,S) with BIG where there is no hit at
    t >= t_min."""
    oc = o[:, None, :] - center[None, :, :]            # (R,S,3)
    a = dot3(d, d)[:, None]                            # (R,1)
    half_b = dot3(oc, d[:, None, :])                   # (R,S)
    c = dot3(oc, oc) - (radius * radius)[None, :]
    disc = fma(half_b, half_b, -(a * c))
    sqrtd = torch.sqrt(torch.clamp(disc, min=1e-30))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    ok0 = (disc >= 0.0) & (root0 >= t_min)
    ok1 = (disc >= 0.0) & (root1 >= t_min)
    big = torch.full_like(root0, BIG)
    return torch.where(ok0, root0, torch.where(ok1, root1, big))


def _no_triangles(scene):
    if scene.triangles.count > 0:
        raise NotImplementedError(
            "triangle meshes are not ported yet: the mesh slice (slice 3) "
            "ports triangle intersection")


def closest_fold(scene, o, d, t_min):
    """Winner search (the closestSoFar fold, ``gpu_kernel.cl:358-394``):
    (best_t, kind, idx), each (R,).  kind is 0 for a sphere, the only kind
    in this slice; best_t == BIG means a miss."""
    _no_triangles(scene)
    spheres = scene.spheres
    r = o.shape[0]
    if spheres.count > 0:
        ts = hit_spheres(o, d, spheres.center, spheres.radius, t_min)
        # argmin returns the first index among equal minima
        idx = torch.argmin(ts, dim=1)
        best_t = ts.gather(1, idx[:, None])[:, 0]
    else:
        best_t = torch.full((r,), BIG, dtype=o.dtype, device=o.device)
        idx = torch.zeros((r,), dtype=torch.long, device=o.device)
    kind = torch.zeros((r,), dtype=torch.int32, device=o.device)
    return best_t, kind, idx


def closest_hit(scene, o, d, t_min) -> HitInfo:
    """Closest hit over the scene's spheres.  o, d: (R,3)."""
    spheres = scene.spheres
    r = o.shape[0]
    best_t, _, idx = closest_fold(scene, o, d, t_min)

    hit = best_t < BIG
    t_safe = torch.where(hit, best_t, torch.ones_like(best_t))
    point = fma(t_safe[:, None], d, o)
    if spheres.count > 0:
        outward = (point - spheres.center[idx]) / spheres.radius[idx][:, None]
        albedo = spheres.albedo[idx]
        fuzz = spheres.fuzz[idx]
        ior = spheres.ior[idx]
        mat_type = spheres.mat_type[idx]
    else:
        outward = torch.zeros_like(o)
        albedo = torch.zeros_like(o)
        fuzz = torch.zeros_like(best_t)
        ior = torch.zeros_like(best_t)
        mat_type = torch.zeros((r,), dtype=torch.int32, device=o.device)

    front_face = dot3(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitInfo(hit=hit, t=best_t, point=point, normal=normal,
                   front_face=front_face, albedo=albedo, fuzz=fuzz,
                   ior=ior, mat_type=mat_type)
