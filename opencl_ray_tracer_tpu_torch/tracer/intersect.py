"""Batched ray-scene intersection (``HitAnything``, ``gpu_kernel.cl:358-394``).

- Sphere test: the RTiOW half-b quadratic with near/far root selection and
  an inclusive lower bound t_min (``HitSphere``, ``gpu_kernel.cl:455-487``).
- Triangle test: direct Moller-Trumbore with the 1e-5 parallel cull, the
  barycentric bounds and a strict t > t_min (``HitTriangle``,
  ``gpu_kernel.cl:489-532``).
- AABB slab test with NaN-ignoring min and max (``fmin``/``fmax``), gating
  each triangle by the box its ``box_id`` names (``HitBoundingBox``,
  ``gpu_kernel.cl:534-555``; the gate at ``:374-391``).
- Closest hit: the first index of the smallest t, as the reference's
  closest-so-far fold with a strict ``<`` picks it; spheres first, so a
  sphere wins a tie with a triangle.
- Front-face normals (``SetFaceNormal``, ``gpu_kernel.cl:352-356``).

Dot products, cross products and the discriminant are fused multiply-add
chains (``_fp.py``), as XLA compiles the JAX reference.  Triangles are
folded in chunks of ``adaptive_tri_chunk`` so that the (rays x triangles)
product never materialises whole.  This is the direct form; the matmul
form and the kernels' form are in ``mesh_accel.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._fp import dot3, fma

TRI_EPS = 1e-5        # gpu_kernel.cl:496
BIG = 3.4e38

# Largest triangle chunk of the fold, and the budget of (rays x chunk)
# elements of one fold step (the JAX package's values).
TRI_CHUNK = 512
PAIR_BUDGET = 2 * 10**8


def adaptive_tri_chunk(n_rays: int, per_pair_cost: int = 3) -> int:
    """Largest 128-multiple triangle chunk keeping n_rays*chunk*cost within
    PAIR_BUDGET (floor 128)."""
    c = PAIR_BUDGET // max(n_rays * per_pair_cost, 1)
    return int(max(128, min(TRI_CHUNK, (c // 128) * 128)))


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


def cross(a, b):
    """Cross product over the last axis, each component fma(p, q, -(r*s))."""
    return torch.stack([fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                        fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                        fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))],
                       dim=-1)


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


def hit_triangles_chunk(o, d, p0, p1, p2, t_min, gate):
    """Moller-Trumbore for one triangle chunk.  o,d: (R,3); p0/p1/p2:
    (C,3); gate: (R,C) bool.  Returns t: (R,C) with BIG on a miss."""
    e0 = (p1 - p0)[None]                               # (1,C,3)
    e1 = (p2 - p0)[None]
    h = cross(d[:, None, :], e1)                       # (R,C,3)
    a = dot3(e0, h)                                    # (R,C)
    parallel = (a > -TRI_EPS) & (a < TRI_EPS)          # gpu_kernel.cl:496
    f = 1.0 / a
    s = o[:, None, :] - p0[None]                       # (R,C,3)
    u = f * dot3(s, h)
    q = cross(s, e0)                                   # (R,C,3)
    v = f * dot3(d[:, None, :], q)
    t0 = f * dot3(e1, q)
    ok = (~parallel
          & (u >= 0.0) & (u <= 1.0)                    # gpu_kernel.cl:505
          & (v >= 0.0) & (u + v <= 1.0)                # gpu_kernel.cl:513
          & (t0 > t_min)                               # strict, :520
          & gate)
    return torch.where(ok, t0, torch.full_like(t0, BIG))


def hit_aabbs(o, d, box_min, box_max):
    """Branchless slab test.  o,d: (R,3); boxes: (B,3).  Returns (R,B) bool.
    1/0 gives inf and 0*inf NaN where the origin lies on a box face;
    fmin/fmax ignore the NaN, as the reference's OpenCL fmin/fmax do."""
    inv_d = 1.0 / d                                    # (R,3)
    t1 = (box_min[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    t2 = (box_max[None, :, :] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.fmin(t1, t2).amax(dim=-1)
    tmax = torch.fmax(t1, t2).amin(dim=-1)
    return tmax > torch.maximum(tmin, torch.zeros_like(tmin))


def scene_box_hit(scene, o, d):
    """(R, B) slab hits of the scene's boxes; (R, 1) False without boxes
    (then no triangle is tested, gpu_kernel.cl:374-391)."""
    if scene.boxes.count > 0:
        return hit_aabbs(o, d, scene.boxes.box_min, scene.boxes.box_max)
    return torch.zeros((o.shape[0], 1), dtype=torch.bool, device=o.device)


def _pad_triangles(tris, chunk):
    """Triangle corners and box ids padded to a chunk multiple with
    degenerate triangles of box -1 (never hit); (p0, p1, p2, box_id,
    n_chunks), or None without triangles."""
    t = tris.count
    if t == 0:
        return None
    pad = (-t) % chunk

    def rows(x, fill=0):
        tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    return (rows(tris.p0), rows(tris.p1), rows(tris.p2),
            rows(tris.box_id, -1), (t + pad) // chunk)


def box_gate(box_hit, box_id):
    """(R, C) gate of C triangles: the ray hits the triangle's box.
    box_hit: (R, B) bool; box_id: (C,), -1 for padding."""
    gate = box_hit[:, box_id.clamp(min=0).long()]
    return gate & (box_id >= 0)[None, :]


def closest_fold(scene, o, d, t_min):
    """Winner search (the closestSoFar fold, ``gpu_kernel.cl:358-394``) over
    the spheres and the box-gated triangles: (best_t, kind, idx), each
    (R,).  kind is 0 for a sphere, 1 for a triangle; best_t == BIG means a
    miss."""
    spheres, tris = scene.spheres, scene.triangles
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=o.dtype, device=o.device)
    idx = torch.zeros((r,), dtype=torch.long, device=o.device)
    kind = torch.zeros((r,), dtype=torch.int32, device=o.device)
    if spheres.count > 0:
        ts = hit_spheres(o, d, spheres.center, spheres.radius, t_min)
        # argmin returns the first index among equal minima
        idx = torch.argmin(ts, dim=1)
        best_t = ts.gather(1, idx[:, None])[:, 0]

    # a chunk no larger than the mesh: the fold's result does not depend
    # on the chunk, and padding costs tests
    chunk = min(adaptive_tri_chunk(r), max(tris.count, 1))
    padded = _pad_triangles(tris, chunk)
    if padded is not None:
        p0, p1, p2, box_id, n_chunks = padded
        box_hit = scene_box_hit(scene, o, d)
        tri_t = torch.full_like(best_t, BIG)
        tri_i = torch.zeros_like(idx)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            tt = hit_triangles_chunk(o, d, p0[sl], p1[sl], p2[sl], t_min,
                                     box_gate(box_hit, box_id[sl]))
            ci = torch.argmin(tt, dim=1)
            ct = tt.gather(1, ci[:, None])[:, 0]
            upd = ct < tri_t
            tri_t = torch.where(upd, ct, tri_t)
            tri_i = torch.where(upd, c * chunk + ci, tri_i)
        upd = tri_t < best_t
        best_t = torch.where(upd, tri_t, best_t)
        kind = torch.where(upd, 1, kind).to(torch.int32)
        idx = torch.where(upd, tri_i, idx)
    return best_t, kind, idx


def closest_hit(scene, o, d, t_min) -> HitInfo:
    """Closest hit over the scene's spheres and box-gated triangles.
    o, d: (R,3)."""
    spheres, tris = scene.spheres, scene.triangles
    r = o.shape[0]
    best_t, kind, idx = closest_fold(scene, o, d, t_min)

    hit = best_t < BIG
    t_safe = torch.where(hit, best_t, torch.ones_like(best_t))
    point = fma(t_safe[:, None], d, o)
    zero_i = torch.zeros_like(idx)
    if spheres.count > 0:
        sidx = torch.where(kind == 0, idx, zero_i)
        outward = (point - spheres.center[sidx]) / spheres.radius[sidx][:, None]
        albedo = spheres.albedo[sidx]
        fuzz = spheres.fuzz[sidx]
        ior = spheres.ior[sidx]
        mat_type = spheres.mat_type[sidx]
    else:
        outward = torch.zeros_like(o)
        albedo = torch.zeros_like(o)
        fuzz = torch.zeros_like(best_t)
        ior = torch.zeros_like(best_t)
        mat_type = torch.zeros((r,), dtype=torch.int32, device=o.device)
    if tris.count > 0:
        is_tri = kind == 1
        tidx = torch.where(is_tri, idx, zero_i).clamp(0, tris.count - 1)
        n = cross(tris.p1[tidx] - tris.p0[tidx], tris.p2[tidx] - tris.p0[tidx])
        t_normal = n / torch.sqrt(dot3(n, n))[:, None]
        outward = torch.where(is_tri[:, None], t_normal, outward)
        albedo = torch.where(is_tri[:, None], tris.albedo[tidx], albedo)
        fuzz = torch.where(is_tri, tris.fuzz[tidx], fuzz)
        ior = torch.where(is_tri, tris.ior[tidx], ior)
        mat_type = torch.where(is_tri, tris.mat_type[tidx], mat_type)

    front_face = dot3(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return HitInfo(hit=hit, t=best_t, point=point, normal=normal,
                   front_face=front_face, albedo=albedo, fuzz=fuzz,
                   ior=ior, mat_type=mat_type)
