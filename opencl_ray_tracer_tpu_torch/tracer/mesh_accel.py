"""Matmul-form ray-triangle intersection (``tri_backend="mm"``).

Moller-Trumbore decomposes into scalar triple products that are bilinear
in ray features F = [d, m, o, 1], m = o x d, and per-triangle constant
columns (the JAX package's ``tracer/mesh_accel.py``):

    a_col = e1 x e0                    (a      = d . a_col)
    u_col = [-(e1 x p0), e1, 0, 0]     (u_num  = F . u_col)
    v_col = [-(p0 x e0), -e0, 0, 0]    (v_num  = F . v_col)
    t_col = [0, 0, n, -(p0 . n)]       (t_num  = F . t_col),  n = e0 x e1

then u = u_num / a in [0,1], v = v_num / a >= 0, u + v <= 1, |a| >= 1e-5
(the parallel cull, ``gpu_kernel.cl:496``) and t = t_num / a > t_min
(strict, ``:520``): the accept tests of the direct form, up to the
rounding of the dot products.

``TriFeatures.table`` holds the nonzero rows of these columns and the unit
normal, ``TRI_ROWS`` rows with one column per triangle (the JAX package
keeps the same numbers as (n_chunks, 10, 4*chunk) matmul weights).  The
port evaluates it in one form everywhere, here and in its CUDA kernels
(``kernels/csrc/mesh.cuh``): each dot product an fma chain in row order,
the division a multiplication by 1/a.  The winner's normal is the table's
unit normal, n / max(|n|, 1e-20).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .._fp import dot3, fma
from .intersect import (BIG, TRI_EPS, HitInfo, adaptive_tri_chunk, box_gate,
                        closest_hit, cross, scene_box_hit)

MM_CHUNK = 2048  # triangles per fold step; adapts down with the ray count
# Rays per step of the fold (bounds the (rays x chunk) temporaries).
RAY_CHUNK = 2**16

# Rows of the triangle table (TRI_ROWS, T_pad), one column per triangle:
# a_col; u_d and e1; v_d and -e0; n and the t bias; the unit normal.
T_A, T_U, T_V, T_T, T_N = 0, 3, 9, 15, 19
TRI_ROWS = 22


class TriFeatures(NamedTuple):
    table: torch.Tensor     # (TRI_ROWS, T_pad) triangle table
    albedo: torch.Tensor    # (T_pad, 3)
    fuzz: torch.Tensor      # (T_pad,)
    ior: torch.Tensor       # (T_pad,)
    mat_type: torch.Tensor  # (T_pad,) i32
    box_id: torch.Tensor    # (T_pad,) i32 (-1 for padding)
    n_chunks: int
    chunk: int
    # from a clusters.MeshPlan; None without one
    cluster_min: torch.Tensor | None = None   # (n_chunks, 3)
    cluster_max: torch.Tensor | None = None   # (n_chunks, 3)
    chunk_box_id: tuple | None = None         # per-chunk gating box id

    @property
    def normal(self) -> torch.Tensor:
        """(T_pad, 3) unit geometric normals."""
        return self.table[T_N:T_N + 3].T


def _pad_rows(x, pad, fill=0):
    tail = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail])


def build_tri_features(scene, chunk: int = MM_CHUNK,
                       plan=None) -> TriFeatures | None:
    """The triangle table and per-triangle materials, once per scene; None
    without triangles.  With a ``clusters.MeshPlan`` the triangles take the plan's
    order (indices in the tables then refer to it) and each chunk gets
    its padded AABB; the degenerate padding triangles never hit (a == 0)."""
    tris = scene.triangles
    t = tris.count
    if t == 0:
        return None
    if plan is not None:
        from .clusters import cluster_bounds, permute
        if plan.chunk != chunk or plan.n_tris != t:
            raise ValueError("the plan does not fit the scene and chunk")
        p0, p1, p2 = (permute(x, plan) for x in (tris.p0, tris.p1, tris.p2))
        cmin, cmax = cluster_bounds(p0, p1, p2, plan)
        return _features_from(
            p0, p1, p2, albedo=permute(tris.albedo, plan),
            fuzz=permute(tris.fuzz, plan), ior=permute(tris.ior, plan),
            mat_type=permute(tris.mat_type, plan),
            box_id=permute(tris.box_id, plan, fill=-1), chunk=chunk,
            cluster_min=cmin, cluster_max=cmax,
            chunk_box_id=plan.chunk_box_id)
    pad = (-t) % chunk
    return _features_from(
        _pad_rows(tris.p0, pad), _pad_rows(tris.p1, pad),
        _pad_rows(tris.p2, pad), albedo=_pad_rows(tris.albedo, pad),
        fuzz=_pad_rows(tris.fuzz, pad), ior=_pad_rows(tris.ior, pad),
        mat_type=_pad_rows(tris.mat_type, pad),
        box_id=_pad_rows(tris.box_id, pad, -1), chunk=chunk)


def _features_from(p0, p1, p2, albedo, fuzz, ior, mat_type, box_id, chunk,
                   cluster_min=None, cluster_max=None, chunk_box_id=None):
    e0 = p1 - p0
    e1 = p2 - p0
    n = cross(e0, e1)                          # geometric normal
    a_col = cross(e1, e0)                      # = -n
    u_d = -cross(e1, p0)
    v_d = -cross(p0, e0)
    t_bias = -dot3(p0, n)

    norm = torch.sqrt(dot3(n, n))[:, None]
    nn = n / torch.clamp(norm, min=1e-20)
    table = torch.cat([a_col.T, u_d.T, e1.T, v_d.T, -e0.T, n.T,
                       t_bias[None], nn.T], dim=0).contiguous()
    return TriFeatures(table=table, albedo=albedo, fuzz=fuzz, ior=ior,
                       mat_type=mat_type, box_id=box_id,
                       n_chunks=p0.shape[0] // chunk, chunk=chunk,
                       cluster_min=cluster_min, cluster_max=cluster_max,
                       chunk_box_id=chunk_box_id)


def _chain(fs, ws):
    """sum_k fs[k] * ws[k] as an fma chain in k order; fs (R,1), ws (1,C)."""
    acc = fs[0] * ws[0]
    for f, w in zip(fs[1:], ws[1:]):
        acc = fma(f, w, acc)
    return acc


def mm_candidates(d, m, o, tab, t_min, gate):
    """t of R rays against the C triangles of tab (TRI_ROWS, C); gate
    (R, C) bool; BIG where a ray misses.  The port's one form of the test
    (see the module docstring)."""
    f_d = [d[:, k:k + 1] for k in range(3)]
    f_m = [m[:, k:k + 1] for k in range(3)]
    f_o = [o[:, k:k + 1] for k in range(3)]
    w = [tab[k:k + 1] for k in range(T_N)]
    a = _chain(f_d, w[T_A:T_A + 3])
    u_num = _chain(f_d + f_m, w[T_U:T_U + 6])
    v_num = _chain(f_d + f_m, w[T_V:T_V + 6])
    t_num = _chain(f_o, w[T_T:T_T + 3]) + w[T_T + 3]
    parallel = torch.abs(a) < TRI_EPS                  # gpu_kernel.cl:496
    inv_a = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    u = u_num * inv_a
    v = v_num * inv_a
    t = t_num * inv_a
    ok = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > t_min) & gate)       # strict, :520
    return torch.where(ok, t, torch.full_like(t, BIG))


def mm_closest_tri(tab, box_id, chunk: int, box_hit, o, d, t_min,
                   chunk_gate=None):
    """Closest triangle of each ray over the table's chunks in order:
    (t (R,), index (R,)), the first index of the smallest t, BIG for none.
    The last chunk may be short.  box_hit: (R, B) bool; chunk_gate:
    optional (R, n_chunks) bool, False
    where a ray cannot hit any triangle of a chunk (the rays it skips
    would find nothing there).  Rays go RAY_CHUNK at a time."""
    r = o.shape[0]
    m = cross(o, d)
    best_t = torch.full((r,), BIG, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((r,), dtype=torch.long, device=o.device)
    n_chunks = -(-tab.shape[1] // chunk)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        gate = box_gate(box_hit, box_id[sl])
        if chunk_gate is None:
            rows = torch.arange(r, device=o.device)
        else:
            rows = torch.nonzero(chunk_gate[:, c])[:, 0]
        for r0 in range(0, rows.shape[0], RAY_CHUNK):
            sel = rows[r0:r0 + RAY_CHUNK]
            tt = mm_candidates(d[sel], m[sel], o[sel], tab[:, sl], t_min,
                               gate[sel])
            ci = torch.argmin(tt, dim=1)
            ct = tt.gather(1, ci[:, None])[:, 0]
            upd = ct < best_t[sel]
            best_t[sel] = torch.where(upd, ct, best_t[sel])
            best_i[sel] = torch.where(upd, c * chunk + ci, best_i[sel])
    return best_t, best_i


def merge_triangle_hit(base: HitInfo, o, d, tri_t, tri_idx, normal, albedo,
                       fuzz, ior, mat_type) -> HitInfo:
    """The sphere hit ``base`` with the closest triangle (t, index into the
    per-triangle tables) where that is nearer; a sphere wins a tie."""
    take_tri = (tri_t < BIG) & (~base.hit | (tri_t < base.t))
    tt = take_tri[:, None]
    idx = tri_idx.clamp(0, normal.shape[0] - 1)
    outward = normal[idx]
    front_tri = dot3(d, outward) < 0.0
    normal_tri = torch.where(front_tri[:, None], outward, -outward)
    t_safe = torch.where(take_tri, tri_t, torch.ones_like(tri_t))
    return HitInfo(
        hit=base.hit | take_tri,
        t=torch.where(take_tri, tri_t, base.t),
        point=torch.where(tt, fma(t_safe[:, None], d, o), base.point),
        normal=torch.where(tt, normal_tri, base.normal),
        front_face=torch.where(take_tri, front_tri, base.front_face),
        albedo=torch.where(tt, albedo[idx], base.albedo),
        fuzz=torch.where(take_tri, fuzz[idx], base.fuzz),
        ior=torch.where(take_tri, ior[idx], base.ior),
        mat_type=torch.where(take_tri, mat_type[idx], base.mat_type))


def sphere_only(scene):
    """The scene without its triangles and boxes."""
    return dataclasses.replace(scene, triangles=scene.triangles.empty(),
                               boxes=scene.boxes.empty())


def make_mm_hit_fn(scene, t_min: float = 1e-3,
                   expected_rays: int | None = None):
    """hit_fn(o, d) with the matmul-form triangle test (the estimator's
    ``hit_fn``); spheres take the direct form.  expected_rays sizes the
    triangle chunk."""
    chunk = MM_CHUNK if expected_rays is None else min(
        MM_CHUNK, adaptive_tri_chunk(expected_rays, per_pair_cost=12))
    feats = build_tri_features(scene, chunk)
    spheres = sphere_only(scene)
    # the padding never hits (a == 0): fold over the mesh's own columns
    t = scene.triangles.count
    tab = feats.table[:, :t] if feats is not None else None

    def hit_fn(o, d):
        base = closest_hit(spheres, o, d, t_min)
        if feats is None:
            return base
        tri_t, tri_idx = mm_closest_tri(tab, feats.box_id[:t], feats.chunk,
                                        scene_box_hit(scene, o, d), o, d,
                                        t_min)
        return merge_triangle_hit(base, o, d, tri_t, tri_idx, feats.normal,
                                  feats.albedo, feats.fuzz, feats.ior,
                                  feats.mat_type)

    return hit_fn
