"""Spatial triangle clustering (BVH-leaf ordering) for chunk culling.

The reference tests every ray against every triangle behind one mesh-level
AABB (``gpu_kernel.cl:374-391``).  Here, as in the JAX package's
``tracer/clusters.py``, the triangles are put into a spatially coherent
order once per scene, on the host, in numpy:

1. triangles are grouped by ``box_id``, and each group is ordered by a
   median-split BVH over centroids whose split axis is the one with the
   smallest summed child AABB area; BVH leaves become contiguous runs;
2. each group is padded to a chunk multiple (padding is -1), so that every
   fixed-size chunk has one gating box;
3. with an ``eye``, chunks are sorted front to back by the distance of
   their nearest centroid, so that entry-t culling fires early.

Each chunk then gets a slightly padded AABB (``cluster_bounds``), and each
run of chunk/k triangles one more (``subcluster_bounds``).  A triangle lies
inside both boxes, so skipping a chunk or a run whose box a ray misses
gives the image of the brute-force scan.

The plan is the JAX package's byte for byte (``np.argpartition`` decides
the order, so the algorithm is copied exactly), and so are the bounds but
for the runs that hold only padding (``subcluster_bounds``).  The plan's
cache key covers the whole triangle arrays, since a fitted mesh changes
rows that a sample of them could skip.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch


class MeshPlan(NamedTuple):
    """Clustering plan, built on the host from concrete triangles."""

    perm_bytes: bytes            # (n_chunks*chunk,) i32; -1 marks padding
    chunk_box_id: tuple          # per-chunk gating box id
    n_chunks: int
    chunk: int
    n_tris: int

    @property
    def perm(self) -> np.ndarray:
        return np.frombuffer(self.perm_bytes, np.int32)


def _bvh_order(idx: np.ndarray, cent: np.ndarray, leaf: int,
               tlo: np.ndarray | None = None,
               thi: np.ndarray | None = None) -> list:
    """Median-split ordering: halve nodes until they fit one leaf; the
    index runs in BVH order.  Each node splits on the axis whose two
    median halves have the smallest summed AABB surface area (over the
    triangle AABBs tlo/thi, else over the centroids)."""
    lo = cent if tlo is None else tlo
    hi = cent if thi is None else thi
    out = []
    stack = [idx]
    while stack:
        ids = stack.pop()
        if ids.size <= leaf:
            out.append(ids)
            continue
        c = cent[ids]
        k = ids.size // 2
        best = None
        for ax in range(3):
            part = np.argpartition(c[:, ax], k)
            sa = 0.0
            for side in (ids[part[:k]], ids[part[k:]]):
                d = hi[side].max(axis=0) - lo[side].min(axis=0)
                sa += 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
            if best is None or sa < best[0]:
                best = (sa, part)
        part = best[1]
        # push right first so pops traverse left-to-right
        stack.append(ids[part[k:]])
        stack.append(ids[part[:k]])
    return out


def build_mesh_plan(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                    box_id: np.ndarray, chunk: int = 512,
                    eye: np.ndarray | None = None) -> MeshPlan:
    """The clustering plan of numpy triangle data; eye (the camera
    position) orders the chunks front to back by their nearest centroid."""
    t = p0.shape[0]
    cent = (p0 + p1 + p2) / 3.0
    pts = np.stack([p0, p1, p2], axis=1)
    tlo, thi = pts.min(axis=1), pts.max(axis=1)
    order_parts = []
    chunk_bids = []
    for b in np.unique(box_id):
        ids = np.nonzero(box_id == b)[0].astype(np.int32)
        runs = _bvh_order(ids, cent, chunk, tlo, thi)
        grouped = np.concatenate(runs) if runs else ids
        pad = (-grouped.size) % chunk
        grouped = np.concatenate([grouped, np.full((pad,), -1, np.int32)])
        order_parts.append(grouped)
        chunk_bids.extend([int(b)] * (grouped.size // chunk))
    perm = (np.concatenate(order_parts) if order_parts
            else np.zeros((0,), np.int32))
    if eye is not None and perm.size:
        n_chunks = perm.size // chunk
        key = []
        for ci in range(n_chunks):
            ids = perm[ci * chunk:(ci + 1) * chunk]
            ids = ids[ids >= 0]
            key.append(float(np.linalg.norm(cent[ids] - eye[None, :],
                                            axis=1).min())
                       if ids.size else np.inf)
        order = np.argsort(np.asarray(key), kind="stable")
        perm = np.concatenate([perm[ci * chunk:(ci + 1) * chunk]
                               for ci in order])
        chunk_bids = [chunk_bids[ci] for ci in order]
    return MeshPlan(perm_bytes=perm.astype(np.int32).tobytes(),
                    chunk_box_id=tuple(chunk_bids),
                    n_chunks=perm.size // chunk if chunk else 0,
                    chunk=chunk, n_tris=t)


_PLAN_CACHE: dict = {}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def plan_for_scene(scene, chunk: int = 512) -> MeshPlan | None:
    """The cached plan of a scene's triangles (eye: the camera position);
    None when the scene has no triangles."""
    tris = scene.triangles
    if tris.count == 0:
        return None
    arrays = [_numpy(x) for x in (tris.p0, tris.p1, tris.p2, tris.box_id)]
    eye = _numpy(scene.camera.look_from).astype(np.float64)
    digest = hashlib.sha256()
    for a in (*arrays, eye):
        digest.update(np.ascontiguousarray(a).tobytes())
    key = (digest.hexdigest(), tris.count, chunk)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = build_mesh_plan(*arrays, chunk, eye=eye)
        if len(_PLAN_CACHE) > 32:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plan
    return plan


def permute(x, plan: MeshPlan, fill=0.0):
    """The plan's order of a per-triangle tensor; padding rows get
    ``fill``."""
    perm = torch.as_tensor(plan.perm.astype(np.int64), device=x.device)
    out = x[perm.clamp(min=0)]
    mask = perm >= 0
    if out.dim() > 1:
        mask = mask[:, None]
    return torch.where(mask, out, torch.full_like(out, fill))


def _corner_bounds(p0, p1, p2, plan: MeshPlan):
    """Per-triangle AABB corners in plan order, padding rows inverted."""
    valid = torch.as_tensor(plan.perm >= 0, device=p0.device)[:, None, None]
    pts = torch.stack([p0, p1, p2], dim=1)           # (T_pad, 3, 3)
    big = torch.full_like(pts, 3.4e38)
    lo = torch.where(valid, pts, big).amin(dim=1)
    hi = torch.where(valid, pts, -big).amax(dim=1)
    return lo, hi


def cluster_bounds(p0, p1, p2, plan: MeshPlan, rel_eps: float = 1e-4,
                   abs_eps: float = 1e-5):
    """Per-chunk AABBs of the permuted corners (n_chunks*chunk, 3),
    padded by ext * rel_eps + abs_eps so that the slab test stays
    conservative (the reference's strict ``tmax > tmin`` misses flat
    boxes, ``gpu_kernel.cl:534-555``).  Returns (cmin, cmax), each
    (n_chunks, 3)."""
    lo, hi = _corner_bounds(p0, p1, p2, plan)
    cmin = lo.reshape(plan.n_chunks, plan.chunk, 3).amin(dim=1)
    cmax = hi.reshape(plan.n_chunks, plan.chunk, 3).amax(dim=1)
    pad = (cmax - cmin).amax(dim=-1, keepdim=True) * rel_eps + abs_eps
    return cmin - pad, cmax + pad


def subcluster_bounds(p0, p1, p2, plan: MeshPlan, k: int,
                      rel_eps: float = 1e-4, abs_eps: float = 1e-5):
    """k AABBs per chunk, over its consecutive runs of chunk/k triangles,
    padded as in ``cluster_bounds``.  An all-padding run gets min = max =
    3.4e38 on every axis: the slab test (``hit_aabbs``, ``csrc/mesh.cuh``)
    finds each axis's entry and exit equal, so its exit is never after its
    entry and no ray enters the run.  (The JAX package gives such a run the
    inverted box [3.4e38, -3.4e38], which that test, taking the min and max
    of the two plane distances, would hit.)  Returns (n_chunks*k, 6)
    [min, max] rows."""
    if plan.chunk % k:
        raise ValueError("k must divide the plan's chunk")
    lo, hi = _corner_bounds(p0, p1, p2, plan)
    sub = plan.chunk // k
    cmin = lo.reshape(plan.n_chunks * k, sub, 3).amin(dim=1)
    cmax = hi.reshape(plan.n_chunks * k, sub, 3).amax(dim=1)
    cmax = torch.where(cmin > cmax, cmin, cmax)      # all-padding runs
    ext = torch.clamp(cmax - cmin, min=0.0).amax(dim=-1, keepdim=True)
    pad = ext * rel_eps + abs_eps
    return torch.cat([cmin - pad, cmax + pad], dim=1)
