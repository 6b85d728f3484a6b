"""Geometry ring: the triangles sharded over the tile axis, passed from rank
to rank.

The renderer's counterpart of ring attention (the JAX package's
``parallel/ring.py``): when a triangle soup is too large for one device,
or to split the rays x triangles product, each rank of a tile group keeps
one shard of the triangles.  The rays stay where they are; each of n steps
folds the closest hit over the shard a rank holds into a running record
and passes the shard on to the next tile's rank (``mesh.ring_shift``, the
counterpart of ``ppermute``).  The fold is exact: the minimum over a
partition of the triangles is the minimum over all of them (the closest-so-
far fold of ``HitAnything``, ``gpu_kernel.cl:358-394``).

Every rank of a ring must call a ring's hit_fn equally often; the bounce
loops of ``render_rows`` end together when they take ``any_alive`` from
``mesh.any_over`` (``render_sharded`` passes it for a hit_fn whose
attribute ``collective`` is true, as this module's are).
"""

from __future__ import annotations

import dataclasses

import torch

from ..kernels.intersect_mm import (MESH_CHUNK, MeshTables, closest_tri,
                                    empty_tables, mesh_tables)
from ..scene import Scene, Spheres, Triangles
from ..tracer.intersect import HitInfo, closest_hit
from ..tracer.mesh_accel import TriFeatures, merge_triangle_hit, sphere_only
from .mesh import Mesh, gather_objects, ring_shift

_TRI_FIELDS = ("p0", "p1", "p2", "albedo", "fuzz", "ior", "mat_type",
               "box_id")


def shard_triangles(tris: Triangles, n_shards: int) -> Triangles:
    """The triangle batch padded to n_shards equal parts with degenerate
    triangles that never hit (zeros, box_id -1); shard k is rows
    [k * per, (k + 1) * per) with per = ceil(count / n_shards)."""
    per = -(-tris.count // n_shards)
    pad = per * n_shards - tris.count

    def pad_leaf(x, fill=0):
        tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    return Triangles(*(pad_leaf(getattr(tris, f), -1 if f == "box_id" else 0)
                       for f in _TRI_FIELDS))


def local_shard(tris: Triangles, mesh: Mesh) -> Triangles:
    """This rank's shard of ``shard_triangles(tris, mesh.n_tile)``."""
    per = tris.count // mesh.n_tile
    rows = slice(mesh.tile_index * per, (mesh.tile_index + 1) * per)
    return Triangles(*(getattr(tris, f)[rows] for f in _TRI_FIELDS))


def _merge(a: HitInfo, b: HitInfo) -> HitInfo:
    """Two closest-hit records folded: the nearer hit per ray, a on a
    tie."""
    take_b = b.hit & (~a.hit | (b.t < a.t))
    tb = take_b[:, None]
    return HitInfo(
        hit=a.hit | b.hit, t=torch.where(take_b, b.t, a.t),
        point=torch.where(tb, b.point, a.point),
        normal=torch.where(tb, b.normal, a.normal),
        front_face=torch.where(take_b, b.front_face, a.front_face),
        albedo=torch.where(tb, b.albedo, a.albedo),
        fuzz=torch.where(take_b, b.fuzz, a.fuzz),
        ior=torch.where(take_b, b.ior, a.ior),
        mat_type=torch.where(take_b, b.mat_type, a.mat_type))


def ring_hit_fn(scene_local: Scene, mesh: Mesh, t_min: float = 1e-3):
    """hit_fn(o, d) -> HitInfo over every rank's triangles, for a rank
    whose ``scene_local`` holds its shard of ``shard_triangles`` (spheres
    and boxes the whole scene's): the spheres once, then n steps of
    ``closest_hit`` over the shard held, the padded leaves passed on
    after each step but the last.  The hit_fn calls collectives: its
    attribute ``collective`` is True."""
    spheres = sphere_only(scene_local)
    no_spheres = Spheres.empty().to(scene_local.spheres.center.device)

    def hit_fn(o, d):
        best = closest_hit(spheres, o, d, t_min)
        tris = scene_local.triangles
        for step in range(mesh.n_tile):
            shard = dataclasses.replace(scene_local, spheres=no_spheres,
                                        triangles=tris)
            best = _merge(best, closest_hit(shard, o, d, t_min))
            if step + 1 < mesh.n_tile:
                leaves = [getattr(tris, f) for f in _TRI_FIELDS]
                tris = Triangles(*ring_shift(
                    leaves, [(x.shape, x.dtype) for x in leaves], mesh))
        return best

    hit_fn.collective = True
    return hit_fn


# The fields of the closest-triangle tables that ride the ring, then those
# of their per-triangle features.
_TABLE_FIELDS = ("tri", "cluster", "sub", "chunk_box", "group", "group_end",
                 "tri_major")
_FEAT_FIELDS = ("albedo", "fuzz", "ior", "mat_type", "box_id")


def _shard_tables(scene_local: Scene) -> list:
    """The closest-triangle tables of the real triangles (box_id >= 0) of
    this rank's shard, as the flat list that rides the ring: the tables'
    ``_TABLE_FIELDS``, then their features' ``_FEAT_FIELDS`` (plan
    order).  A shard of padding alone has ``empty_tables``' fields (no
    chunk) and no features."""
    tris = scene_local.triangles
    real = tris.box_id >= 0
    if not bool(real.any()):
        t = empty_tables(tris.p0.device)
        return [getattr(t, f) for f in _TABLE_FIELDS]
    shard = dataclasses.replace(scene_local, triangles=Triangles(
        *(getattr(tris, f)[real] for f in _TRI_FIELDS)))
    t = mesh_tables(shard)
    return ([getattr(t, f) for f in _TABLE_FIELDS]
            + [getattr(t.feats, f) for f in _FEAT_FIELDS])


def _tables_from(ride: list, boxes: torch.Tensor) -> MeshTables | None:
    """The tables of a ``_shard_tables`` list, None for a shard of padding
    alone."""
    if len(ride) == len(_TABLE_FIELDS):
        return None
    tab = dict(zip(_TABLE_FIELDS, ride))
    feats = TriFeatures(table=tab["tri"],
                        **dict(zip(_FEAT_FIELDS, ride[len(_TABLE_FIELDS):])),
                        n_chunks=tab["chunk_box"].shape[0], chunk=MESH_CHUNK)
    return MeshTables(**tab, boxes=boxes, feats=feats, plan=None)


def ring_hit_fn_mm(scene_local: Scene, mesh: Mesh, t_min: float = 1e-3):
    """The rotation of ``ring_hit_fn`` with each step's intersection on the
    closest-triangle route: ``intersect_mm.closest_tri`` over the tables
    of the shard held (K3 on the card, on the CPU its plain version, the
    matmul-form fold of ``tracer/mesh_accel.py``).

    As in the JAX package, each rank builds its own shard's tables once,
    here (from its real triangles: padding never hits, and K3's tables
    take only triangles in a gating box), and the built tables ride the
    ring, not the triangles: no step rebuilds anything, and a rank holds
    one shard's tables at a time.  The shards' tables differ in shape, so
    the ranks exchange their lists' shapes and dtypes once, here (a
    collective: every rank of the tile group builds its hit_fn together).
    The hit_fn calls collectives: its attribute ``collective`` is True."""
    spheres = sphere_only(scene_local)
    boxes = torch.cat([scene_local.boxes.box_min, scene_local.boxes.box_max],
                      dim=1).contiguous()
    own = _shard_tables(scene_local)
    specs = gather_objects([(tuple(x.shape), x.dtype) for x in own], mesh)
    ti, n = mesh.tile_index, mesh.n_tile

    def hit_fn(o, d):
        best = closest_hit(spheres, o, d, t_min)
        oc, dc = o.contiguous(), d.contiguous()
        ride = own
        for step in range(n):
            tab = _tables_from(ride, boxes)
            if tab is not None:
                tri_t, tri_idx = closest_tri(tab, oc, dc, t_min)
                f = tab.feats
                best = merge_triangle_hit(best, o, d, tri_t, tri_idx,
                                          f.normal, f.albedo, f.fuzz, f.ior,
                                          f.mat_type)
            if step + 1 < n:
                # the next step holds the shard of tile ti - step - 1
                ride = ring_shift(ride, specs[(ti - step - 1) % n], mesh)
        return best

    hit_fn.collective = True
    return hit_fn
