"""The closest-triangle kernel: (t, index) of the closest triangle of each
ray of a batch, on the card.

``closest_tri`` is the wrapper of the CUDA kernel in
``csrc/intersect_mm.cu`` (one thread per ray, the plan's chunks culled per
ray and staged in shared memory per block; see the note at the top of that
file).  It replaces the JAX package's Pallas
``kernels/intersect_mm.py::_make_kernel``.  ``closest_tri_plain`` is its
plain PyTorch version with the same signature: ``mesh_accel``'s matmul-form
fold over the same tables in the same plan order, so that both return the
first index of the smallest t.  The wrapper runs it for tensors on the CPU
and nowhere else.

``mesh_tables`` builds the tables both this kernel and the mesh megakernel
read: the triangle table in the plan's order (``MESH_CHUNK`` triangles per
chunk, front to back from the camera), the chunks' padded AABBs and
sub-boxes, each chunk's gating box and the gating boxes, and over the
chunks a second level (``group_tables``): groups of up to ``MESH_GROUP``
consecutive chunks of one gating box, each with the union of its chunks'
AABBs, which the mesh megakernel's walk and the mesh backward kernels'
test first; and the triangle table's triangle-major copy (``tri_major``,
one 96-byte row a triangle) that the mesh megakernel and the HDR emit
pass read their triangle tests from.  It keeps the
tables of the last few scenes, keyed by a digest of the leaves they are
built from (``leaves_key``).  Given a plan, it builds them from the
scene's current vertices in that plan's order: a fit that moves the
vertices keeps its first plan and rebuilds only the tables and bounds.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..scene import scene_to_numpy
from ..tracer.clusters import (MeshPlan, permute, plan_for_scene,
                               subcluster_bounds)
from ..tracer.intersect import closest_hit, hit_aabbs
from ..tracer.mesh_accel import (RAY_CHUNK, TRI_ROWS, T_N, TriFeatures,
                                 build_tri_features, merge_triangle_hit,
                                 mm_closest_tri, sphere_only)
from . import _build

# Triangles per plan chunk and sub-boxes per chunk (the kernels' kChunk and
# kSub, csrc/mesh.cuh): runs of 16 triangles, a chunk's AABB in front of
# eight sub-boxes.
MESH_CHUNK = 128
MESH_SUB_BOXES = 8
# Chunks per group at most (the kernels' kGroup, csrc/mesh.cuh).
MESH_GROUP = 8
# Entries of each host-side cache of built tables.
CACHE_ENTRIES = 8

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"closest_tri_launch": (
    [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _I, ctypes.c_float, _P, _P, _P,
     _P], _I)}


def _library():
    return _build.load("intersect_mm", _SYMBOLS)


class MeshTables(NamedTuple):
    """The triangles of a scene as the mesh kernels read them."""
    tri: torch.Tensor        # (TRI_ROWS, T_pad) f32, plan order
    cluster: torch.Tensor    # (n_chunks, 6) f32 [min, max]
    sub: torch.Tensor        # (n_chunks * MESH_SUB_BOXES, 6) f32
    chunk_box: torch.Tensor  # (n_chunks,) i32
    boxes: torch.Tensor      # (n_boxes, 6) f32
    feats: TriFeatures       # per-triangle materials, plan order
    plan: MeshPlan           # the order: plan.perm maps columns to ids
    group: torch.Tensor      # (n_groups, 6) f32 [min, max]
    group_end: torch.Tensor  # (n_groups,) i32, each group's last chunk + 1
    tri_major: torch.Tensor  # (T_pad, 24) f32: tri's columns, 2 zeros each


def group_tables(cluster: torch.Tensor, chunk_box: torch.Tensor,
                 size: int = MESH_GROUP):
    """The second level over the chunks: (group (n_groups, 6) f32, group_end
    (n_groups,) i32).  Groups hold up to ``size`` consecutive chunks in plan
    order and never chunks of two gating boxes; a group's box is the exact
    union (min of the mins, max of the maxes) of its chunks' AABBs, so it
    contains each of them bit for bit."""
    boxes = chunk_box.tolist()
    ends = []
    for ci in range(1, len(boxes) + 1):
        start = ends[-1] if ends else 0
        if (ci == len(boxes) or boxes[ci] != boxes[start]
                or ci - start == size):
            ends.append(ci)
    rows = [torch.cat([cluster[a:b, :3].amin(0), cluster[a:b, 3:].amax(0)])
            for a, b in zip([0] + ends[:-1], ends)]
    group = (torch.stack(rows) if rows
             else cluster.new_zeros((0, 6))).contiguous()
    return group, torch.tensor(ends, dtype=torch.int32,
                               device=cluster.device)


def table_args(tab: MeshTables) -> tuple:
    """The tables as the kernels' entry points take them: tri, t_pad,
    cluster, sub, chunk_box, n_chunks, boxes, n_boxes, group, group_end,
    n_groups, tri_major (pointers and counts)."""
    return (tab.tri.data_ptr(), tab.tri.shape[1], tab.cluster.data_ptr(),
            tab.sub.data_ptr(), tab.chunk_box.data_ptr(),
            tab.chunk_box.shape[0], tab.boxes.data_ptr(), tab.boxes.shape[0],
            tab.group.data_ptr(), tab.group_end.data_ptr(),
            tab.group_end.shape[0], tab.tri_major.data_ptr())


# ctypes argument types of table_args.
TABLE_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def leaves_key(leaves: dict, *extra) -> tuple:
    """A cache key of numpy leaves: the SHA-256 of their paths, dtypes,
    shapes and bytes, followed by ``extra``."""
    digest = hashlib.sha256()
    for path in sorted(leaves):
        a = np.ascontiguousarray(leaves[path])
        digest.update(f"{path}:{a.dtype}:{a.shape};".encode())
        digest.update(a)
    return (digest.hexdigest(), *extra)


def cached(cache: dict, key, build):
    """cache[key], built first when missing; the oldest of CACHE_ENTRIES
    entries goes."""
    value = cache.get(key)
    if value is None:
        value = build()
        if len(cache) >= CACHE_ENTRIES:
            cache.pop(next(iter(cache)))
        cache[key] = value
    return value


_TABLES: dict = {}


def mesh_tables(scene, leaves: dict | None = None,
                plan: MeshPlan | None = None) -> MeshTables:
    """The tables of a scene with triangles in one or more gating boxes, on
    the scene's device.  leaves: the scene's ``scene_to_numpy``, when the
    caller has read it already.  plan: the order to build them in (a plan
    of the same triangle count and chunk, ``MESH_CHUNK``), by default the
    scene's own (``clusters.plan_for_scene``)."""
    tris = scene.triangles
    if tris.count == 0 or scene.boxes.count == 0:
        raise ValueError("the mesh kernels take triangles in one or more "
                         "gating boxes")
    leaves = scene_to_numpy(scene) if leaves is None else leaves
    key = leaves_key({p: a for p, a in leaves.items()
                      if p.startswith(("triangles.", "boxes."))
                      or p == "camera.look_from"}, str(tris.p0.device),
                     None if plan is None else plan_key(plan))
    return cached(_TABLES, key, lambda: _build_tables(scene, plan))


def plan_key(plan: MeshPlan) -> str:
    """A digest of a plan's order and chunk boxes."""
    return hashlib.sha256(plan.perm_bytes + repr(
        (plan.chunk_box_id, plan.chunk, plan.n_tris)).encode()).hexdigest()


@torch.no_grad()
def _build_tables(scene, plan: MeshPlan | None = None) -> MeshTables:
    tris = scene.triangles
    if plan is None:
        plan = plan_for_scene(scene, MESH_CHUNK)
    if plan.chunk != MESH_CHUNK or plan.n_tris != tris.count:
        raise ValueError("the plan does not fit the scene's triangles")
    if not all(0 <= b < scene.boxes.count for b in plan.chunk_box_id):
        raise ValueError("every triangle's box_id must name a gating box")
    feats = build_tri_features(scene, MESH_CHUNK, plan=plan)
    sub = subcluster_bounds(permute(tris.p0, plan), permute(tris.p1, plan),
                            permute(tris.p2, plan), plan, MESH_SUB_BOXES)
    dev = tris.p0.device
    cluster = torch.cat([feats.cluster_min, feats.cluster_max],
                        dim=1).contiguous()
    chunk_box = torch.tensor(plan.chunk_box_id, dtype=torch.int32,
                             device=dev)
    group, group_end = group_tables(cluster, chunk_box)
    return MeshTables(
        tri=feats.table, cluster=cluster, sub=sub.contiguous(),
        chunk_box=chunk_box,
        boxes=torch.cat([scene.boxes.box_min, scene.boxes.box_max],
                        dim=1).contiguous(),
        feats=feats, plan=plan, group=group, group_end=group_end,
        tri_major=triangle_major(feats.table))


def triangle_major(tri: torch.Tensor) -> torch.Tensor:
    """The triangle table (TRI_ROWS, T_pad) as the kernels' triangle-major
    copy: (T_pad, 24), a triangle's 22 rows and 2 zeros in one 96-byte
    row, so that a triangle test reads five float4."""
    return torch.nn.functional.pad(tri.T, (0, 24 - TRI_ROWS)).contiguous()


def empty_tables(device) -> MeshTables:
    """The tables of a scene without triangles, which the mesh megakernel
    and the HDR kernels take for a sphere scene under an HDR sky: no
    chunk, no gating box, no group, no plan."""
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MeshTables(tri=zeros(TRI_ROWS, 0), cluster=zeros(0, 6),
                      sub=zeros(0, 6), chunk_box=zeros(0, dtype=torch.int32),
                      boxes=zeros(0, 6), feats=None, plan=None,
                      group=zeros(0, 6),
                      group_end=zeros(0, dtype=torch.int32),
                      tri_major=zeros(0, 24))


def check_tables(tab: MeshTables, allow_empty: bool = False) -> None:
    """Raise unless the tables are what the kernels read (shapes, types and
    devices; the chunks' box ids and the groups' ends are checked when
    ``mesh_tables`` builds them, so that a launch reads nothing back from
    the card); ``allow_empty`` also takes ``empty_tables``."""
    n_chunks = tab.chunk_box.shape[0]
    n_groups = tab.group_end.shape[0]
    shapes = ((tab.tri, (TRI_ROWS, n_chunks * MESH_CHUNK), torch.float32),
              (tab.cluster, (n_chunks, 6), torch.float32),
              (tab.sub, (n_chunks * MESH_SUB_BOXES, 6), torch.float32),
              (tab.chunk_box, (n_chunks,), torch.int32),
              (tab.boxes, (tab.boxes.shape[0], 6), torch.float32),
              (tab.group, (n_groups, 6), torch.float32),
              (tab.group_end, (n_groups,), torch.int32),
              (tab.tri_major, (n_chunks * MESH_CHUNK, 24), torch.float32))
    for t, shape, dtype in shapes:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != tab.tri.device):
            raise ValueError("mesh tables do not match mesh_tables()")
    if allow_empty and n_chunks == 0 and tab.boxes.shape[0] == 0 \
            and n_groups == 0:
        return
    if n_chunks < 1 or tab.boxes.shape[0] < 1 or not 1 <= n_groups <= n_chunks:
        raise ValueError("the mesh kernels take one or more chunks, gating "
                         "boxes and groups")


def _check_rays(tab, o, d, tests):
    for name, x in (("o", o), ("d", d)):
        if (x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2
                or x.shape[1] != 3 or x.device != tab.tri.device):
            raise ValueError(f"{name} must be contiguous float32 (R, 3) on "
                             "the tables' device")
    if o.shape != d.shape or o.shape[0] >= 2**31:
        raise ValueError("o and d must have the same shape")
    if tests is not None and (tests.dtype != torch.int64
                              or tests.numel() != 1
                              or tests.device != o.device):
        raise ValueError("tests must be one int64 on the rays' device")


def closest_tri(tab: MeshTables, o, d, t_min: float, tests=None):
    """(t (R,) f32, index (R,) int64) of the closest triangle of each ray:
    the first index, in the tables' plan order, of the smallest t among the
    triangles whose gating box the ray hits; t = BIG for none.  tests: an
    optional one-element int64 tensor that receives the number of triangle
    tests run.  CUDA tensors launch the kernel; CPU tensors run
    ``closest_tri_plain``."""
    global LAUNCHES
    check_tables(tab)
    _check_rays(tab, o, d, tests)
    if o.device.type == "cpu":
        return closest_tri_plain(tab, o, d, t_min, tests)
    if o.device.type != "cuda":
        raise ValueError(f"no kernel for device {o.device}")
    r = o.shape[0]
    out_t = torch.empty((r,), dtype=torch.float32, device=o.device)
    out_i = torch.empty((r,), dtype=torch.int32, device=o.device)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().closest_tri_launch(
            tab.tri.data_ptr(), tab.tri.shape[1], tab.cluster.data_ptr(),
            tab.sub.data_ptr(), tab.chunk_box.data_ptr(),
            tab.chunk_box.shape[0], tab.boxes.data_ptr(), tab.boxes.shape[0],
            o.data_ptr(), d.data_ptr(), r, t_min, out_t.data_ptr(),
            out_i.data_ptr(), tests.data_ptr() if tests is not None else None,
            stream)
    if rc != 0:
        raise RuntimeError(f"closest-triangle launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out_t, out_i.long()


def closest_tri_plain(tab: MeshTables, o, d, t_min: float, tests=None):
    """The plain PyTorch version of ``closest_tri``, on the tables' device:
    the matmul-form fold (``mesh_accel.mm_closest_tri``) over the chunks in
    plan order, each for the rays that hit its gating box and its AABB.
    tests receives the triangle tests of the chunks each ray entered (the
    kernel's count also culls by entry t and sub-box, so it is smaller)."""
    t, idx = [], []
    for r0 in range(0, o.shape[0], RAY_CHUNK):
        os_, ds = o[r0:r0 + RAY_CHUNK], d[r0:r0 + RAY_CHUNK]
        box_hit = hit_aabbs(os_, ds, tab.boxes[:, :3], tab.boxes[:, 3:])
        gate = (hit_aabbs(os_, ds, tab.cluster[:, :3], tab.cluster[:, 3:])
                & box_hit[:, tab.chunk_box.long()])
        if tests is not None:
            tests += gate.sum() * MESH_CHUNK
        ct, ci = mm_closest_tri(tab.tri, tab.feats.box_id, MESH_CHUNK,
                                box_hit, os_, ds, t_min, chunk_gate=gate)
        t.append(ct)
        idx.append(ci)
    if not t:
        return (torch.empty((0,), dtype=o.dtype, device=o.device),
                torch.empty((0,), dtype=torch.long, device=o.device))
    return torch.cat(t), torch.cat(idx)


def tri_hit_fn(tab: MeshTables, sphere_scene, t_min: float, closest,
               material=None):
    """hit_fn(o, d) of a scene whose triangles the tables hold: the direct
    sphere hit of ``sphere_scene`` merged with ``closest(tab, o, d, t_min)``
    (``closest_tri`` or ``closest_tri_plain``), the winner taking the
    table's normal and its material: (albedo, fuzz, ior, mat_type) per
    triangle in plan order, by default the scene's (``tab.feats``)."""
    f = tab.feats
    albedo, fuzz, ior, mat_type = (
        material if material is not None
        else (f.albedo, f.fuzz, f.ior, f.mat_type))
    normal = tab.tri[T_N:T_N + 3].T

    def hit_fn(o, d):
        base = closest_hit(sphere_scene, o, d, t_min)
        tri_t, tri_idx = closest(tab, o.contiguous(), d.contiguous(), t_min)
        return merge_triangle_hit(base, o, d, tri_t, tri_idx, normal, albedo,
                                  fuzz, ior, mat_type)

    return hit_fn


def make_kernel_hit_fn(scene, t_min: float = 1e-3):
    """The estimator's hit_fn with the closest-triangle kernel (the
    plain tracer's triangle hit on the card)."""
    return tri_hit_fn(mesh_tables(scene), sphere_only(scene), t_min,
                      closest_tri)
