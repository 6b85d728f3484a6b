"""The mesh tables' second level (``intersect_mm.group_tables``): groups
of up to ``MESH_GROUP`` consecutive chunks of one gating box, in plan
order, each with the exact union of its chunks' AABBs, which the kernels'
grouped walk tests before a group's chunks (csrc/mesh.cuh); and the
triangle table's triangle-major copy (``tri_major``).  A group's box
holds its chunks' boxes bit for bit, so the grouped walk culls no chunk the
earlier walk over every chunk would test; that the two walks run the same
triangle tests is checked on the card (test_torch_kernels_gpu.py and
chip_smoke.py's K2 split).  No kernel runs here and nothing is
jit-compiled: the JAX plan's chunk bounds run eagerly on a few arrays."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.io.obj import load_obj as jax_load_obj
from opencl_ray_tracer_tpu.tracer import clusters as jcl
from opencl_ray_tracer_tpu_torch.io import load_obj, parse_obj
from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im

torch.set_num_threads(1)
TORUS = os.path.join(os.path.dirname(__file__), "..", "assets", "torus.obj")
XFORM = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))


def _torus_576():
    tris, aabb = load_obj(TORUS, *XFORM)
    return ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)


def _boxes_by(scene, bid: np.ndarray):
    """The scene with triangle i in gating box bid[i], each box its
    triangles' bounds."""
    t = scene.triangles
    bid = torch.tensor(bid, dtype=torch.int32)
    pts = torch.stack([t.p0, t.p1, t.p2], 1)
    n = int(bid.max()) + 1
    lo = torch.stack([pts[bid == b].reshape(-1, 3).amin(0) for b in range(n)])
    hi = torch.stack([pts[bid == b].reshape(-1, 3).amax(0) for b in range(n)])
    return dataclasses.replace(
        scene, triangles=dataclasses.replace(t, box_id=bid),
        boxes=ot.BoundingBoxes(lo, hi))


def _torus_2304_two_boxes():
    """2,304 triangles, the first 1,000 in one box and the rest in
    another: 8 and 11 chunks, neither a multiple of MESH_GROUP."""
    tris, aabb = parse_obj(make_torus_obj(48, 24), *XFORM)
    scene = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
    return _boxes_by(scene, (np.arange(2304) >= 1000).astype(np.int32))


def _torus_576_seven_boxes():
    scene = _torus_576()
    return _boxes_by(scene, (np.arange(576) % 7).astype(np.int32))


SCENES = {"torus_576": _torus_576, "torus_2304_two_boxes":
          _torus_2304_two_boxes,
          "torus_576_seven_boxes": _torus_576_seven_boxes}


@pytest.mark.parametrize("case", sorted(SCENES))
def test_groups_hold_their_chunks_in_plan_order(case):
    tab = im.mesh_tables(SCENES[case]())
    im.check_tables(tab)
    n_chunks = tab.chunk_box.shape[0]
    ends = tab.group_end.tolist()
    starts = [0] + ends[:-1]
    # consecutive chunks in plan order, rising to the chunk count
    assert ends[-1] == n_chunks
    assert all(0 < b - a <= im.MESH_GROUP for a, b in zip(starts, ends))
    box = tab.chunk_box.tolist()
    for g, (a, b) in enumerate(zip(starts, ends)):
        # one gating box a group, and a new group where the box changes
        assert len(set(box[a:b])) == 1
        assert b == n_chunks or box[b] != box[a] or b - a == im.MESH_GROUP
        # every chunk AABB inside its group's box, the box their union
        lo, hi = tab.group[g, :3], tab.group[g, 3:]
        assert (tab.cluster[a:b, :3] >= lo).all()
        assert (tab.cluster[a:b, 3:] <= hi).all()
        assert torch.equal(lo, tab.cluster[a:b, :3].amin(0))
        assert torch.equal(hi, tab.cluster[a:b, 3:].amax(0))
    if case != "torus_576":
        assert len(set(box)) > 1


def test_group_split_rule():
    chunk_box = torch.tensor([0] * 10 + [1] * 3 + [0] * 2 + [2] * 16,
                             dtype=torch.int32)
    cluster = torch.arange(chunk_box.shape[0] * 6, dtype=torch.float32)
    cluster = cluster.reshape(-1, 6)
    group, ends = im.group_tables(cluster, chunk_box)
    assert ends.tolist() == [8, 10, 13, 15, 23, 31]
    assert ends.dtype == torch.int32 and group.shape == (6, 6)
    assert torch.equal(group[0], torch.cat([cluster[0, :3], cluster[7, 3:]]))


@pytest.mark.parametrize("fault", ["group_width", "group_end_dtype",
                                   "more_groups_than_chunks", "no_group",
                                   "tri_major_width"])
def test_check_tables_refuses_bad_groups(fault):
    tab = im.mesh_tables(_torus_2304_two_boxes())
    bad = {
        "group_width": dict(group=tab.group[:, :5].contiguous()),
        "group_end_dtype": dict(group_end=tab.group_end.long()),
        "more_groups_than_chunks": dict(
            group=torch.zeros((tab.chunk_box.shape[0] + 1, 6)),
            group_end=torch.arange(1, tab.chunk_box.shape[0] + 2,
                                   dtype=torch.int32)),
        "no_group": dict(group=torch.zeros((0, 6)),
                         group_end=torch.zeros((0,), dtype=torch.int32)),
        "tri_major_width": dict(tri_major=tab.tri.T.contiguous()),
    }[fault]
    with pytest.raises(ValueError):
        im.check_tables(tab._replace(**bad))


@pytest.mark.parametrize("case", sorted(SCENES))
def test_triangle_major_copy_holds_the_table(case):
    """tri_major, which K2 and K6 read their triangle tests from: column j
    of the (22, T_pad) table as row j, then two zeros (96 bytes)."""
    tab = im.mesh_tables(SCENES[case]())
    assert tab.tri_major.shape == (tab.tri.shape[1], 24)
    assert torch.equal(tab.tri_major[:, :22], tab.tri.T)
    assert not tab.tri_major[:, 22:].any()


def test_empty_tables_have_no_group():
    tab = im.empty_tables("cpu")
    im.check_tables(tab, allow_empty=True)
    assert tab.group.shape == (0, 6) and tab.group_end.shape == (0,)
    assert tab.tri_major.shape == (0, 24)


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_chunk_aabbs_match_the_jax_plan():
    """The kernels' chunk AABBs, which the groups are built over, against
    the JAX package's plan and ``cluster_bounds`` for the same triangles
    (within 1 ulp, as tests/test_torch_clusters.py holds them)."""
    tris, aabb = jax_load_obj(TORUS, *XFORM)
    js = ort.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
    tab = im.mesh_tables(ot.reference_scene(16 / 9, mesh_tris=tris,
                                            mesh_aabb=aabb))
    jplan = jcl.plan_for_scene(js, im.MESH_CHUNK)
    assert jplan.perm_bytes == tab.plan.perm_bytes
    assert jplan.chunk_box_id == tab.plan.chunk_box_id
    jt = js.triangles
    q = [jcl.permute(x, jplan) for x in (jt.p0, jt.p1, jt.p2)]
    jmin, jmax = jcl.cluster_bounds(*q, jplan)
    assert _ulps(tab.cluster[:, :3].numpy(), jmin) <= 1
    assert _ulps(tab.cluster[:, 3:].numpy(), jmax) <= 1
