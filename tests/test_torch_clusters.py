"""The port's cluster plans and triangle features against the JAX
package's.  Plans (the permutation and each chunk's gating box) are
identical byte for byte: both sides run the same numpy code on the same
float32 triangles.  Bounds, permuted arrays and the triangle table (the
rows of the JAX matmul weights) are torch against XLA under ``jax.jit``,
within 1 ulp (XLA fuses the cross products, dot products and padding into
fma chains as ``_fp.py`` does).  The one difference by design: a sub-box
run that holds only padding gets a box no ray enters."""

import numpy as np
import pytest
import torch

import jax

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.io.obj import parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_torus_obj
from opencl_ray_tracer_tpu.tracer import clusters as jcl
from opencl_ray_tracer_tpu.tracer import mesh_accel as jma
from opencl_ray_tracer_tpu_torch.tracer import clusters as tcl
from opencl_ray_tracer_tpu_torch.tracer import intersect as tint
from opencl_ray_tracer_tpu_torch.tracer import mesh_accel as tma

torch.set_num_threads(1)


def _two_box_arrays():
    """tests/test_clusters.py::test_plan_groups_by_box_id's 300 triangles
    in two boxes."""
    rng = np.random.default_rng(1)
    t = 300
    p0 = rng.normal(0, 1, (t, 3)).astype(np.float32)
    p0[t // 2:] += 10.0
    p1 = p0 + rng.normal(0, 0.1, (t, 3)).astype(np.float32)
    p2 = p0 + rng.normal(0, 0.1, (t, 3)).astype(np.float32)
    box_id = np.where(np.arange(t) < t // 2, 0, 1).astype(np.int32)
    return p0, p1, p2, box_id


def _torus_scenes(n_major, n_minor):
    """The reference scene with a procedural torus, in both packages."""
    tris, aabb = parse_obj(make_torus_obj(n_major, n_minor),
                           scale=(0.15, 0.15, 0.15), translate=(0, -0.5, -1))
    return (ort.reference_scene(mesh_tris=tris, mesh_aabb=aabb),
            ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb))


def _assert_plans_equal(got, want):
    assert got.perm_bytes == want.perm_bytes
    assert got.chunk_box_id == want.chunk_box_id
    assert (got.n_chunks, got.chunk, got.n_tris) == (
        want.n_chunks, want.chunk, want.n_tris)


@pytest.mark.parametrize("chunk", [64, 128])
def test_two_box_plan_matches_jax(chunk):
    arrays = _two_box_arrays()
    got = tcl.build_mesh_plan(*arrays, chunk=chunk)
    _assert_plans_equal(got, jcl.build_mesh_plan(*arrays, chunk=chunk))
    eye = np.array([0.0, 3.0, 20.0])
    _assert_plans_equal(tcl.build_mesh_plan(*arrays, chunk=chunk, eye=eye),
                        jcl.build_mesh_plan(*arrays, chunk=chunk, eye=eye))
    perm = got.perm
    for c in range(got.n_chunks):
        ids = perm[c * chunk:(c + 1) * chunk]
        ids = ids[ids >= 0]
        assert (arrays[3][ids] == got.chunk_box_id[c]).all()


@pytest.mark.parametrize("shape,chunk", [((24, 12), 128), ((128, 60), 128),
                                         ((128, 60), 2048)])
def test_scene_plan_matches_jax(shape, chunk):
    """plan_for_scene, with the camera's front-to-back order: the bundled
    torus's size and the 15,360-triangle torus (the F1 car's count)."""
    js, ts = _torus_scenes(*shape)
    got = tcl.plan_for_scene(ts, chunk)
    _assert_plans_equal(got, jcl.plan_for_scene(js, chunk))
    real = got.perm[got.perm >= 0]
    assert sorted(real.tolist()) == list(range(ts.triangles.count))


def test_plan_cache_keys_the_whole_mesh():
    """The JAX package's key samples every (T/64)-th row of p0; the port's
    covers every row, so moving an unsampled vertex gives a new plan."""
    _, ts = _torus_scenes(24, 12)
    plan = tcl.plan_for_scene(ts, 128)
    assert tcl.plan_for_scene(ts, 128) is plan
    p0 = ts.triangles.p0.clone()
    p0[1] += 0.25                    # row 1: not in the JAX sample
    moved = ts.triangles.__class__(p0, *[
        getattr(ts.triangles, f) for f in ("p1", "p2", "albedo", "fuzz", "ior",
                                           "mat_type", "box_id")])
    other = tcl.plan_for_scene(ot.Scene(ts.camera, ts.spheres, moved,
                                        ts.boxes, ts.sky), 128)
    assert other is not plan
    assert tcl.plan_for_scene(ot.readme_scene()) is None


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def test_bounds_and_permute_match_jax():
    js, ts = _torus_scenes(24, 12)
    plan = tcl.plan_for_scene(ts, 128)
    jplan = jcl.plan_for_scene(js, 128)

    @jax.jit
    def jax_side(p0, p1, p2, albedo, box_id):
        q = [jcl.permute(x, jplan) for x in (p0, p1, p2)]
        return (q, jcl.permute(albedo, jplan),
                jcl.permute(box_id, jplan, fill=-1),
                jcl.cluster_bounds(*q, jplan),
                jcl.subcluster_bounds(*q, jplan, 8))

    jt = js.triangles
    jq, jalb, jbid, (jmin, jmax), jsub = jax_side(
        jt.p0, jt.p1, jt.p2, jt.albedo, jt.box_id)
    tt = ts.triangles
    q = [tcl.permute(x, plan) for x in (tt.p0, tt.p1, tt.p2)]
    for a, b in zip(q, jq):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tcl.permute(tt.albedo, plan).numpy(),
                                  np.asarray(jalb))
    np.testing.assert_array_equal(
        tcl.permute(tt.box_id, plan, fill=-1).numpy(), np.asarray(jbid))
    cmin, cmax = tcl.cluster_bounds(*q, plan)
    assert _ulps(cmin.numpy(), jmin) <= 1 and _ulps(cmax.numpy(), jmax) <= 1
    sub = tcl.subcluster_bounds(*q, plan, 8).numpy()
    jsub = np.asarray(jsub)
    real = (plan.perm.reshape(-1, 128 // 8) >= 0).any(axis=1)
    assert 0 < (~real).sum() < real.sum()
    assert _ulps(sub[real], jsub[real]) <= 1
    # padding runs: JAX's inverted box, the port's min = max = 3.4e38
    assert (jsub[~real, :3] > jsub[~real, 3:]).all()
    assert (sub[~real] == np.float32(3.4e38)).all()


def test_no_ray_enters_a_padding_run():
    """The slab test (the kernels' in csrc/mesh.cuh, ``hit_aabbs`` here)
    takes the min and max of the two plane distances, so JAX's inverted box
    for an all-padding run is entered by every ray; the port's box is
    entered by none, while the real runs are entered."""
    js, ts = _torus_scenes(24, 12)
    plan = tcl.plan_for_scene(ts, 128)
    tt = ts.triangles
    q = [tcl.permute(x, plan) for x in (tt.p0, tt.p1, tt.p2)]
    sub = tcl.subcluster_bounds(*q, plan, 8)
    real = torch.as_tensor((plan.perm.reshape(-1, 16) >= 0).any(axis=1))
    rng = np.random.default_rng(7)
    o = rng.normal(0.0, 2.0, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d[:300, 1:] = 0.0                           # axis-aligned: 1/0 = inf
    d[300:600, 0] = 0.0
    o[600:700] = sub[~real][0, :3].numpy()      # on the padding box itself
    o, d = torch.tensor(o), torch.tensor(d)
    assert not tint.hit_aabbs(o, d, sub[~real, :3], sub[~real, 3:]).any()
    assert tint.hit_aabbs(o, d, sub[real, :3], sub[real, 3:]).any()
    big = torch.full((1, 3), 3.4e38)
    assert tint.hit_aabbs(o[:600], d[:600], big, -big).all()


@pytest.mark.parametrize("planned", [False, True])
def test_build_tri_features_match_jax(planned):
    js, ts = _torus_scenes(24, 12)
    chunk = 128
    plan = tcl.plan_for_scene(ts, chunk) if planned else None
    jplan = jcl.plan_for_scene(js, chunk) if planned else None
    want = jax.jit(lambda s: jma.build_tri_features(s, chunk, plan=jplan))(js)
    got = tma.build_tri_features(ts, chunk, plan=plan)
    assert (got.n_chunks, got.chunk) == (want.n_chunks, want.chunk)
    assert _ulps(got.table.numpy(), _jax_table(want)) <= 1
    for f in ("normal", "albedo", "fuzz", "ior"):
        assert _ulps(getattr(got, f).numpy(),
                     np.asarray(getattr(want, f))) <= 1, f
    for f in ("mat_type", "box_id"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    if planned:
        assert got.chunk_box_id == want.chunk_box_id
        assert _ulps(got.cluster_min.numpy(), want.cluster_min) <= 1
        assert _ulps(got.cluster_max.numpy(), want.cluster_max) <= 1


def _jax_table(feats):
    """The JAX matmul weights (n_chunks, 10, 4*chunk) as the port's
    triangle table: the nonzero rows of the a, u, v and t blocks (rows
    [d, m, o, 1]: a 0-2, u and v 0-5, t 6-9) and the unit normal."""
    c = feats.chunk
    w = np.asarray(feats.weights)

    def block(k, rows):
        return (w[:, rows, k * c:(k + 1) * c].transpose(1, 0, 2)
                .reshape(len(rows), -1))

    return np.concatenate([block(0, [0, 1, 2]), block(1, list(range(6))),
                           block(2, list(range(6))), block(3, [6, 7, 8, 9]),
                           np.asarray(feats.normal).T])


def test_tri_table_rows_are_the_weights():
    """The kernels' triangle table holds the nonzero rows of the JAX
    package's matmul weights and the unit normal, column for column, in
    the plan's order; the padding's columns are all zero (a == 0 culls
    them)."""
    js, ts = _torus_scenes(24, 12)
    plan = tcl.plan_for_scene(ts, 128)
    jplan = jcl.plan_for_scene(js, 128)
    f = tma.build_tri_features(ts, 128, plan=plan)
    want = jax.jit(lambda s: jma.build_tri_features(s, 128, plan=jplan))(js)
    tab = f.table
    assert tab.shape == (tma.TRI_ROWS, f.n_chunks * 128)
    assert _ulps(tab.numpy(), _jax_table(want)) <= 1
    assert torch.equal(f.normal, tab[tma.T_N:tma.T_N + 3].T)
    pad = torch.as_tensor(plan.perm < 0)
    assert pad.sum() == plan.n_chunks * 128 - ts.triangles.count
    assert not tab[:, pad].any()
