"""The port's triangle hit against the JAX package's, on the random-triangle
cases of tests/test_mesh_accel.py, the JAX side under ``jax.jit``:

- the direct form (``hit_triangles_chunk``, ``hit_aabbs``, ``closest_hit``
  with triangles): the same hits, t and points within 2e-5 relative (the
  einsums of the JAX form and the port's fma chains round differently),
  normals within 1e-6;
- the matmul form (``make_mm_hit_fn``) and the closest-triangle kernel's
  plain version (``closest_tri_plain``, the same form over the mesh plan's
  order), against JAX ``make_mm_hit_fn``, the plain reference that
  tests/test_clusters.py holds the Pallas kernel against: the same hits,
  t within 2e-5 relative, the same winners but for ties.

The CUDA kernel against ``closest_tri_plain`` on the card is in
test_torch_kernels_gpu.py, which imports no JAX."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.tracer import intersect as jint
from opencl_ray_tracer_tpu.tracer import mesh_accel as jma
from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
from opencl_ray_tracer_tpu_torch.tracer import intersect as tint
from opencl_ray_tracer_tpu_torch.tracer import mesh_accel as tma

torch.set_num_threads(1)
T_MIN = 1e-3
RTOL = 2e-5


def _tri_scene(mod, n_random=50, seed=0, spheres=True, two_boxes=False):
    """tests/test_mesh_accel.py::_tri_scene: random triangles in front of
    the README spheres (or none), gated by one box or by two."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2, 2, size=(n_random, 3)).astype(np.float32)
    base[:, 2] = rng.uniform(-4, -2, n_random)
    tv = np.stack([
        base, base + rng.uniform(0.1, 0.6, (n_random, 3)).astype(np.float32),
        base + rng.uniform(0.1, 0.6, (n_random, 3)).astype(np.float32)], 1)
    tris = mod.Triangles.from_vertices(tv, albedo=(0.7, 0.5, 0.3), fuzz=0.1,
                                       ior=0.0, mat_type=1, box_id=0)
    boxes = mod.BoundingBoxes.single((-3, -3, -5), (3, 3, -1))
    if two_boxes:
        left = tv[:, :, 0].mean(1) < 0
        bid = np.where(left, 0, 1).astype(np.int32)
        tris = dataclasses.replace(tris, box_id=(
            jnp.asarray(bid) if mod is ort else torch.tensor(bid)))
        lo = [tv[m].reshape(-1, 3).min(0) for m in (left, ~left)]
        hi = [tv[m].reshape(-1, 3).max(0) for m in (left, ~left)]
        conv = jnp.asarray if mod is ort else torch.tensor
        boxes = mod.BoundingBoxes(conv(np.stack(lo)), conv(np.stack(hi)))
    scene = dataclasses.replace(mod.readme_scene(), triangles=tris,
                                boxes=boxes)
    if not spheres:
        scene = dataclasses.replace(scene, spheres=mod.Spheres.empty())
    return scene


def _rays(n=256, seed=1):
    """Rays from the origin into the triangles' box, one straight down the
    axis (a direction with zero components)."""
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    d = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  -np.ones(n)], axis=1).astype(np.float32)
    d[0] = (0.0, 0.0, -1.0)
    return o, d


CASES = {"readme_spheres": {}, "triangles_only": dict(spheres=False),
         "two_boxes": dict(spheres=False, two_boxes=True)}


def _both(case):
    kw = CASES[case]
    return _tri_scene(ort, **kw), _tri_scene(ot, **kw)


_jit_closest_hit = jax.jit(lambda s, o, d: jint.closest_hit(s, o, d, T_MIN))
_jit_closest_fold = jax.jit(lambda s, o, d: jint.closest_fold(s, o, d, T_MIN))
_jit_mm_hit = jax.jit(lambda s, o, d: jma.make_mm_hit_fn(s, T_MIN)(o, d))


def _assert_hits_match(got, want):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    assert hit.any()
    t = np.asarray(want.t)[hit]
    np.testing.assert_allclose(got.t.numpy()[hit], t, rtol=RTOL)
    np.testing.assert_allclose(got.point.numpy()[hit],
                               np.asarray(want.point)[hit], rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_array_equal(got.mat_type.numpy()[hit],
                                  np.asarray(want.mat_type)[hit])
    np.testing.assert_array_equal(got.front_face.numpy()[hit],
                                  np.asarray(want.front_face)[hit])
    np.testing.assert_allclose(got.normal.numpy()[hit],
                               np.asarray(want.normal)[hit], atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_matches_jax(case):
    js, ts = _both(case)
    o, d = _rays()
    want = _jit_closest_hit(js, jnp.asarray(o), jnp.asarray(d))
    got = tint.closest_hit(ts, torch.tensor(o), torch.tensor(d), T_MIN)
    _assert_hits_match(got, want)
    kind_w = np.asarray(_jit_closest_fold(js, jnp.asarray(o),
                                          jnp.asarray(d))[1])
    kind_g = tint.closest_fold(ts, torch.tensor(o), torch.tensor(d),
                               T_MIN)[1].numpy()
    np.testing.assert_array_equal(kind_g, kind_w)
    assert (kind_w == 1).sum() > 5


def test_hit_triangles_chunk_matches_jax():
    js, ts = _both("triangles_only")
    o, d = _rays(256)
    gate = np.random.default_rng(3).uniform(size=(256, 50)) < 0.9
    jt, tt = js.triangles, ts.triangles
    want = np.asarray(jax.jit(
        lambda *a: jint.hit_triangles_chunk(*a[:5], T_MIN, a[5]))(
        jnp.asarray(o), jnp.asarray(d), jt.p0, jt.p1, jt.p2,
        jnp.asarray(gate)))
    got = tint.hit_triangles_chunk(torch.tensor(o), torch.tensor(d), tt.p0,
                                   tt.p1, tt.p2, T_MIN,
                                   torch.tensor(gate)).numpy()
    np.testing.assert_array_equal(got < 1e38, want < 1e38)
    hit = want < 1e38
    assert hit.sum() > 20
    np.testing.assert_allclose(got[hit], want[hit], rtol=RTOL)


def test_hit_aabbs_matches_jax():
    """Including origins on box faces with zero direction components
    (0 * inf = NaN, which fmin/fmax ignore) and rays from inside."""
    rng = np.random.default_rng(4)
    lo = rng.uniform(-2, 0, (6, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 2, (6, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    o[:40, 0] = lo[0, 0]                       # on a face of box 0 ...
    d[:40, 0] = 0.0                            # ... moving along it
    d[40:60, 1:] = 0.0
    o[60:80] = (lo[1] + hi[1]) / 2             # inside box 1
    want = np.asarray(jax.jit(jint.hit_aabbs)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = tint.hit_aabbs(torch.tensor(o), torch.tensor(d), torch.tensor(lo),
                         torch.tensor(hi)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[60:80, 1].all() and want.mean() > 0.03


@pytest.mark.parametrize("case", sorted(CASES))
def test_mm_hit_fn_matches_jax(case):
    js, ts = _both(case)
    o, d = _rays()
    want = _jit_mm_hit(js, jnp.asarray(o), jnp.asarray(d))
    got = tma.make_mm_hit_fn(ts, T_MIN)(torch.tensor(o), torch.tensor(d))
    _assert_hits_match(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_tri_plain_matches_jax_mm(case):
    """The kernel's plain version, over the mesh plan's order and the
    kernels' tables, merged with the spheres as the plain tracer's hit."""
    js, ts = _both(case)
    o, d = _rays()
    want = _jit_mm_hit(js, jnp.asarray(o), jnp.asarray(d))
    tab = im.mesh_tables(ts)
    hit_fn = im.tri_hit_fn(tab, tma.sphere_only(ts), T_MIN,
                           im.closest_tri_plain)
    got = hit_fn(torch.tensor(o), torch.tensor(d))
    _assert_hits_match(got, want)
    # the same triangle wins: the plan's index maps back to the scene's
    t, idx = im.closest_tri_plain(tab, torch.tensor(o), torch.tensor(d),
                                  T_MIN)
    perm = torch.tensor(im.plan_for_scene(ts, im.MESH_CHUNK).perm)

    @jax.jit
    def jax_winners(s, o, d):
        box_hit = jint.hit_aabbs(o, d, s.boxes.box_min, s.boxes.box_max)
        return jma._mm_closest_tri(jma.build_tri_features(s, 2048), box_hit,
                                   o, d, T_MIN)

    jt, ji = jax_winners(js, jnp.asarray(o), jnp.asarray(d))
    hit = np.asarray(jt) < 1e38
    np.testing.assert_array_equal(perm[idx].numpy()[hit], np.asarray(ji)[hit])


def test_closest_tri_wrapper_runs_plain_on_cpu():
    ts = _tri_scene(ot, spheres=False, two_boxes=True)
    tab = im.mesh_tables(ts)
    o, d = (torch.tensor(x) for x in _rays(300))
    before = im.LAUNCHES
    tests = torch.zeros(1, dtype=torch.int64)
    t, idx = im.closest_tri(tab, o, d, T_MIN, tests=tests)
    assert im.LAUNCHES == before
    tp, ip = im.closest_tri_plain(tab, o, d, T_MIN)
    assert torch.equal(t, tp) and torch.equal(idx, ip)
    assert idx.dtype == torch.int64 and tests.item() > 0
    with pytest.raises(ValueError):
        im.closest_tri(tab, o.double(), d, T_MIN)
    with pytest.raises(ValueError):
        im.closest_tri(tab._replace(cluster=tab.cluster[:, :3]), o, d, T_MIN)
    with pytest.raises(ValueError, match="gating boxes"):
        im.mesh_tables(dataclasses.replace(ts, boxes=ot.BoundingBoxes.empty()))


def _many_box_scene(n_boxes=40):
    """The random triangles, triangle i in box i % n_boxes, each box the
    bounds of its triangles but every third one moved away, so that its
    triangles are never tested."""
    ts = _tri_scene(ot, spheres=False)
    t = ts.triangles
    bid = torch.arange(t.count, dtype=torch.int32) % n_boxes
    pts = torch.stack([t.p0, t.p1, t.p2], 1)
    lo = torch.stack([pts[bid == b].reshape(-1, 3).amin(0)
                      for b in range(n_boxes)])
    hi = torch.stack([pts[bid == b].reshape(-1, 3).amax(0)
                      for b in range(n_boxes)])
    away = (torch.arange(n_boxes) % 3 == 0)[:, None] * 50.0
    return dataclasses.replace(
        ts, triangles=dataclasses.replace(t, box_id=bid),
        boxes=ot.BoundingBoxes(lo + away, hi + away))


def test_many_gating_boxes():
    """More gating boxes than the 32 bits of a mask: the plain version of
    the closest-triangle kernel, over the plan's chunks and each chunk's
    box, finds the direct form's hits."""
    ts = _many_box_scene()
    tab = im.mesh_tables(ts)
    assert tab.boxes.shape[0] == 40
    o, d = (torch.tensor(x) for x in _rays(400))
    want = tint.closest_hit(ts, o, d, T_MIN)
    t, idx = im.closest_tri(tab, o, d, T_MIN)
    hit = t < 1e38
    assert torch.equal(hit, want.hit) and hit.sum() > 20
    torch.testing.assert_close(t[hit], want.t[hit], rtol=RTOL, atol=0)
    # no winner lies in a moved box
    perm = torch.tensor(im.plan_for_scene(ts, im.MESH_CHUNK).perm)
    assert (ts.triangles.box_id[perm[idx[hit]]] % 3 != 0).all()


def test_mm_form_matches_direct_form():
    """The port's two triangle forms agree (tests/test_mesh_accel.py's
    check, here on the port alone), and a scene without triangles passes
    the spheres' hit through."""
    ts = _tri_scene(ot)
    o, d = (torch.tensor(x) for x in _rays())
    want = tint.closest_hit(ts, o, d, T_MIN)
    got = tma.make_mm_hit_fn(ts, T_MIN, expected_rays=256)(o, d)
    assert torch.equal(got.hit, want.hit)
    torch.testing.assert_close(got.t[want.hit], want.t[want.hit], rtol=1e-4,
                               atol=0)
    spheres = ot.readme_scene()
    a = tma.make_mm_hit_fn(spheres, T_MIN)(o, d)
    b = tint.closest_hit(spheres, o, d, T_MIN)
    assert torch.equal(a.t, b.t) and torch.equal(a.hit, b.hit)
