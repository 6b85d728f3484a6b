"""The port's mesh-scene gradients on the CPU against the JAX package's.

- ``render_grad_sampled`` of the JAX package (``grad_backend="jnp"``, the
  oracle its own mesh-gradient tests use; its loss, image and gradient
  are recorded with the inputs they came from in
  tests/goldens/torch_grad_refs.npz by ``tools/make_port_refs.py``, which
  calls ``jax_references`` below; ``port_refs.load`` checks the inputs)
  against three routes of the port:
  ``render_grad_sampled(grad_backend="plain")``, ``render_grad_scene``
  through the mesh backward's wrapper (whose CPU path is its plain
  version, autograd of the plain wavefront with the winner hit in plane
  form) chained by ``tri_grads_to_scene``, and ``render_and_grad``.  The
  scenes are tests/test_megagrad.py's mesh cases at its size (32x16,
  2 spp, depth 4) with a 192-triangle torus (the tests/test_megamesh.py
  mesh): the reference spheres and the fuzzy-metal torus under a gradient
  sky, a metal torus under a constant sky, and the torus without spheres.
  (With the 48 triangles of tests/test_megagrad.py's torus the JAX
  package gathers the winner by 48-way select folds, and its oracle
  compiles about 2.5 times as long.)  Tolerances per leaf,
  max|a - b| / max|b|, are those of tests/test_megagrad.py: 5e-4, 5e-3
  for the metal case, 1e-4 for the camera without spheres; the camera
  leaves that the JAX tests leave out (vup, aspect ratio) and the
  aperture, whose gradient sums lens draws that ATen's sin and cos give
  an ulp apart from XLA's, take the reference scene's 5e-3
  (test_torch_grad.py).  Losses agree within 1e-6.
- The triangle branch of ``winner_hitinfo`` against the JAX package's on
  random rays into a mesh: values, and gradients under ``jax.vjp``.
- The closest-triangle kernel's winner search (its plain version on the
  CPU, with the plan order mapped back) finds the plain fold's winners.
- ``fit_scene`` on the triangle vertices through the mesh kernels' route
  (their plain versions here): the first step is one Adam update of the
  port's own mesh gradient, the plan is built once per fit, and the
  tables follow the moved vertices.  (The JAX package's vertex fit on its
  jnp route differentiates the whole closest-hit fold and returns NaN
  vertices, so it is no oracle here.)
- The scope, the wrapper's argument checks, and the chain from plan-order
  cotangents to the triangles' leaves.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
from opencl_ray_tracer_tpu.io.obj import parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_torus_obj
from opencl_ray_tracer_tpu.scene import Sky as JSky
from opencl_ray_tracer_tpu.scene import Spheres as JSpheres
from opencl_ray_tracer_tpu.scene import Triangles as JTriangles
from opencl_ray_tracer_tpu.tracer import diffhit as jdh
from opencl_ray_tracer_tpu.tracer.render import (
    render_grad_sampled as jax_render_grad_sampled)
from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
from opencl_ray_tracer_tpu_torch.scene import (materials, scene_from_numpy,
                                               scene_to_numpy)
from opencl_ray_tracer_tpu_torch.tracer import clusters
from opencl_ray_tracer_tpu_torch.tracer import diffhit as tdh
from opencl_ray_tracer_tpu_torch.tracer.intersect import BIG, closest_fold

torch.set_num_threads(1)

CFG = dict(width=32, height=16, spp=2, max_depth=4, nan_policy="zero")
T_MIN = 1e-3
TRI_LEAVES = ("triangles.p0", "triangles.p1", "triangles.p2",
              "triangles.albedo", "triangles.fuzz", "triangles.ior")
# the leaves of tests/test_megagrad.py::_assert_close and the triangles'
JAX_TEST_LEAVES = ("spheres.center", "spheres.radius", "spheres.albedo",
                   "spheres.fuzz", "spheres.ior", "camera.look_from",
                   "camera.look_at", "camera.vfov_deg", "camera.focus_dist",
                   "sky.const_colour") + TRI_LEAVES
LENS_LEAVES = ("camera.aperture_deg", "camera.vup", "camera.aspect_ratio")


def _jax_mesh_scene(sky=None, mesh_material=None):
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    scene = ort.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)
    if mesh_material is not None:
        scene = dataclasses.replace(scene, triangles=JTriangles.from_vertices(
            np.asarray(tris), box_id=0, **mesh_material))
    return scene


def _tolerances(rtol, lens=5e-3):
    return {**{k: rtol for k in JAX_TEST_LEAVES},
            **{k: lens for k in LENS_LEAVES}}


# name: (JAX scene, seed, tolerance per leaf)
CASES = {
    "gradient_sky": (lambda: _jax_mesh_scene(), 0, _tolerances(5e-4)),
    "metal_const_sky": (lambda: _jax_mesh_scene(
        sky=JSky.constant((0.3, 0.5, 0.8)),
        mesh_material=dict(albedo=(0.8, 0.7, 0.3), fuzz=0.2, ior=0.0,
                           mat_type=materials.METAL)), 3, _tolerances(5e-3)),
    "mesh_only": (lambda: dataclasses.replace(_jax_mesh_scene(),
                                              spheres=JSpheres.empty()), 0,
                  {"camera.look_from": 1e-4, "camera.look_at": 1e-4,
                   "camera.vfov_deg": 1e-4, **{k: 5e-4 for k in TRI_LEAVES}}),
}


def _loss_jax(img):
    return jnp.mean(img ** 2)


def _loss(img):
    return torch.mean(img ** 2)


def _port_scene(jscene):
    return scene_from_numpy(scene_to_numpy(jscene), jscene.sky.kind)


def jax_references() -> dict:
    """JAX's loss, image and gradient leaves of every case with their
    inputs, keyed "mesh_grad/<case>/<name>" (``tools/make_port_refs.py``
    records them)."""
    refs = {}
    for case, (make, seed, _) in CASES.items():
        jscene, jcfg = make(), ort.RenderConfig(**CFG)
        loss, img, grads = jax_render_grad_sampled(
            jscene, jcfg, _loss_jax, seed=seed, grad_backend="jnp")
        refs.update(port_refs.record(f"mesh_grad/{case}", jscene, jcfg, seed,
                                     loss, img, grads))
    return refs


def _assert_leaves_close(got, want, tol, name):
    a, b = scene_to_numpy(got), want
    errs = {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-9) for k in tol}
    bad = {k: v for k, v in errs.items() if not v < tol[k]}
    assert not bad, f"{name}: {bad}"


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_grads_match_jax(case):
    make, seed, tol = CASES[case]
    jscene = make()
    jcfg = ort.RenderConfig(**CFG)
    jloss, jimg, jgrads = port_refs.load(f"mesh_grad/{case}", jscene, jcfg,
                                         seed)
    assert jimg.shape == (jcfg.height, jcfg.width, 3)
    scene = _port_scene(jscene)
    cfg = ot.RenderConfig(**CFG)
    assert mg.supports_grad_mesh(scene, cfg)

    loss, img, grads = ot.render_grad_sampled(scene, cfg, _loss, seed=seed,
                                              grad_backend="plain",
                                              device="cpu")
    assert abs(float(loss) - float(jloss)) < 1e-6
    _assert_leaves_close(grads, jgrads, tol, "plain")

    g_img = (2.0 / img.numel()) * img
    before = mg.MESH_LAUNCHES
    kgrads = mg.render_grad_scene(scene, cfg, g_img, seed=seed)
    assert mg.MESH_LAUNCHES == before
    _assert_leaves_close(kgrads, jgrads, tol, "mesh backward's plain version")

    rloss, rgrads = ot.render_and_grad(scene, cfg, _loss, seed=seed,
                                       device="cpu")
    assert abs(float(rloss) - float(jloss)) < 1e-6
    _assert_leaves_close(rgrads, jgrads, tol, "render_and_grad")

    if case == "gradient_sky":
        # real vertex and material signal, as the JAX test asserts
        assert np.abs(jgrads["triangles.p0"]).max() > 0
        assert np.abs(jgrads["triangles.albedo"]).max() > 1e-6
        # the kernel route on CPU tensors: the mesh megakernel's and the
        # mesh backward's plain versions through MeshRenderFn
        launches = (mm.LAUNCHES, mg.MESH_LAUNCHES)
        l2, i2, g2 = ot.render_grad_sampled(scene, cfg, _loss, seed=seed,
                                            grad_backend="kernel",
                                            device="cpu")
        assert (mm.LAUNCHES, mg.MESH_LAUNCHES) == launches
        assert abs(float(l2) - float(jloss)) < 1e-6
        assert float((i2 - img).abs().mean()) < 1e-5
        _assert_leaves_close(g2, jgrads, tol, "kernel route")


def _rays(scene, n=256, seed=0):
    """Rays from around the camera towards the mesh's box, with weights
    for a scalar of the hit record."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(scene.boxes.box_min[0])
    hi = np.asarray(scene.boxes.box_max[0])
    target = lo + (hi - lo) * rng.uniform(size=(n, 3))
    o = (np.asarray(scene.camera.look_from)
         + 0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    d = (target - o).astype(np.float32)
    w = rng.normal(size=(n, 12)).astype(np.float32)
    return o, d, w


def _weighted(h, w, lib):
    fields = (h.t[:, None], h.point, h.normal, h.albedo, h.fuzz[:, None],
              h.ior[:, None])
    cat = lib.concatenate if lib is jnp else torch.cat
    return ((cat(fields, -1) * w).sum(-1) * h.hit).sum()


def test_winner_hitinfo_triangles_match_jax():
    jscene = _jax_mesh_scene()
    o, d, w = _rays(jscene)
    leaves = ("p0", "p1", "p2", "albedo", "fuzz")
    from opencl_ray_tracer_tpu.tracer.intersect import closest_fold as jfold

    def f(tri, o, d):
        scene = dataclasses.replace(jscene, triangles=dataclasses.replace(
            jscene.triangles, **tri))
        best_t, kind, idx = jfold(jax.lax.stop_gradient(scene), o, d, T_MIN)
        hit = best_t < BIG
        h = jdh.winner_hitinfo(scene, o, d, kind, idx, hit, T_MIN)
        return _weighted(h._replace(hit=hit.astype(jnp.float32)), w, jnp), (
            h, kind)

    (jval, (jh, jkind)), jgrads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            {k: getattr(jscene.triangles, k) for k in leaves},
            jnp.asarray(o), jnp.asarray(d))
    jkind = np.asarray(jkind)
    assert 0.2 < (jkind == 1).mean() < 0.9    # triangles and other winners

    scene = _port_scene(jscene)
    tri = {f"triangles.{k}": getattr(scene.triangles, k).clone()
           .requires_grad_() for k in leaves}
    scene = ot.scene.replace_leaves(scene, tri)
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    with torch.no_grad():
        best_t, kind, idx = closest_fold(scene, to, td, T_MIN)
    np.testing.assert_array_equal(kind.numpy(), jkind)
    h = tdh.winner_hitinfo(scene, to, td, kind, idx, best_t < BIG, T_MIN)
    val = _weighted(h._replace(hit=h.hit.float()), torch.tensor(w), torch)
    m = np.asarray(jh.hit)
    np.testing.assert_array_equal(h.hit.numpy(), m)
    for name in ("t", "point", "normal", "albedo", "fuzz", "ior"):
        np.testing.assert_allclose(getattr(h, name).detach().numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    grads = torch.autograd.grad(val, [*tri.values(), to, td])
    want = [*(jgrads[0][k] for k in leaves), jgrads[1], jgrads[2]]
    for name, a, b in zip([*leaves, "o", "d"], grads, want):
        b = np.asarray(b)
        err = float(np.abs(a.numpy() - b).max() / np.abs(b).max())
        assert err < 1e-5, (name, err)


def test_kernel_winner_search_matches_plain_fold():
    """winner_backend "pallas" (the closest-triangle kernel; its plain
    version on CPU tensors) maps the plan-order winner back to the scene's
    triangle ids and finds the plain fold's winners; "kernel" is not a
    winner backend."""
    jscene = _jax_mesh_scene()
    o, d, _ = _rays(jscene, n=2048, seed=1)
    scene = _port_scene(jscene)
    to, td = torch.tensor(o), torch.tensor(d)
    hits = {}
    for backend in ("plain", "pallas"):
        h = tdh.make_grad_hit_fn(scene, T_MIN, winner_backend=backend)(to, td)
        hits[backend] = h
    _, kind, _ = closest_fold(scene, to, td, T_MIN)
    assert (kind == 1).float().mean() > 0.2
    plan = im.mesh_tables(scene).plan
    assert not np.array_equal(plan.perm[:scene.triangles.count],
                              np.arange(scene.triangles.count))
    h = hits["pallas"]
    assert torch.equal(h.hit, hits["plain"].hit)
    # the same winners: the same recomputed records
    for name in ("t", "point", "normal", "albedo"):
        assert torch.equal(getattr(h, name), getattr(hits["plain"], name))
    # "auto" on CPU tensors is the plain fold
    h = tdh.make_grad_hit_fn(scene, T_MIN, winner_backend="auto")(to, td)
    assert torch.equal(h.t, hits["plain"].t)
    for bad in ("jnp", "kernel"):
        with pytest.raises(ValueError, match="winner_backend"):
            tdh.make_grad_hit_fn(scene, T_MIN, winner_backend=bad)


def test_vertex_gradient_matches_finite_differences():
    """Away from edges the vertex gradient is the loss's derivative: a
    mirror quad filling the view (no silhouette, no gap), the gradient of
    one corner against central differences of the loss (fixed noise)."""
    quad = torch.tensor([
        [[-50., -50., -3.], [50., -50., -3.5], [50., 50., -3.]],
        [[-50., -50., -3.], [50., 50., -3.], [-50., 50., -2.5]]])
    tris = ot.Triangles.from_vertices(quad, albedo=(0.8, 0.7, 0.6), fuzz=0.0,
                                      ior=0.0, mat_type=materials.METAL)
    scene = ot.Scene(ot.reference_scene().camera, ot.Spheres.empty(), tris,
                     ot.BoundingBoxes.single(torch.tensor([-60., -60., -10.]),
                                             torch.tensor([60., 60., 0.])),
                     ot.Sky.gradient())
    cfg = ot.RenderConfig(width=32, height=18, spp=4, max_depth=4,
                          nan_policy="zero")

    def loss_fn(img):
        return torch.mean((img - 0.5) ** 2)

    def loss_at(dp2):
        moved = dataclasses.replace(scene, triangles=dataclasses.replace(
            tris, p2=tris.p2 + dp2))
        return float(loss_fn(ot.render(moved, cfg, seed=1, device="cpu")))

    _, _, g = ot.render_grad_sampled(scene, cfg, loss_fn, seed=1,
                                     grad_backend="kernel", device="cpu")
    h = 3e-3
    fd = torch.zeros(3)
    for k in range(3):
        step = torch.zeros_like(tris.p2)
        step[0, k] = h
        fd[k] = (loss_at(step) - loss_at(-step)) / (2 * h)
    grad = g.triangles.p2[0]
    assert float(grad.abs().max()) > 1e-5
    assert float((grad - fd).abs().max() / grad.abs().max()) < 1e-2, (grad, fd)


def _fit_problem():
    """tests/test_megagrad.py::test_fit_scene_triangle_vertices_pallas: its
    48-triangle torus, target rendered with seed 7, every p0 moved by
    0.02."""
    tris, aabb = parse_obj(make_torus_obj(6, 4), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    true = _port_scene(ort.reference_scene(mesh_tris=tris, mesh_aabb=aabb))
    cfg = ot.RenderConfig(**CFG)
    target = ot.render(true, cfg, seed=7, device="cpu")
    t = true.triangles
    init = dataclasses.replace(true, triangles=dataclasses.replace(
        t, p0=t.p0 + 0.02))
    return target, init, cfg


def test_vertex_fit_first_step_is_one_adam_update():
    target, init, cfg = _fit_problem()
    paths = ("triangles.p0", "triangles.p1", "triangles.p2")
    fitted, losses = ot.fit_scene(target, init, cfg, param_paths=paths,
                                  steps=1, learning_rate=5e-3, seed=7,
                                  sample_new_noise=False,
                                  grad_backend="kernel", device="cpu")

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    loss, _, g = ot.render_grad_sampled(init, cfg, loss_fn, seed=7,
                                        grad_backend="kernel", device="cpu")
    assert losses[0] == pytest.approx(float(loss), rel=1e-6)
    params = [init.triangles.p0.clone().requires_grad_(),
              init.triangles.p1.clone().requires_grad_(),
              init.triangles.p2.clone().requires_grad_()]
    adam = torch.optim.Adam(params, lr=5e-3)
    for p, gp in zip(params, (g.triangles.p0, g.triangles.p1,
                              g.triangles.p2)):
        p.grad = gp.clone()
    adam.step()
    for p, name in zip(params, ("p0", "p1", "p2")):
        torch.testing.assert_close(getattr(fitted.triangles, name), p.detach(),
                                   rtol=0, atol=1e-7)
    assert float(g.triangles.p0.abs().max()) > 0
    # only the fitted leaves move
    assert torch.equal(fitted.triangles.albedo, init.triangles.albedo)
    assert torch.equal(fitted.spheres.center, init.spheres.center)


def test_vertex_fit_keeps_its_plan_and_moves_the_tables(monkeypatch):
    """A fit builds the plan of its first scene once and, every step, the
    tables from the moved vertices in that plan's order; the loss falls
    over the four steps of the JAX test's fit of p0."""
    target, init, cfg = _fit_problem()
    built = []
    build_plan = clusters.build_mesh_plan
    monkeypatch.setattr(clusters, "build_mesh_plan", lambda *a, **k: (
        built.append(1), build_plan(*a, **k))[1])
    monkeypatch.setattr(clusters, "_PLAN_CACHE", {})
    monkeypatch.setattr(im, "_TABLES", {})
    tables = []
    build_tables = im._build_tables
    monkeypatch.setattr(im, "_build_tables", lambda scene, plan=None: (
        tables.append((scene.triangles.p0.clone(),
                       build_tables(scene, plan))), tables[-1][1])[1])
    scenes = []
    _, losses = ot.fit_scene(
        target, init, cfg, param_paths=("triangles.p0",), steps=4,
        learning_rate=5e-3, seed=7, sample_new_noise=False,
        callback=lambda i, loss, s: scenes.append(s), device="cpu",
        grad_backend="kernel")
    assert losses[-1] < losses[0], losses
    assert len(built) == 1
    assert len(tables) == 4
    plan = tables[0][1].plan
    assert all(t.plan is plan for _, t in tables)
    for (_, before), (p0_built, after), moved in zip(tables, tables[1:],
                                                     scenes):
        assert torch.equal(p0_built, moved.triangles.p0)
        assert not torch.equal(before.tri, after.tri)
        again = im.mesh_tables(moved, plan=plan)
        assert torch.equal(after.tri, again.tri)
        assert torch.equal(after.cluster, again.cluster)
        # every moved vertex lies in its chunk's box
        p0 = clusters.permute(moved.triangles.p0, plan)
        chunk = torch.arange(p0.shape[0]) // im.MESH_CHUNK
        real = torch.as_tensor(plan.perm >= 0)
        lo, hi = after.cluster[chunk, :3], after.cluster[chunk, 3:]
        assert bool(((p0 >= lo) & (p0 <= hi))[real].all())


def test_fitting_materials_takes_the_plain_route():
    target, init, cfg = _fit_problem()
    with pytest.raises(NotImplementedError, match="plain route"):
        ot.fit_scene(target, init, cfg, param_paths=("triangles.albedo",),
                     steps=1, grad_backend="kernel", device="cpu")
    fitted, losses = ot.fit_scene(target, init, cfg,
                                  param_paths=("triangles.albedo",), steps=1,
                                  learning_rate=1e-2, device="cpu")
    assert not torch.equal(fitted.triangles.albedo, init.triangles.albedo)


def test_tri_cotangents_unpermute_the_plan():
    """gtri in plan order chains to the triangles' leaves as autograd of
    the plane and material rows through the plan's permutation does (a
    dielectric mesh: 1/ior is not clamped)."""
    scene = _port_scene(_jax_mesh_scene(mesh_material=dict(
        albedo=(0.9, 0.9, 0.9), fuzz=0.0, ior=1.5,
        mat_type=materials.DIELECTRIC)))
    plan = im.mesh_tables(scene).plan
    t_pad = plan.perm.shape[0]
    gtri = torch.tensor(np.random.default_rng(3).normal(
        size=(mg.GTRI_ROWS, t_pad)), dtype=torch.float32)
    got = mg.tri_grads_to_scene(scene, plan, gtri)
    leaves = {k: getattr(scene.triangles, k).clone().requires_grad_()
              for k in ("p0", "p1", "p2", "albedo", "fuzz", "ior")}
    q0, q1, q2 = (clusters.permute(leaves[k], plan) for k in ("p0", "p1",
                                                              "p2"))
    n = torch.linalg.cross(q1 - q0, q2 - q0, dim=-1)
    ior = clusters.permute(leaves["ior"], plan, fill=1.0)
    rows = torch.cat([n.T, (n * q0).sum(-1)[None],
                      clusters.permute(leaves["albedo"], plan).T,
                      clusters.permute(leaves["fuzz"], plan)[None],
                      ior[None], 1.0 / torch.clamp(ior, min=1e-8)[None]])
    want = torch.autograd.grad(rows, list(leaves.values()), gtri)
    for k, w in zip(leaves, want):
        torch.testing.assert_close(getattr(got.triangles, k), w, rtol=1e-5,
                                   atol=1e-5)
    assert got.spheres.center.abs().max() == 0


def test_mesh_grad_scope():
    cfg = ot.RenderConfig(**CFG)
    scene = _port_scene(_jax_mesh_scene())
    assert mg.supports_grad_mesh(scene, cfg)
    no_spheres = dataclasses.replace(scene, spheres=ot.Spheres.empty())
    assert mg.supports_grad_mesh(no_spheres, cfg)
    t = scene.triangles
    mixed = dataclasses.replace(scene, triangles=dataclasses.replace(
        t, fuzz=torch.linspace(0.0, 0.5, t.count)))
    assert "uniform" in mg.unsupported_grad_mesh_reason(mixed)
    boxless = dataclasses.replace(scene, boxes=ot.BoundingBoxes.empty())
    assert "gating boxes" in mg.unsupported_grad_mesh_reason(boxless)
    many = dataclasses.replace(scene, spheres=ot.book_cover_scene(
        n_random=196).spheres)
    assert "128" in mg.unsupported_grad_mesh_reason(many)
    # an HDR sky takes the HDR passes (K6, K7), not K5, texels above 1
    # too
    hdr = dataclasses.replace(scene, sky=ot.Sky.hdr(torch.ones((4, 8, 3))))
    assert mg.unsupported_grad_reason(hdr) is None
    assert "K6 and K7" in mg.unsupported_grad_mesh_reason(hdr)
    bright = dataclasses.replace(
        scene, sky=ot.Sky.hdr(torch.full((4, 8, 3), 2.0)))
    assert mg.unsupported_grad_reason(bright) is None
    assert mg.unsupported_grad_reason(scene) is None
    assert mg.supports_grad(ot.readme_scene(), cfg)


def _mesh_args(scene, cfg, n_pix=None):
    n_pix = cfg.width * cfg.height if n_pix is None else n_pix
    g = torch.linspace(0.0, 1.0, 3 * n_pix).reshape(3, n_pix).contiguous()
    return (mm.mesh_camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, mm.mesh_tables(scene), cfg, scene.sky.kind,
            mm.specialize_mesh_flags(scene), g[0], g[1], g[2], 5, n_pix)


def test_mesh_grad_wrapper_windows_and_checks():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; windows of pixels and samples add up to the whole; wrong
    arguments raise."""
    scene = _port_scene(_jax_mesh_scene())
    cfg = ot.RenderConfig(width=16, height=10, spp=2, max_depth=4,
                          nan_policy="zero")
    args = _mesh_args(scene, cfg)
    before = mg.MESH_LAUNCHES
    counts = torch.zeros(4, dtype=torch.int64)
    whole = mg.render_grad_mesh_tables(*args, counts=counts)
    assert mg.MESH_LAUNCHES == before and counts[0] > 0
    assert whole[2].shape == (mg.GTRI_ROWS, args[3].tri.shape[1])
    assert whole[2][:4].abs().max() > 0
    cam, sph, n, tab, cfg_, kind, flags, gr, gg, gb, seed, n_pix = args
    parts = [mg.render_grad_mesh_tables(
        cam, sph, n, tab, cfg_, kind, flags, gr[p0:p1], gg[p0:p1],
        gb[p0:p1], seed, p1 - p0, pix_offset=p0, sample_base=s, n_samples=1)
        for p0, p1 in ((0, 70), (70, n_pix)) for s in range(cfg.spp)]
    for k in range(3):
        torch.testing.assert_close(sum(p[k] for p in parts), whole[k],
                                   rtol=1e-4, atol=1e-7)
    for i, bad in ((0, cam.double()), (1, sph[:, :64]), (7, gr[:-1])):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            mg.render_grad_mesh_tables(*wrong)
    with pytest.raises(ValueError, match="sky"):
        mg.render_grad_mesh_tables(*args[:5], 1, *args[6:])
    with pytest.raises(ValueError, match="counts"):
        mg.render_grad_mesh_tables(
            *args, counts=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        meta = [a.to("meta") if torch.is_tensor(a) else a for a in args]
        meta[3] = im.MeshTables(*(x.to("meta") if torch.is_tensor(x) else x
                                  for x in tab))
        mg.render_grad_mesh_tables(*meta)
