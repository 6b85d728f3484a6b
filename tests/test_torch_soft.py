"""The port's soft-visibility renderer (``tracer/soft.py``), the trace
arguments it needs and ``fit_scene(soft=True)``, against the JAX package's
on the CPU.

Two scenes, each built in both packages: the README scene (five spheres,
fuzzy metal) and tests/test_soft.py's one-triangle scene, at 16x9, 2 spp,
depth 3.  One ``jax.jit`` of the loss's value and gradient per scene
structure (a module-scope fixture) gives JAX's image, loss and gradient,
at beta 40 and at beta 50000, where coverages inside a silhouette are
exactly 1.0.
Images: at most 0.2% of values off by more than 1e-4, means within 1e-4
(tests/test_golden.py); gradients per leaf by max|a-b|/max|b| under
tests/test_megagrad.py's tolerances (the README scene's fuzzy metal 8e-2,
a Lambertian scene under the gradient sky 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.optimize import extract_params as jax_extract
from opencl_ray_tracer_tpu.optimize import fit_scene as jax_fit_scene
from opencl_ray_tracer_tpu.optimize import insert_params as jax_insert
from opencl_ray_tracer_tpu.tracer.estimator import trace as jax_trace
from opencl_ray_tracer_tpu.tracer.soft import render_soft as jax_render_soft
from opencl_ray_tracer_tpu_torch.optimize import (extract_params,
                                                  insert_params)
from opencl_ray_tracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy
from opencl_ray_tracer_tpu_torch.tracer.estimator import trace
from opencl_ray_tracer_tpu_torch.tracer.soft import _primary_candidates

torch.set_num_threads(1)

CFG = dict(width=16, height=9, spp=2, max_depth=3)
SEED = 3
BETAS = (40.0, 50000.0)
PATHS = {"readme": ("spheres.center",),
         "triangle": ("triangles.p0", "triangles.p1", "triangles.p2")}
GRAD_TOL = {"readme": 8e-2, "triangle": 5e-3}


def _triangle_scene(mod, shift_x=0.0):
    """tests/test_soft.py's scene: one Lambertian triangle facing the
    camera in a gating box, under the gradient sky."""
    tv = np.array([[[-0.6 + shift_x, -0.5, -1.5], [0.6 + shift_x, -0.5, -1.5],
                    [0.0 + shift_x, 0.6, -1.5]]], np.float32)
    tris = mod.Triangles.from_vertices(tv, albedo=(0.7, 0.3, 0.2), fuzz=0.0,
                                       ior=0.0,
                                       mat_type=mod.materials.LAMBERTIAN)
    boxes = mod.BoundingBoxes.single((-2.0, -1.0, -1.6), (2.0, 1.0, -1.4))
    cam = mod.Camera.create((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                            vfov_deg=70.0, aspect_ratio=48.0 / 27.0,
                            focus_dist=1.0, aperture_deg=0.0)
    return mod.Scene(cam, mod.Spheres.empty(), tris, boxes, mod.Sky.gradient())


def _scenes(name):
    """The scene in the JAX package and in the port, each built by its
    own package."""
    if name == "readme":
        return ort.readme_scene(), ot.readme_scene()
    return _triangle_scene(ort), _triangle_scene(ot)


def _target():
    return np.random.default_rng(0).uniform(
        0.0, 1.0, (CFG["height"], CFG["width"], 3)).astype(np.float32)


def _jax_loss(params, scene, seed, beta, target):
    img = jax_render_soft(jax_insert(scene, params), ort.RenderConfig(**CFG),
                          seed, beta)
    return jnp.mean((img - target) ** 2), img


@pytest.fixture(scope="module")
def jax_soft():
    """One jit of the loss's value and gradient, with the image beside
    them; it compiles once per scene structure."""
    return jax.jit(jax.value_and_grad(_jax_loss, has_aux=True))


def _jax_case(value_and_grad, name, beta):
    """JAX's loss, image and gradient leaves."""
    scene = _scenes(name)[0]
    (loss, img), g = value_and_grad(jax_extract(scene, PATHS[name]), scene,
                                    jnp.uint32(SEED), beta, _target())
    return float(loss), np.asarray(img), {k: np.asarray(v)
                                          for k, v in g.items()}


def _port_case(name, beta):
    """The port's loss, image and gradient leaves."""
    scene = _scenes(name)[1]
    params = {p: v.clone().requires_grad_()
              for p, v in extract_params(scene, PATHS[name]).items()}
    img = ot.render_soft(insert_params(scene, params), ot.RenderConfig(**CFG),
                         SEED, beta, device="cpu")
    loss = torch.mean((img - torch.tensor(_target())) ** 2)
    loss.backward()
    return (float(loss.detach()), img.detach().numpy(),
            {k: v.grad.numpy() for k, v in params.items()})


def test_trace_offsets_match_jax():
    """trace(first_bounce=, throughput=) against JAX's trace, and the
    defaults equal to passing them explicitly, bit for bit."""
    jscene, tscene = _scenes("readme")
    rng = np.random.default_rng(1)
    n = 256
    o = (rng.normal(size=(n, 3)) * 0.01).astype(np.float32)
    d = (rng.normal(size=(n, 3)) * [0.5, 0.3, 0.2]
         + [0.0, 0.0, -1.0]).astype(np.float32)
    thr = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    pix = np.arange(n, dtype=np.int32)
    want = np.asarray(jax.jit(
        lambda s, o, d, p, thr: jax_trace(s, o, d, p, 1, jnp.uint32(7), 3,
                                          first_bounce=1, throughput=thr))(
        jscene, o, d, pix, thr))
    t = torch.tensor
    got = trace(tscene, t(o), t(d), t(pix).long(), 1, 7, 3, first_bounce=1,
                throughput=t(thr)).numpy()
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() < 0.002, diff.max()
    assert abs(got.mean() - want.mean()) < 1e-4
    # the offset moves the draws: the same rays from bounce 0's slots differ
    plain = trace(tscene, t(o), t(d), t(pix).long(), 1, 7, 3)
    assert not np.allclose(plain.numpy() * thr, got)
    explicit = trace(tscene, t(o), t(d), t(pix).long(), 1, 7, 3,
                     first_bounce=0, throughput=torch.ones((n, 3)))
    assert torch.equal(plain, explicit)


@pytest.mark.parametrize("name", sorted(PATHS))
def test_render_soft_matches_jax(jax_soft, name):
    """Images, losses and gradients of one scene at both betas: one test a
    scene, so that one process compiles the scene's jit (xdist spreads
    tests over processes)."""
    for beta in BETAS:
        jloss, jimg, want = _jax_case(jax_soft, name, beta)
        tloss, timg, got = _port_case(name, beta)
        assert timg.shape == (CFG["height"], CFG["width"], 3)
        diff = np.abs(timg - jimg)
        assert (diff > 1e-4).mean() < 0.002, (beta, diff.max())
        assert abs(timg.mean() - jimg.mean()) < 1e-4, beta
        assert tloss == pytest.approx(jloss, rel=1e-4), beta
        for path in PATHS[name]:
            a, b = got[path], want[path]
            # the one-triangle scene's vertex gradient through the full
            # closest-hit fold is finite in both packages
            assert np.isfinite(a).all() and np.isfinite(b).all(), path
            scale = float(np.abs(b).max())
            assert scale > 1e-6, (beta, path)
            err = float(np.abs(a - b).max()) / scale
            assert err < GRAD_TOL[name], (beta, path, err)


def test_coverage_reaches_one_at_high_beta():
    """At beta 50000 the camera rays inside a silhouette have a coverage
    of exactly 1.0 (the cumulative product's factor 1e-12), where the
    gradient tests above hold both packages together."""
    tscene = _scenes("readme")[1]
    rng = np.random.default_rng(2)
    d = torch.tensor((rng.normal(size=(64, 3)) * [0.3, 0.3, 0.05]
                      + [0.0, 0.0, -1.0]).astype(np.float32))
    alpha = _primary_candidates(tscene, torch.zeros((64, 3)), d, 50000.0,
                                1e-3)[0]
    assert (alpha == 1.0).any() and (alpha == 0.0).any()


def test_soft_fit_two_steps_match_jax():
    """Two Adam steps of fit_scene(soft=True, beta=40) on the triangle's
    vertices with only the apex unmasked, towards the shifted triangle's
    hard render: losses to 1e-4 relative, vertices to 1e-4, the masked
    vertices unchanged."""
    cfg = dict(CFG, spp=1)
    target = ot.render(_triangle_scene(ot, shift_x=0.15),
                       ot.RenderConfig(**cfg), seed=7, device="cpu").numpy()
    jinit = _triangle_scene(ort)
    paths = PATHS["triangle"]
    mask = {"triangles.p0": np.zeros((1, 3), np.float32),
            "triangles.p1": np.zeros((1, 3), np.float32),
            "triangles.p2": np.ones((1, 3), np.float32)}
    kw = dict(param_paths=paths, steps=2, learning_rate=1e-2, seed=5,
              soft=True, beta=40.0)
    jscene, jlosses = jax_fit_scene(
        jnp.asarray(target), jinit, ort.RenderConfig(**cfg),
        param_mask={k: jnp.asarray(v) for k, v in mask.items()}, **kw)
    tinit = scene_from_numpy(scene_to_numpy(jinit), jinit.sky.kind)
    tscene, tlosses = ot.fit_scene(
        torch.tensor(target), tinit, ot.RenderConfig(**cfg),
        param_mask={k: torch.tensor(v) for k, v in mask.items()},
        device="cpu", **kw)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for p in paths:
        np.testing.assert_allclose(extract_params(tscene, [p])[p].numpy(),
                                   np.asarray(jax_extract(jscene, [p])[p]),
                                   atol=1e-4)
    for p in ("triangles.p0", "triangles.p1"):
        assert torch.equal(extract_params(tscene, [p])[p],
                           extract_params(tinit, [p])[p])
    assert not torch.equal(tscene.triangles.p2, tinit.triangles.p2)


def test_soft_takes_precedence_over_kernel_backend():
    """soft=True with grad_backend="kernel" renders the soft image: one
    step's loss is that of render_soft at the step's seed."""
    scene = ot.readme_scene()
    cfg = ot.RenderConfig(**dict(CFG, spp=1, max_depth=2))
    target = torch.tensor(_target())
    _, losses = ot.fit_scene(target, scene, cfg,
                             param_paths=("spheres.center",), steps=1,
                             seed=4, soft=True, beta=40.0,
                             grad_backend="kernel", device="cpu")
    img = ot.render_soft(scene, cfg, seed=5, beta=40.0, device="cpu")
    assert losses[0] == pytest.approx(
        float(torch.mean((img - target) ** 2)), rel=1e-6)


def test_render_soft_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ot.RenderConfig(**dict(CFG, spp=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render_soft(ot.readme_scene(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.fit_scene(torch.zeros((9, 16, 3)), ot.readme_scene(), cfg,
                     steps=1, soft=True)


def test_sample_groups_do_not_change_the_image(monkeypatch):
    """Samples shaded one group at a time (``SHADE_BATCH``) give the image
    of one batch, bit for bit: the samples are added in order either way."""
    from opencl_ray_tracer_tpu_torch.tracer import soft
    scene = _scenes("readme")[1]
    cfg = ot.RenderConfig(**dict(CFG, spp=3, max_depth=2))
    whole = ot.render_soft(scene, cfg, SEED, 40.0, device="cpu")
    monkeypatch.setattr(soft, "SHADE_BATCH", 1)
    assert torch.equal(ot.render_soft(scene, cfg, SEED, 40.0, device="cpu"),
                       whole)
