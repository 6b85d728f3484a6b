"""The port's HDR-sky gradients on the CPU against the JAX package's.

- The fused kernel route (``render_grad_sampled(grad_backend="kernel")``:
  the HDR emit pass, the texels' lookup, the image rebuilt from them, the
  consume pass and the texels' scatter; on CPU tensors the passes' plain
  versions) against JAX ``render_grad_sampled(grad_backend="jnp")``, its
  own HDR tests' oracle (its loss, image and gradient recorded with the
  inputs they came from in tests/goldens/torch_grad_refs.npz by
  ``tools/make_port_refs.py``, which calls ``jax_references`` below;
  ``port_refs.load`` checks the inputs): the README spheres at 3 spp and
  the mesh scene of tests/test_megamesh.py at 10 spp (more than the JAX
  passes' 8-sample window), 32x16, depth 4, under tests/test_megagrad.py's tolerances
  (max|a - b| / max|b|): sphere albedo 5e-3 (fused) and vertices 5e-4,
  ``sky.image`` 5e-3 with more than 99.9% of texels within 1e-6, the loss
  within 1e-4.  The
  geometry's gradients are zero on both sides: the nearest-texel lookup
  is constant in the direction.  On the README case,
  ``render_grad_scene`` on JAX's image cotangent (the two passes alone,
  the JAX package's ``_grad_scene_hdr_jit``) takes the non-fused
  tolerance, 1e-4 on the albedo, and the plain route, and
  ``render_and_grad``, agree with the fused route texel for texel.
- ``hdr_emit``'s plain version against the port's plain render: the image
  rebuilt from its records is the render's.
- ``fit_scene`` of ``sky.image`` through the HDR kernels' route follows the
  JAX package's fit history for two steps.
- The scope and the wrappers' argument checks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
from opencl_ray_tracer_tpu.io.hdr import tone_map
from opencl_ray_tracer_tpu.io.obj import parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_sky_image, make_torus_obj
from opencl_ray_tracer_tpu.optimize import fit_scene as jax_fit_scene
from opencl_ray_tracer_tpu.tracer.render import (
    render_grad_sampled as jax_render_grad_sampled)
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

torch.set_num_threads(1)

SKY = tone_map(make_sky_image(64, 32))
CASES = {"readme": 3, "mesh": 10}
# The share of sky-image values within 1e-6 of JAX's: tests/test_megagrad.py's
# 99.9% in both cases.  In the mesh case the oracle itself is not more
# stable than that: tests/hdr_texel_flips.py traces the JAX route's two forms
# of one wavefront (its differentiable scan, which this test reads, and the
# while form that probes the scan's length) and finds them one miss apart at
# seeds 0 and 1.  With the camera's tan and the lens and scatter draws'
# sin, cos and cube root taken from glibc on the CPU (``_fp``), as XLA:CPU
# takes them, the port is 0 misses from the while form and 1 from the scan
# at both seeds (about 6 of 6,144 values each).
TEXELS_WITHIN = {"readme": 0.999, "mesh": 0.999}


def _scene(mod, name, sky=SKY):
    if name == "readme":
        return dataclasses.replace(mod.readme_scene(), sky=mod.Sky.hdr(sky))
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    return mod.reference_scene(mesh_tris=tris, mesh_aabb=aabb,
                               sky=mod.Sky.hdr(sky))


def _cfg(mod, spp):
    return mod.RenderConfig(width=32, height=16, spp=spp, max_depth=4,
                            nan_policy="zero")


def _loss(img):
    return (img ** 2).mean()


def jax_references() -> dict:
    """JAX render_grad_sampled(grad_backend="jnp") of every case: its loss,
    image and gradient leaves with their inputs, keyed
    "hdr_grad/<case>/<name>" (``tools/make_port_refs.py`` records them)."""
    refs = {}
    for name in CASES:
        jscene, jcfg = _scene(ort, name), _cfg(ort, CASES[name])
        loss, img, g = jax_render_grad_sampled(
            jscene, jcfg, lambda im: jnp.mean(im ** 2), seed=0,
            grad_backend="jnp")
        refs.update(port_refs.record(f"hdr_grad/{name}", jscene, jcfg, 0,
                                     loss, img, g))
    return refs


def _jax_grads(name):
    """The recorded JAX loss, image and numpy leaves of the gradient."""
    return port_refs.load(f"hdr_grad/{name}", _scene(ort, name),
                          _cfg(ort, CASES[name]), 0)


def _rel(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-9)


def _check_leaves(got, want, albedo_tol, texels_within=0.999):
    a = scene_to_numpy(got)
    assert float(np.abs(want["spheres.albedo"]).max()) > 1e-3
    assert _rel(a["spheres.albedo"], want["spheres.albedo"]) < albedo_tol
    for k in ("spheres.center", "spheres.radius", "spheres.fuzz",
              "spheres.ior", "camera.look_from", "camera.look_at"):
        assert float(np.abs(a[k] - want[k]).max()) < 1e-6, k
    for k in ("triangles.p0", "triangles.p1", "triangles.p2"):
        if want[k].size:
            assert _rel(a[k], want[k]) < 5e-4, k
    sa, sb = a["sky.image"], want["sky.image"]
    assert float(np.abs(sb).max()) > 1e-6
    assert _rel(sa, sb) < 5e-3
    assert (np.abs(sa - sb) <= 1e-6).mean() > texels_within


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_route_matches_jax_jnp(name):
    jloss, jimg, want = _jax_grads(name)
    scene, cfg = _scene(ot, name), _cfg(ot, CASES[name])
    before = (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES, mm.LAUNCHES)
    loss, img, grads = ot.render_grad_sampled(scene, cfg, _loss, seed=0,
                                              grad_backend="kernel",
                                              device="cpu")
    # CPU tensors: the plain versions, and no forward render
    assert (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES, mm.LAUNCHES) == before
    assert (np.abs(img.numpy() - jimg) > 1e-3).mean() < 0.01
    assert abs(float(loss) - jloss) < 1e-4
    _check_leaves(grads, want, 5e-3, TEXELS_WITHIN[name])
    if name == "mesh":
        return
    # the two passes alone on JAX's image cotangent
    g_img = torch.tensor(2.0 * jimg / jimg.size)
    _check_leaves(mg.render_grad_scene(scene, cfg, g_img, seed=0), want,
                  1e-4, TEXELS_WITHIN[name])
    # the plain route: the image through render(), autograd of the plain
    # wavefront
    ploss, pimg, pgrads = ot.render_grad_sampled(
        scene, cfg, _loss, seed=0, grad_backend="plain", device="cpu")
    assert abs(float(ploss) - float(loss)) < 1e-6
    _check_leaves(pgrads, scene_to_numpy(grads), 1e-5, 1.0 - 1e-9)


def test_emit_rebuilds_the_plain_image():
    scene, cfg = _scene(ot, "mesh"), _cfg(ot, 3)
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    n_pix = cfg.width * cfg.height
    counts = torch.zeros(2, dtype=torch.int64)
    emit, emis = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 0, n_pix,
                             counts=counts)
    assert emit.shape == (6, 3, n_pix) and emis.shape == (3, n_pix)
    missed = emit[3:6].abs().sum(0) > 0
    assert 0.1 < float(missed.float().mean()) < 1.0
    # a sample that did not miss keeps direction (0, 0, 1) and throughput 0
    assert bool((emit[2][~missed] == 1).all())
    assert int(counts[0]) >= n_pix * cfg.spp and int(counts[1]) > 0
    sky, flat = mg.hdr_lookup(image, emit)
    img = mg.hdr_image(emit, emis, sky, cfg).T.reshape(16, 32, 3)
    want = ot.render(scene, cfg, seed=0, device="cpu")
    np.testing.assert_allclose(img.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_render_and_grad_under_hdr():
    scene, cfg = _scene(ot, "readme"), _cfg(ot, 3)
    loss, grads = ot.render_and_grad(scene, cfg, _loss, seed=0, device="cpu")
    kloss, _, kgrads = ot.render_grad_sampled(
        scene, cfg, _loss, seed=0, grad_backend="kernel", device="cpu")
    assert abs(float(loss) - float(kloss)) < 1e-6
    _check_leaves(grads, scene_to_numpy(kgrads), 1e-5, 1.0 - 1e-9)


def test_sky_image_fit_matches_jax():
    cfg = dict(width=24, height=14, spp=2, max_depth=4)
    true = _scene(ort, "readme")
    target = np.asarray(ort.render(true, ort.RenderConfig(**cfg), seed=11))
    jinit = _scene(ort, "readme", SKY * 0.8)
    _, jlosses = jax_fit_scene(
        jnp.asarray(target), jinit, ort.RenderConfig(**cfg),
        param_paths=("sky.image",), steps=2, learning_rate=1e-2, seed=4,
        sample_new_noise=False, grad_backend="jnp")
    before = (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES)
    fitted, losses = ot.fit_scene(
        torch.tensor(target), _scene(ot, "readme", SKY * 0.8),
        ot.RenderConfig(**cfg), param_paths=("sky.image",), steps=2,
        learning_rate=1e-2, seed=4, sample_new_noise=False,
        grad_backend="kernel", device="cpu")
    assert (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES) == before
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert losses[1] < losses[0]
    moved = fitted.sky.image - torch.tensor(SKY * 0.8)
    # two Adam steps move a texel by at most twice the learning rate
    assert float(moved.abs().max()) == pytest.approx(2e-2, rel=1e-2)


def test_hdr_grad_scope_and_checks():
    cfg = _cfg(ot, 2)
    scene = _scene(ot, "mesh")
    assert mg.supports_grad_hdr(scene, cfg)
    assert mg.unsupported_grad_reason(scene) is None
    assert "K6 and K7" in mg.unsupported_grad_mesh_reason(scene)
    bright = _scene(ot, "mesh", SKY * 2.0)
    assert "at most 1" in mg.unsupported_grad_hdr_reason(bright)
    assert "HDR sky" in mg.unsupported_grad_hdr_reason(ot.readme_scene())
    # explicit "kernel" routes out of scope raise before the device is
    # touched; "auto" there takes the plain route
    with pytest.raises(NotImplementedError, match="at most 1"):
        ot.render_grad_sampled(bright, cfg, _loss, grad_backend="kernel",
                               device="cuda")
    with pytest.raises(NotImplementedError, match="at most 1"):
        ot.fit_scene(torch.zeros((16, 32, 3)), bright, cfg,
                     param_paths=("sky.image",), grad_backend="kernel",
                     device="cuda")
    for paths, match in ((("sky.const_colour",), "sky.const_colour"),
                         (("triangles.albedo",), "uniform")):
        with pytest.raises(NotImplementedError, match=match):
            ot.fit_scene(torch.zeros((16, 32, 3)), scene, cfg,
                         param_paths=paths, grad_backend="kernel",
                         device="cuda")
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    n_pix = 8
    g = torch.zeros(3, n_pix)
    with pytest.raises(ValueError, match="sky_rows"):
        mg.hdr_consume(cam, sph, n, tab, cfg, flags, g[0], g[1], g[2],
                       torch.zeros(3, 1, n_pix), 0, n_pix)
    with pytest.raises(ValueError, match="2 int64"):
        mg.hdr_emit(cam, sph, n, tab, cfg, flags, 0, n_pix,
                    counts=torch.zeros(4, dtype=torch.int64))
    # K5 refuses an HDR sky
    with pytest.raises(ValueError, match="K7"):
        mg.render_grad_mesh_tables(cam, sph, n, tab, cfg, scene.sky.kind,
                                   flags, g[0], g[1], g[2], 0, n_pix)
