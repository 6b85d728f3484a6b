"""The port's scene gradients on the CPU against the JAX package's.

- ``render_and_grad`` against JAX ``render_and_grad``, leaf by leaf, with
  max|a - b| / max|b| under the tolerances of tests/test_megagrad.py: the
  reference scene under a gradient sky (5e-3) and a constant sky (1e-3),
  the README scene (8e-2 and a cosine above 0.9999 of the stacked centre,
  albedo and radius gradient: fuzzy-metal chains are ill-conditioned in
  f32), an emissive sphere whose albedo (2.5, 0.9, 2.5) clamps two
  channels (5e-3), and 40 random spheres (2e-2).  Both draw the same
  counter-RNG samples, so the paths agree but for ulps.  JAX's losses and
  gradients are recorded with their inputs (below).
- ``render_grad_sampled(grad_backend="plain")`` against JAX
  ``render_grad_sampled(grad_backend="jnp")``: loss, image and gradients
  (JAX's recorded with the inputs they came from in
  tests/goldens/torch_grad_refs.npz by ``tools/make_port_refs.py``, which
  calls ``jax_references`` below; ``port_refs.load`` checks the inputs).
- One finite-difference check of the albedo gradient on the port alone.

Scenes cross over as numpy leaves (``scene_to_numpy``).
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
from opencl_ray_tracer_tpu.scene import Sky as JSky
from opencl_ray_tracer_tpu.tracer.render import (
    render_and_grad as jax_render_and_grad,
    render_grad_sampled as jax_render_grad_sampled)
from opencl_ray_tracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy

torch.set_num_threads(1)

CFG = dict(width=32, height=18, spp=3, max_depth=5, nan_policy="zero")
SEED = 7
LEAVES = ("spheres.center", "spheres.radius", "spheres.albedo",
          "spheres.fuzz", "spheres.ior", "camera.look_from",
          "camera.look_at", "camera.vfov_deg", "camera.aperture_deg",
          "camera.focus_dist", "sky.const_colour")


def jax_loss(img):
    return jnp.mean(img ** 2)


def torch_loss(img):
    return torch.mean(img ** 2)


def _random_spheres(scene):
    rng = np.random.default_rng(42)
    n = 40
    sp = scene.spheres
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        sp,
        center=jnp.asarray(np.stack([rng.uniform(-3, 3, n),
                                     rng.uniform(0.3, 0.8, n),
                                     rng.uniform(-3, 3, n)], 1), jnp.float32),
        radius=jnp.asarray(rng.uniform(0.2, 0.45, n), jnp.float32),
        albedo=jnp.asarray(rng.uniform(0.1, 0.9, (n, 3)), jnp.float32),
        mat_type=jnp.asarray(rng.integers(0, 2, n), jnp.int32),
        fuzz=jnp.asarray(rng.uniform(0.0, 0.3, n), jnp.float32),
        ior=jnp.full((n,), 1.5, jnp.float32)))


def _emissive_clamp(scene):
    sp = scene.spheres
    alb = np.asarray(sp.albedo).copy()
    alb[int(np.argmax(np.asarray(sp.mat_type) == 3))] = (2.5, 0.9, 2.5)
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        sp, albedo=jnp.asarray(alb)))


# name: (JAX scene, tolerance)
CASES = {
    "reference_gradient_sky": (lambda: ort.reference_scene(), 5e-3),
    "reference_const_sky": (lambda: dataclasses.replace(
        ort.reference_scene(), sky=JSky.constant((0.6, 0.7, 0.9))), 1e-3),
    "readme": (lambda: ort.readme_scene(), 8e-2),
    "emissive_clamp": (lambda: _emissive_clamp(ort.reference_scene()), 5e-3),
    "random_40": (lambda: _random_spheres(ort.reference_scene()), 2e-2),
}


def to_port(js):
    return scene_from_numpy(scene_to_numpy(js), js.sky.kind)


def assert_grads_close(got: dict, want: dict, rtol: float):
    """max|a - b| / max|b| per leaf (scale floor 1e-6), as
    tests/test_megagrad.py::_assert_close."""
    for name in LEAVES:
        a, b = got[name], want[name]
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a - b).max()) / scale
        assert err < rtol, f"{name}: relerr {err:.3e} (scale {scale:.2e})"


def stacked_cosine(got: dict, want: dict) -> float:
    keys = ("spheres.center", "spheres.albedo", "spheres.radius")
    va = np.concatenate([got[k].ravel() for k in keys]).astype(np.float64)
    vb = np.concatenate([want[k].ravel() for k in keys]).astype(np.float64)
    return float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_and_grad_matches_jax(case):
    make, rtol = CASES[case]
    js = make()
    cfg = ot.RenderConfig(**CFG)
    jl, _, want = port_refs.load(f"grad/render_and_grad/{case}", js,
                                 ort.RenderConfig(**CFG), SEED)
    tl, tg = ot.render_and_grad(to_port(js), cfg, torch_loss, seed=SEED,
                                device="cpu")
    assert tg.spheres.mat_type is None
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    got = scene_to_numpy(tg)
    assert_grads_close(got, want, rtol)
    if case == "readme":
        assert stacked_cosine(got, want) > 0.9999
    if case == "reference_const_sky":
        assert np.abs(got["sky.const_colour"]).max() > 0


def jax_references() -> dict:
    """JAX render_and_grad of every case (its loss and gradient leaves,
    keyed "grad/render_and_grad/<case>/<name>"), and JAX
    render_grad_sampled(grad_backend="jnp") of the reference scene (its
    loss, image and gradient leaves, keyed "grad/sampled/<name>"), each
    with its inputs (``tools/make_port_refs.py`` records them).  The JAX
    render_and_grad differentiates the whole closest-hit fold (its
    fast_hit=False): the same gradients as its winner-only hit
    (tests/test_diffhit.py), at a fraction of the compile time; scenes of
    the same structure share one jit."""
    jcfg = ort.RenderConfig(**CFG)
    render_and_grad = jax.jit(lambda js: jax_render_and_grad(
        js, jcfg, jax_loss, seed=SEED, fast_hit=False))
    refs = {}
    for case, (make, _) in CASES.items():
        js = make()
        loss, g = render_and_grad(js)
        refs.update(port_refs.record(f"grad/render_and_grad/{case}", js,
                                     jcfg, SEED, loss, grads=g))
    js = ort.reference_scene()
    loss, img, g = jax_render_grad_sampled(js, jcfg, jax_loss, seed=SEED,
                                           grad_backend="jnp")
    refs.update(port_refs.record("grad/sampled", js, jcfg, SEED, loss, img,
                                 g))
    return refs


def test_render_grad_sampled_plain_matches_jax():
    js = ort.reference_scene()
    jl, jimg, want = port_refs.load("grad/sampled", js,
                                    ort.RenderConfig(**CFG), SEED)
    # chunks of 9 rows and 2 samples: two row chunks, two sample chunks
    tl, timg, tg = ot.render_grad_sampled(
        to_port(js), ot.RenderConfig(**CFG), torch_loss, seed=SEED,
        spp_chunk=2, row_chunk=9, grad_backend="plain", device="cpu")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    diff = np.abs(timg.numpy() - jimg)
    assert (diff > 1e-4).mean() < 0.005 and diff.mean() < 1e-4
    assert_grads_close(scene_to_numpy(tg), want, 5e-3)


def test_render_and_grad_remat_and_full_fold_agree():
    """remat and the whole-fold hit (fast_hit=False) give the same
    gradients as the default."""
    scene = ot.reference_scene()
    cfg = ot.RenderConfig(width=12, height=8, spp=2, max_depth=4)
    _, g0 = ot.render_and_grad(scene, cfg, torch_loss, seed=1, device="cpu")
    _, g1 = ot.render_and_grad(scene, cfg, torch_loss, seed=1, remat=True,
                               device="cpu")
    _, g2 = ot.render_and_grad(scene, cfg, torch_loss, seed=1,
                               fast_hit=False, device="cpu")
    a, b, c = (scene_to_numpy(g) for g in (g0, g1, g2))
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(c[k], a[k], rtol=1e-4, atol=1e-8)


def test_albedo_gradient_matches_finite_differences():
    """tests/test_grad.py::test_albedo_gradient_matches_fd on the port:
    albedo changes no discrete event, so the estimator is smooth in it."""
    scene = ot.readme_scene()
    cfg = ot.RenderConfig(width=24, height=14, spp=3, max_depth=5,
                          early_stop=False)

    def loss_at(albedo):
        s = dataclasses.replace(scene, spheres=dataclasses.replace(
            scene.spheres, albedo=albedo))
        return torch.mean(ot.render(s, cfg, seed=0, device="cpu"))

    _, g = ot.render_and_grad(scene, cfg, torch.mean, seed=0, device="cpu")
    a0 = scene.spheres.albedo
    for i, c in [(0, 1), (1, 0), (3, 2)]:
        e = torch.zeros_like(a0)
        e[i, c] = 1.0
        fd = float(loss_at(a0 + 1e-3 * e) - loss_at(a0 - 1e-3 * e)) / 2e-3
        ad = float(g.spheres.albedo[i, c])
        assert abs(fd - ad) < 3e-4 + 0.02 * abs(fd), (i, c, fd, ad)
        assert ad > 0.0


def test_gradients_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render_grad_sampled(ot.readme_scene(), cfg, torch_loss)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render_and_grad(ot.readme_scene(), cfg, torch_loss)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.fit_scene(torch.zeros((4, 8, 3)), ot.readme_scene(), cfg, steps=1)
