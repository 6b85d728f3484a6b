"""The port's sphere megakernel module.

- ``render_spheres_plain`` (the kernel's plain PyTorch version) against the
  JAX package's Pallas megakernel run in interpret mode, under the
  tolerance of tests/test_megakernel.py: both draw the same pcg4d streams,
  so images agree sample for sample up to fp rounding, and only pixels
  whose samples cross a discrete event (hit/miss, absorb) under an ulp of
  difference move, by O(1/spp).
- The CUDA kernel against its plain version on the card is in
  test_torch_kernels_gpu.py, which imports no JAX.
- Routing: the wrapper takes the plain path for CPU tensors and only
  then; ``render`` without a device needs CUDA; unsupported scenes raise.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.kernels import render_pallas
from opencl_ray_tracer_tpu.scene import Sky as JSky
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)

CFG = dict(width=32, height=16, spp=2, max_depth=4)
CASES = {
    "readme": (lambda m: m.readme_scene(), {}),
    "reference_spheres": (lambda m: m.reference_scene(), {}),
    "const_sky": (lambda m: dataclasses.replace(
        m.readme_scene(), sky=m.Sky.constant((0.2, 0.4, 0.6))), {}),
    "nan_zero_no_clamp": (lambda m: m.readme_scene(),
                          dict(nan_policy="zero", clamp_samples=False)),
}


def assert_images_close(got, want, frac=0.005):
    """The tolerance of tests/test_megakernel.py::_compare."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    flipped = (diff > 1e-3).mean()
    assert flipped < frac, f"{flipped:.4%} pixels flipped"
    assert (diff <= 1e-4).mean() > 1.0 - 2 * frac
    assert abs(np.mean(got) - np.mean(want)) < 2e-3


def plain_image(scene, cfg, seed, device="cpu"):
    scene = scene.to(device)
    r, g, b = mk.render_spheres_plain(
        mk.camera_table(scene), mk.sphere_table(scene), scene.spheres.count,
        cfg, scene.sky.kind, mk.specialize_flags(scene), seed,
        cfg.width * cfg.height)
    return torch.stack([r, g, b], -1).reshape(cfg.height, cfg.width, 3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    make, kw = CASES[case]
    want = np.asarray(render_pallas(make(ort), ort.RenderConfig(**CFG, **kw),
                                    seed=0, interpret=True))
    got = plain_image(make(ot), ot.RenderConfig(**CFG, **kw), 0).numpy()
    assert got.shape == want.shape
    assert_images_close(got, want)


def test_wrapper_takes_plain_path_on_cpu():
    scene = ot.reference_scene()
    cfg = ot.RenderConfig(width=20, height=10, spp=2, max_depth=3)
    before = mk.LAUNCHES
    bounces = torch.zeros(1, dtype=torch.int64)
    out = mk.render_spheres(mk.camera_table(scene), mk.sphere_table(scene),
                            scene.spheres.count, cfg, scene.sky.kind,
                            mk.specialize_flags(scene), 5, 150,
                            pix_offset=25, bounces=bounces)
    assert mk.LAUNCHES == before
    img = ot.render(scene, cfg, seed=5, device="cpu").reshape(-1, 3)[25:175]
    for plane, k in zip(out, range(3)):
        assert plane.shape == (150,)
        torch.testing.assert_close(plane, img[:, k], rtol=0, atol=0)
    # every sample traces at least one and at most max_depth bounces
    assert 150 * cfg.spp <= bounces.item() <= 150 * cfg.spp * cfg.max_depth


def test_wrapper_checks_tables():
    scene = ot.readme_scene()
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
    args = (scene.spheres.count, cfg, scene.sky.kind,
            mk.specialize_flags(scene), 0, 32)
    with pytest.raises(ValueError):
        mk.render_spheres(cam.double(), sph, *args)
    with pytest.raises(ValueError):
        mk.render_spheres(cam, sph[:, :64], *args)
    with pytest.raises(ValueError):
        mk.render_spheres(cam, sph.t().contiguous().t(), *args)
    with pytest.raises(ValueError, match="sky"):
        mk.render_spheres(cam, sph, scene.spheres.count, cfg, 1,
                          mk.specialize_flags(scene), 0, 32)


def test_render_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render(ot.readme_scene(), cfg)


def test_unsupported_scenes_raise_on_cuda():
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    hdr = dataclasses.replace(ot.readme_scene(),
                              sky=ot.Sky.hdr(torch.ones((4, 8, 3))))
    with pytest.raises(NotImplementedError, match="HDR slice"):
        ot.render(hdr, cfg, device="cuda")
    many = ot.book_cover_scene(n_random=200)
    with pytest.raises(NotImplementedError, match="mesh slice"):
        ot.render(many, cfg, device="cuda")
    assert mk.supports(ot.readme_scene(), cfg)
    assert mk.supports(ot.book_cover_scene(), cfg)
    # the JAX predicate agrees on the same scenes
    from opencl_ray_tracer_tpu.kernels import megakernel_supports
    jcfg = ort.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    assert megakernel_supports(ort.book_cover_scene(), jcfg)
    assert not megakernel_supports(dataclasses.replace(
        ort.readme_scene(), sky=JSky.hdr(jnp.ones((4, 8, 3)))), jcfg)


def test_tables_match_jax_builders():
    from opencl_ray_tracer_tpu.kernels import megakernel as jmk
    for name in ("readme_scene", "reference_scene", "book_cover_scene"):
        js, ts = getattr(ort, name)(), getattr(ot, name)()
        np.testing.assert_allclose(mk.camera_table(ts).numpy(),
                                   np.asarray(jmk._camera_table(js)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(mk.sphere_table(ts).numpy(),
                                      np.asarray(jmk._sphere_table(js)))
        flags = jmk.specialize_flags(js)
        assert mk.specialize_flags(ts) == tuple(flags[:5])
