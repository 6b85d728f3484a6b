"""The port's forward render under an HDR sky against the JAX package's.

- ``render(device="cpu")``, the plain tracer, against JAX ``ort.render`` on
  the README spheres and on the mesh scene of tests/test_megamesh.py, each
  under the tone-mapped procedural sky of that file (``_hdr_sky``), and on
  the README spheres under twice that sky (texels up to 2, where the
  clamp before the average cuts sky terms), at
  32x16, 3 spp, depth 4, under tests/test_megamesh.py::_compare's
  tolerance (at most 0.5% of pixels off by more than 1e-3, more than 99%
  within 1e-4, means within 2e-3).
- ``render_mesh_plain``, the plain version of the mesh megakernel's HDR
  body, on those scenes' tables (none for the README spheres) against the
  port's plain render: the same image.
- The scope of the HDR body (``supports_mesh``) against the JAX package's
  on HDR scenes in and out of it (the port's also takes texels and
  albedos above 1, which JAX's does not), and the route ``render`` takes
  on the card (``kernel_route``).

The CUDA kernel against its plain version is in test_torch_kernels_gpu.py
and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.io.hdr import tone_map
from opencl_ray_tracer_tpu.io.obj import parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_sky_image, make_torus_obj
from opencl_ray_tracer_tpu.kernels import megamesh as jmm
from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
from opencl_ray_tracer_tpu_torch.tracer.render import kernel_route

torch.set_num_threads(1)

CFG = dict(width=32, height=16, spp=3, max_depth=4)
SKY = tone_map(make_sky_image(64, 32))
# texels and albedos above 1: in the port's HDR body, not in JAX's
ABOVE_1 = ("texel_above_1", "albedo_above_1", "untonemapped")


def _scene(mod, name, sky=SKY):
    """The README spheres, or tests/test_megamesh.py's mesh scene, under
    the HDR sky ``sky``; "bright": the README spheres under twice it."""
    if name == "bright":
        return _scene(mod, "readme", sky * 2.0)
    if name == "readme":
        return dataclasses.replace(mod.readme_scene(), sky=mod.Sky.hdr(sky))
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    return mod.reference_scene(mesh_tris=tris, mesh_aabb=aabb,
                               sky=mod.Sky.hdr(sky))


def assert_images_close(got, want, frac=0.005):
    """tests/test_megamesh.py::_compare's tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    flipped = (diff > 1e-3).mean()
    assert flipped < frac, f"{flipped:.4%} pixels flipped"
    assert (diff <= 1e-4).mean() > 1.0 - 2 * frac
    assert abs(got.mean() - want.mean()) < 2e-3


@pytest.mark.parametrize("name", ["bright", "readme", "mesh"])
def test_hdr_render_matches_jax_and_twin(name):
    cfg = ot.RenderConfig(**CFG)
    want = np.asarray(ort.render(_scene(ort, name), ort.RenderConfig(**CFG),
                                 seed=0))
    scene = _scene(ot, name)
    got = ot.render(scene, cfg, seed=0, device="cpu")
    assert got.shape == (16, 32, 3) and torch.isfinite(got).all()
    assert float(got.mean()) > 0.05
    assert_images_close(got.numpy(), want)
    # the plain version of K2's HDR body, on the kernel's inputs
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    assert (tab.tri.shape[1] == 0) == (name != "mesh")
    counts = torch.zeros(2, dtype=torch.int64)
    before = mm.LAUNCHES
    r, g, b = mm.render_mesh(cam, sph, n, tab, cfg, scene.sky.kind, flags, 0,
                             cfg.width * cfg.height, counts=counts,
                             sky_image=image)
    assert mm.LAUNCHES == before     # CPU tensors: the plain version
    twin = torch.stack([r, g, b], -1).reshape(cfg.height, cfg.width, 3)
    assert torch.equal(twin, got)
    assert counts[0] >= cfg.width * cfg.height * cfg.spp


def _mixed_material(mod):
    scene = _scene(mod, "mesh")
    fuzz = np.linspace(0.0, 0.5, scene.triangles.count).astype(np.float32)
    fuzz = torch.tensor(fuzz) if mod is ot else jnp.asarray(fuzz)
    return dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, fuzz=fuzz))


def test_hdr_scope_matches_jax():
    """supports_mesh's HDR conditions: at most 128 spheres, a uniform mesh
    material behind a box when there are triangles (JAX
    kernels/megamesh.py:909-947); JAX's also needs texels and albedos of
    at most 1, the port's takes them above 1 (ABOVE_1)."""
    cfg = dict(width=32, height=16, spp=2, max_depth=4)
    cases = {
        "readme": lambda m: _scene(m, "readme"),
        "mesh": lambda m: _scene(m, "mesh"),
        "texel_above_1": lambda m: _scene(m, "mesh", SKY * 1.5),
        "albedo_above_1": lambda m: dataclasses.replace(
            _scene(m, "readme"), spheres=dataclasses.replace(
                m.readme_scene().spheres,
                albedo=m.readme_scene().spheres.albedo * 2.0)),
        "untonemapped": lambda m: _scene(m, "readme", make_sky_image(64, 32)),
        "mixed_material": _mixed_material,
        "129_spheres": lambda m: dataclasses.replace(
            m.book_cover_scene(n_random=125), sky=m.Sky.hdr(SKY)),
    }
    for name, make in cases.items():
        want = jmm.supports_mesh(make(ort), ort.RenderConfig(**cfg))
        tscene = make(ot)
        got = mm.supports_mesh(tscene, ot.RenderConfig(**cfg))
        assert got == (want or name in ABOVE_1), name
        assert not (want and name in ABOVE_1), name
        assert (kernel_route(tscene, ot.RenderConfig(**cfg))
                == ("megamesh" if got else None)), name
        reason = mm.unsupported_mesh_reason(tscene)
        assert (reason is None) == got, name
    # the sphere megakernel never takes an HDR sky
    assert not mk.supports(_scene(ot, "readme"), ot.RenderConfig(**cfg))
    assert "HDR body" in mk.unsupported_reason(_scene(ot, "readme"))


def test_hdr_inputs_and_empty_tables():
    """A sphere scene under an HDR sky takes empty mesh tables and the sky
    image on the device; a wrong image is refused before any launch."""
    scene = _scene(ot, "readme")
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    assert tab.chunk_box.shape == (0,) and tab.boxes.shape == (0, 6)
    assert torch.equal(image, scene.sky.image)
    im.check_tables(tab, allow_empty=True)
    with pytest.raises(ValueError, match="one or more chunks"):
        im.check_tables(tab)
    cfg = ot.RenderConfig(**CFG)
    args = (cam, sph, n, tab, cfg, scene.sky.kind, flags, 0, 8)
    with pytest.raises(ValueError, match="HDR sky takes"):
        mm.render_mesh(*args)
    with pytest.raises(ValueError, match="HDR sky takes"):
        mm.render_mesh(*args, sky_image=image[..., :2].contiguous())
    # a gradient sky takes neither empty tables nor an image
    plain = ot.readme_scene()
    with pytest.raises(ValueError):
        mm.render_mesh(cam, sph, n, tab, cfg, plain.sky.kind, flags, 0, 8)
