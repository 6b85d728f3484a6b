"""The port's mesh render against the JAX package's.

- ``render(device="cpu")`` of the tests/test_megamesh.py mesh scene (the
  reference spheres and a 192-triangle fuzzy-metal torus) against JAX
  ``ort.render``, under that file's ``_compare`` tolerance: at most 0.5%
  of pixels off by more than 1e-3, more than 99% within 1e-4, means within
  2e-3 (the same pcg4d streams; only samples that cross a discrete event
  under an ulp of difference move).  JAX's image is recorded with its
  inputs in tests/goldens/torch_grad_refs.npz (``jax_references``;
  ``python tools/make_port_refs.py mesh_render`` records it).
- ``render_mesh_plain``, the mesh megakernel's plain version, on that
  scene's tables against the port's plain render, and the three triangle
  forms of the plain tracer against each other, under the same tolerance.
- The scope and the host tables of the mesh megakernel against the JAX
  package's (``supports_mesh`` on the cases of test_megamesh.py:76-92
  without an HDR sky, ``specialize_mesh_flags``, the camera table).
- Routing: on the card ``render`` sends such scenes to the mesh
  megakernel; the gradient entry points' kernel routes refuse an HDR sky
  brighter than 1, the fit of a sky leaf other than its image, and a mesh
  of more than one material.

The CUDA kernel against its plain version is in test_torch_kernels_gpu.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
from opencl_ray_tracer_tpu.io.obj import parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_torus_obj
from opencl_ray_tracer_tpu.kernels import megamesh as jmm
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
from opencl_ray_tracer_tpu_torch.tracer.render import kernel_route

torch.set_num_threads(1)

CFG = dict(width=48, height=32, spp=3, max_depth=5)


def _mesh_scene(mod, sky=None):
    """tests/test_megamesh.py::_mesh_scene."""
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    return mod.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)


def assert_images_close(got, want, frac=0.005):
    """tests/test_megamesh.py::_compare's tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want)
    flipped = (diff > 1e-3).mean()
    assert flipped < frac, f"{flipped:.4%} pixels flipped"
    assert (diff <= 1e-4).mean() > 1.0 - 2 * frac
    assert abs(got.mean() - want.mean()) < 2e-3


_IMAGES = {}


def _port_image():
    if "port" not in _IMAGES:
        _IMAGES["port"] = ot.render(_mesh_scene(ot), ot.RenderConfig(**CFG),
                                    seed=0, device="cpu")
    return _IMAGES["port"]


def jax_references() -> dict:
    """JAX ``ort.render`` of the mesh scene with its inputs, keyed
    "mesh_render/render/img" (``tools/make_port_refs.py`` records it)."""
    jscene, jcfg = _mesh_scene(ort), ort.RenderConfig(**CFG)
    return port_refs.record("mesh_render/render", jscene, jcfg, 0,
                            img=ort.render(jscene, jcfg, seed=0))


def test_render_cpu_matches_jax():
    _, want, _ = port_refs.load("mesh_render/render", _mesh_scene(ort),
                                ort.RenderConfig(**CFG), 0)
    got = _port_image()
    assert got.shape == (32, 48, 3) and not torch.isnan(got).any()
    assert_images_close(got.numpy(), want)


def test_render_mesh_plain_matches_port_render():
    scene = _mesh_scene(ot)
    cfg = ot.RenderConfig(**CFG)
    counts = torch.zeros(2, dtype=torch.int64)
    before = mm.LAUNCHES
    r, g, b = mm.render_mesh(mm.mesh_camera_table(scene),
                             mk.sphere_table(scene), scene.spheres.count,
                             mm.mesh_tables(scene), cfg, scene.sky.kind,
                             mm.specialize_mesh_flags(scene), 0,
                             cfg.width * cfg.height, counts=counts)
    assert mm.LAUNCHES == before     # CPU tensors: the plain version
    img = torch.stack([r, g, b], -1).reshape(cfg.height, cfg.width, 3)
    assert_images_close(img, _port_image())
    n_samples = cfg.width * cfg.height * cfg.spp
    assert n_samples <= counts[0] <= n_samples * cfg.max_depth
    assert counts[1] > 0


@pytest.mark.parametrize("tri_backend", ["mm", "pallas"])
def test_triangle_forms_agree(tri_backend):
    """The matmul fold and the closest-triangle kernel's plain version in
    place of the direct form (192 triangles take the direct form)."""
    got = ot.render(_mesh_scene(ot),
                    ot.RenderConfig(**CFG, tri_backend=tri_backend), seed=0,
                    device="cpu")
    assert_images_close(got, _port_image())


def _supports_cases(mod):
    cfg = mod.RenderConfig(width=32, height=16, spp=2, max_depth=4)
    return {
        "readme_spp2": (mod.readme_scene(), cfg),
        "mesh": (_mesh_scene(mod), cfg),
        "mesh_const_sky": (_mesh_scene(mod, mod.Sky.constant((0.2, 0.4,
                                                               0.6))), cfg),
        "readme_spp64": (mod.readme_scene(), cfg.replace(spp=64)),
        "book_cover": (mod.book_cover_scene(), cfg),
    }


@pytest.mark.parametrize("case", sorted(_supports_cases(ot)))
def test_supports_mesh_matches_jax(case):
    """The same answer on scenes with triangles and on the small sphere
    scene.  The JAX package also takes sphere-only scenes into its fused
    mesh kernel from 24 spheres or 64 spp, for the TPU's scheduling; the
    port's mesh megakernel needs a triangle, and those scenes take the
    sphere megakernel."""
    scene, cfg = _supports_cases(ot)[case]
    jscene, jcfg = _supports_cases(ort)[case]
    if case in ("readme_spp64", "book_cover"):
        assert jmm.supports_mesh(jscene, jcfg)
        assert not mm.supports_mesh(scene, cfg)
        assert kernel_route(scene, cfg) == "megakernel"
    else:
        assert mm.supports_mesh(scene, cfg) == jmm.supports_mesh(jscene, jcfg)


def test_scope_needs_one_material_and_a_box():
    scene = _mesh_scene(ot)
    cfg = ot.RenderConfig(**CFG)
    assert kernel_route(scene, cfg) == "megamesh"
    assert kernel_route(scene, cfg.replace(backend="jnp")) is None
    t = scene.triangles
    mixed = dataclasses.replace(scene, triangles=dataclasses.replace(
        t, fuzz=torch.linspace(0.0, 0.5, t.count)))
    assert "uniform" in mm.unsupported_mesh_reason(mixed)
    assert kernel_route(mixed, cfg) is None      # the plain tracer
    boxless = dataclasses.replace(scene, boxes=ot.BoundingBoxes.empty())
    assert "gating boxes" in mm.unsupported_mesh_reason(boxless)
    # any number of boxes: 40, triangle i in box i % 40
    many = dataclasses.replace(
        scene, triangles=dataclasses.replace(
            t, box_id=torch.arange(t.count, dtype=torch.int32) % 40),
        boxes=ot.BoundingBoxes(scene.boxes.box_min.expand(40, 3),
                               scene.boxes.box_max.expand(40, 3)))
    assert kernel_route(many, cfg) == "megamesh"
    # an HDR sky: the mesh megakernel's HDR body, for texels at most 1 and
    # for brighter ones (the JAX package's takes the plain tracer there)
    hdr = dataclasses.replace(scene, sky=ot.Sky.hdr(torch.ones((4, 8, 3))))
    assert kernel_route(hdr, cfg) == "megamesh"
    bright = dataclasses.replace(
        scene, sky=ot.Sky.hdr(torch.full((4, 8, 3), 2.0)))
    assert kernel_route(bright, cfg) == "megamesh"
    assert mm.unsupported_mesh_reason(bright) is None


@pytest.mark.parametrize("material", ["metal", "dielectric", "emissive"])
def test_mesh_flags_and_camera_table_match_jax(material):
    code = ot.materials.MATERIAL_NAMES[material]
    scenes = []
    for mod in (ot, ort):
        s = _mesh_scene(mod)
        n = s.triangles.count
        full = ((lambda v: torch.full((n,), v)) if mod is ot
                else (lambda v: np.full((n,), v, np.float32)))
        tris = dataclasses.replace(
            s.triangles, ior=full(1.5), mat_type=(
                torch.full((n,), code, dtype=torch.int32) if mod is ot
                else np.full((n,), code, np.int32)))
        scenes.append(dataclasses.replace(s, triangles=tris))
    ts, js = scenes
    jflags = jmm.specialize_mesh_flags(js)
    assert mm.specialize_mesh_flags(ts) == tuple(jflags[:6])
    assert (mm.specialize_mesh_flags(ts, conservative=True)
            == tuple(jmm.specialize_mesh_flags(js, conservative=True)[:6]))
    np.testing.assert_allclose(mm.mesh_camera_table(ts).numpy(),
                               np.asarray(jmm._mesh_camera_table(js)),
                               rtol=1e-6, atol=1e-7)


def test_mesh_inputs_are_cached_by_content():
    """Rendering a scene again builds nothing: the same inputs come back for
    an equal scene, new ones when any leaf changes; the mesh route renders
    the plain version's image from them on the CPU."""
    scene = _mesh_scene(ot)
    first = mm.mesh_inputs(scene, "cpu")
    assert mm.mesh_inputs(_mesh_scene(ot), "cpu") is first
    moved = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, look_from=scene.camera.look_from + 0.1))
    other = mm.mesh_inputs(moved, "cpu")
    assert other is not first and other[3] is not first[3]
    t = scene.triangles
    recoloured = dataclasses.replace(scene, triangles=dataclasses.replace(
        t, albedo=t.albedo * 0.5))
    again = mm.mesh_inputs(recoloured, "cpu")
    assert again is not first and torch.equal(again[3].tri, first[3].tri)
    cfg = ot.RenderConfig(**CFG)
    img = mm.render_megamesh(scene, cfg, seed=0, device="cpu")
    assert_images_close(img, _port_image())


def test_gradients_refuse_mesh_scenes():
    """Mesh and HDR gradients are ported (tests/test_torch_mesh_grad.py,
    tests/test_torch_hdr_grad.py); an explicit "kernel" route refuses a
    mesh of more than one material under an HDR sky (brighter than 1,
    which the HDR kernels take), naming the bound, the fit of a sky leaf
    the HDR kernels do not take, and a mesh of more than one material,
    before anything moves to the card (this machine has none)."""
    scene = _mesh_scene(ot, sky=ot.Sky.hdr(torch.full((4, 8, 3), 2.0)))
    t = scene.triangles
    scene = dataclasses.replace(scene, triangles=dataclasses.replace(
        t, fuzz=torch.linspace(0.0, 0.5, t.count)))
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(NotImplementedError, match="HDR scope.*uniform"):
        ot.render_grad_sampled(scene, cfg, lambda im: im.mean(),
                               grad_backend="kernel", device="cuda")
    with pytest.raises(NotImplementedError, match="HDR scope.*uniform"):
        ot.fit_scene(torch.zeros((4, 8, 3)), scene, cfg,
                     param_paths=("sky.image",), grad_backend="kernel",
                     device="cuda")
    dim = _mesh_scene(ot, sky=ot.Sky.hdr(torch.ones((4, 8, 3))))
    with pytest.raises(NotImplementedError, match="sky.const_colour"):
        ot.fit_scene(torch.zeros((4, 8, 3)), dim, cfg,
                     param_paths=("sky.const_colour",),
                     grad_backend="kernel", device="cuda")
    mixed = _mesh_scene(ot)
    t = mixed.triangles
    mixed = dataclasses.replace(mixed, triangles=dataclasses.replace(
        t, fuzz=torch.linspace(0.0, 0.5, t.count)))
    with pytest.raises(NotImplementedError, match="uniform"):
        ot.render_grad_sampled(mixed, cfg, lambda im: im.mean(),
                               grad_backend="kernel", device="cuda")
    with pytest.raises(NotImplementedError, match="uniform"):
        ot.fit_scene(torch.zeros((4, 8, 3)), mixed, cfg,
                     param_paths=("triangles.p0",), grad_backend="kernel",
                     device="cuda")
