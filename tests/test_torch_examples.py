"""The port's versions of the JAX package's examples against those examples.

- ``examples/fit_mesh_vertices_torch.py``: step 0 of the shear fit at the
  example's own configuration (the reference scene with a 96-triangle
  fuzzy-metal torus, 64x36, 2 spp, depth 5, the "zero" NaN policy, seed
  7, s0 = 0.02) on the CPU, through the mesh kernels' route
  (``grad_backend="kernel"``, whose wrappers run their plain versions on
  CPU tensors), against the JAX example's own route:
  ``render_grad_sampled(..., grad_backend="pallas")``, the Pallas kernels
  in interpret mode.  The loss within 1e-4 and dL/ds within 5e-3
  (relative; tests/test_megagrad.py's tolerance for a metal mesh).
- ``examples/fit_sky_image_torch.py``: step 0 of the gain fit (the README
  scene under the tone-mapped 64x32 procedural sky, 64x36, 2 spp, depth
  4, gain 0.6) the same way, through the fused HDR route; dL/dgain within
  5e-4 (relative) of the JAX example's route and of JAX's jnp route, the
  image under the image tolerance below of both.  JAX's Pallas route
  draws two of the 2,304 pixels differently from its own ``render()``
  (a sample's path flips under an ulp; 0.226 in G and B), which moves its
  loss by 1.1e-3 relative; the port's image is ``render()``'s, so the
  loss is held within 1e-4 of JAX's jnp route
  (``render_grad_sampled(grad_backend="jnp")``, whose image is
  ``render()``'s).
  The JAX results of both (the target image, the loss, the step's image,
  dL/ds or dL/dgain, and for the sky the jnp route's) are read from
  tests/goldens/torch_grad_refs.npz with the inputs they came from
  (``jax_references``; ``python tools/make_port_refs.py examples``
  records them), so that the interpret-mode kernels never run here.
  (JAX's ``grad_backend="jnp"`` gives NaN vertex gradients on a mesh:
  ROADMAP §C.)  Each example's
  scene equals the JAX example's leaf for leaf, and its target image the
  JAX target under the image tolerance of tests/test_megakernel.py.
- ``examples/reference_scene_render_torch.py``: its scene, with the
  procedural torus and with an OBJ file through ``--obj`` (the native
  loader under the reference transform), equals the scene the JAX example
  builds leaf for leaf; its image at 32x18, 1 spp, depth 3 equals the
  port's ``render()`` of that scene on the CPU, and its PNG is written.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
from opencl_ray_tracer_tpu.io.hdr import tone_map
from opencl_ray_tracer_tpu.io.obj import load_obj, parse_obj
from opencl_ray_tracer_tpu.io.procgen import make_sky_image, make_torus_obj
from opencl_ray_tracer_tpu.scene import Sky as JSky
from opencl_ray_tracer_tpu.tracer.render import (
    render_grad_sampled as jax_render_grad_sampled)
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy
from test_torch_megakernel import assert_images_close

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))
try:
    import fit_mesh_vertices_torch as fit_mesh
    import fit_sky_image_torch as fit_sky
    import reference_scene_render_torch as ref_render
finally:
    sys.path.pop(0)

torch.set_num_threads(1)

DIRECTION = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)


def _jax_mesh_case():
    """The JAX example's scene and configuration, sheared by s0."""
    tris, aabb = parse_obj(make_torus_obj(8, 6), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    scene = ort.reference_scene(mesh_tris=tris, mesh_aabb=aabb)
    cfg = ort.RenderConfig(width=64, height=36, spp=2, max_depth=5,
                           nan_policy="zero")
    sheared = dataclasses.replace(scene, triangles=dataclasses.replace(
        scene.triangles, p0=scene.triangles.p0
        + jnp.float32(fit_mesh.S0) * DIRECTION))
    return scene, sheared, cfg


def _jax_sky_case():
    """The JAX example's scene and configuration, its sky dimmed by g0."""
    sky_img = tone_map(make_sky_image(64, 32))
    scene = dataclasses.replace(ort.readme_scene(), sky=JSky.hdr(sky_img))
    cfg = ort.RenderConfig(width=64, height=36, spp=2, max_depth=4,
                           nan_policy="zero")
    dimmed = dataclasses.replace(
        scene, sky=JSky.hdr(sky_img * jnp.float32(fit_sky.G0)))
    return scene, dimmed, cfg, sky_img


def jax_references() -> dict:
    """Step 0 of both JAX examples through their own route (the Pallas
    kernels in interpret mode on the CPU), keyed "examples/<example>/<name>"
    (``tools/make_port_refs.py`` records them)."""
    refs = {}
    scene, sheared, cfg = _jax_mesh_case()
    target = ort.render(scene, cfg, seed=fit_mesh.SEED)
    loss, img, g = jax_render_grad_sampled(
        sheared, cfg, lambda im: jnp.mean((im - target) ** 2),
        seed=fit_mesh.SEED, grad_backend="pallas")
    refs.update(port_refs.record(
        "examples/fit_mesh_vertices", sheared, cfg, fit_mesh.SEED, loss,
        img, outputs={"target": target,
                      "ds": jnp.sum(g.triangles.p0 * DIRECTION)}))
    scene, dimmed, cfg, sky_img = _jax_sky_case()
    target = ort.render(scene, cfg, seed=fit_sky.SEED)
    loss, img, g = jax_render_grad_sampled(
        dimmed, cfg, lambda im: jnp.mean((im - target) ** 2),
        seed=fit_sky.SEED, grad_backend="pallas")
    refs.update(port_refs.record(
        "examples/fit_sky_image", dimmed, cfg, fit_sky.SEED, loss, img,
        outputs={"target": target, "dg": jnp.sum(g.sky.image * sky_img)}))
    # JAX's jnp route: its image is render()'s
    loss, img, g = jax_render_grad_sampled(
        dimmed, cfg, lambda im: jnp.mean((im - target) ** 2),
        seed=fit_sky.SEED, grad_backend="jnp")
    refs.update(port_refs.record(
        "examples/fit_sky_image_jnp", dimmed, cfg, fit_sky.SEED, loss, img,
        outputs={"dg": jnp.sum(g.sky.image * sky_img)}))
    return refs


def _assert_leaves_equal(port_scene, jax_scene):
    got, want = scene_to_numpy(port_scene), scene_to_numpy(jax_scene)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(port_scene.sky.kind) == int(jax_scene.sky.kind)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def test_fit_mesh_vertices_step0_matches_jax():
    _, sheared, jcfg = _jax_mesh_case()
    jloss, jimg, refs = port_refs.load("examples/fit_mesh_vertices",
                                       sheared, jcfg, fit_mesh.SEED)
    scene, cfg = fit_mesh.make_scene()
    _assert_leaves_equal(fit_mesh.deformed(scene, fit_mesh.S0), sheared)
    target = ot.render(scene, cfg, seed=fit_mesh.SEED, device="cpu")
    assert_images_close(target.numpy(), refs["target"])
    loss, ds, img = fit_mesh.fit_step(scene, cfg, target, fit_mesh.S0,
                                      device="cpu")
    assert_images_close(img.numpy(), jimg)
    assert _rel(loss, jloss) < 1e-4, (loss, jloss)
    assert _rel(ds, float(refs["ds"])) < 5e-3, (ds, float(refs["ds"]))


def test_fit_sky_image_step0_matches_jax():
    _, dimmed, jcfg, _ = _jax_sky_case()
    _, jimg, refs = port_refs.load("examples/fit_sky_image", dimmed, jcfg,
                                   fit_sky.SEED)
    jloss, jnp_img, jnp_refs = port_refs.load("examples/fit_sky_image_jnp",
                                              dimmed, jcfg, fit_sky.SEED)
    scene, cfg, sky_img = fit_sky.make_scene()
    _assert_leaves_equal(fit_sky.dimmed(scene, sky_img, fit_sky.G0), dimmed)
    target = ot.render(scene, cfg, seed=fit_sky.SEED, device="cpu")
    assert_images_close(target.numpy(), refs["target"])
    loss, dg, img = fit_sky.fit_step(scene, sky_img, cfg, target,
                                     fit_sky.G0, device="cpu")
    assert_images_close(img.numpy(), jimg)
    assert_images_close(img.numpy(), jnp_img)
    assert _rel(loss, jloss) < 1e-4, (loss, jloss)
    assert _rel(dg, float(refs["dg"])) < 5e-4, (dg, float(refs["dg"]))
    assert _rel(dg, float(jnp_refs["dg"])) < 5e-4, (dg, float(jnp_refs["dg"]))


@pytest.mark.parametrize("mesh", ["procedural", "obj"])
def test_reference_scene_render_example(mesh, tmp_path):
    sky = JSky.hdr(tone_map(make_sky_image(1024, 512)))
    argv = ["--cpu", "-o", str(tmp_path / "ref.png")]
    if mesh == "obj":
        # the JAX example's --obj branch: load_obj under the reference
        # transform (the JAX package's Python parser; the port's native one)
        path = str(tmp_path / "mesh.obj")
        with open(path, "w") as f:
            f.write(make_torus_obj(12, 8))
        tris, aabb = load_obj(path, scale=(0.15, 0.15, 0.15),
                              translate=(0.0, -0.5, -1.0))
        argv += ["--obj", path]
    else:
        tris, aabb = parse_obj(make_torus_obj(24, 12), scale=(0.5, 0.5, 0.5),
                               translate=(0.3, 0.0, -1.6))
    jscene = ort.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)
    cfg = ot.RenderConfig(width=32, height=18, spp=1, max_depth=3)
    run = ref_render.main(argv, cfg=cfg)
    _assert_leaves_equal(run["scene"], jscene)
    assert run["scene"].triangles.count == (576 if mesh == "procedural"
                                            else 192)
    want = ot.render(run["scene"], cfg, seed=0, device="cpu")
    assert torch.equal(run["image"], want)
    assert os.path.getsize(tmp_path / "ref.png") > 0
