"""The port's scene layer against the JAX package's: presets carried across
by ``scene_from_numpy`` equal the port's own exactly; camera frames, rays
and skies agree to 1e-6 (f32 tan/sin/cos/sqrt differ by a few ulp between
XLA and ATen); RenderConfig JSON loads on both sides."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.scene import camera as jcam, sky as jsky
from opencl_ray_tracer_tpu_torch.scene import camera as tcam, sky as tsky

torch.set_num_threads(1)

PRESETS = ["readme_scene", "reference_scene", "book_cover_scene"]


def jax_leaves(scene):
    """Flat ``"group.field"`` numpy leaves of a JAX scene, and its sky kind."""
    out = {}
    for group in dataclasses.fields(scene):
        obj = getattr(scene, group.name)
        for f in dataclasses.fields(obj):
            if f.name != "kind":
                out[f"{group.name}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out, scene.sky.kind


@pytest.mark.parametrize("name", PRESETS)
def test_scene_from_numpy_equals_port_preset(name):
    leaves, kind = jax_leaves(getattr(ort, name)())
    carried = ot.scene_from_numpy(leaves, kind, device="cpu")
    own = getattr(ot, name)()
    assert carried.sky.kind == own.sky.kind
    for group in dataclasses.fields(own):
        a, b = getattr(carried, group.name), getattr(own, group.name)
        for f in dataclasses.fields(b):
            if f.name == "kind":
                continue
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert torch.equal(x, y), f"{group.name}.{f.name}"


@pytest.mark.parametrize("name", PRESETS)
def test_camera_frame_and_rays_match(name):
    jscene = getattr(ort, name)()
    tscene = getattr(ot, name)()
    jf = jcam.camera_frame(jscene.camera)
    tf = tcam.camera_frame(tscene.camera)
    for key in jf:
        np.testing.assert_allclose(tf[key].numpy(), np.asarray(jf[key]),
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    u = np.random.default_rng(2).uniform(size=(4, 2000)).astype(np.float32)
    jo, jd = jcam.make_rays(jscene.camera, *(jnp.asarray(x) for x in u))
    to, td = tcam.make_rays(tscene.camera, *(torch.tensor(x) for x in u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)


def test_aperture_jitters_origin():
    # reference_scene has a 1.2-degree aperture: origins must spread
    scene = ot.reference_scene()
    u = torch.rand(4, 100, generator=torch.Generator().manual_seed(0))
    o, _ = tcam.make_rays(scene.camera, *u)
    assert float(o.std(dim=0).max()) > 1e-3


@pytest.mark.parametrize("kind", ["gradient", "constant"])
def test_sky_colour_matches(kind):
    d = np.random.default_rng(3).normal(size=(3000, 3)).astype(np.float32)
    if kind == "gradient":
        js, ts = jsky.Sky.gradient(), tsky.Sky.gradient()
    else:
        js, ts = (jsky.Sky.constant((0.2, 0.4, 0.6)),
                  tsky.Sky.constant((0.2, 0.4, 0.6)))
    want = np.asarray(jsky.sky_colour(js, jnp.asarray(d)))
    got = tsky.sky_colour(ts, torch.tensor(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg_kw", [
    {},
    dict(width=64, height=36, spp=8, max_depth=8, nan_policy="zero",
         clamp_samples=False, row_chunk=12, early_stop=False),
])
def test_render_config_json_round_trip(cfg_kw):
    tcfg = ot.RenderConfig(**cfg_kw)
    jcfg = ort.RenderConfig(**cfg_kw)
    assert tcfg.to_json() == jcfg.to_json()
    assert (dataclasses.asdict(ort.RenderConfig.from_json(tcfg.to_json()))
            == dataclasses.asdict(ot.RenderConfig.from_json(jcfg.to_json())))
    assert dataclasses.asdict(ot.README_BENCH) == dataclasses.asdict(
        ort.README_BENCH)
    assert dataclasses.asdict(ot.REFERENCE_DEFAULTS) == dataclasses.asdict(
        ort.REFERENCE_DEFAULTS)
