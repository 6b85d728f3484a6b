"""The port's mesh inputs against the JAX package's: the OBJ parser and
loader (arrays equal), the procedural assets (text and image equal byte for
byte), the JSON scene builder and the mesh reference scene (scene leaves
equal), and scenes carried across with their triangles and boxes
(``scene_from_numpy`` / ``scene_to_numpy``).  Everything here is exact:
both sides run the same numpy arithmetic on the same float32 values."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.io import obj as jobj
from opencl_ray_tracer_tpu.io import procgen as jgen
from opencl_ray_tracer_tpu.scene import builder as jbuilder
from opencl_ray_tracer_tpu_torch.io import obj as tobj
from opencl_ray_tracer_tpu_torch.io import procgen as tgen
from opencl_ray_tracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
SCENES = os.path.join(ROOT, "scenes")
# (scale, translate) of the reference executable's mesh (presets.py:138)
REF_XFORM = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))


def _assert_parse_equal(got, want):
    (gt, (glo, ghi)), (wt, (wlo, whi)) = got, want
    assert gt.dtype == np.float32 and gt.shape == wt.shape
    np.testing.assert_array_equal(gt, wt)
    np.testing.assert_array_equal(glo, wlo)
    np.testing.assert_array_equal(ghi, whi)


PROCGEN = {
    "uv_sphere": lambda m: m.make_uv_sphere_obj(),
    "uv_sphere_6x8_r2": lambda m: m.make_uv_sphere_obj(6, 8, 2.0),
    "torus": lambda m: m.make_torus_obj(),
    "torus_15360": lambda m: m.make_torus_obj(128, 60),
}


@pytest.mark.parametrize("name", sorted(PROCGEN))
def test_procgen_text_equal_bytes(name):
    text = PROCGEN[name](tgen)
    assert text.encode() == PROCGEN[name](jgen).encode()
    # and it parses to the same triangles, under the reference transform
    _assert_parse_equal(tobj.parse_obj(text, *REF_XFORM),
                        jobj.parse_obj(text, *REF_XFORM))


def test_procgen_torus_counts():
    tris, _ = tobj.parse_obj(tgen.make_torus_obj(128, 60))
    assert tris.shape == (15360, 3, 3)


def test_sky_image_equal_bytes():
    got = tgen.make_sky_image(64, 32)
    assert got.dtype == np.float32
    assert got.tobytes() == jgen.make_sky_image(64, 32).tobytes()


@pytest.mark.parametrize("asset", ["torus.obj", "uv_sphere.obj"])
@pytest.mark.parametrize("xform", [((1.0, 1.0, 1.0), (0.0, 0.0, 0.0)),
                                   REF_XFORM])
def test_load_obj_matches_jax(asset, xform):
    path = os.path.join(ASSETS, asset)
    got = tobj.load_obj(path, *xform)
    # the JAX package's Python parser, the behavioural reference
    with open(path) as f:
        _assert_parse_equal(got, jobj.parse_obj(f.read(), *xform))
    _assert_parse_equal(got, jobj.load_obj(path, *xform))


def test_parse_obj_forms_and_empty():
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3\nf 2/2/2 4/4/4 3/3/3\n"
    _assert_parse_equal(tobj.parse_obj(text), jobj.parse_obj(text))
    tris, (lo, hi) = tobj.parse_obj("# nothing\n")
    assert tris.shape == (0, 3, 3) and (lo == 0).all() and (hi == 0).all()


def _leaves_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _two_mesh_json():
    return json.dumps({
        "camera": {"look_from": [0.0, 0.5, 2.0], "look_at": [0, 0, -1],
                   "aperture_deg": 0.0},
        "spheres": [{"center": [0, -100.5, -1], "radius": 100,
                     "albedo": [0.5, 0.5, 0.5]}],
        "meshes": [
            {"path": "torus.obj", "scale": [0.3, 0.3, 0.3],
             "translate": [-0.5, 0, -1], "material": "metal", "fuzz": 0.1},
            {"path": "uv_sphere.obj", "scale": [0.2, 0.2, 0.2],
             "translate": [0.5, 0, -1], "material": "glass", "ior": 1.5,
             "albedo": [1, 1, 1]}],
        "sky": {"kind": "const", "colour": [0.2, 0.3, 0.4]}})


JSON_CASES = {
    "mesh_demo": lambda: (os.path.join(SCENES, "mesh_demo.json"), None),
    "readme_bench": lambda: (os.path.join(SCENES, "readme_bench.json"), None),
    "two_meshes_const_sky": lambda: (_two_mesh_json(), ASSETS),
}


@pytest.mark.parametrize("case", sorted(JSON_CASES))
def test_scene_from_json_matches_jax(case):
    source, base = JSON_CASES[case]()
    got = ot.scene_from_json(source, base)
    want = jbuilder.scene_from_json(source, base)
    assert got.sky.kind == want.sky.kind
    _leaves_equal(scene_to_numpy(got), scene_to_numpy(want))


def test_scene_json_hdr_sky_raises():
    """An HDR sky loads, tone-mapped by default (tests/test_torch_hdr_io.py
    holds it against the JAX package); a missing file raises."""
    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets")
    scene = ot.scene_from_json(json.dumps({"sky": {"kind": "hdr",
                                                   "path": "sky.hdr"}}),
                               assets)
    assert scene.sky.kind == ot.scene.sky.KIND_HDR
    assert tuple(scene.sky.image.shape) == (128, 256, 3)
    assert 0.0 <= float(scene.sky.image.min()) <= float(
        scene.sky.image.max()) <= 1.0
    with pytest.raises(FileNotFoundError):
        ot.scene_from_json(json.dumps({"sky": {"kind": "hdr",
                                               "path": "missing.hdr"}}),
                           assets)


@pytest.mark.parametrize("name", ["readme_scene", "reference_scene"])
def test_scene_to_json_matches_jax(name):
    got = json.loads(ot.scene_to_json(getattr(ot, name)()))
    want = json.loads(jbuilder.scene_to_json(getattr(ort, name)()))
    assert got == want
    # a sphere scene round-trips
    back = ot.scene_from_json(ot.scene_to_json(getattr(ot, name)()))
    _leaves_equal(scene_to_numpy(back), scene_to_numpy(getattr(ot, name)()))


def _mesh_reference(mod):
    tris, aabb = jobj.load_obj(os.path.join(ASSETS, "torus.obj"), *REF_XFORM)
    return mod.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)


def test_reference_scene_with_mesh_matches_jax():
    got, want = _mesh_reference(ot), _mesh_reference(ort)
    assert got.triangles.count == 576 and got.boxes.count == 1
    _leaves_equal(scene_to_numpy(got), scene_to_numpy(want))


def test_mesh_scene_carried_both_ways():
    """The triangles.* and boxes.* leaves go across with the rest: JAX scene
    -> numpy -> port scene -> numpy gives the same leaves, and the port's
    own mesh scene round-trips."""
    want = scene_to_numpy(_mesh_reference(ort))
    assert {k for k in want if k.split(".")[0] in ("triangles", "boxes")} == {
        "triangles.p0", "triangles.p1", "triangles.p2", "triangles.albedo",
        "triangles.fuzz", "triangles.ior", "triangles.mat_type",
        "triangles.box_id", "boxes.box_min", "boxes.box_max"}
    carried = scene_from_numpy(want, ort.Sky.gradient().kind)
    _leaves_equal(scene_to_numpy(carried), want)
    own = _mesh_reference(ot)
    back = scene_from_numpy(scene_to_numpy(own), own.sky.kind)
    for group in ("triangles", "boxes"):
        a, b = getattr(back, group), getattr(own, group)
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
