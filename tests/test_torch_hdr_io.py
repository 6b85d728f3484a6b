"""The port's HDR host side against the JAX package's.

- ``io/hdr.py``: ``decode_hdr`` gives the same floats, bit for bit, on the
  bundled ``assets/sky.hdr`` (256x128) and on hand-built scanlines in each
  of the reference loader's encodings (new RLE with runs and dumps, old
  RLE with repeat codes, a literal first pixel that seeds old RLE, flat
  pixels); ``tone_map`` and ``encode_hdr`` give the same arrays and bytes.
- ``io/procgen.py::write_test_assets`` writes the same files, byte for
  byte.
- ``scene_from_json`` with an HDR sky (tone-mapped or not) and
  ``flagship_scene`` give the JAX package's leaves exactly.
"""

import json
import os

import numpy as np
import pytest

from opencl_ray_tracer_tpu.io import hdr as jhdr
from opencl_ray_tracer_tpu.io import procgen as jprocgen
from opencl_ray_tracer_tpu.scene import builder as jbuilder
from opencl_ray_tracer_tpu.scene import presets as jpresets
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu_torch.io import hdr as thdr
from opencl_ray_tracer_tpu_torch.io import procgen as tprocgen
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SKY = os.path.join(ROOT, "assets", "sky.hdr")
HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def _file(h, w, scanlines: bytes) -> bytes:
    return HEADER + f"-Y {h} +X {w}\n".encode() + scanlines


def _new_rle_line(w):
    # (2, 2, w >> 8, w & 255), then each of the four planes as a run of
    # three and a dump of the rest
    out = bytes([2, 2, w >> 8, w & 255])
    for comp in range(4):
        out += bytes([128 + 3, 100 + comp])
        out += bytes([w - 3]) + bytes(range(40 + comp, 40 + comp + w - 3))
    return out


RLE_CASES = {
    # the new RLE of the reference's decrunch, two scanlines of width 8
    "new_rle": _file(2, 8, _new_rle_line(8) * 2),
    # old RLE: a pixel, then a repeat code for four more (tests/test_io.py)
    "old_rle": _file(1, 5, bytes([128, 64, 32, 128, 1, 1, 1, 4])),
    # (2, G, B, E) with G != 2: a literal first pixel that seeds old RLE
    "seeded_old_rle": _file(1, 8, bytes([2, 7, 9, 130])
                            + bytes([10, 20, 30, 129]) + bytes([1, 1, 1, 6])),
    # flat pixels, as encode_hdr writes them
    "flat": jhdr.encode_hdr((np.random.default_rng(0).uniform(
        0, 8, size=(4, 6, 3)) ** 2).astype(np.float32)),
    "sky_asset": open(SKY, "rb").read(),
}


@pytest.mark.parametrize("case", sorted(RLE_CASES))
def test_decode_hdr_matches_jax(case):
    data = RLE_CASES[case]
    want = jhdr.decode_hdr(data)
    got = thdr.decode_hdr(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert thdr.tone_map(got).tobytes() == jhdr.tone_map(want).tobytes()


def test_load_encode_and_tone_map_match_jax():
    img = thdr.load_hdr(SKY)
    assert img.shape == (128, 256, 3)
    assert img.tobytes() == jhdr.decode_hdr(open(SKY, "rb").read()).tobytes()
    assert thdr.encode_hdr(img) == jhdr.encode_hdr(img)
    big = (np.random.default_rng(1).uniform(0, 30, size=(5, 7, 3))
           ** 2).astype(np.float32)
    assert thdr.encode_hdr(big) == jhdr.encode_hdr(big)
    for e in (1, 2, 3):
        assert (thdr.tone_map(big, e).tobytes()
                == jhdr.tone_map(big, e).tobytes())


def test_write_test_assets_matches_jax(tmp_path):
    got = tprocgen.write_test_assets(str(tmp_path / "port"))
    want = jprocgen.write_test_assets(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == ["sky", "torus", "uv_sphere"]
    for name in got:
        with open(got[name], "rb") as a, open(want[name], "rb") as b:
            assert a.read() == b.read(), name


def _leaves_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("tonemap", [True, False])
def test_scene_json_hdr_sky_matches_jax(tonemap):
    spec = json.dumps({"meshes": [{"path": "torus.obj",
                                   "scale": [0.15, 0.15, 0.15],
                                   "translate": [0.0, -0.5, -1.0]}],
                       "sky": {"kind": "hdr", "path": "sky.hdr",
                               "tonemap": tonemap}})
    base = os.path.join(ROOT, "assets")
    got = ot.scene_from_json(spec, base)
    want = jbuilder.scene_from_json(spec, base)
    assert got.sky.kind == want.sky.kind == ot.scene.sky.KIND_HDR
    _leaves_equal(scene_to_numpy(got), scene_to_numpy(want))
    assert (float(got.sky.image.max()) <= 1.0) == tonemap


def test_flagship_scene_matches_jax():
    got, want = ot.flagship_scene(), jpresets.flagship_scene()
    assert got.triangles.count == want.triangles.count == 576
    assert tuple(got.sky.image.shape) == (512, 1024, 3)
    _leaves_equal(scene_to_numpy(got), scene_to_numpy(want))
    hdr_got = ot.flagship_scene(hdr_path=SKY)
    hdr_want = jpresets.flagship_scene(hdr_path=SKY)
    np.testing.assert_array_equal(hdr_got.sky.image.numpy(),
                                  np.asarray(hdr_want.sky.image))
