"""The port's native IO library (``io/native.py`` over
``io/csrc/oclrt_native.cpp``) against the JAX package's Python loaders,
bit for bit.

- OBJ: the plain and the ``a/b/c`` face forms under a scale and a
  translate, and the bundled torus under the reference transform, against
  ``parse_obj``.
- HDR: the cases of tests/test_native.py (which skips without the JAX
  package's hand-built library): a flat file from ``encode_hdr``, new RLE
  (runs and dumps, and an encoded length the reference ignores), old RLE
  (a repeat, a chain of repeats whose counts shift by 8 bits, a repeat as
  the first record), a literal-seeded old RLE, a width below 8, and mixed
  scanlines, against ``decode_hdr``.
- BMP: ``write_bmp_native``'s bytes against ``encode_bmp``.
- A missing file gives None, and so does ``OCLRT_NATIVE=0``; the port's
  ``load_obj`` and ``load_hdr`` read through the library (with the Python
  parsers made to fail) and equal the JAX package's ``load_obj`` and
  ``load_hdr``, and with the library off they parse in Python.
- The library is built at first use into ``_build/``, never into the JAX
  package's ``native/``; a failed build raises with the compiler's errors.
- The port's C++ source is the JAX package's ``native/oclrt_native.cpp``
  line for line after their header comments, so a change to either shows
  here.
"""

import os
import pathlib

import numpy as np
import pytest

from opencl_ray_tracer_tpu.io import bmp as jbmp
from opencl_ray_tracer_tpu.io import hdr as jhdr
from opencl_ray_tracer_tpu.io import obj as jobj
from opencl_ray_tracer_tpu.io.procgen import make_sky_image
from opencl_ray_tracer_tpu_torch.io import hdr as thdr
from opencl_ray_tracer_tpu_torch.io import native
from opencl_ray_tracer_tpu_torch.io import obj as tobj
from opencl_ray_tracer_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORUS = os.path.join(REPO, "assets", "torus.obj")
MIXED_FACES = ("v 1 2 3\nv 4 5 6\nv 7 8 9\nv -1 -2 -3\n"
               "f 1 2 3\nf 1/11/21 2/12/22 4/14/24\n")


def _header(w, h):
    return (b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"
            + f"-Y {h} +X {w}\n".encode())


def _mixed_scanlines():
    rng = np.random.default_rng(0)
    w, h = 16, 6
    body = b""
    for y in range(h):
        if y % 3 == 0:      # new RLE: a run and a dump per component
            body += bytes([2, 2, 0, w])
            for _ in range(4):
                body += bytes([128 + 8, int(rng.integers(256))])
                body += bytes([8]) + rng.integers(0, 256, 8,
                                                  dtype=np.uint8).tobytes()
        elif y % 3 == 1:    # old RLE literals (first byte not 2)
            for x in range(w):
                px = rng.integers(0, 256, 4, dtype=np.uint8)
                px[0] = 3 if x == 0 else max(2, int(px[0]))
                body += px.tobytes()
        else:               # a (2, G != 2) seed, then literals
            body += bytes([2, 5, 1, 130])
            for _ in range(w - 1):
                body += rng.integers(2, 256, 4, dtype=np.uint8).tobytes()
    return _header(w, h) + body


def _flat():
    img = (np.random.default_rng(0).uniform(0, 4, size=(6, 9, 3))
           ** 2).astype(np.float32)
    return jhdr.encode_hdr(img)


HDR_CASES = {
    "flat": _flat,
    "new_rle_ignores_length": lambda: _header(8, 1) + bytes([2, 2, 0, 99])
    + b"".join(bytes([128 + 8, c + 1]) for c in range(4)),
    "old_rle": lambda: _header(5, 1) + bytes([128, 64, 32, 128, 1, 1, 1, 4]),
    "old_rle_shift_chain": lambda: _header(300, 1) + bytes(
        [5, 6, 7, 136, 1, 1, 1, 42, 1, 1, 1, 1, 9, 9, 9, 136]),
    "old_rle_first_record_repeat": lambda: _header(4, 1)
    + bytes([1, 1, 1, 2]) + bytes([3, 3, 3, 136]) * 2,
    "literal_seeded_old_rle": lambda: _header(8, 1)
    + bytes([2, 7, 9, 130, 1, 1, 1, 7]),
    "narrow_width": lambda: _header(4, 2)
    + (bytes([2, 2, 0, 4]) + bytes([10, 20, 30, 140]) * 3) * 2,
    "mixed_scanlines": _mixed_scanlines,
}


@pytest.mark.parametrize("case", ["mixed_faces", "torus"])
def test_obj_matches_jax_parser(case, tmp_path):
    if case == "torus":
        path, scale, translate = TORUS, (0.15, 0.15, 0.15), (0.0, -0.5, -1.0)
    else:
        path = str(tmp_path / "m.obj")
        with open(path, "w") as f:
            f.write(MIXED_FACES)
        scale, translate = (2.0, 2.0, 2.0), (1.0, 0.0, 0.0)
    with open(path) as f:
        want_tris, (want_lo, want_hi) = jobj.parse_obj(f.read(), scale,
                                                       translate)
    tris, (lo, hi) = native.load_obj_native(path, scale, translate)
    assert tris.dtype == lo.dtype == hi.dtype == np.float32
    np.testing.assert_array_equal(tris, want_tris)
    np.testing.assert_array_equal(lo, want_lo)
    np.testing.assert_array_equal(hi, want_hi)


@pytest.mark.parametrize("case", sorted(HDR_CASES))
def test_hdr_matches_jax_decoder(case, tmp_path):
    data = HDR_CASES[case]()
    path = tmp_path / "f.hdr"
    path.write_bytes(data)
    got = native.load_hdr_native(str(path))
    want = jhdr.decode_hdr(data)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_bmp_matches_jax_encoder(tmp_path):
    img = np.random.default_rng(1).integers(0, 255, size=(7, 5, 3),
                                            dtype=np.uint8)
    path = tmp_path / "n.bmp"
    assert native.write_bmp_native(str(path), img)
    assert path.read_bytes() == jbmp.encode_bmp(img)


def test_missing_file_and_library_off_give_none(tmp_path, monkeypatch):
    missing = str(tmp_path / "missing")
    assert native.load_obj_native(missing + ".obj", (1, 1, 1),
                                  (0, 0, 0)) is None
    assert native.load_hdr_native(missing + ".hdr") is None
    assert not native.write_bmp_native(str(tmp_path / "no" / "x.bmp"),
                                       np.zeros((2, 2, 3), np.uint8))
    monkeypatch.setenv("OCLRT_NATIVE", "0")
    assert native.load_obj_native(TORUS, (1, 1, 1), (0, 0, 0)) is None
    assert native.load_hdr_native(missing + ".hdr") is None
    assert not native.write_bmp_native(str(tmp_path / "x.bmp"),
                                       np.zeros((2, 2, 3), np.uint8))


@pytest.mark.parametrize("library", ["on", "off"])
def test_port_loaders_match_jax_loaders(library, tmp_path, monkeypatch):
    hdr_path = str(tmp_path / "sky.hdr")
    with open(hdr_path, "wb") as f:
        f.write(jhdr.encode_hdr(make_sky_image(64, 32)))
    transform = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))
    want_tris, want_box = jobj.load_obj(TORUS, *transform)
    want_img = jhdr.load_hdr(hdr_path)
    if library == "on":
        # the Python parsers fail: the loaders must take the library
        def refuse(*args):
            raise AssertionError("parsed in Python")
        monkeypatch.setattr(tobj, "parse_obj", refuse)
        monkeypatch.setattr(thdr, "decode_hdr", refuse)
    else:
        monkeypatch.setenv("OCLRT_NATIVE", "0")
    tris, box = tobj.load_obj(TORUS, *transform)
    np.testing.assert_array_equal(tris, want_tris)
    np.testing.assert_array_equal(box[0], want_box[0])
    np.testing.assert_array_equal(box[1], want_box[1])
    np.testing.assert_array_equal(thdr.load_hdr(hdr_path), want_img)


def test_library_is_built_into_build_dir_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    assert native._lib() is not None
    built = list(_build.BUILD_DIR.glob("oclrt_native_*.so"))
    assert built, "the library was not built into _build/"
    assert not os.path.exists(os.path.join(REPO, "native",
                                           "liboclrt_native.so"))
    bad = tmp_path / "broken.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="error"):
        _build.build_host(bad)
    monkeypatch.setenv("CXX", "no-such-compiler-oclrt")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.build_host(bad)


def test_source_is_the_jax_package_copy_after_its_header():
    def body(path):
        lines = pathlib.Path(path).read_text().splitlines()
        start = next(i for i, ln in enumerate(lines)
                     if not ln.startswith("//"))
        return lines[start:]

    port = body(native.SOURCE)
    assert port[0] == "" and any(ln.startswith("extern \"C\"")
                                 for ln in port)
    assert port == body(os.path.join(REPO, "native", "oclrt_native.cpp"))
