"""The port end to end on the CPU: ``render(device="cpu")`` against the
committed goldens that the JAX package renders, its image writers against
the JAX package's bytes, and the port's independence from JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu import io as jio
from opencl_ray_tracer_tpu_torch import io as tio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")

# The configurations of tests/test_golden.py (seed 42).
CASES = {
    "readme_64x36": (ot.readme_scene,
                     ot.RenderConfig(width=64, height=36, spp=8, max_depth=8)),
    "reference_64x36": (ot.reference_scene,
                        ot.RenderConfig(width=64, height=36, spp=8,
                                        max_depth=8)),
    "cover_64x36": (ot.book_cover_scene,
                    ot.RenderConfig(width=64, height=36, spp=4, max_depth=6)),
}


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["img"]


@pytest.mark.parametrize("early_stop", [True, False])
@pytest.mark.parametrize("name", ["readme_64x36", "reference_64x36"])
def test_golden(name, early_stop):
    """The golden tolerance of tests/test_golden.py, for both loop forms
    (path regeneration and the per-sample bounce loop)."""
    scene_fn, cfg = CASES[name]
    want = _golden(name)
    got = ot.render(scene_fn(), cfg.replace(early_stop=early_stop), seed=42,
                    device="cpu").numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() < 0.002, diff.max()
    assert abs(got.mean() - want.mean()) < 1e-4


def test_golden_book_cover():
    """The book cover under the kernel-parity tolerance of
    tests/test_megakernel.py::_compare (frac 0.005) instead of the golden
    one: its ground sphere of radius 1000 makes |oc|^2 - r^2 cancel
    between numbers near 1e6, where one ulp is 0.06, and XLA's own sin/cos
    approximations and cube root differ from ATen's by an ulp, so about
    0.3% of pixels cross a discrete event (a grazing ray re-hitting the
    ground above t_min) against 0.2% allowed by the golden tolerance."""
    scene_fn, cfg = CASES["cover_64x36"]
    want = _golden("cover_64x36")
    got = ot.render(scene_fn(), cfg, seed=42, device="cpu").numpy()
    diff = np.abs(got - want)
    assert (diff > 1e-3).mean() < 0.005
    assert (diff <= 1e-4).mean() > 0.99
    assert abs(got.mean() - want.mean()) < 1e-4


def test_row_chunks_equal_whole_image():
    cfg = ot.RenderConfig(width=24, height=12, spp=2, max_depth=4)
    whole = ot.render(ot.reference_scene(), cfg, seed=1, device="cpu")
    chunked = ot.render(ot.reference_scene(), cfg.replace(row_chunk=4),
                        seed=1, device="cpu")
    assert torch.equal(whole, chunked)


def test_writers_match_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.2, 1.2, size=(9, 13, 3)).astype(np.float32)
    u8 = tio.tonemap_u8(torch.tensor(img))
    np.testing.assert_array_equal(u8, jio.tonemap_u8(img))
    assert tio.encode_bmp(u8) == jio.encode_bmp(jio.tonemap_u8(img))
    assert tio.encode_png(u8) == jio.encode_png(jio.tonemap_u8(img))
    assert (tio.encode_png(u8, bottom_up=False)
            == jio.encode_png(jio.tonemap_u8(img), bottom_up=False))
    tio.write_bmp(str(tmp_path / "t.bmp"), torch.tensor(img))
    jio.write_bmp(str(tmp_path / "j.bmp"), img)
    assert (tmp_path / "t.bmp").read_bytes() == (tmp_path / "j.bmp").read_bytes()


def test_port_imports_no_jax():
    code = ("import sys, opencl_ray_tracer_tpu_torch, "
            "opencl_ray_tracer_tpu_torch.kernels.megakernel, "
            "opencl_ray_tracer_tpu_torch.io\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'opencl_ray_tracer_tpu' "
            "or m.startswith('opencl_ray_tracer_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


# An import statement of jax or of the JAX package (the port's files may
# name the JAX files they replace in prose and in its kernels line).
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|opencl_ray_tracer_tpu(?!_torch))\b",
    re.MULTILINE)


def test_port_sources_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT,
                                               "opencl_ray_tracer_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path
