"""The port's command line and its helpers on the CPU: the reference
executable's surface (``main.cpp:13``), as tests/test_cli.py holds the JAX
package's.

- Two runs in a subprocess with ``--cpu``: a plain render, and a
  checkpointed one with a progress image.  Every other case calls
  ``cli.main(argv)`` in process.  The BMP written equals ``tonemap_u8`` of
  ``render(device="cpu")`` byte for byte, and a checkpointed run resumed
  by running the command again equals it too.
- ``read_bmp`` reads back what ``write_bmp`` wrote, and the JAX package's
  ``read_bmp`` reads the same pixels; ``ProgressReporter`` writes a BMP or
  a PNG; ``PhaseTimer``, ``rays_per_second`` and ``device_info`` (which
  reports no device here).
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.io import read_bmp as jax_read_bmp
from opencl_ray_tracer_tpu_torch import cli
from opencl_ray_tracer_tpu_torch.io import read_bmp, tonemap_u8, write_bmp
from opencl_ray_tracer_tpu_torch.utils import (PhaseTimer, ProgressReporter,
                                               device_info, rays_per_second)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "32", "--height", "16", "--spp", "4", "--max-depth",
         "3"]


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300)


def _want(scene_fn, spp=4):
    cfg = ot.RenderConfig(width=32, height=16, spp=spp, max_depth=3)
    return tonemap_u8(ot.render(scene_fn(), cfg, seed=0, device="cpu"))


def test_cli_render_subprocess(tmp_path):
    out = str(tmp_path / "out.bmp")
    r = _run(["render", "--scene", "readme", *SMALL, "--cpu", "-o", out])
    assert r.returncode == 0, r.stderr
    assert "camera samples/s" in r.stdout and "Device information" in r.stdout
    np.testing.assert_array_equal(read_bmp(out), _want(ot.readme_scene))


def test_cli_checkpoint_progress_subprocess(tmp_path):
    out = str(tmp_path / "out.bmp")
    ckpt = str(tmp_path / "state.npz")
    prog = str(tmp_path / "progress.bmp")
    r = _run(["render", "--scene", "reference", *SMALL, "--cpu",
              "--checkpoint", ckpt, "--chunk-spp", "2", "--progress-image",
              prog, "-o", out])
    assert r.returncode == 0, r.stderr
    assert "Rendered 4 / 4 samples" in r.stderr
    with np.load(ckpt) as z:
        assert int(z["n_samples"]) == 4 and z["acc"].shape == (16, 32, 3)
    want = _want(ot.flagship_scene)
    np.testing.assert_array_equal(read_bmp(out), want)
    np.testing.assert_array_equal(read_bmp(prog), want)


def test_cli_resumes_a_checkpoint(tmp_path, capsys):
    """Two samples, then the same command with four resumes the render."""
    out = str(tmp_path / "out.bmp")
    ckpt = str(tmp_path / "state.npz")
    args = ["render", "--scene", "readme", "--width", "32", "--height",
            "16", "--max-depth", "3", "--cpu", "--checkpoint", ckpt,
            "--chunk-spp", "1", "-o", out]
    assert cli.main([*args, "--spp", "2"]) == 0
    assert cli.main([*args, "--spp", "4"]) == 0
    err = capsys.readouterr().err
    assert "Rendered 2 / 2 samples" in err and "Rendered 4 / 4" in err
    assert "Rendered 1 / 4" not in err     # samples 0 and 1 were not redone
    np.testing.assert_array_equal(read_bmp(out), _want(ot.readme_scene))


def test_cli_progress_image_and_png(tmp_path, capsys):
    """--progress-image without a checkpoint: row blocks, the reference's
    growing image; a .png output."""
    out = str(tmp_path / "out.png")
    prog = str(tmp_path / "progress.png")
    assert cli.main(["render", "--scene", "readme", *SMALL, "--cpu",
                     "--progress-image", prog, "-o", out]) == 0
    assert "Rendered 16 / 16" in capsys.readouterr().err
    for path in (out, prog):
        assert open(path, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"


def test_cli_json_scene(tmp_path):
    scene = tmp_path / "scene.json"
    scene.write_text(ot.scene_to_json(ot.readme_scene()))
    out = str(tmp_path / "out.bmp")
    assert cli.main(["render", "--scene", str(scene), *SMALL, "--cpu",
                     "-o", out]) == 0
    np.testing.assert_array_equal(read_bmp(out), _want(ot.readme_scene))


def test_cli_info(capsys):
    assert cli.main(["info"]) == 0
    assert "Device information" in capsys.readouterr().out
    assert cli.main(["info", "--json"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["device_count"] == torch.cuda.device_count()
    assert len(info["devices"]) == info["device_count"]


def test_cli_needs_a_card_without_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["render", *SMALL, "-o", str(tmp_path / "out.bmp")])
    assert os.listdir(tmp_path) == []
    assert device_info() == {"backend": "cpu", "device_count": 0,
                             "devices": [], "torch": torch.__version__,
                             "cuda": torch.version.cuda}


def test_bmp_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)  # odd row padding
    path = str(tmp_path / "a.bmp")
    write_bmp(path, torch.from_numpy(img))
    np.testing.assert_array_equal(read_bmp(path), tonemap_u8(img))
    np.testing.assert_array_equal(jax_read_bmp(path), tonemap_u8(img))
    u8 = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    write_bmp(path, u8, already_u8=True)
    np.testing.assert_array_equal(read_bmp(path), u8)


def test_progress_reporter_writes_images(tmp_path):
    stream = io.StringIO()
    bmp = str(tmp_path / "p.bmp")
    rep = ProgressReporter(bmp, every_s=0.0, stream=stream)
    img = torch.full((4, 8, 3), 0.25)
    rep(1, 2, img)
    assert read_bmp(bmp).shape == (4, 8, 3) and (read_bmp(bmp) == 127).all()
    rep(2, 2, img)
    assert stream.getvalue().endswith("Rendered 2 / 2 samples (100%)\n")
    png = str(tmp_path / "p.png")
    ProgressReporter(png, stream=stream)(1, 1, img)
    assert open(png, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"


def test_phase_timer_and_rates():
    timer = PhaseTimer(verbose=False)
    with timer.phase("a", sync_on={"img": torch.zeros(1)}):
        pass
    with timer.phase("a"):
        pass
    assert timer["a"] >= 0.0 and list(timer.spans) == ["a"]
    stats = rays_per_second(1280, 720, 5, 2.0, mean_bounces=3.0)
    assert stats["camera_samples_per_s"] == 1280 * 720 * 5 / 2.0
    assert stats["rays_per_s"] == 4 * stats["camera_samples_per_s"]
