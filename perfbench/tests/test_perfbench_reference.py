"""The plain reference against the port's plain versions at a tiny size
(the test may import the port; the reference does not)."""

import json
import os

import pytest
import torch

from perfbench import scenes
from perfbench.entries import fit
from perfbench.reference import tracer as ref
from perfbench.tests.tiny import BENCH


def _leaves(name, width, height, torus=(8, 6)):
    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    config["render"].update(width=width, height=height)
    if "mesh" in config:
        config["mesh"]["torus"].update(n_major=torus[0], n_minor=torus[1])
    return config, *scenes.scene_leaves(config)


@pytest.mark.parametrize("name, torus", [("readme", None),
                                         ("flagship", (8, 6)),
                                         ("flagship", (32, 16))])
def test_image_equals_the_plain_tracer(name, torus):
    import opencl_ray_tracer_tpu_torch as ot
    config, leaves, kind = _leaves(name, 24, 14, torus)
    cfg = ot.RenderConfig(width=24, height=14, spp=3, max_depth=6,
                          tri_backend="mm")
    want = ot.render(ot.scene_from_numpy(leaves, kind), cfg,
                     seed=2**32 - 5, device="cpu")
    counts = ref.new_counts()
    got = ref.render_pixels(
        ref.Scene(leaves, kind, "cpu"), ref.RenderSettings(24, 14, 3, 6),
        torch.arange(24 * 14), 2**32 - 5, counts)
    torch.testing.assert_close(got.reshape(14, 24, 3), want, rtol=0, atol=0)
    assert counts["camera_rays"] == 24 * 14 * 3
    assert counts["segments"] >= counts["camera_rays"]
    assert counts["sphere_hits"] + counts["tri_hits"] <= counts["segments"]


def test_rows_equal_the_whole_image():
    _, leaves, kind = _leaves("readme", 16, 8)
    rs = ref.RenderSettings(16, 8, 5, 8)
    scene = ref.Scene(leaves, kind, "cpu")
    whole = ref.render_pixels(scene, rs, torch.arange(128), 11)
    rows = torch.tensor([1, 6])
    pix = (rows[:, None] * 16 + torch.arange(16)).reshape(-1)
    part = ref.render_pixels(scene, rs, pix, 11, rays=7)
    torch.testing.assert_close(part, whole[pix], rtol=0, atol=0)


@pytest.mark.parametrize("name, paths, lr", [
    ("readme", ["spheres.center", "spheres.albedo"], 1e-2),
    ("flagship", ["triangles.p0", "sky.image"], 1e-3)])
def test_fit_step_equals_the_plain_route(name, paths, lr, tmp_path):
    """One step of the port's fit through its kernels' plain versions
    (``grad_backend="kernel"`` on CPU tensors) against the reference's."""
    import opencl_ray_tracer_tpu_torch as ot
    config, leaves, kind = _leaves(name, 20, 12)
    config["render"].update(spp=2, max_depth=5)
    params = {"param_paths": paths, "lr": lr, "target_spp": 1,
              "perturb": {"sphere_center": 0.02, "vertices": 0.02,
                          "sky_gain": 0.1}}
    inp = fit.inputs(config, params, 5, "cpu")
    ck = os.fspath(tmp_path / "fit.pt")
    rs = inp["rs"]
    ot.fit_scene(inp["target"], ot.scene_from_numpy(leaves, kind),
                 ot.RenderConfig(width=rs.width, height=rs.height,
                                 spp=rs.spp, max_depth=rs.max_depth),
                 param_paths=paths, steps=1, learning_rate=lr,
                 seed=inp["fit_seed"], checkpoint_path=ck,
                 grad_backend="kernel", device="cpu")
    prog = fit.program_step(inp, torch.load(ck, weights_only=True))
    gaps = fit.compare(inp, prog, fit.reference_step(inp, "cpu"))
    assert max(gaps.values()) < 1e-5, gaps
    assert float(prog[1][paths[-1]].abs().sum()) > 0
