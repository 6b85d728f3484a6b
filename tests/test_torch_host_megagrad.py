"""K5, K6 and K7, the mesh backward kernels (``csrc/megagrad.cu::
mesh_megagrad``), compiled as host C++ through the shim of
``tools/host_megagrad_check.py`` and run on the CPU with a third as many
threads as work items (pixel samples), so that each thread's flat loop
takes several items of several pixels.  K5's and K7's cotangents are
held against the plain versions (``render_grad_mesh_tables_plain``,
``hdr_consume_plain``) on the scene's leaves, K6's emit rows and non-sky
sums (its per-sample rows added in sample order) against
``hdr_emit_plain``'s, and the counts of all three against
the earlier design's (the megagrad template's mesh instances, a pixel per
thread) on the same tables.

Tolerance, max|a - b| / max|b|: tests/test_megagrad.py's mesh tolerance,
5e-4, per table block (camera slots, sphere rows, triangle rows) and per
scene leaf.  The focus distance's leaf is left out: here its cotangent is
a near-zero cancelling sum (about 3e-5 of the camera position's), so its
relative error is rounding; the camera slots it chains from are held in
the camera block.  The host shim runs one lane a warp, so the sums keep
one order; the differences are float32 rounding.  K6: the non-sky sums
within 1e-6; each sample's direction and throughput within 1e-6 on 99.9%
of samples and within 1e-4 on all (host glibc ``sinf``/``cosf`` against
ATen's vectorised ones, an ulp apart on a few draws), and equal to the
earlier design's bit for bit.  Skips without g++.
"""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot

TOOL = (pathlib.Path(__file__).resolve().parents[1] / "tools"
        / "host_megagrad_check.py")
CFG = ot.RenderConfig(width=24, height=14, spp=2, max_depth=4,
                      nan_policy="zero")
LEAVES = ("spheres.center", "spheres.radius", "spheres.albedo",
          "spheres.fuzz", "camera.look_from", "camera.look_at",
          "camera.vfov_deg", "camera.aperture_deg",
          "triangles.p0", "triangles.p1", "triangles.p2", "triangles.albedo",
          "triangles.fuzz")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel source as host code")
    spec = importlib.util.spec_from_file_location("host_megagrad_check",
                                                  TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    work = tmp_path_factory.mktemp("megagrad_host")
    return tool, work, tool.build(work)


@pytest.mark.parametrize("kernel", ["k5", "k6", "k7"])
def test_mesh_backward_body_matches_plain_on_host(host, kernel):
    """K5 on the 192-triangle fuzzy-metal torus with the reference spheres
    under the gradient sky, K6 on the same under a tone-mapped HDR sky, K7
    under twice that sky, where the clamp before the average cuts sky
    terms and so the cotangents through them."""
    tool, work, exe = host
    if kernel == "k6":
        from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
        from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
        scene = tool.torus(sky=ot.Sky.hdr(tool.SKY))
        emit, emis, counts = tool.run_k6(exe, work, scene, CFG)
        e_emit, e_emis, earlier = tool.run_k6(exe, work, scene, CFG,
                                              earlier=True)
        assert counts == earlier and counts[1] > 0
        assert torch.equal(emit, e_emit) and torch.equal(emis, e_emis)
        cam, sph, n, tab, flags, _ = mm.mesh_inputs(scene, "cpu")
        p_emit, p_emis = mg.hdr_emit_plain(cam, sph, n, tab, CFG, flags, 7,
                                           CFG.width * CFG.height)
        dev = (emit - p_emit).abs().amax(0)
        assert float((dev <= 1e-6).float().mean()) >= 0.999
        assert float(dev.max()) <= 1e-4
        assert float(emis.abs().max()) > 0
        assert float((emis - p_emis).abs().max()) <= 1e-6
        return
    if kernel == "k5":
        scene = tool.torus()
        blocks, leaves, counts = tool.check(exe, work, scene, CFG)
        earlier = tool.check(exe, work, scene, CFG, earlier=True,
                             counts_only=True)
    else:
        scene = tool.torus(sky=ot.Sky.hdr(tool.SKY * 2.0))
        _, blocks, leaves, counts = tool.check_hdr(exe, work, scene, CFG)
        earlier = tool.check_hdr(exe, work, scene, CFG, earlier=True,
                                 counts_only=True)
    assert counts == earlier and counts[3] > 0
    assert all(v < 5e-4 for v in blocks.values()), blocks
    errs = {k: v for k, v in leaves.items() if k in LEAVES}
    assert errs and all(v < 5e-4 for v in errs.values()), errs
    assert all(np.isfinite(v) for v in leaves.values())
