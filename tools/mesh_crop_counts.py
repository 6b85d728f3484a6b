"""Bounce and triangle-test counts of the mesh main path on crops, on the CPU.

Runs the mesh megakernel's plain version (``kernels.megamesh.
render_mesh_plain``, on CPU tensors) over a few full-width rows of the
reference scene at ``REFERENCE_DEFAULTS`` (1280x720, 5 spp, depth 32), with
the bundled ``assets/torus.obj`` and with the 15,360-triangle procedural
torus, each loaded as ``chip_smoke.py`` loads it.  It prints, per mesh, one
JSON line: the bounces per camera sample and the triangle tests per bounce
of the plain fold (every 128-triangle chunk whose gating box and AABB a ray
hits; the kernel also culls by entry t and by sub-box, so it runs fewer).
These size the mesh megakernel's time before a chip run.

    python tools/mesh_crop_counts.py [--rows 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch.io import load_obj, parse_obj  # noqa: E402
from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm  # noqa: E402

XFORM = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))   # presets.py:138-139


def meshes():
    tris, aabb = load_obj(os.path.join(os.path.dirname(HERE), "assets",
                                       "torus.obj"), *XFORM)
    yield "torus_576", tris, aabb
    tris, aabb = parse_obj(make_torus_obj(128, 60), *XFORM)
    yield "torus_15360", tris, aabb


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=8,
                    help="full-width rows, spread evenly over the image")
    args = ap.parse_args()
    cfg = ot.REFERENCE_DEFAULTS
    rows = [int((i + 0.5) * cfg.height / args.rows) for i in range(args.rows)]
    for name, tris, aabb in meshes():
        scene = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
        tables = (mm.mesh_camera_table(scene), mk.sphere_table(scene),
                  scene.spheres.count, mm.mesh_tables(scene), cfg,
                  scene.sky.kind, mm.specialize_mesh_flags(scene), 0)
        counts = torch.zeros(2, dtype=torch.int64)
        t0 = time.perf_counter()
        for row in rows:
            mm.render_mesh_plain(*tables, cfg.width, pix_offset=row * cfg.width,
                                 counts=counts)
        samples = len(rows) * cfg.width * cfg.spp
        bounces, tests = counts.tolist()
        print(json.dumps({
            "mesh": name, "triangles": scene.triangles.count, "rows": rows,
            "camera_samples": samples, "bounces": bounces,
            "bounces_per_sample": bounces / samples,
            "plain_tri_tests_per_bounce": tests / bounces,
            "cpu_seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
