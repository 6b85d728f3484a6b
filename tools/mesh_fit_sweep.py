"""Vertex fits of the reference scene's mesh over a few targets and rates.

Runs ``fit_scene`` on the triangles' vertices of the reference scene with
the bundled 576-triangle ``assets/torus.obj`` (loaded as ``chip_smoke.py``
loads it), towards targets rendered from displaced copies of the mesh, for
a few Adam learning rates and parameter sets, with fixed noise
(``sample_new_noise=False``), and prints one JSON line per fit with its
losses.  It shows where the interior-derivative gradients of a
hard-visibility render descend: each triangle carries its own copy of its
vertices, so a step that moves the copies of one vertex apart opens gaps
that the gradient does not see.

Displacements: every p0 moved by a constant; the whole mesh translated; the
mesh turned about its axis; every p0 moved along its triangle's normal.
With ``--mesh jax_test`` it runs tests/test_megagrad.py's vertex fit
instead: the 48-triangle torus of that file's ``_mesh_scene`` (scale 0.5,
near the camera), from every p0 moved by 0.02 back towards the target
rendered from the true mesh (seed 7), as ``chip_smoke.py`` phase 15 does.
``--repeats N`` runs each fit N times: the backward kernels add their
cotangents with float atomics, so the sums, and the fit that follows them,
can differ between runs on the card.

    python tools/mesh_fit_sweep.py [--device cuda] [--mesh reference|jax_test]
        [--width 1280 --height 720] [--steps 5] [--repeats 1]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch.io import load_obj, parse_obj  # noqa: E402
from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj  # noqa: E402

XFORM = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))   # presets.py:138-139
CENTER = torch.tensor(XFORM[1])


def turned(p, deg):
    """p turned by deg about the mesh's vertical axis."""
    a = math.radians(deg)
    q = p - CENTER
    return torch.stack([math.cos(a) * q[:, 0] + math.sin(a) * q[:, 2],
                        q[:, 1],
                        -math.sin(a) * q[:, 0] + math.cos(a) * q[:, 2]],
                       1) + CENTER


def displacements(tris):
    n = torch.linalg.cross(tris.p1 - tris.p0, tris.p2 - tris.p0, dim=-1)
    n = n / n.norm(dim=1, keepdim=True)
    shift = torch.tensor([0.005, 0.0025, -0.005])
    return {
        "p0_plus_0.01": dict(p0=tris.p0 + 0.01),
        "translate_0.0075": dict(p0=tris.p0 + shift, p1=tris.p1 + shift,
                                 p2=tris.p2 + shift),
        "turn_3deg": dict(p0=turned(tris.p0, 3.0), p1=turned(tris.p1, 3.0),
                          p2=turned(tris.p2, 3.0)),
        "p0_along_normal_0.005": dict(p0=tris.p0 + 0.005 * n),
    }


def fits(mesh: str, cfg, device):
    """(name, target, initial scene, seed, learning rates) of each fit."""
    if mesh == "jax_test":
        tris, aabb = parse_obj(make_torus_obj(6, 4), (0.5, 0.5, 0.5),
                               (0.3, 0.0, -1.6))
        true = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
        t = true.triangles
        init = dataclasses.replace(true, triangles=dataclasses.replace(
            t, p0=t.p0 + 0.02))
        yield ("p0_plus_0.02", ot.render(true, cfg, seed=7, device=device),
               init, 7, (5e-3, 2e-3, 1e-3, 5e-4))
        return
    tris, aabb = load_obj(os.path.join(os.path.dirname(HERE), "assets",
                                       "torus.obj"), *XFORM)
    true = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
    for name, moved in displacements(true.triangles).items():
        displaced = dataclasses.replace(true, triangles=dataclasses.replace(
            true.triangles, **moved))
        yield (name, ot.render(displaced, cfg, seed=0, device=device), true,
               0, (1e-3, 3e-4, 1e-4, 3e-5))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--mesh", choices=("reference", "jax_test"),
                    default="reference")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    cfg = ot.REFERENCE_DEFAULTS.replace(width=args.width, height=args.height)
    for name, target, init, seed, rates in fits(args.mesh, cfg, args.device):
        for paths in (("triangles.p0",),
                      ("triangles.p0", "triangles.p1", "triangles.p2")):
            for lr, repeat in itertools.product(rates, range(args.repeats)):
                t0 = time.perf_counter()
                _, losses = ot.fit_scene(target, init, cfg, param_paths=paths,
                                         steps=args.steps, learning_rate=lr,
                                         seed=seed, sample_new_noise=False,
                                         device=args.device)
                print(json.dumps({
                    "mesh": args.mesh, "target": name, "params": paths,
                    "learning_rate": lr, "repeat": repeat,
                    "size": f"{cfg.width}x{cfg.height}x{cfg.spp}"
                            f"/d{cfg.max_depth}",
                    "losses": losses, "falls": losses[-1] < losses[0],
                    "last_over_first": losses[-1] / losses[0],
                    "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
