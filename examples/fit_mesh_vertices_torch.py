"""Recover a mesh deformation through vertex gradients, on the PyTorch port.

The port's version of ``examples/fit_mesh_vertices.py``, with the same
scene, sizes, seeds, step size and closing check.  A torus in the
reference scene (fuzzy metal, gradient sky) is SHEARED: every p0 is
shifted by a scalar s along (1,1,1), which tilts all faces, so the metal
surface's reflected sky shifts over covered pixels.  s is recovered by
chaining the per-vertex cotangents of ``render_grad_sampled`` onto it:
dL/ds = sum(dL/dp0 . (1,1,1)).  On the card the gradient runs the mesh
megakernel (K2) and the mesh backward kernel (K5); with --cpu the same
route runs their plain PyTorch versions.

A low-dimensional deformation keeps the demo robust at this size: a full
vertex field from interior derivatives alone is noise-dominated, and
rigid translations are silhouette-dominated (``render_soft`` gives their
gradients).

Run on the card, or on the CPU with --cpu:
    python examples/fit_mesh_vertices_torch.py [--steps 12] [--cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

S0 = 0.02          # the unknown shear to recover (-> 0)
LR = 40.0          # 1-D problem; plain gradient descent
SEED = 7


def make_scene():
    """(scene, cfg): the reference scene with a 96-triangle torus at
    64x36, 2 spp, depth 5, the "zero" NaN policy."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj

    tris, aabb = parse_obj(make_torus_obj(8, 6), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    scene = ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb)
    cfg = ot.RenderConfig(width=64, height=36, spp=2, max_depth=5,
                          nan_policy="zero")
    return scene, cfg


def deformed(scene, s: float):
    """The scene with every p0 moved by s along (1,1,1), in float32."""
    import torch
    direction = torch.ones(3, dtype=torch.float32)
    shift = torch.tensor(s, dtype=torch.float32) * direction
    return dataclasses.replace(
        scene, triangles=dataclasses.replace(
            scene.triangles, p0=scene.triangles.p0 + shift))


def fit_step(scene, cfg, target, s: float, device=None,
             grad_backend: str = "kernel"):
    """One step's (loss, dL/ds, image) at shear s against ``target``: the
    gradient of mean((img - target)^2) through ``render_grad_sampled``,
    chained onto s: dL/ds = sum(dL/dp0 . (1,1,1))."""
    import torch

    import opencl_ray_tracer_tpu_torch as ot

    def loss_fn(im):
        return torch.mean((im - target) ** 2)

    loss, img, g = ot.render_grad_sampled(
        deformed(scene, s), cfg, loss_fn, seed=SEED,
        grad_backend=grad_backend, device=device)
    return float(loss), float(g.triangles.p0.sum()), img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    import opencl_ray_tracer_tpu_torch as ot

    device = "cpu" if args.cpu else None
    scene, cfg = make_scene()
    target = ot.render(scene, cfg, seed=SEED, device=device)

    s = S0
    losses, grads, secs = [], [], []
    print(f"s0 = {s:.5f}")
    for it in range(args.steps):
        t0 = time.perf_counter()
        loss, ds, _ = fit_step(scene, cfg, target, s, device)
        secs.append(time.perf_counter() - t0)
        s = s - LR * ds
        losses.append(loss)
        grads.append(ds)
        print(f"step {it:2d}: loss {loss:.3e}  s -> {s:+.5f}")
    # relative-improvement check: descent must at least halve the shear
    assert abs(s) < 0.5 * S0, s
    print(f"recovered shear |s| = {abs(s):.5f} (true 0)")
    return dict(scene=scene, cfg=cfg, target=target, s=s, losses=losses,
                grads=grads, seconds_per_step=secs)


if __name__ == "__main__":
    main()
