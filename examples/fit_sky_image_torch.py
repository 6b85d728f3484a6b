"""Recover an HDR environment map's gain through sky-texel gradients, on the
PyTorch port.

The port's version of ``examples/fit_sky_image.py``, with the same scene,
sizes, seeds, step size and closing check.  The README scene's sky is a
tone-mapped procedural HDR image, globally DIMMED by an unknown scalar
gain; the gain is recovered by chaining the per-texel cotangents of
``render_grad_sampled`` onto it: dL/dgain = sum(dL/dsky * sky_image).  On
the card every step's gradient takes the fused HDR route: the emit pass
(K6), the texels' lookup, and the consume pass (K7) with the texels'
scatter, also where a gain above 1 carries sky terms past the clamp
before the average; with --cpu the same route runs their plain PyTorch
versions.

A 1-D gain keeps the demo robust at this size; ``fit_scene(...,
param_paths=("sky.image",), grad_backend="kernel")`` fits the whole texel
field.

Run on the card, or on the CPU with --cpu:
    python examples/fit_sky_image_torch.py [--steps 10] [--cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

G0 = 0.6           # the unknown gain to recover (-> 1)
LR = 4.0
SEED = 7


def make_scene():
    """(scene, cfg, sky image): the README scene under the tone-mapped
    procedural 64x32 sky at 64x36, 2 spp, depth 4, the "zero" NaN
    policy; the sky image a (32, 64, 3) float32 tensor."""
    import torch

    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import tone_map
    from opencl_ray_tracer_tpu_torch.io.procgen import make_sky_image

    sky_img = torch.as_tensor(tone_map(make_sky_image(64, 32)))
    scene = dataclasses.replace(ot.readme_scene(), sky=ot.Sky.hdr(sky_img))
    cfg = ot.RenderConfig(width=64, height=36, spp=2, max_depth=4,
                          nan_policy="zero")
    return scene, cfg, sky_img


def dimmed(scene, sky_img, gain: float):
    """The scene under the sky image times gain, in float32."""
    import torch

    import opencl_ray_tracer_tpu_torch as ot
    return dataclasses.replace(scene, sky=ot.Sky.hdr(
        sky_img * torch.tensor(gain, dtype=torch.float32)))


def fit_step(scene, sky_img, cfg, target, gain: float, device=None,
             grad_backend: str = "kernel"):
    """One step's (loss, dL/dgain, image) at ``gain`` against ``target``:
    the gradient of mean((img - target)^2) through ``render_grad_sampled``,
    chained onto the gain: dL/dgain = sum(dL/dsky * sky_img).  The kernel
    route takes any gain: a sky term above 1 is clamped in the image and
    in both cotangents."""
    import torch

    import opencl_ray_tracer_tpu_torch as ot

    def loss_fn(img):
        return torch.mean((img - target) ** 2)

    loss, img, g = ot.render_grad_sampled(dimmed(scene, sky_img, gain), cfg,
                                          loss_fn, seed=SEED,
                                          grad_backend=grad_backend,
                                          device=device)
    dg = float((g.sky.image * sky_img.to(g.sky.image.device)).sum())
    return float(loss), dg, img


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    import opencl_ray_tracer_tpu_torch as ot

    device = "cpu" if args.cpu else None
    scene, cfg, sky_img = make_scene()
    target = ot.render(scene, cfg, seed=SEED, device=device)

    gain = G0
    gains, losses, grads, secs = [], [], [], []
    print(f"gain0 = {gain:.4f}")
    for it in range(args.steps):
        t0 = time.perf_counter()
        loss, dg, _ = fit_step(scene, sky_img, cfg, target, gain, device)
        secs.append(time.perf_counter() - t0)
        gains.append(gain)
        gain = gain - LR * dg
        losses.append(loss)
        grads.append(dg)
        print(f"step {it:2d}: loss {loss:.3e}  gain -> {gain:.4f}")
    # descent must close at least half the gap to the true gain of 1
    assert abs(gain - 1.0) < 0.5 * abs(G0 - 1.0), gain
    print(f"recovered gain = {gain:.4f} (true 1.0)")
    return dict(scene=scene, cfg=cfg, sky_img=sky_img, target=target,
                gain=gain, gains=gains, losses=losses, grads=grads,
                seconds_per_step=secs)


if __name__ == "__main__":
    main()
