"""Where the HDR gradient's time goes outside its two kernels, on the card.

    python tools/hdr_host_profile.py [--mesh 576|15360] [--fit-steps N]

Runs ``render_grad_sampled`` of ``flagship_scene()`` at
``REFERENCE_DEFAULTS`` (the fused route: K6, the texels' lookup, the
image, the loss, K7 and the texels' scatter), once to warm up, then:

1. the same steps one by one, each ended by ``torch.cuda.synchronize()``
   and timed on the host clock (min of 3): the scene moved to the card,
   the scope check, the differentiable table builders, the mesh tables'
   cache hit and the flags, K6, the lookup, the image and the loss, the
   texels' scatter, K7, and the chain of the table and triangle
   cotangents to the scene's leaves;
2. one call under ``torch.profiler`` (CPU and CUDA), whose ten largest ops
   by CPU time and by device time it prints;
3. with ``--fit-steps``, a ``fit_scene`` of ``sky.image`` (chip_smoke.py's
   phase 20: from the sky scaled by 0.85 towards the image of the true
   sky), each step's seconds ended by a synchronize.

Prints one JSON line per stage and per profiler row, then the card's name
and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene import (detached,  # noqa: E402
                                               requiring_grad)


def loss_fn(img):
    return torch.mean(img ** 2)


def min_ms(fn, reps: int = 3):
    best, out = float("inf"), None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, 1e3 * (time.perf_counter() - t0))
    return best, out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", choices=("576", "15360"), default="576")
    ap.add_argument("--fit-steps", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    if args.mesh == "576":
        scene = ot.flagship_scene(16 / 9)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "torus.obj")
            with open(path, "w") as f:
                f.write(make_torus_obj(128, 60))
            scene = ot.flagship_scene(16 / 9, obj_path=path)
    cfg = ot.REFERENCE_DEFAULTS
    n_pix = cfg.width * cfg.height
    ot.render_grad_sampled(scene, cfg, loss_fn, seed=0)  # warm-up
    total, _ = min_ms(lambda: ot.render_grad_sampled(scene, cfg, loss_fn,
                                                     seed=0))

    stages = {}

    def stage(name, fn):
        stages[name], out = min_ms(fn)
        return out

    s = stage("scene_to_card", lambda: scene.to(dev))
    stage("scope_check", lambda: mg.unsupported_grad_hdr_reason(s))
    r = stage("requiring_grad", lambda: requiring_grad(s))
    cam, sph = stage("table_builders", lambda: (mm.mesh_camera_table(r),
                                                mk.sphere_table(r)))
    frozen = detached(r)
    tab = stage("mesh_tables_cache_hit", lambda: im.mesh_tables(frozen))
    flags = stage("flags", lambda: mm.specialize_mesh_flags(frozen))
    args_ = (cam.detach(), sph.detach(), s.spheres.count, tab, cfg, flags)
    emit, emis = stage("k6_emit", lambda: mg.hdr_emit(*args_, 0, n_pix))
    image = s.sky.image.contiguous()
    sky, flat = stage("lookup", lambda: mg.hdr_lookup(image, emit))

    def image_and_loss():
        img = mg.hdr_image(emit, emis, sky, cfg).T.reshape(
            cfg.height, cfg.width, 3).requires_grad_()
        return torch.autograd.grad(loss_fn(img), img)[0]

    g_img = stage("image_and_loss", image_and_loss)
    planes = mg._planes(g_img, cfg.spp)
    stage("sky_scatter", lambda: mg.hdr_sky_cot(image, emit, sky, flat,
                                                *planes))
    gcam, gsph, gtri = stage("k7_consume", lambda: mg.hdr_consume(
        *args_, *planes, sky, 0, n_pix))

    def chain():
        grads = mg.table_grads_to_scene(s, gcam, gsph)
        return mg.tri_grads_to_scene(s, tab.plan, gtri, grads)

    stage("chain_to_leaves", chain)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"case": f"flagship_{args.mesh}", "size":
                      "1280x720x5/d32", "fwd_bwd_ms": total,
                      "stages_ms": stages,
                      "stages_sum_ms": sum(stages.values())}), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ot.render_grad_sampled(scene, cfg, loss_fn, seed=0)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    for key in ("cpu_time_total", "device_time_total"):
        top = sorted(rows, key=lambda e: getattr(e, key, 0.0),
                     reverse=True)[:10]
        for e in top:
            print(json.dumps({"sorted_by": key, "op": e.key,
                              "count": e.count,
                              "cpu_ms": e.cpu_time_total / 1e3,
                              "device_ms": getattr(e, "device_time_total",
                                                   0.0) / 1e3}), flush=True)
    if args.fit_steps:
        target = ot.render(scene, cfg, seed=3)
        init = ot.Scene(scene.camera, scene.spheres, scene.triangles,
                        scene.boxes, ot.Sky.hdr(scene.sky.image * 0.85))
        stamps = [time.perf_counter()]

        def on_step(i, loss, s):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        ot.fit_scene(target, init, cfg, param_paths=("sky.image",),
                     steps=args.fit_steps, seed=3, sample_new_noise=False,
                     callback=on_step)
        print(json.dumps({"case": f"flagship_{args.mesh}",
                          "fit_seconds_per_step": [
                              b - a for a, b in zip(stamps, stamps[1:])]}),
              flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
