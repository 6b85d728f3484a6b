"""Closed-loop renders: one client calls ``render(scene, cfg, seed=k)``
with a new seed for each image and waits for it (the call, then
``torch.cuda.synchronize()``) before it asks for the next, until the
window's seconds have passed.

Parameters (the workload file's ``params``): ``warmup_images`` rendered
in set-up; ``check_images`` images, drawn from the seed among the window's
first ``check_among``, whose ``check_rows`` rows (drawn from the seed too)
are kept and, once the window has closed, rendered again by the
reference; the check is the widest of those images' mean absolute
differences to the reference, "image_mean_abs".
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import scenes, tracing
from perfbench.reference import tracer as ref


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(config: dict, params: dict, seed: int) -> dict:
    """What a run of this seed renders and checks: the scene's leaves, the
    render settings, each image's seed (``seed_of(i)``), the images
    checked and their rows."""
    leaves, kind = scenes.scene_leaves(config)
    r = config["render"]
    rs = ref.RenderSettings(r["width"], r["height"], r["spp"],
                            r["max_depth"])
    pick = np.random.default_rng([seed, 1])
    check = sorted(int(i) for i in pick.choice(
        params["check_among"], params["check_images"], replace=False))
    rows = np.sort(pick.choice(rs.height, params["check_rows"],
                               replace=False))
    base = int(np.random.default_rng(seed).integers(0, 2**32))
    return dict(leaves=leaves, kind=kind, rs=rs, check=check, rows=rows,
                seed_of=lambda i: (base + i) % 2**32)


def reference_rows(inp: dict, image: int, device, counts=None,
                   dtype=torch.float32):
    """The reference's pixels of the checked rows of image ``image``,
    (rows * W, 3); in ``dtype`` (bfloat16: the control)."""
    rs = inp["rs"]
    pix = (torch.as_tensor(inp["rows"], device=device)[:, None] * rs.width
           + torch.arange(rs.width, device=device)).reshape(-1)
    scene = ref.Scene(inp["leaves"], inp["kind"], device, dtype)
    return ref.render_pixels(scene, rs, pix, inp["seed_of"](image), counts)


def mean_abs(got, want) -> float:
    return float((got.reshape(-1, 3).double()
                  - want.reshape(-1, 3).double()).abs().mean())


def run(config, params, seed, seconds, traced, t0, device, limits):
    import opencl_ray_tracer_tpu_torch as ot

    inp = inputs(config, params, seed)
    rs, seed_of = inp["rs"], inp["seed_of"]
    if device.type == "cuda":
        # the run's memory peak counts from the program's set-up on
        torch.cuda.reset_peak_memory_stats(device)
    scene = ot.scene_from_numpy(inp["leaves"], inp["kind"], device=device)
    cfg = ot.RenderConfig(width=rs.width, height=rs.height, spp=rs.spp,
                          max_depth=rs.max_depth)
    rows_t = torch.as_tensor(inp["rows"], device=device)
    check = set(inp["check"])
    for i in range(params["warmup_images"]):
        ot.render(scene, cfg, seed=seed_of(2**31 + i), device=device)
    _sync(device)

    latency, host, kept = [], [], {}
    out: dict = {}
    with tracing.traced_window(traced, out):
        _sync(device)
        start = time.perf_counter()
        i = 0
        while True:
            ta = time.perf_counter()
            img = ot.render(scene, cfg, seed=seed_of(i), device=device)
            tb = time.perf_counter()
            _sync(device)
            tc = time.perf_counter()
            latency.append(tc - ta)
            host.append(tb - ta)
            if i in check:
                kept[i] = img.index_select(0, rows_t)
            i += 1
            if tc - start >= seconds:
                break
    run = dict(kind="render", setup_s=start - t0, window_s=tc - start,
               latency_s=latency, host_s=host, attempted=i,
               trace=out.get("trace"))
    if device.type == "cuda":
        run["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    del img, scene
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed; an image that never came
    # counts as failed
    t_ref = time.perf_counter()
    counts = ref.new_counts()
    gaps = [mean_abs(kept[k], reference_rows(inp, k, device, counts))
            for k in inp["check"] if k in kept]
    run["reference_s"] = time.perf_counter() - t_ref
    run["failed"] = (len(check) - len(gaps)
                     + sum(not g <= limits["image_mean_abs"] for g in gaps))
    run["checks"] = {"image_mean_abs": {
        "value": max(gaps) if gaps else float("inf"),
        "limit": limits["image_mean_abs"]}}
    # the reference's path counts, per image
    share = len(gaps) * len(inp["rows"]) / rs.height
    leaves = inp["leaves"]
    run["work"] = dict(
        {k: v / share for k, v in counts.items()} if gaps else {},
        n_pix=rs.width * rs.height, spp=rs.spp,
        n_spheres=int(leaves["spheres.center"].shape[0]),
        n_tris=int(leaves["triangles.p0"].shape[0]),
        sky_texels=int(np.prod(leaves["sky.image"].shape[:2])))
    return run
