"""Fitting a scene to a target image with ``fit_scene``: Adam on the
leaves ``param_paths`` at ``lr``, new samples every step.

The target is the reference's image, at ``target_spp`` samples, of the
scene moved by ``perturb`` (draws from the seed; ``scenes.scene_leaves``).
Set-up drives one fit through its first step, keeping its state in a
checkpoint that ``fit_scene`` writes and resumes from, then resumes it for
``warmup_steps`` more, a call that sizes the window; the window is one
further ``fit_scene`` call on that same state, of as many steps as fill
``seconds`` at the warm-up call's time a step (at least ``min_steps``),
with no callback.  Each resumed call loads the checkpoint and writes it
after its last step, as a user's resumed fit does.

The check follows the first step: the reference computes the same step
from the scene's leaves (``reference/fit.py``), and three numbers are
compared, each the gap between the program's and the reference's value
over the reference's: the step's loss ("loss_gap"), the norm of each
leaf's gradient as Adam got it (its first moment over 1 - beta1) and the
norm of each leaf's change after the step, each taken at the worst leaf
against the larger of that leaf's and the median leaf's reference norm
("grad_gap", "step_gap"); the change leaves out the leaves whose
reference gradient is under a thousandth of the median leaf's.
"""

from __future__ import annotations

import math
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from perfbench import scenes, tracing
from perfbench.reference import fit as ref_fit
from perfbench.reference import tracer as ref


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def inputs(config: dict, params: dict, seed: int, device) -> dict:
    """What a run of this seed fits: the scene's leaves, the render
    settings, the target image (on ``device``) and the fit's seed."""
    r = config["render"]
    rs = ref.RenderSettings(r["width"], r["height"], r["spp"],
                            r["max_depth"])
    leaves, kind = scenes.scene_leaves(config)
    perturbed, _ = scenes.scene_leaves(config, params["perturb"], seed)
    target_seed, fit_seed = (int(x) for x in np.random.default_rng(
        [seed, 2]).integers(0, 2**31 - 2**20, 2))
    n_pix = rs.width * rs.height
    target = ref.render_pixels(
        ref.Scene(perturbed, kind, device), ref.RenderSettings(
            rs.width, rs.height, params["target_spp"], rs.max_depth),
        torch.arange(n_pix, device=device), target_seed)
    return dict(leaves=leaves, kind=kind, rs=rs, fit_seed=fit_seed,
                target=target.reshape(rs.height, rs.width, 3).float(),
                paths=list(params["param_paths"]), lr=params["lr"])


def reference_step(inp: dict, device, counts=None, dtype=torch.float32,
                   keep_blocks=None, image_fn=None):
    """The reference's first step of the fit: (loss, gradients, parameters
    after it); in ``dtype`` (bfloat16: the control), with ``keep_blocks``
    leaving part of the image out and ``image_fn`` altering it
    (``reference.fit.fit_step``)."""
    return ref_fit.fit_step(inp["leaves"], inp["kind"], inp["rs"],
                            inp["target"], inp["paths"],
                            inp["fit_seed"] + 1, inp["lr"], device, counts,
                            dtype=dtype, keep_blocks=keep_blocks,
                            image_fn=image_fn)


def _gap(a: float, b: float, scale: float) -> float:
    if scale == 0.0:
        return 0.0 if a == b else math.inf
    return abs(a - b) / scale


def worst_leaf_gap(prog: dict, want: dict) -> float:
    """The largest |norm(prog[leaf]) - norm(want[leaf])| over the larger
    of norm(want[leaf]) and the median leaf's norm of ``want``."""
    norms = {p: float(v.double().norm()) for p, v in want.items()}
    median = statistics.median(norms.values())
    return max(_gap(float(prog[p].double().norm()), norms[p],
                    max(norms[p], median)) for p in want)


def compare(inp: dict, prog: tuple, want: tuple) -> dict:
    """The three numbers, of a step ``prog`` against the reference's step
    ``want``, each (loss, {leaf: gradient}, {leaf: parameter after})."""
    init = {p: torch.as_tensor(np.asarray(inp["leaves"][p]))
            for p in inp["paths"]}
    grads = {p: g.detach().cpu().float() for p, g in want[1].items()}
    # leaves whose reference gradient is nought to rounding move under
    # Adam by round-off alone: their change is not compared
    norms = {p: float(g.double().norm()) for p, g in grads.items()}
    median = statistics.median(norms.values())
    moving = [p for p in inp["paths"] if norms[p] >= 1e-3 * median]
    return {"loss_gap": _gap(prog[0], want[0], abs(want[0])),
            "grad_gap": worst_leaf_gap(
                {p: g.detach().cpu().float() for p, g in prog[1].items()},
                grads),
            "step_gap": worst_leaf_gap(
                {p: prog[2][p].detach().cpu().float() - init[p]
                 for p in moving},
                {p: want[2][p].detach().cpu().float() - init[p]
                 for p in moving})}


def program_step(inp: dict, state: dict) -> tuple:
    """The program's first step from its checkpoint after it: (loss,
    gradients from Adam's first moment, parameters).  Adam holds no state
    for a leaf whose gradient was None: a zero one."""
    adam = state["adam"]["state"]
    grads = {p: adam[i]["exp_avg"] / (1.0 - ref_fit.ADAM_BETA1)
             if i in adam else torch.zeros(np.shape(inp["leaves"][p]))
             for i, p in enumerate(inp["paths"])}
    return state["losses"][0], grads, state["params"]


def run(config, params, seed, seconds, traced, t0, device, limits):
    import opencl_ray_tracer_tpu_torch as ot

    inp = inputs(config, params, seed, device)
    rs = inp["rs"]
    cfg = ot.RenderConfig(width=rs.width, height=rs.height, spp=rs.spp,
                          max_depth=rs.max_depth)
    scene = ot.scene_from_numpy(inp["leaves"], inp["kind"], device=device)
    tmp = tempfile.TemporaryDirectory(prefix="perfbench_fit_")
    ck = os.path.join(tmp.name, "fit.pt")

    def fit(steps, every):
        return ot.fit_scene(inp["target"], scene, cfg,
                            param_paths=inp["paths"], steps=steps,
                            learning_rate=inp["lr"], seed=inp["fit_seed"],
                            sample_new_noise=True, checkpoint_path=ck,
                            checkpoint_every=every, device=device)

    try:
        if device.type == "cuda":
            # the reference's target is an input: the run's memory peak
            # counts from the program's set-up on
            _sync(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        fit(1, 1)
        first = torch.load(ck, map_location="cpu", weights_only=True)
        w = params["warmup_steps"]
        t = time.perf_counter()
        fit(1 + w, 10**9)
        _sync(device)
        step_s = (time.perf_counter() - t) / w
        done = 1 + w
        n = max(params["min_steps"], math.ceil(seconds / step_s))
        out: dict = {}
        with tracing.traced_window(traced, out):
            _sync(device)
            start = time.perf_counter()
            _, losses = fit(done + n, 10**9)
            _sync(device)
            end = time.perf_counter()
    finally:
        tmp.cleanup()
    run = dict(kind="fit", setup_s=start - t0, window_s=end - start,
               steps=n, attempted=n, trace=out.get("trace"),
               failed=sum(not math.isfinite(x) for x in losses[done:]))
    if device.type == "cuda":
        run["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
    del scene, losses
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference follows the first step, once the window has closed
    t_ref = time.perf_counter()
    counts = ref.new_counts()
    want = reference_step(inp, device, counts)
    run["reference_s"] = time.perf_counter() - t_ref
    run["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in
                     compare(inp, program_step(inp, first), want).items()}
    leaves = inp["leaves"]
    run["work"] = dict(counts, n_pix=rs.width * rs.height, spp=rs.spp,
                       n_spheres=int(leaves["spheres.center"].shape[0]),
                       n_tris=int(leaves["triangles.p0"].shape[0]),
                       sky_texels=int(np.prod(leaves["sky.image"].shape[:2])))
    return run
