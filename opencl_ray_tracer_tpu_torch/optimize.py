"""Inverse rendering: fit scene parameters to a target image.

``fit_scene`` descends the pixel loss with Adam over the listed scene
leaves (``"spheres.center"``, ``"spheres.albedo"``, ...).  Hard visibility
gives interior gradients only, so material and shading parameters fit
well; geometry (sphere centres and radii, triangle vertices) is dominated
by silhouette terms that it misses: fit it with ``soft=True``, which
renders with soft visibility (``tracer/soft.py``).
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Sequence

import torch

from .config import RenderConfig
from .scene import Scene, get_leaf, replace_leaves
from .scene.sky import KIND_HDR
from .tracer.diffhit import make_grad_hit_fn
from .tracer.render import render_rows, resolve_device
from .tracer.soft import render_soft


def extract_params(scene: Scene, paths: Sequence[str]) -> dict:
    """The leaves at ``paths`` ("group.field") by path."""
    return {p: get_leaf(scene, p) for p in paths}


def insert_params(scene: Scene, params: dict) -> Scene:
    """A copy of scene with the leaves of ``params`` put in."""
    return replace_leaves(scene, params)


def _kernel_scope(scene: Scene, param_paths) -> str | None:
    """Why the kernel route of ``fit_scene`` does not take this fit, or
    None."""
    hdr = scene.sky.kind == KIND_HDR
    if scene.triangles.count == 0 and not hdr:
        from .kernels.megakernel import unsupported_reason
        return unsupported_reason(scene)
    from .kernels.megagrad import (unsupported_grad_hdr_reason,
                                   unsupported_grad_mesh_reason)
    reason = (unsupported_grad_hdr_reason(scene) if hdr
              else unsupported_grad_mesh_reason(scene))
    materials = [p for p in param_paths if p.startswith("triangles.")
                 and p not in ("triangles.p0", "triangles.p1",
                               "triangles.p2")]
    sky = [p for p in param_paths if p.startswith("sky.")
           and not (hdr and p == "sky.image")]
    if reason is None and materials:
        reason = (f"fitting {', '.join(materials)} takes the plain route: "
                  "the mesh kernels need one uniform mesh material, which "
                  "a step would break")
    if reason is None and hdr and sky:
        reason = (f"fitting {', '.join(sky)} takes the plain route: the "
                  "HDR kernels read the sky's image alone")
    return reason


def _step_renderer(init_scene: Scene, cfg: RenderConfig, param_paths,
                   soft: bool, beta: float, grad_backend: str, device):
    """The route of a ``fit_scene`` step for these arguments (see there):
    (render_fn, init_scene on the device), render_fn(scene, step_seed) the
    image of a scene that holds the fit's parameters, differentiable in
    them.  ``chip_smoke.py`` holds one step of the kernel route against
    the same step of "plain" through it."""
    if soft:
        grad_backend = "soft"
    reason = None if soft else _kernel_scope(init_scene, param_paths)
    hdr = init_scene.sky.kind == KIND_HDR
    device = resolve_device(device)
    if grad_backend == "auto":
        grad_backend = ("kernel" if device.type == "cuda"
                        and (reason is None
                             or (init_scene.triangles.count == 0
                                 and not hdr))
                        else "plain")
    if grad_backend == "kernel" and reason is not None:
        raise NotImplementedError(reason)
    init_scene = init_scene.to(device)
    dcfg = cfg.replace(early_stop=False)
    if grad_backend == "soft":
        def render_fn(scene, step_seed):
            return render_soft(scene, dcfg, step_seed, beta, device=device)
    elif grad_backend == "kernel" and hdr:
        from .kernels.intersect_mm import MESH_CHUNK
        from .kernels.megagrad import render_hdr_differentiable
        from .kernels.megamesh import specialize_mesh_flags
        from .tracer.clusters import plan_for_scene
        flags = specialize_mesh_flags(init_scene, conservative=True)
        plan = (plan_for_scene(init_scene, MESH_CHUNK)
                if init_scene.triangles.count else None)
        gcfg = cfg.replace(nan_policy="zero")

        def render_fn(scene, step_seed):
            return render_hdr_differentiable(scene, gcfg, step_seed,
                                             flags=flags, plan=plan)
    elif grad_backend == "kernel" and init_scene.triangles.count > 0:
        from .kernels.intersect_mm import MESH_CHUNK
        from .kernels.megagrad import render_mesh_differentiable
        from .kernels.megamesh import specialize_mesh_flags
        from .tracer.clusters import plan_for_scene
        flags = specialize_mesh_flags(init_scene, conservative=True)
        plan = plan_for_scene(init_scene, MESH_CHUNK)
        gcfg = cfg.replace(nan_policy="zero")

        def render_fn(scene, step_seed):
            return render_mesh_differentiable(scene, gcfg, step_seed,
                                              flags=flags, plan=plan)
    elif grad_backend == "kernel":
        from .kernels.megagrad import render_tables_differentiable
        from .kernels.megakernel import specialize_flags
        flags = specialize_flags(init_scene, conservative=True)
        gcfg = cfg.replace(nan_policy="zero")

        def render_fn(scene, step_seed):
            return render_tables_differentiable(scene, gcfg, step_seed,
                                                flags=flags)
    else:
        def render_fn(scene, step_seed):
            return render_rows(scene, dcfg, 0, dcfg.height, step_seed,
                               hit_fn=make_grad_hit_fn(
                                   scene, dcfg.t_min, winner_backend="auto"))
    return render_fn, init_scene


def fit_scene(
    target,
    init_scene: Scene,
    cfg: RenderConfig,
    param_paths: Sequence[str] = ("spheres.center", "spheres.albedo"),
    steps: int = 100,
    learning_rate: float = 1e-2,
    loss_fn: Callable | None = None,
    seed: int = 0,
    sample_new_noise: bool = True,
    callback: Callable | None = None,
    soft: bool = False,
    beta: float = 80.0,
    param_mask: dict | None = None,
    grad_backend: str = "auto",
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    device=None,
):
    """Adam on the leaves at ``param_paths`` against ``target`` ((H, W, 3)
    radiance at cfg's size).  Returns (fitted scene, losses per step).

    loss_fn(img) defaults to the mean squared error to target.
    sample_new_noise draws new Monte Carlo samples every step (step i uses
    seed + i + 1); False keeps ``seed``, a deterministic objective.
    callback(i, loss, scene) runs after each step.  param_mask multiplies
    a parameter's gradient before the update ("group.field" -> tensor).
    grad_backend: "kernel" renders with the forward megakernel and
    differentiates with the backward megakernel, both under the "zero" NaN
    policy and with value-independent flags (``specialize_flags(...,
    conservative=True)``), since a step changes fuzz and aperture values;
    a mesh scene takes the mesh megakernel and the mesh backward kernel the
    same way (``specialize_mesh_flags(..., conservative=True)``), with the
    mesh tables in the initial scene's plan, rebuilt from the moved
    vertices every step (the plan is built once per fit).  The mesh route
    fits any leaf but the triangles' materials (a step would break the
    uniform material its scope needs); fitting those takes "plain".  An
    HDR scene takes the HDR passes (K6 and K7, the JAX package's fused
    pipeline: no forward render) the same way, with the first plan when it
    has triangles; its scope is held on the initial scene, as in the JAX
    package, and it fits ``sky.image`` besides; fitting another sky leaf
    or the triangles' materials takes "plain".
    "plain" is autograd of the plain per-sample tracer (cfg.early_stop
    off); "auto" is "kernel" on CUDA for a scene in the kernels' scope and
    "plain" otherwise.  An explicit "kernel" out of scope raises
    ``NotImplementedError``.  soft renders every step with
    ``render_soft(scene, cfg, step_seed, beta)`` (soft visibility of
    sharpness beta, autograd of torch ops; no kernel) and takes
    precedence over grad_backend, as in the JAX package.  ``device`` None
    means the card, and raises when there is none.

    checkpoint_path: the fit's state (the parameters, Adam's state, the
    losses and the step count) is written there atomically every
    ``checkpoint_every`` steps and after the last; a fit started again with
    the same arguments resumes from it, and with ``sample_new_noise`` its
    step-indexed seeds continue where they stopped.

    Adam with torch's defaults performs optax.adam's update (both divide by
    sqrt(v_hat) + eps).
    """
    if checkpoint_every < 1:
        raise ValueError("checkpoint_every must be at least 1")
    if grad_backend not in ("auto", "kernel", "plain"):
        raise ValueError(f"unknown grad_backend: {grad_backend}")
    device = resolve_device(device)
    render_fn, init_scene = _step_renderer(init_scene, cfg, param_paths,
                                           soft, beta, grad_backend, device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    if loss_fn is None:
        def loss_fn(img):
            return torch.mean((img - target) ** 2)

    params = {p: v.detach().clone().requires_grad_()
              for p, v in extract_params(init_scene, param_paths).items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    masks = {k: torch.as_tensor(m, dtype=torch.float32, device=device)
             for k, m in (param_mask or {}).items()}
    losses = []
    start = 0
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        losses, start = _load_fit_state(checkpoint_path, params, opt)
    for i in range(start, steps):
        step_seed = seed + i + 1 if sample_new_noise else seed
        opt.zero_grad()
        loss = loss_fn(render_fn(insert_params(init_scene, params),
                                 step_seed))
        loss.backward()
        for path, mask in masks.items():
            params[path].grad.mul_(mask)
        opt.step()
        losses.append(float(loss.detach()))
        if callback is not None:
            # copies: the next step updates the parameters in place
            callback(i, losses[-1], insert_params(
                init_scene, {p: v.detach().clone()
                             for p, v in params.items()}))
        if checkpoint_path is not None and ((i + 1) % checkpoint_every == 0
                                            or i + 1 == steps):
            _save_fit_state(checkpoint_path, params, opt, losses, i + 1)
    return (insert_params(init_scene,
                          {p: v.detach() for p, v in params.items()}),
            losses)


def _save_fit_state(path: str, params: dict, opt, losses, step: int) -> None:
    """Write a fit's state to ``path`` atomically (a temporary file beside
    it, then ``os.replace``): a crash while writing leaves the last state
    whole."""
    state = {"step": step, "losses": list(losses),
             "params": {p: v.detach().cpu() for p, v in params.items()},
             "adam": opt.state_dict()}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        torch.save(state, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def _load_fit_state(path: str, params: dict, opt):
    """Put the state of ``_save_fit_state`` into params (in place) and the
    optimizer; (losses, step)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if sorted(state["params"]) != sorted(params):
        raise ValueError(f"fit checkpoint {path} holds the parameters "
                         f"{sorted(state['params'])}, not {sorted(params)}")
    with torch.no_grad():
        for p, v in params.items():
            v.copy_(state["params"][p])
    opt.load_state_dict(state["adam"])
    return [float(x) for x in state["losses"]], int(state["step"])
