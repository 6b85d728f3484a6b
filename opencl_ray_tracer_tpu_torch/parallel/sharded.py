"""Sharded renders, gradients and training steps over the (tile, sample)
mesh of ranks.

The counterpart of the JAX package's ``shard_map`` code (and of the
reference's serial block loop, ``main.cpp:229-269``): each rank renders the
row block of its tile over the sample window of its sample index, the
windows' means are averaged over the sample group and the row blocks
gathered over the tile group, so that every rank returns the whole image,
as a JAX global array holds it.  The scene is replicated.  Gradients go
the other way: each rank differentiates its rows with its slice of the
whole image's cotangent, and the sums over the world stand in for
``shard_map``'s transpose (``psum``).

Determinism: the counter RNG is keyed on (global pixel id, global sample
id), and each row block takes ``render``'s route at its global pixel
offset (on the card the kernels' ``pix_offset``), so a tile-sharded image
is ``render()``'s bit for bit.  Sample windows apply the NaN running-sum
policy per window, as in the JAX package; their mean equals the whole
render's to rounding.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import RenderConfig
from ..kernels.megagrad import (TableCots, grads_from_cots, table_cots_rows,
                                unsupported_grad_reason)
from ..scene import Scene, Triangles, detached, float_leaves, get_leaf
from ..scene.sky import KIND_HDR
from ..tracer.diffhit import make_grad_hit_fn
from ..tracer.render import render_rows, render_window, resolve_device
from .mesh import Mesh, all_sum, any_over, gather_rows, sample_mean
from .ring import local_shard, ring_hit_fn_mm, shard_triangles


def _check(cfg: RenderConfig, mesh: Mesh) -> None:
    if cfg.height % mesh.n_tile:
        raise ValueError(f"height {cfg.height} is not divisible by the tile "
                         f"axis {mesh.n_tile}")
    if cfg.spp % mesh.n_sample:
        raise ValueError(f"spp {cfg.spp} is not divisible by the sample axis "
                         f"{mesh.n_sample}")


def _block(cfg: RenderConfig, mesh: Mesh) -> tuple:
    """This rank's (first row, rows, first sample, samples)."""
    rows = cfg.height // mesh.n_tile
    spp = cfg.spp // mesh.n_sample
    return mesh.tile_index * rows, rows, mesh.sample_index * spp, spp


def _loops_together(hit_fn, mesh: Mesh):
    """render_rows' any_alive for hit_fn: over the tile group when hit_fn
    calls collectives (its attribute ``collective``), so that every rank
    calls it equally often; else None, each rank's own rays."""
    if not getattr(hit_fn, "collective", False):
        return None
    return lambda alive: any_over(bool(alive.any()), mesh)


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                   seed: int = 0, hit_fn_factory=None,
                   geometry_ring: bool = False, device=None):
    """The (H, W, 3) image, rendered over the mesh and returned on every
    rank, on ``device`` (None: the mesh's; the card raises when there is
    none).  Every rank calls it with the same arguments.

    Each rank renders rows [ti * H / n_tile, (ti + 1) * H / n_tile) over
    samples [si * spp / n_sample, (si + 1) * spp / n_sample) through
    ``render_window``'s route (on the card the sphere or mesh megakernel
    at the block's pixel offset and sample window, or the plain tracer;
    on the CPU the plain tracer).

    hit_fn_factory(scene) -> hit_fn renders the block with the plain
    tracer and that closest hit instead.  A hit_fn that calls collectives
    (a ring's: ``ring_hit_fn``, ``ring_hit_fn_mm``) says so with a true
    attribute ``collective``; the block's bounce loops then end together
    over the tile group, at one all_reduce and one host sync a bounce.
    Any other hit_fn's loops end on their own rank's rays.
    geometry_ring shards the triangles over the tile axis and intersects
    them with ``ring.ring_hit_fn_mm`` (each step through the
    closest-triangle kernel on the card), for meshes larger than one
    device holds; it is its own intersection path, so not with
    hit_fn_factory."""
    _check(cfg, mesh)
    device = resolve_device(mesh.device if device is None else device)
    row_start, rows, sample_offset, spp = _block(cfg, mesh)
    wcfg = cfg.replace(spp=spp)
    if geometry_ring:
        if hit_fn_factory is not None:
            raise ValueError("geometry_ring is its own intersection path: "
                             "pass no hit_fn_factory")
        if scene.triangles.count == 0:
            raise ValueError("geometry_ring needs triangles")
        scene = scene.to(device)
        shard = local_shard(shard_triangles(scene.triangles, mesh.n_tile),
                            mesh)
        hit_fn = ring_hit_fn_mm(dataclasses.replace(scene, triangles=shard),
                                mesh, cfg.t_min)
        # the replicated scene holds no triangles: each rank keeps one shard
        rep = dataclasses.replace(scene,
                                  triangles=Triangles.empty().to(device))
        img = render_rows(rep, wcfg, row_start, rows, seed, hit_fn=hit_fn,
                          sample_offset=sample_offset,
                          any_alive=_loops_together(hit_fn, mesh))
    elif hit_fn_factory is not None:
        scene = scene.to(device)
        hit_fn = hit_fn_factory(scene)
        img = render_rows(scene, wcfg, row_start, rows, seed, hit_fn=hit_fn,
                          sample_offset=sample_offset,
                          any_alive=_loops_together(hit_fn, mesh))
    else:
        img = render_window(scene, wcfg, seed, device, row_start=row_start,
                            rows=rows, sample_offset=sample_offset)
    return gather_rows(sample_mean(img, mesh), mesh)


def render_sharded_jit(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                       seed: int = 0):
    """``render_sharded``: PyTorch runs eagerly and has no separate compile
    step, so this is the same call (kept for the JAX package's name)."""
    return render_sharded(scene, cfg, mesh, seed)


def _sum_cots(cots: TableCots, mesh: Mesh) -> TableCots:
    """Table cotangents summed over the world (psum)."""
    return cots._replace(**{
        k: all_sum(getattr(cots, k), mesh.world)
        for k in ("gcam", "gsph", "gtri", "g_sky")
        if getattr(cots, k) is not None})


def _image_cotangent(img, loss_fn):
    """(loss, d loss / d img) of a detached image."""
    img = img.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(img)
    (g_img,) = torch.autograd.grad(loss, img)
    return loss.detach(), g_img


def render_grad_sharded(scene: Scene, cfg: RenderConfig, loss_fn,
                        mesh: Mesh, seed: int = 0):
    """(loss, image, gradient Scene) over the mesh, on every rank.

    The image is ``render_sharded``'s; loss_fn(image) and its image
    cotangent are computed on every rank.  Each rank runs the backward
    kernels on its row block of the cotangent at the block's pixel offset
    (``megagrad.table_cots_rows``: K4 for a sphere scene, K5 for a mesh
    scene, K6, the texels' scatter and K7 for an HDR scene; on the CPU
    their plain versions), the table cotangents are summed over the world,
    and every rank chains the sums once through the table builders and
    ``tri_cotangents`` (``megagrad.grads_from_cots``).  The backward takes
    the "zero" NaN policy, as ``render_grad_sampled``'s kernels do; the
    sample axis must be 1, as in the JAX package (the kernels walk every
    sample of a pixel).  The scene must be in the backward kernels' scope
    (``megagrad.unsupported_grad_reason``)."""
    _check(cfg, mesh)
    if mesh.n_sample != 1:
        raise ValueError("the sharded gradient takes a sample axis of 1")
    reason = unsupported_grad_reason(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    scene = detached(scene.to(resolve_device(mesh.device)))
    img = render_sharded(scene, cfg, mesh, seed)
    loss, g_img = _image_cotangent(img, loss_fn)
    row_start, rows, _, _ = _block(cfg, mesh)
    cots = table_cots_rows(scene, cfg, g_img[row_start:row_start + rows],
                           seed, row_start)
    return loss, img, grads_from_cots(scene, _sum_cots(cots, mesh))


def make_train_step(cfg: RenderConfig, mesh: Mesh, optimizer, loss_fn,
                    insert_params, seed: int = 0, hit_fn_factory=None,
                    grad_backend: str = "plain", template_scene=None):
    """A sharded inverse-rendering step: ``step(params, target, step_seed)
    -> loss``, which updates ``params`` in place.

    params: a dict of tensors on the mesh's device that ``optimizer`` (a
    ``torch.optim`` optimizer over them) steps; it holds the state that the
    JAX package passes around as ``opt_state``.  insert_params(params) ->
    Scene, differentiably; loss_fn(image, target).  Every rank calls step
    with the same arguments; the gradients every rank applies are the same
    sums, so the parameters stay equal on all ranks.  seed is kept for
    the JAX package's signature: each step renders with its step_seed.

    grad_backend "plain": each rank renders its block with the plain
    per-sample tracer (early_stop off; the winner-only differentiable hit,
    or ``hit_fn_factory(scene)``, as in ``render_sharded``), the blocks'
    means are gathered, and each rank backpropagates its block with its
    slice of the whole image's cotangent; the parameters' gradients are
    summed over the world before ``optimizer.step()`` (``shard_map``'s
    transpose).
    "kernel" (the JAX package's "pallas"): the forward and backward kernels
    per tile, as ``render_grad_sharded``, under the "zero" NaN policy,
    with value-independent flags and the mesh tables' plan taken once
    from ``template_scene`` (a scene of the structure insert_params
    returns); the summed table cotangents are chained to the scene and
    through insert_params to the parameters.  Its scope: the backward
    kernels', at most 128 spheres (the forward's), on a mesh vertex
    parameters only (a step must keep the mesh's one material), and a
    sample axis of 1."""
    _check(cfg, mesh)
    if grad_backend == "kernel":
        return _kernel_train_step(cfg, mesh, optimizer, loss_fn,
                                  insert_params, template_scene)
    if grad_backend != "plain":
        raise ValueError(f"unknown grad_backend: {grad_backend}")
    dcfg = cfg.replace(early_stop=False)
    row_start, rows, sample_offset, spp = _block(dcfg, mesh)

    def step(params, target, step_seed):
        optimizer.zero_grad()
        scene = insert_params(params)
        hit_fn = (hit_fn_factory(scene) if hit_fn_factory is not None
                  else make_grad_hit_fn(scene, dcfg.t_min,
                                        winner_backend="auto"))
        with torch.enable_grad():
            block = render_rows(scene, dcfg, row_start, rows, step_seed,
                                hit_fn=hit_fn, sample_offset=sample_offset,
                                spp=spp,
                                any_alive=_loops_together(hit_fn, mesh))
        img = gather_rows(sample_mean(block.detach(), mesh), mesh)
        loss, g_img = _image_cotangent(img, lambda im: loss_fn(im, target))
        # the sample mean's transpose: each window carries 1 / n_sample
        block.backward(g_img[row_start:row_start + rows] / mesh.n_sample)
        for p in params.values():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = all_sum(g, mesh.world)
        optimizer.step()
        return loss

    return step


def _kernel_train_step(cfg, mesh, optimizer, loss_fn, insert_params,
                       template_scene):
    from ..kernels.intersect_mm import MESH_CHUNK, empty_tables, mesh_tables
    from ..kernels.megakernel import (camera_table, render_spheres,
                                      specialize_flags, sphere_table,
                                      unsupported_reason)
    from ..kernels.megamesh import (mesh_camera_table, render_mesh,
                                    specialize_mesh_flags)
    from ..tracer.clusters import plan_for_scene

    if template_scene is None:
        raise ValueError("grad_backend='kernel' needs template_scene")
    if mesh.n_sample != 1:
        raise ValueError("the kernel train step takes a sample axis of 1")
    gcfg = cfg.replace(early_stop=False, nan_policy="zero")
    reason = unsupported_grad_reason(template_scene)
    hdr = template_scene.sky.kind == KIND_HDR
    has_tris = template_scene.triangles.count > 0
    if reason is None and not (hdr or has_tris):
        # the forward kernel takes 128 spheres, the backward 256
        reason = unsupported_reason(template_scene)
    if reason is not None:
        raise NotImplementedError(reason)
    if hdr or has_tris:
        flags = specialize_mesh_flags(template_scene, conservative=True)
        plan = (plan_for_scene(template_scene, MESH_CHUNK) if has_tris
                else None)
    else:
        flags = specialize_flags(template_scene, conservative=True)
        plan = None
    row_start, rows, _, _ = _block(gcfg, mesh)
    n_pix = rows * gcfg.width
    pix_offset = row_start * gcfg.width

    def forward_rows(s, step_seed):
        """This rank's row block through the forward kernel (the plain
        version on the CPU), with the template's flags and plan."""
        if hdr or has_tris:
            tab = (mesh_tables(s, plan=plan) if has_tris
                   else empty_tables(s.spheres.center.device))
            planes = render_mesh(
                mesh_camera_table(s), sphere_table(s), s.spheres.count, tab,
                gcfg, s.sky.kind, flags, step_seed, n_pix, pix_offset,
                sky_image=s.sky.image.contiguous() if hdr else None)
        else:
            planes = render_spheres(camera_table(s), sphere_table(s),
                                    s.spheres.count, gcfg, s.sky.kind, flags,
                                    step_seed, n_pix, pix_offset)
        return torch.stack(planes, dim=-1).reshape(rows, gcfg.width, 3)

    def step(params, target, step_seed):
        optimizer.zero_grad()
        scene = insert_params(params)
        if has_tris:
            moved = [f for f in ("albedo", "fuzz", "ior")
                     if getattr(scene.triangles, f).requires_grad]
            if moved:
                raise NotImplementedError(
                    f"the kernel train step fits a mesh's vertices only: "
                    f"triangles.{', triangles.'.join(moved)} would break "
                    "the one mesh material the mesh kernels take")
        frozen = detached(scene)
        img = gather_rows(forward_rows(frozen, step_seed), mesh)
        loss, g_img = _image_cotangent(img, lambda im: loss_fn(im, target))
        cots = table_cots_rows(frozen, gcfg, g_img[row_start:row_start + rows],
                               step_seed, row_start, flags=flags, plan=plan)
        grads = grads_from_cots(frozen, _sum_cots(cots, mesh))
        pairs = [(leaf, get_leaf(grads, path))
                 for path, leaf in float_leaves(scene).items()
                 if leaf.requires_grad]
        torch.autograd.backward([a for a, _ in pairs], [g for _, g in pairs])
        optimizer.step()
        return loss

    return step
