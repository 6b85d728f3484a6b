"""Full-image rendering and its gradients.

``render`` runs on the card unless the caller asks for the CPU.  On CUDA
it routes as the JAX package's ``render`` does (``kernel_route``): with
``cfg.backend`` "auto" or "pallas", a scene in the mesh megakernel's scope
(triangles of one material in gating boxes, at most 128 spheres; or an
HDR sky, with or without such triangles, whose texels and albedos may
exceed 1, unlike JAX's HDR body) goes through it, a sphere scene in the sphere megakernel's scope through
that; every other scene, and every scene under another backend, goes
through the plain tracer below (``render_rows``) on the card, whose
triangle hit is the closest-triangle kernel from 256 triangles.  Nothing
falls back: a kernel that fails to build or launch raises.  With
``device="cpu"`` the plain tracer renders, the oracle the kernels are
held against.

Gradients: ``render_and_grad`` is autograd of the plain per-sample tracer;
``render_grad_sampled`` is the full-size gradient, through the forward and
backward kernels on the card ("kernel": the sphere kernels; for a mesh
scene the mesh megakernel and the mesh backward kernel; for an HDR scene
the HDR passes, the JAX package's fused pipeline) or through autograd of
the plain wavefront tracer in pixel and sample chunks ("plain", the CPU's
route).  On the card a kernel that fails to build or launch raises;
nothing falls back.

Pixel conventions are the reference kernel's (``gpu_kernel.cl:626-627``):
u = (col + jitter)/W, v = (row + jitter)/H with row 0 at the image
*bottom*; the io writers handle display order.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .._fp import div
from ..config import RenderConfig
from ..rng import SLOT_PIXEL_U, uniform4
from ..scene import (Scene, camera_frame, float_leaves, gradient_scene,
                     rays_from_frame, requiring_grad)
from ..scene.sky import KIND_HDR
from .diffhit import make_grad_hit_fn
from .estimator import accumulate_sample, trace
from .wavefront import render_rows_wavefront


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; raises if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to render "
                "with the plain PyTorch tracer")
        device = "cuda"
    return torch.device(device)


def triangle_hit_fn(scene: Scene, cfg: RenderConfig, expected_rays: int):
    """The plain tracer's hit_fn for a scene with triangles, by
    cfg.tri_backend (the JAX package's ``render_rows`` rule): "pallas", or
    "auto" on the card from 256 triangles, takes the closest-triangle
    kernel; "mm", or "auto" otherwise from 256 triangles, the matmul-form
    fold; None (the direct form of ``closest_hit``) below 256."""
    from ..kernels.intersect_mm import make_kernel_hit_fn
    from .mesh_accel import make_mm_hit_fn
    n = scene.triangles.count
    on_card = scene.triangles.p0.device.type == "cuda"
    use_kernel = (cfg.tri_backend == "pallas"
                  or (cfg.tri_backend == "auto" and on_card and n >= 256))
    if use_kernel:
        return make_kernel_hit_fn(scene, cfg.t_min)
    if cfg.tri_backend == "mm" or (cfg.tri_backend == "auto" and n >= 256):
        return make_mm_hit_fn(scene, cfg.t_min, expected_rays=expected_rays)
    return None


def render_rows(scene: Scene, cfg: RenderConfig, row_start: int, n_rows: int,
                seed: int, hit_fn=None, remat: bool = False,
                sample_offset: int = 0, spp: int | None = None,
                mean: bool = True, acc0=None, any_alive=None):
    """Plain-tracer render of n_rows rows from row_start on the scene's
    device: (n_rows, W, 3) mean radiance.  The RNG is keyed on global pixel
    ids, so row blocks compose into the full image exactly.

    sample_offset and spp (None: cfg.spp) select the window of global
    sample ids [sample_offset, sample_offset + spp), which is what a
    sequential run draws there.  mean False returns the radiance sum
    instead of the mean, and acc0 ((n_rows, W, 3), (n_rows * W, 3) or None)
    seeds it: a window whose acc0 is the sum of the samples before it
    reproduces the NaN running-sum policy of an uninterrupted run
    (``gpu_kernel.cl:640-642``), and the result includes acc0.

    hit_fn(o, d) replaces the closest hit (``diffhit.make_grad_hit_fn``);
    without one, a scene with triangles takes ``triangle_hit_fn``.  remat
    recomputes each sample's bounce loop in the backward pass
    (``torch.utils.checkpoint``) instead of keeping it, for the per-sample
    loop (cfg.early_stop False).  any_alive(mask) -> bool ends the bounce
    loops (``estimator.trace``): the geometry ring's agrees over the
    ring."""
    width = cfg.width
    n_samples = cfg.spp if spp is None else spp
    dev = scene.spheres.center.device
    if hit_fn is None and scene.triangles.count > 0:
        hit_fn = triangle_hit_fn(scene, cfg, n_rows * width)
    rows = torch.arange(row_start, row_start + n_rows, device=dev)
    rows = rows[:, None].expand(n_rows, width).reshape(-1)
    cols = torch.arange(width, device=dev).repeat(n_rows)
    pixel_ids = rows * width + cols
    frame = camera_frame(scene.camera)
    if acc0 is not None:
        if not isinstance(acc0, torch.Tensor):
            acc0 = torch.tensor(acc0)   # a copy: the array may be read-only
        acc0 = acc0.to(device=dev, dtype=torch.float32).reshape(-1, 3)

    if cfg.early_stop:
        acc = render_rows_wavefront(scene, cfg, rows, cols, pixel_ids, seed,
                                    sample_offset, n_samples, frame=frame,
                                    hit_fn=hit_fn, acc0=acc0,
                                    any_alive=any_alive)
    else:
        def sample_colour(o, d, s):
            return trace(scene, o, d, pixel_ids, s, seed, cfg.max_depth,
                         t_min=cfg.t_min, hit_fn=hit_fn, any_alive=any_alive)

        acc = (torch.zeros((n_rows * width, 3), device=dev) if acc0 is None
               else acc0)
        for s in range(sample_offset, sample_offset + n_samples):
            u0, u1, u2, u3 = uniform4(seed, pixel_ids, s, SLOT_PIXEL_U)
            uu = div(cols.to(torch.float32) + u0, width)
            vv = div(rows.to(torch.float32) + u1, cfg.height)
            o, d = rays_from_frame(frame, uu, vv, u2, u3)
            if remat:
                colour = checkpoint(sample_colour, o, d, s,
                                    use_reentrant=False)
            else:
                colour = sample_colour(o, d, s)
            acc = accumulate_sample(acc, colour, cfg.nan_policy,
                                    cfg.clamp_samples)
    if mean:
        acc = div(acc, n_samples)
    return acc.reshape(n_rows, width, 3)


def kernel_route(scene: Scene, cfg: RenderConfig) -> str | None:
    """The kernel ``render`` takes on the card: "megamesh", "megakernel",
    or None for the plain tracer.  An HDR scene takes the mesh
    megakernel's HDR body when it is in its scope (``supports_mesh``, as
    in the JAX package but for texels and albedos above 1, which the CUDA
    kernel takes), and the plain tracer otherwise."""
    from ..kernels.megakernel import supports
    from ..kernels.megamesh import supports_mesh
    if cfg.backend in ("auto", "pallas"):
        if supports_mesh(scene, cfg):
            return "megamesh"
        if supports(scene, cfg):
            return "megakernel"
    return None


def render(scene: Scene, cfg: RenderConfig, seed: int = 0, device=None,
           progress=None, progress_blocks: int = 8):
    """Render the full image: (H, W, 3) f32 radiance on ``device``, row 0 =
    image bottom.  device None means CUDA, and raises when there is none;
    on CUDA the route is ``kernel_route``'s.

    progress: optional callback ``progress(rows_done, total_rows, canvas)``
    called after each of ``progress_blocks`` row blocks with the (H, W, 3)
    canvas so far, on ``device``: the reference's full-frame BMP rewrite
    after every block (``main.cpp:263-265``).  Each block takes the same
    route with its global pixel offset, so the image is the one-shot
    render's."""
    device = resolve_device(device)
    if progress is not None:
        return _render_progressive(scene, cfg, seed, device, progress,
                                   progress_blocks)
    return render_window(scene, cfg, seed, device)


def render_window(scene: Scene, cfg: RenderConfig, seed: int = 0,
                  device=None, row_start: int = 0, rows: int | None = None,
                  sample_offset: int = 0, mean: bool = True, acc0=None):
    """``rows`` image rows (None: cfg.height) from ``row_start`` on, over
    the cfg.spp samples from global sample id ``sample_offset``, through
    ``render``'s route on ``device`` (None: the card): the mean, or with
    mean False the radiance sum from the sums acc0 ((rows, W, 3) or None),
    as ``render_rows``.  The row blocks of ``render(progress=)`` and the
    sample windows of ``parallel.render_checkpointed`` run here."""
    device = resolve_device(device)
    rows = cfg.height if rows is None else rows
    window = dict(pix_offset=row_start * cfg.width, rows=rows,
                  sample_offset=sample_offset, mean=mean, acc0=acc0)
    if device.type == "cuda":
        route = kernel_route(scene, cfg)
        if route == "megamesh":
            from ..kernels.megamesh import render_megamesh
            return render_megamesh(scene, cfg, seed, device, **window)
        if route == "megakernel":
            from ..kernels.megakernel import render_megakernel
            return render_megakernel(scene.to(device), cfg, seed, **window)
    return _render_plain(scene.to(device), cfg, seed, row_start, rows,
                         sample_offset, mean, acc0)


def _render_progressive(scene: Scene, cfg: RenderConfig, seed: int, device,
                        progress, progress_blocks: int):
    """``render(progress=)``: row blocks of ``render_window`` written into
    one canvas on the device, the callback after each."""
    h = cfg.height
    block = max(1, -(-h // max(1, progress_blocks)))
    canvas = torch.zeros((h, cfg.width, 3), dtype=torch.float32,
                         device=device)
    for r0 in range(0, h, block):
        n = min(block, h - r0)
        canvas[r0:r0 + n] = render_window(scene, cfg, seed, device,
                                          row_start=r0, rows=n)
        progress(r0 + n, h, canvas)
    return canvas


# Rays per call of the plain tracer for a scene with triangles when
# cfg.row_chunk is None (the JAX package's bound on its triangle fold's
# intermediates).
_MESH_ROW_RAYS = 131072


def _render_plain(scene: Scene, cfg: RenderConfig, seed: int,
                  row_start: int = 0, rows: int | None = None,
                  sample_offset: int = 0, mean: bool = True, acc0=None):
    rows = cfg.height if rows is None else rows
    chunk = cfg.row_chunk or cfg.height
    if cfg.row_chunk is None and scene.triangles.count > 0:
        max_rows = max(1, _MESH_ROW_RAYS // cfg.width)
        chunk = next(r for r in range(min(max_rows, cfg.height), 0, -1)
                     if cfg.height % r == 0)
    if cfg.height % chunk:
        raise ValueError("row_chunk must divide height")
    out = []
    for r0 in range(0, rows, chunk):
        n = min(chunk, rows - r0)
        out.append(render_rows(
            scene, cfg, row_start + r0, n, seed, sample_offset=sample_offset,
            mean=mean, acc0=None if acc0 is None else acc0[r0:r0 + n]))
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


def render_and_grad(scene: Scene, cfg: RenderConfig, loss_fn, seed: int = 0,
                    fast_hit: bool = True, remat: bool = False, device=None):
    """Differentiable render: (loss, grads), grads a gradient Scene (float
    leaves hold gradients, integer leaves are None).  Autograd of the
    plain per-sample tracer (early_stop is forced off) on ``device`` (None
    means the card, and raises when there is none).

    fast_hit uses the winner-only differentiable hit (``diffhit``): the
    same values and gradients as autograd through the whole closest-hit
    fold, at a backward cost independent of the sphere count.  remat
    recomputes each sample in the backward pass instead of keeping it."""
    device = resolve_device(device)
    dcfg = cfg.replace(early_stop=False)
    s = requiring_grad(scene.to(device))
    hit_fn = make_grad_hit_fn(s, dcfg.t_min) if fast_hit else None
    img = render_rows(s, dcfg, 0, dcfg.height, seed, hit_fn=hit_fn,
                      remat=remat)
    loss = loss_fn(img)
    leaves = float_leaves(s)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), gradient_scene(s, dict(zip(leaves, grads)))


def render_grad_sampled(scene: Scene, cfg: RenderConfig, loss_fn,
                        seed: int = 0, spp_chunk: int = 25,
                        row_chunk: int | None = None,
                        winner_backend: str = "auto",
                        grad_backend: str = "auto", device=None):
    """Full-size differentiable render: (loss, image, grads), grads a
    gradient Scene.  ``device`` None means the card, and raises when there
    is none.

    Sphere scenes render the image of the scene's tables and differentiate
    it through ``kernels.megagrad.SphereRenderFn``:
      - "kernel": the forward megakernel renders and the backward
        megakernel differentiates (on CPU tensors the wrappers run their
        plain versions);
      - "plain": the plain tracer renders, and the gradient is autograd of
        the plain wavefront tracer with the winner-only hit, one (row_chunk
        rows x spp_chunk samples) chunk at a time: the mean image is linear
        in the samples, so the chunks' gradients add up.  Chunks bound the
        memory at any size; row_chunk None picks the most rows with at most
        2**17 rays.
    Mesh scenes:
      - "kernel": ``kernels.megagrad.MeshRenderFn``, the mesh megakernel
        (K2) and the mesh backward kernel (K5), for scenes in their scope
        (``supports_grad_mesh``);
      - "plain": ``render()`` draws the image on ``device``, and the
        gradient is autograd of the plain wavefront tracer over the scene's
        leaves in the same chunks, with the winner-only hit whose triangle
        search ``winner_backend`` picks (``diffhit.make_grad_hit_fn``:
        "auto" is the closest-triangle kernel on CUDA).
    HDR scenes, with or without triangles:
      - "kernel": ``kernels.megagrad.render_grad_hdr_fused``, the HDR
        emit pass (K6), the texels' lookup, the image rebuilt from them,
        and the consume pass (K7) with the texels' scatter into
        ``sky.image``; no forward render runs.  For scenes in their scope
        (``supports_grad_hdr``: the mesh megakernel's, any texels);
      - "plain": as for mesh scenes.
    "auto" is "kernel" on CUDA and "plain" on the CPU; on CUDA a mesh or
    HDR scene outside the kernels' scope takes "plain".

    The gradient treats a NaN sample with the order-invariant "zero"
    policy on every backend; the image keeps cfg.nan_policy, but for the
    HDR kernel route's, which is rebuilt under "zero".  A scene outside
    the backend's scope raises ``NotImplementedError`` naming the reason,
    before anything moves to the device, and on CUDA a kernel failure
    raises."""
    from ..kernels.megagrad import (render_grad_hdr_fused,
                                    render_mesh_differentiable,
                                    render_tables_differentiable,
                                    unsupported_grad_hdr_reason,
                                    unsupported_grad_mesh_reason,
                                    unsupported_grad_reason)
    from ..kernels.megakernel import unsupported_reason
    device = resolve_device(device)
    hdr = scene.sky.kind == KIND_HDR
    mesh = scene.triangles.count > 0
    # the kernel route's scope: the HDR passes', K5's, or K1's
    kernel_reason = (unsupported_grad_hdr_reason(scene) if hdr
                     else unsupported_grad_mesh_reason(scene) if mesh
                     else unsupported_reason(scene))
    if grad_backend == "auto":
        in_scope = not (hdr or mesh) or kernel_reason is None
        grad_backend = ("kernel" if device.type == "cuda" and in_scope
                        else "plain")
    rows = row_chunk or max(1, 2**17 // cfg.width)
    if grad_backend == "kernel":
        chunks = None
        reason = kernel_reason
    elif grad_backend == "plain":
        chunks = (rows * cfg.width, spp_chunk)
        reason = None if hdr or mesh else unsupported_grad_reason(scene)
    else:
        raise ValueError(f"unknown grad_backend: {grad_backend}")
    if reason is not None:
        raise NotImplementedError(reason)
    if (hdr or mesh) and grad_backend == "plain":
        return _grad_plain(scene, cfg, loss_fn, seed, chunks, winner_backend,
                           device)
    if hdr:
        return render_grad_hdr_fused(scene.to(device), cfg, loss_fn, seed)
    s = requiring_grad(scene.to(device))
    if mesh:
        img = render_mesh_differentiable(s, cfg, seed)
    else:
        img = render_tables_differentiable(s, cfg, seed, plain_chunks=chunks)
    loss = loss_fn(img)
    leaves = float_leaves(s)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return (loss.detach(), img.detach(),
            gradient_scene(s, dict(zip(leaves, grads))))


def _grad_plain(scene: Scene, cfg: RenderConfig, loss_fn, seed: int, chunks,
                winner_backend: str, device):
    """render_grad_sampled's "plain" route for a mesh or HDR scene (the JAX
    package's jnp route): the image through ``render()``, then autograd of
    the plain wavefront over (pixels, samples) chunks of ``chunks``."""
    img = render(scene, cfg, seed, device=device)
    img_ = img.detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn(img_)
    (g_img,) = torch.autograd.grad(loss, img_)
    g = div(g_img.reshape(-1, 3), cfg.spp)
    s = requiring_grad(scene.to(device))
    dcfg = cfg.replace(early_stop=False, nan_policy="zero")
    hit_fn = make_grad_hit_fn(s, dcfg.t_min, winner_backend=winner_backend)
    leaves = float_leaves(s)
    total = {k: None for k in leaves}
    n_pix = cfg.width * cfg.height
    pix_chunk, spp_chunk = chunks
    for p0 in range(0, n_pix, pix_chunk):
        m = min(pix_chunk, n_pix - p0)
        lin = torch.arange(p0, p0 + m, device=device)
        for s0 in range(0, cfg.spp, spp_chunk):
            acc = render_rows_wavefront(
                s, dcfg, lin // cfg.width, lin % cfg.width, lin, seed, s0,
                min(spp_chunk, cfg.spp - s0), hit_fn=hit_fn)
            grads = torch.autograd.grad((acc * g[p0:p0 + m]).sum(),
                                        list(leaves.values()),
                                        allow_unused=True)
            for k, gk in zip(leaves, grads):
                if gk is not None:
                    total[k] = gk if total[k] is None else total[k] + gk
    return loss.detach(), img.detach(), gradient_scene(s, total)
