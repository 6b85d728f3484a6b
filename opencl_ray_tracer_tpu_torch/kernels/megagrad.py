"""The sphere megakernel's backward: scene gradients on the card.

``render_grad_tables`` is the wrapper of the CUDA kernel in
``csrc/megagrad.cu`` (forward replay with the forward kernel's device
code, then a reverse walk with adjoints derived by hand; see the note at
the top of that file).  It replaces the sphere variant of the JAX package's
Pallas ``kernels/megagrad.py::_make_grad_kernel``.  Given the cotangent of
each pixel's mean radiance, already divided by the number of samples, it
returns the cotangents of the camera table (the ``CAM_SLOTS``) and of the
sphere table (the ``DIFF_FIELDS`` rows: centre, r^2, 1/r, albedo, fuzz, ior,
1/ior).  ``render_grad_tables_plain`` is its plain PyTorch version with the
same signature, autograd through the plain wavefront tracer with the
winner-only hit; the wrapper runs it for tensors on the CPU and nowhere
else.  The plain version reads the radius from the ``F_R`` row and the ior
from ``F_IOR`` alone, so the two agree on the scene's leaves
(``render_grad_scene``), and row by row only on the rows both read.

The backward always uses the order-invariant "zero" NaN policy, whatever
``cfg.nan_policy`` says: the running-sum policy is not linear in the
samples.  The forward keeps ``cfg.nan_policy``.  A NaN-free render is the
same under both.
"""

from __future__ import annotations

import ctypes

import torch

from .._fp import div
from ..config import RenderConfig
from ..scene import Scene, float_leaves, gradient_scene, requiring_grad
from ..tracer.diffhit import make_grad_hit_fn
from ..tracer.wavefront import render_rows_wavefront
from . import _build
from .megakernel import (F_ALB, F_ALG, F_ALR, F_CX, F_CY, F_CZ, F_FUZZ,
                         F_INVIOR, F_INVR, F_IOR, F_R2, C_DUX, C_DUY, C_DUZ,
                         C_DVX, C_DVY, C_DVZ, C_HX, C_HY, C_HZ, C_LX, C_LY,
                         C_LZ, C_OX, C_OY, C_OZ, C_SKY0, C_SKY1, C_SKY2,
                         C_VX, C_VY, C_VZ, LANES, N_FIELDS,
                         _flag_bits, camera_table, render_spheres,
                         render_spheres_plain,
                         scene_from_tables, specialize_flags, sphere_table,
                         unsupported_reason)
from ..scene.sky import KIND_CONST, KIND_GRADIENT, KIND_HDR

# The backward takes up to 256 spheres, as the JAX package's; the forward
# kernel takes 128.
GRAD_MAX_SPHERES = 256
# Differentiable sphere-table rows, in the kernel's accumulator order.
DIFF_FIELDS = (F_CX, F_CY, F_CZ, F_R2, F_INVR, F_ALR, F_ALG, F_ALB,
               F_FUZZ, F_IOR, F_INVIOR)
# Differentiable camera-table slots.
CAM_SLOTS = (C_OX, C_OY, C_OZ, C_HX, C_HY, C_HZ, C_VX, C_VY, C_VZ,
             C_LX, C_LY, C_LZ, C_DUX, C_DUY, C_DUZ, C_DVX, C_DVY, C_DVZ,
             C_SKY0, C_SKY1, C_SKY2)
# Floats the kernel records per bounce that goes on; threads per block;
# camera-table slots the kernel reads (C_OX .. C_SKY2).
_REC = 10
_THREADS = 128
_CAM_USED = C_SKY2 + 1
# Pixels and samples per autograd call of the plain version.
_PLAIN_PIX_CHUNK = 2**17
_PLAIN_SPP_CHUNK = 25

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    "sphere_megagrad_launch": (
        [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
         ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I, ctypes.c_float,
         _I, _P], _I),
    "sphere_megagrad_threads": ([_I], _I),
}


def _library():
    return _build.load("megagrad", _SYMBOLS)


def unsupported_grad_reason(scene: Scene) -> str | None:
    """Why the backward kernel does not cover this scene, or None.  It
    takes twice the forward kernel's spheres."""
    if scene.triangles.count > 0 or scene.sky.kind == KIND_HDR:
        return unsupported_reason(scene)
    if not 0 < scene.spheres.count <= GRAD_MAX_SPHERES:
        return (f"the backward kernel takes 1 to {GRAD_MAX_SPHERES} "
                "spheres; larger sphere scenes are not ported")
    return None


def supports_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the backward kernel covers this scene: spheres only, up to
    GRAD_MAX_SPHERES, gradient or constant sky."""
    return unsupported_grad_reason(scene) is None


def _check_args(cam, sph, n_spheres, cfg, sky_kind, planes, n_pix,
                pix_offset, n_samples, counts):
    if sky_kind not in (KIND_GRADIENT, KIND_CONST):
        raise ValueError(f"the kernel takes a gradient or constant sky, "
                         f"not kind {sky_kind}")
    for name, t, rows in (("camera", cam, 1), ("sphere", sph, N_FIELDS)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} table must be contiguous float32")
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} table has shape {tuple(t.shape)}")
    if cam.shape[1] != LANES or sph.shape[1] < max(LANES, n_spheres):
        raise ValueError("table widths do not match the table builders")
    if not 0 < n_spheres <= GRAD_MAX_SPHERES:
        raise ValueError(f"n_spheres must be in 1..{GRAD_MAX_SPHERES}")
    for t in planes:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != (n_pix,)):
            raise ValueError("cotangent planes must be contiguous float32 "
                             "of shape (n_pix,)")
    if any(t.device != cam.device for t in (sph, *planes)):
        raise ValueError("tables and cotangents are on different devices")
    if (n_pix < 0 or pix_offset < 0 or pix_offset + n_pix >= 2**31
            or n_samples < 0 or n_samples * cfg.max_depth >= 2**31):
        raise ValueError("pixel or sample counts out of range")
    if counts is not None and (counts.dtype != torch.int64
                               or counts.numel() != 2
                               or counts.device != cam.device):
        raise ValueError("counts must be two int64 on the tables' device")


def render_grad_tables(cam, sph, n_spheres: int, cfg: RenderConfig,
                       sky_kind: int, flags, g_r, g_g, g_b, seed: int,
                       n_pix: int, pix_offset: int = 0, sample_base: int = 0,
                       n_samples: int | None = None, counts=None):
    """Cotangents (gcam (1, 128), gsph (16, W)) of the camera and sphere
    tables for the cotangent planes g_r, g_g, g_b ((n_pix,) each, already
    divided by the number of samples) of n_pix pixels from global pixel
    ``pix_offset``, over n_samples samples (cfg.spp when None) from global
    sample ``sample_base``.

    cam/sph: ``camera_table``/``sphere_table``; flags: ``specialize_flags``;
    counts: optional two-element int64 tensor that receives the bounces
    replayed and the bounces walked back.  CUDA tensors launch the kernel;
    CPU tensors run ``render_grad_tables_plain``.
    """
    global LAUNCHES
    n_samples = cfg.spp if n_samples is None else n_samples
    planes = (g_r, g_g, g_b)
    _check_args(cam, sph, n_spheres, cfg, sky_kind, planes, n_pix,
                pix_offset, n_samples, counts)
    if cam.device.type == "cpu":
        return render_grad_tables_plain(cam, sph, n_spheres, cfg, sky_kind,
                                        flags, g_r, g_g, g_b, seed, n_pix,
                                        pix_offset, sample_base, n_samples,
                                        counts)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg, sky_kind, flags)
    lib = _library()
    gsph = torch.zeros_like(sph)
    with torch.cuda.device(cam.device):
        n_threads = lib.sphere_megagrad_threads(max(n_pix, 1))
        if n_threads <= 0:
            raise RuntimeError("sphere megagrad: occupancy query failed")
        rec = torch.empty(n_threads * cfg.max_depth * _REC,
                          dtype=torch.float32, device=cam.device)
        # one row of camera cotangents per block, added up below in a fixed
        # order (the kernel's note, step 4)
        cam_part = torch.zeros((n_threads // _THREADS, _CAM_USED),
                               dtype=torch.float32, device=cam.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.sphere_megagrad_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(),
            cam_part.data_ptr(), gsph.data_ptr(), rec.data_ptr(), n_threads,
            counts.data_ptr() if counts is not None else None, n_pix,
            pix_offset, seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF,
            n_samples, cfg.width, cfg.height, cfg.max_depth, cfg.t_min,
            bits, stream)
    if rc != 0:
        raise RuntimeError(f"sphere megagrad launch failed: CUDA error {rc}")
    LAUNCHES += 1
    gcam = torch.zeros_like(cam)
    gcam[0, :_CAM_USED] = cam_part.sum(dim=0)
    return gcam, gsph


def render_grad_tables_plain(cam, sph, n_spheres: int, cfg: RenderConfig,
                             sky_kind: int, flags, g_r, g_g, g_b, seed: int,
                             n_pix: int, pix_offset: int = 0,
                             sample_base: int = 0,
                             n_samples: int | None = None, counts=None,
                             pix_chunk: int = _PLAIN_PIX_CHUNK,
                             spp_chunk: int = _PLAIN_SPP_CHUNK):
    """The plain PyTorch version of ``render_grad_tables``, on the tables'
    device: autograd of the plain wavefront tracer with the winner-only
    hit, over chunks of at most pix_chunk pixels and spp_chunk samples,
    which bound its memory (the sum is linear in the samples under the
    "zero" policy).  counts[0] receives the bounces traced; counts[1] stays
    0.  ``flags`` only prune the kernel's code."""
    n_samples = cfg.spp if n_samples is None else n_samples
    gcfg = cfg.replace(nan_policy="zero")
    g = torch.stack([g_r, g_g, g_b], dim=-1)
    gcam = torch.zeros_like(cam)
    gsph = torch.zeros_like(sph)
    bounces = counts[:1] if counts is not None else None
    for p0 in range(0, n_pix, pix_chunk):
        m = min(pix_chunk, n_pix - p0)
        lin = torch.arange(pix_offset + p0, pix_offset + p0 + m,
                           device=cam.device)
        for s0 in range(0, n_samples, spp_chunk):
            # also under a backward pass, which turns grad mode off
            with torch.enable_grad():
                cam_ = cam.detach().requires_grad_()
                sph_ = sph.detach().requires_grad_()
                scene, frame = scene_from_tables(cam_, sph_, n_spheres,
                                                 sky_kind)
                acc = render_rows_wavefront(
                    scene, gcfg, lin // cfg.width, lin % cfg.width, lin,
                    seed, sample_base + s0, min(spp_chunk, n_samples - s0),
                    frame=frame, bounces=bounces,
                    hit_fn=make_grad_hit_fn(scene, cfg.t_min))
                a, b = torch.autograd.grad((acc * g[p0:p0 + m]).sum(),
                                           (cam_, sph_), allow_unused=True)
            if a is not None:
                gcam += a
            if b is not None:
                gsph += b
    return gcam, gsph


def _planes(g_img, spp: int):
    """(H, W, 3) image cotangent -> three contiguous planes divided by
    spp."""
    g = div(g_img.reshape(-1, 3).to(torch.float32), spp).T.contiguous()
    return g[0], g[1], g[2]


def render_grad_scene(scene: Scene, cfg: RenderConfig, g_img, seed: int = 0,
                      flags=None):
    """Gradient Scene for the cotangent g_img (H, W, 3) of the mean image:
    the table cotangents of ``render_grad_tables`` (with g_img / spp)
    chained to the scene's leaves by ``table_grads_to_scene``.  Runs on the
    scene's device; flags default to ``specialize_flags(scene)``."""
    reason = unsupported_grad_reason(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    gcam, gsph = render_grad_tables(
        camera_table(scene), sphere_table(scene), scene.spheres.count, cfg,
        scene.sky.kind,
        flags if flags is not None else specialize_flags(scene),
        *_planes(g_img, cfg.spp), seed, cfg.width * cfg.height)
    return table_grads_to_scene(scene, gcam, gsph)


def table_grads_to_scene(scene: Scene, gcam, gsph) -> Scene:
    """Gradient Scene from the cotangents of ``camera_table(scene)`` and
    ``sphere_table(scene)``, through autograd of the two builders (r^2,
    1/r and 1/ior chain to the radius and the ior there)."""
    s = requiring_grad(scene)
    cam, sph = camera_table(s), sphere_table(s)
    leaves = float_leaves(s)
    grads = torch.autograd.grad((cam, sph), list(leaves.values()),
                                (gcam, gsph), allow_unused=True)
    return gradient_scene(scene, dict(zip(leaves, grads)))


class SphereRenderFn(torch.autograd.Function):
    """(H, W, 3) image of the tables through ``render_spheres`` (the
    forward kernel on CUDA), whose backward is ``render_grad_tables`` (the
    backward kernel).  The forward keeps ``cfg.nan_policy``; the backward
    differentiates the "zero" policy (see the module docstring).

    apply(cam, sph, n_spheres, cfg, sky_kind, flags, seed, plain_chunks):
    plain_chunks None takes the wrappers, which launch the kernels for CUDA
    tensors and run the plain versions for CPU tensors; a pair (pix_chunk,
    spp_chunk) takes the plain versions on any device, the backward in
    chunks of that many pixels and samples."""

    @staticmethod
    def forward(ctx, cam, sph, n_spheres, cfg, sky_kind, flags, seed,
                plain_chunks=None):
        fwd = render_spheres if plain_chunks is None else render_spheres_plain
        r, g, b = fwd(cam.detach(), sph.detach(), n_spheres, cfg, sky_kind,
                      flags, seed, cfg.width * cfg.height)
        ctx.save_for_backward(cam, sph)
        ctx.args = (n_spheres, cfg, sky_kind, flags, seed, plain_chunks)
        return torch.stack([r, g, b], dim=-1).reshape(cfg.height, cfg.width,
                                                      3)

    @staticmethod
    def backward(ctx, g_img):
        cam, sph = ctx.saved_tensors
        n_spheres, cfg, sky_kind, flags, seed, plain_chunks = ctx.args
        args = (cam.detach(), sph.detach(), n_spheres, cfg, sky_kind, flags,
                *_planes(g_img, cfg.spp), seed, cfg.width * cfg.height)
        if plain_chunks is None:
            gcam, gsph = render_grad_tables(*args)
        else:
            gcam, gsph = render_grad_tables_plain(
                *args, pix_chunk=plain_chunks[0], spp_chunk=plain_chunks[1])
        return gcam, gsph, None, None, None, None, None, None


def render_tables_differentiable(scene: Scene, cfg: RenderConfig,
                                 seed: int = 0, flags=None,
                                 plain_chunks=None):
    """(H, W, 3) image of ``scene`` through ``SphereRenderFn``: autograd
    reaches the scene's leaves through the table builders.  The kernels
    take up to 128 spheres (the forward's limit), the plain versions
    (``plain_chunks`` given) up to GRAD_MAX_SPHERES."""
    reason = (unsupported_reason(scene) if plain_chunks is None
              else unsupported_grad_reason(scene))
    if reason is not None:
        raise NotImplementedError(reason)
    return SphereRenderFn.apply(
        camera_table(scene), sphere_table(scene), scene.spheres.count, cfg,
        scene.sky.kind,
        flags if flags is not None else specialize_flags(scene), seed,
        plain_chunks)
