"""The backward megakernels: scene gradients on the card.

``render_grad_tables`` is the wrapper of the sphere backward in
``csrc/megagrad.cu`` (K4, ``sphere_megagrad``: forward replay with the
forward kernel's device code, then a reverse walk with adjoints derived by
hand, one flat loop per lane over (pixel sample, phase, bounce); see the
notes in that file).  It replaces the sphere variant of
the JAX package's Pallas ``kernels/megagrad.py::_make_grad_kernel``.
Given the cotangent of each pixel's mean radiance, already divided by the
number of samples, it returns the cotangents of the camera table (the
``CAM_SLOTS``) and of the sphere table (the ``DIFF_FIELDS`` rows: centre,
r^2, 1/r, albedo, fuzz, ior, 1/ior).  ``render_grad_tables_plain`` is its plain PyTorch version with the
same signature, autograd through the plain wavefront tracer with the
winner-only hit; the wrapper runs it for tensors on the CPU and nowhere
else.  The plain version reads the radius from the ``F_R`` row and the ior
from ``F_IOR`` alone, so the two agree on the scene's leaves
(``render_grad_scene``), and row by row only on the rows both read.

``render_grad_mesh_tables`` is the wrapper of the mesh backward (K5,
``csrc/megagrad.cu::mesh_megagrad``, K4's flat loop per lane with the
mesh's replay; replacing the mesh variant of the same Pallas function):
scenes of the mesh megakernel's scope, with 0 to 128 spheres.  Besides
the camera and sphere table cotangents it returns ``gtri`` (10, T_pad) in
the tables' plan order: the cotangents of each triangle's raw normal
n = (p1 - p0) x (p2 - p0) and plane constant c = n . p0 (rows 0-3), and of
its albedo, fuzz, ior and 1/ior (rows 4-9).  ``tri_grads_to_scene``
chains them to the triangles' vertices and materials.  Its plain version
``render_grad_mesh_tables_plain`` is autograd of the plain wavefront with
a winner hit in plane form on the tables; its row 8 carries the whole ior
cotangent (1/ior included) and row 9 stays 0, so the two agree on the
scene's leaves.  ``MeshRenderFn`` is the image of a mesh scene through
the mesh megakernel (K2), whose backward is K5.

HDR skies take two more instances (the JAX package's ``hdr_mode`` "emit"
and "consume", K6 and K7), for the scenes of the mesh megakernel's HDR
scope with or without triangles.  ``hdr_emit`` (K6) replays every sample
and returns its miss direction and throughput, and each pixel's sum of
the contributions that are not sky; ``hdr_lookup`` reads the texels of
those directions, ``hdr_image`` rebuilds the image from them, and
``hdr_sky_cot`` scatters the image cotangent onto the texels (torch ops,
as the JAX package keeps them in XLA).  ``hdr_consume`` (K7) is K5 with
each sample's sky value given (the other instance of ``mesh_megagrad``).
``HdrRenderFn`` chains them: the image of an HDR scene through K6, whose
backward is K7 and the texels' scatter, so that a forward and backward
run no K2 (the JAX package's
``render_grad_hdr_fused``).  Their plain versions ``hdr_emit_plain`` and
``hdr_consume_plain`` are the plain wavefront recording the misses and
the autograd of the plain wavefront with the sky values given.

The backward always uses the order-invariant "zero" NaN policy, whatever
``cfg.nan_policy`` says: the running-sum policy is not linear in the
samples.  The forward keeps ``cfg.nan_policy``.  A NaN-free render is the
same under both.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .._fp import clip01, div, dot3, fma
from ..config import RenderConfig
from ..scene import (Scene, detached, float_leaves, gradient_scene,
                     requiring_grad)
from ..tracer.clusters import permute
from ..tracer.diffhit import make_grad_hit_fn, winner_hitinfo
from ..tracer.intersect import BIG, HitInfo, closest_fold
from ..tracer.mesh_accel import T_T
from ..tracer.wavefront import render_rows_wavefront
from . import _build
from .intersect_mm import (TABLE_ARGTYPES, MeshTables, check_tables,
                           closest_tri_plain, empty_tables, mesh_tables,
                           table_args)
from .megakernel import (F_ALB, F_ALG, F_ALR, F_CX, F_CY, F_CZ, F_FUZZ,
                         F_INVIOR, F_INVR, F_IOR, F_R2, C_DUX, C_DUY, C_DUZ,
                         C_DVX, C_DVY, C_DVZ, C_HX, C_HY, C_HZ, C_LX, C_LY,
                         C_LZ, C_OX, C_OY, C_OZ, C_SKY0, C_SKY1, C_SKY2,
                         C_VX, C_VY, C_VZ, LANES, MAX_SPHERES, N_FIELDS,
                         _flag_bits, camera_table, render_spheres,
                         render_spheres_plain,
                         scene_from_tables, specialize_flags, sphere_table,
                         unsupported_reason)
from .megamesh import (mesh_camera_table, plain_hit_fn, render_mesh,
                       specialize_mesh_flags, unsupported_mesh_reason)
from ..scene.sky import KIND_CONST, KIND_GRADIENT, KIND_HDR, texel_index

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
# Rows of gtri, the mesh variant's per-triangle cotangents: n (3), c, then
# albedo (3), fuzz, ior, 1/ior.
GTRI_ROWS = 10
# Floats the kernels record per bounce that goes on (K4, K5 and K7: 3
# float4); threads per block; camera-table slots the kernel writes
# (C_OX .. C_SKY2); rows of K6's per-sample output (the miss direction and
# throughput).
_REC = 12
EMIT_ROWS = 6
_THREADS = 128
_CAM_USED = C_SKY2 + 1
# Pixels and samples per autograd call of the plain version.
_PLAIN_PIX_CHUNK = 2**17
_PLAIN_SPP_CHUNK = 25

# Launches of the sphere variant (K4), the mesh variant (K5) and the HDR
# passes (K6, K7) since their counts were last set to 0.
LAUNCHES = 0
MESH_LAUNCHES = 0
EMIT_LAUNCHES = 0
CONSUME_LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {
    "sphere_megagrad_launch": (
        [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
         ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I, ctypes.c_float,
         _I, _P], _I),
    "sphere_megagrad_threads": ([ctypes.c_longlong, _I], _I),
    "mesh_megagrad_launch": (
        [_P, _P, _I, _I, *TABLE_ARGTYPES, _I, _P, _P, _P, _P,
         _P, _P, _P, _I, _P, _I, _I, ctypes.c_uint32, ctypes.c_uint32, _I,
         _I, _I, _I, ctypes.c_float, _I, _P], _I),
    "mesh_megagrad_threads": ([ctypes.c_longlong, _I], _I),
    "hdr_emit_launch": (
        [_P, _P, _I, _I, *TABLE_ARGTYPES, _I, _P, _P, _P, _I,
         _I, ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I,
         ctypes.c_float, _I, _P], _I),
    "hdr_consume_launch": (
        [_P, _P, _I, _I, *TABLE_ARGTYPES, _I, _P, _P, _P, _P,
         _P, _P, _P, _P, _I, _P, _I, _I, ctypes.c_uint32, ctypes.c_uint32,
         _I, _I, _I, _I, ctypes.c_float, _I, _P], _I),
    "hdr_consume_threads": ([ctypes.c_longlong, _I], _I),
}


def _library():
    return _build.load("megagrad", _SYMBOLS)


def unsupported_grad_mesh_reason(scene: Scene) -> str | None:
    """Why the mesh variant (K5) does not cover this scene, or None: it
    takes the mesh megakernel's scenes (triangles of one uniform material
    in one or more gating boxes, 0 to 128 spheres) under a gradient or
    constant sky."""
    if scene.sky.kind == KIND_HDR:
        return ("the mesh backward kernel (K5) takes a gradient or constant "
                "sky: an HDR scene differentiates through K6 and K7 "
                "(unsupported_grad_hdr_reason)")
    reason = unsupported_mesh_reason(scene)
    if reason is None:
        return None
    return ("the mesh backward kernel (K5) has the mesh megakernel's "
            f"scope: {reason}")


def unsupported_grad_hdr_reason(scene: Scene) -> str | None:
    """Why the HDR passes (K6, K7) do not cover this scene, or None: they
    take the mesh megakernel's HDR scenes (0 to 128 spheres, triangles or
    none, texels and albedos of at most 1), the JAX package's
    ``supports_grad_hdr``."""
    if scene.sky.kind != KIND_HDR:
        return "the HDR backward kernels (K6, K7) take an HDR sky"
    reason = unsupported_mesh_reason(scene)
    if reason is None:
        return None
    return ("the HDR backward kernels (K6, K7) have the mesh megakernel's "
            f"HDR scope: {reason}")


def supports_grad_hdr(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the HDR passes cover this scene."""
    return unsupported_grad_hdr_reason(scene) is None


def supports_grad_mesh(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the mesh variant covers this scene."""
    return unsupported_grad_mesh_reason(scene) is None


def unsupported_grad_reason(scene: Scene) -> str | None:
    """Why the backward kernels do not cover this scene, or None.  HDR
    scenes take the HDR passes' scope, mesh scenes the mesh variant's; the
    sphere variant takes twice the forward kernel's spheres."""
    if scene.sky.kind == KIND_HDR:
        return unsupported_grad_hdr_reason(scene)
    if scene.triangles.count > 0:
        return unsupported_grad_mesh_reason(scene)
    if not 0 < scene.spheres.count <= GRAD_MAX_SPHERES:
        return (f"the backward kernel takes 1 to {GRAD_MAX_SPHERES} "
                "spheres; larger sphere scenes are not ported")
    return None


def supports_grad(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the backward kernel covers this scene: spheres only, up to
    GRAD_MAX_SPHERES, gradient or constant sky."""
    return unsupported_grad_reason(scene) is None


def _check_args(cam, sph, n_spheres, cfg, sky_kind, planes, n_pix,
                pix_offset, n_samples, counts, tab=None, n_counts=None):
    """The wrappers' argument checks: the sphere variant's, or with the
    mesh tables ``tab`` the mesh variant's (0 to 128 spheres, four
    counts), or with ``sky_kind`` HDR the HDR passes' (the mesh variant's,
    whose tables may be ``empty_tables``; n_counts counts)."""
    hdr = sky_kind == KIND_HDR
    if sky_kind not in (KIND_GRADIENT, KIND_CONST) and not (
            hdr and tab is not None):
        raise ValueError(f"the kernel takes a gradient or constant sky, "
                         f"not kind {sky_kind}")
    for name, t, rows in (("camera", cam, 1), ("sphere", sph, N_FIELDS)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} table must be contiguous float32")
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} table has shape {tuple(t.shape)}")
    if cam.shape[1] != LANES or sph.shape[1] < max(LANES, n_spheres):
        raise ValueError("table widths do not match the table builders")
    lo, hi = (1, GRAD_MAX_SPHERES) if tab is None else (0, MAX_SPHERES)
    if not lo <= n_spheres <= hi:
        raise ValueError(f"n_spheres must be in {lo}..{hi}")
    others = (sph, *planes)
    if tab is not None:
        check_tables(tab, allow_empty=hdr)
        if tab.tri.shape[1] >= 2**24:
            raise ValueError("the mesh backward takes fewer than 2**24 "
                             "triangle columns")
        others += (tab.tri,)
    for t in planes:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != (n_pix,)):
            raise ValueError("cotangent planes must be contiguous float32 "
                             "of shape (n_pix,)")
    if any(t.device != cam.device for t in others):
        raise ValueError("tables and cotangents are on different devices")
    if (n_pix < 0 or pix_offset < 0 or pix_offset + n_pix >= 2**31
            or n_samples < 0 or n_samples * cfg.max_depth >= 2**31):
        raise ValueError("pixel or sample counts out of range")
    if n_counts is None:
        n_counts = 2 if tab is None else 4
    if counts is not None and (counts.dtype != torch.int64
                               or counts.numel() != n_counts
                               or counts.device != cam.device):
        raise ValueError(f"counts must be {n_counts} int64 on the tables' "
                         "device")


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
        n_threads = lib.sphere_megagrad_threads(max(n_pix * n_samples, 1),
                                                n_spheres)
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


def render_grad_mesh_tables(cam, sph, n_spheres: int, tab: MeshTables,
                            cfg: RenderConfig, sky_kind: int, flags, g_r,
                            g_g, g_b, seed: int, n_pix: int,
                            pix_offset: int = 0, sample_base: int = 0,
                            n_samples: int | None = None, counts=None):
    """Cotangents (gcam (1, 128), gsph (16, W), gtri (10, T_pad)) of the
    mesh camera table, the sphere table and the triangles of the mesh
    tables, for the cotangent planes g_r, g_g, g_b ((n_pix,) each, already
    divided by the number of samples) of n_pix pixels from global pixel
    ``pix_offset``, over n_samples samples (cfg.spp when None) from global
    sample ``sample_base``.  gtri is in the tables' plan order (rows: see
    the module docstring); the mesh material slots of gcam stay 0.

    cam: ``megamesh.mesh_camera_table``; sph: ``sphere_table`` (0 to 128
    spheres); tab: ``intersect_mm.mesh_tables``; flags:
    ``specialize_mesh_flags``; counts: optional four-element int64 tensor
    that receives the bounces replayed, the bounces walked back (sphere
    and triangle bounces), the triangle tests of the replay and the
    triangle bounces walked back.
    CUDA tensors launch the kernel; CPU tensors run
    ``render_grad_mesh_tables_plain``.
    """
    global MESH_LAUNCHES
    n_samples = cfg.spp if n_samples is None else n_samples
    planes = (g_r, g_g, g_b)
    if sky_kind == KIND_HDR:
        raise ValueError("the mesh backward kernel (K5) takes a gradient or "
                         "constant sky; an HDR sky's is hdr_consume (K7)")
    _check_args(cam, sph, n_spheres, cfg, sky_kind, planes, n_pix,
                pix_offset, n_samples, counts, tab)
    if cam.device.type == "cpu":
        return render_grad_mesh_tables_plain(
            cam, sph, n_spheres, tab, cfg, sky_kind, flags, g_r, g_g, g_b,
            seed, n_pix, pix_offset, sample_base, n_samples, counts)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg, sky_kind, flags[:5])
    lib = _library()
    gsph = torch.zeros_like(sph)
    t_pad = tab.tri.shape[1]
    gtri = torch.zeros((GTRI_ROWS, t_pad), dtype=torch.float32,
                       device=cam.device)
    with torch.cuda.device(cam.device):
        n_threads = lib.mesh_megagrad_threads(max(n_pix * n_samples, 1),
                                              n_spheres)
        if n_threads <= 0:
            raise RuntimeError("mesh megagrad: occupancy query failed")
        rec = torch.empty(n_threads * cfg.max_depth * _REC,
                          dtype=torch.float32, device=cam.device)
        cam_part = torch.zeros((n_threads // _THREADS, _CAM_USED),
                               dtype=torch.float32, device=cam.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mesh_megagrad_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            *table_args(tab),
            int(flags[5]), g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(),
            cam_part.data_ptr(), gsph.data_ptr(), gtri.data_ptr(),
            rec.data_ptr(), n_threads,
            counts.data_ptr() if counts is not None else None, n_pix,
            pix_offset, seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF,
            n_samples, cfg.width, cfg.height, cfg.max_depth, cfg.t_min,
            bits, stream)
    if rc != 0:
        raise RuntimeError(f"mesh megagrad launch failed: CUDA error {rc}")
    MESH_LAUNCHES += 1
    gcam = torch.zeros_like(cam)
    gcam[0, :_CAM_USED] = cam_part.sum(dim=0)
    return gcam, gsph, gtri


def _plane_hit_fn(tab: MeshTables, sphere_scene, t_min: float, plane,
                 material):
    """hit_fn(o, d) of the mesh backward's plain version: the winner
    search of ``render_mesh_plain`` (the spheres' fold, then
    ``closest_tri_plain`` on the tables, a sphere winning a tie) without
    autograd, and the winner's record differentiably: a sphere's through
    ``winner_hitinfo``, a triangle's from its plane.  plane: (4, T_pad)
    rows n and t bias = -c of the triangle table; material: (albedo,
    fuzz, ior, mat_type) per triangle in plan order.  A triangle's hit is
    t = t_rec + t_plane - sg(t_plane), t_plane = (c - n.o) / (n.d), and
    its normal n / max(|n|, 1e-20): the kernel's adjoints."""
    albedo, fuzz, ior, mat_type = material
    up = torch.tensor([0.0, 0.0, 1.0], device=tab.tri.device)

    def hit_fn(o, d):
        with torch.no_grad():
            s_t, _, s_idx = closest_fold(sphere_scene, o, d, t_min)
            tri_t, tri_idx = closest_tri_plain(tab, o.contiguous(),
                                               d.contiguous(), t_min)
            take = (tri_t < BIG) & (tri_t < s_t)
        base = winner_hitinfo(sphere_scene, o, d,
                              torch.zeros_like(take, dtype=torch.int32),
                              s_idx, (s_t < BIG) & ~take, t_min)
        tt = take[:, None]
        j = torch.where(take, tri_idx, torch.zeros_like(tri_idx))
        n = torch.where(tt, plane[0:3, j].T, up)
        nd = torch.where(take, dot3(n, d), torch.ones_like(tri_t))
        t_plane = (-plane[3, j] - dot3(n, o)) / nd
        t = torch.where(take, tri_t, torch.ones_like(tri_t))
        t = t + (t_plane - t_plane.detach())
        outward = n / torch.clamp(torch.sqrt(dot3(n, n)), min=1e-20)[:, None]
        front = dot3(d, outward) < 0.0
        normal = torch.where(front[:, None], outward, -outward)
        return HitInfo(
            hit=base.hit | take, t=torch.where(take, t, base.t),
            point=torch.where(tt, fma(t[:, None], d, o), base.point),
            normal=torch.where(tt, normal, base.normal),
            front_face=torch.where(take, front, base.front_face),
            albedo=torch.where(tt, albedo[j], base.albedo),
            fuzz=torch.where(take, fuzz[j], base.fuzz),
            ior=torch.where(take, ior[j], base.ior),
            mat_type=torch.where(take, mat_type[j], base.mat_type))

    return hit_fn


def render_grad_mesh_tables_plain(cam, sph, n_spheres: int, tab: MeshTables,
                                  cfg: RenderConfig, sky_kind: int, flags,
                                  g_r, g_g, g_b, seed: int, n_pix: int,
                                  pix_offset: int = 0, sample_base: int = 0,
                                  n_samples: int | None = None, counts=None,
                                  pix_chunk: int = _PLAIN_PIX_CHUNK,
                                  spp_chunk: int = _PLAIN_SPP_CHUNK):
    """The plain PyTorch version of ``render_grad_mesh_tables``, on the
    tables' device: autograd of the plain wavefront tracer with
    ``_plane_hit_fn`` over the scene the tables hold, with respect to the
    camera and sphere tables, the triangle table's plane rows and the
    per-triangle materials of ``tab.feats``, in chunks of at most
    pix_chunk pixels and spp_chunk samples.  gtri row 8 receives the whole
    ior cotangent and row 9 stays 0.  counts[0] receives the bounces
    traced; the other counts stay 0.  ``flags`` only prune the kernel's
    code."""
    return _mesh_vjp_plain(cam, sph, n_spheres, tab, cfg, sky_kind,
                           (g_r, g_g, g_b), seed, n_pix, pix_offset,
                           sample_base, n_samples, counts, pix_chunk,
                           spp_chunk)


def _mesh_vjp_plain(cam, sph, n_spheres, tab, cfg, sky_kind, planes, seed,
                    n_pix, pix_offset, sample_base, n_samples, counts,
                    pix_chunk, spp_chunk, sky_rows=None):
    """The body of the mesh variant's plain version (see
    ``render_grad_mesh_tables_plain``); with ``sky_rows`` (3, n_samples,
    n_pix) a miss takes the given sky value, a constant (K7's plain
    version), and tables without triangles take the spheres' winner-only
    hit."""
    n_samples = cfg.spp if n_samples is None else n_samples
    gcfg = cfg.replace(nan_policy="zero")
    g = torch.stack(planes, dim=-1)
    feats = tab.feats
    t_pad = tab.tri.shape[1]
    gcam = torch.zeros_like(cam)
    gsph = torch.zeros_like(sph)
    gtri = torch.zeros((GTRI_ROWS, t_pad), dtype=torch.float32,
                       device=cam.device)
    bounces = counts[:1] if counts is not None else None
    # an HDR scene's misses read sky_rows: its image is never looked up
    image = torch.zeros((1, 1, 3), device=cam.device)
    for p0 in range(0, n_pix, pix_chunk):
        m = min(pix_chunk, n_pix - p0)
        lin = torch.arange(pix_offset + p0, pix_offset + p0 + m,
                           device=cam.device)
        miss_fn = (None if sky_rows is None
                   else _given_sky(sky_rows, sample_base, p0, m))
        for s0 in range(0, n_samples, spp_chunk):
            # also under a backward pass, which turns grad mode off
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_() for x in (
                    (cam, sph, tab.tri[T_T:T_T + 4], feats.albedo,
                     feats.fuzz, feats.ior) if t_pad else (cam, sph))]
                scene, frame = scene_from_tables(
                    leaves[0], leaves[1], n_spheres, sky_kind,
                    image if sky_kind == KIND_HDR else None)
                if t_pad:
                    hit_fn = _plane_hit_fn(tab, scene, cfg.t_min, leaves[2],
                                           (*leaves[3:], feats.mat_type))
                else:
                    hit_fn = make_grad_hit_fn(scene, cfg.t_min)
                acc = render_rows_wavefront(
                    scene, gcfg, lin // cfg.width, lin % cfg.width, lin,
                    seed, sample_base + s0, min(spp_chunk, n_samples - s0),
                    frame=frame, bounces=bounces, hit_fn=hit_fn,
                    miss_fn=miss_fn)
                grads = torch.autograd.grad((acc * g[p0:p0 + m]).sum(),
                                            leaves, allow_unused=True)
            grads = [torch.zeros_like(x) if gx is None else gx
                     for gx, x in zip(grads, leaves)]
            gcam += grads[0]
            gsph += grads[1]
            if t_pad:
                gp, galb, gfz, gior = grads[2:]
                gtri[0:3] += gp[0:3]
                gtri[3] -= gp[3]
                gtri[4:7] += galb.T
                gtri[7] += gfz
                gtri[8] += gior
    return gcam, gsph, gtri


def _given_sky(sky_rows, sample_base: int, p0: int, m: int):
    """miss_fn of the wavefront that returns the sky values of sky_rows
    (3, n_samples, n_pix) for pixels p0 .. p0 + m, as constants."""
    cols = torch.arange(p0, p0 + m, device=sky_rows.device)
    last = sky_rows.shape[1] - 1
    rows = sky_rows.detach()

    def miss_fn(d, sample, throughput, miss):
        s = torch.clamp(sample - sample_base, 0, last)
        return rows[:, s, cols].T

    return miss_fn


def _planes(g_img, spp: int):
    """(H, W, 3) image cotangent -> three contiguous planes divided by
    spp."""
    g = div(g_img.reshape(-1, 3).to(torch.float32), spp).T.contiguous()
    return g[0], g[1], g[2]


def render_grad_scene(scene: Scene, cfg: RenderConfig, g_img, seed: int = 0,
                      flags=None):
    """Gradient Scene for the cotangent g_img (H, W, 3) of the mean image:
    the table cotangents of ``render_grad_tables`` (with g_img / spp)
    chained to the scene's leaves by ``table_grads_to_scene``; for a mesh
    scene those of ``render_grad_mesh_tables``, whose triangle cotangents
    ``tri_grads_to_scene`` adds; for an HDR scene the backward of
    ``HdrRenderFn`` (K6, then K7 and the texels' scatter into
    ``sky.image``).  Runs on the scene's device; flags default to
    ``specialize_flags(scene)`` (``specialize_mesh_flags`` for a mesh or
    HDR scene)."""
    reason = unsupported_grad_reason(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    if scene.sky.kind == KIND_HDR:
        s = requiring_grad(scene)
        img = render_hdr_differentiable(s, cfg, seed, flags)
        leaves = float_leaves(s)
        grads = torch.autograd.grad(img, list(leaves.values()), g_img,
                                    allow_unused=True)
        return gradient_scene(scene, dict(zip(leaves, grads)))
    if scene.triangles.count > 0:
        frozen = detached(scene)
        tab = mesh_tables(frozen)
        gcam, gsph, gtri = render_grad_mesh_tables(
            mesh_camera_table(frozen), sphere_table(frozen),
            scene.spheres.count, tab, cfg, scene.sky.kind,
            flags if flags is not None else specialize_mesh_flags(frozen),
            *_planes(g_img, cfg.spp), seed, cfg.width * cfg.height)
        return tri_grads_to_scene(scene, tab.plan, gtri,
                                  table_grads_to_scene(scene, gcam, gsph))
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


def tri_cotangents(p0, p1, p2, ior, plan, gtri):
    """Cotangents (p0, p1, p2, albedo, fuzz, ior) of a mesh's triangles, in
    the scene's order, from gtri (10, T_pad) in the plan's order: rows 0-3
    through autograd of n = (p1 - p0) x (p2 - p0) and c = n . p0 on the
    plan-permuted vertices, rows 4-9 as they are, with
    d_ior = g_ior - g_invior / max(ior, 1e-8)^2; both un-permuted by
    ``index_add_`` over the plan's real triangles (perm >= 0)."""
    perm = torch.as_tensor(plan.perm.astype(np.int64), device=gtri.device)
    real = perm >= 0
    ids = perm[real]

    def unpermute(x, like):
        return torch.zeros_like(like).index_add_(0, ids, x[real])

    with torch.enable_grad():
        q = [permute(x.detach(), plan).requires_grad_() for x in (p0, p1, p2)]
        n = torch.linalg.cross(q[1] - q[0], q[2] - q[0], dim=-1)
        c = (n * q[0]).sum(dim=-1)
        dq = torch.autograd.grad((n, c), q, (gtri[0:3].T, gtri[3]))
    ior_p = torch.clamp(permute(ior.detach(), plan, fill=1.0), min=1e-8)
    d_ior = gtri[8] - gtri[9] / (ior_p * ior_p)
    return (*(unpermute(x, p0) for x in dq),
            unpermute(gtri[4:7].T, p0), unpermute(gtri[7], ior),
            unpermute(d_ior, ior))


def tri_grads_to_scene(scene: Scene, plan, gtri, grads: Scene | None = None):
    """A gradient Scene with the triangle cotangents of gtri (the mesh
    backward's, in ``plan``'s order) added to the triangle leaves of
    ``grads`` (zeros when None)."""
    if grads is None:
        grads = gradient_scene(scene, {})
    t = scene.triangles
    cots = tri_cotangents(t.p0, t.p1, t.p2, t.ior, plan, gtri)
    g = grads.triangles
    return dataclasses.replace(grads, triangles=dataclasses.replace(
        g, **{f: getattr(g, f) + x for f, x in zip(
            ("p0", "p1", "p2", "albedo", "fuzz", "ior"), cots)}))


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
    if scene.triangles.count > 0:
        raise NotImplementedError("a mesh scene's image differentiates "
                                  "through render_mesh_differentiable")
    reason = (unsupported_reason(scene) if plain_chunks is None
              else unsupported_grad_reason(scene))
    if reason is not None:
        raise NotImplementedError(reason)
    return SphereRenderFn.apply(
        camera_table(scene), sphere_table(scene), scene.spheres.count, cfg,
        scene.sky.kind,
        flags if flags is not None else specialize_flags(scene), seed,
        plain_chunks)


class MeshRenderFn(torch.autograd.Function):
    """(H, W, 3) image of a mesh scene's tables through ``render_mesh`` (the
    mesh megakernel on CUDA), whose backward is ``render_grad_mesh_tables``
    (the mesh backward kernel) with its triangle cotangents chained to the
    triangles' leaves by ``tri_cotangents``.  The forward keeps
    ``cfg.nan_policy``; the backward differentiates the "zero" policy.

    apply(cam, sph, p0, p1, p2, albedo, fuzz, ior, n_spheres, tab, cfg,
    sky_kind, flags, seed): cam ``mesh_camera_table``, sph
    ``sphere_table``, the triangles' leaves in the scene's order, tab the
    mesh tables (in their plan's order), flags ``specialize_mesh_flags``.
    The wrappers launch the kernels for CUDA tensors and run the plain
    versions for CPU tensors."""

    @staticmethod
    def forward(ctx, cam, sph, p0, p1, p2, albedo, fuzz, ior, n_spheres, tab,
                cfg, sky_kind, flags, seed):
        r, g, b = render_mesh(cam.detach(), sph.detach(), n_spheres, tab,
                              cfg, sky_kind, flags, seed,
                              cfg.width * cfg.height)
        ctx.save_for_backward(cam, sph, p0, p1, p2, ior)
        ctx.args = (n_spheres, tab, cfg, sky_kind, flags, seed)
        return torch.stack([r, g, b], dim=-1).reshape(cfg.height, cfg.width,
                                                      3)

    @staticmethod
    def backward(ctx, g_img):
        cam, sph, p0, p1, p2, ior = ctx.saved_tensors
        n_spheres, tab, cfg, sky_kind, flags, seed = ctx.args
        gcam, gsph, gtri = render_grad_mesh_tables(
            cam.detach(), sph.detach(), n_spheres, tab, cfg, sky_kind, flags,
            *_planes(g_img, cfg.spp), seed, cfg.width * cfg.height)
        cots = tri_cotangents(p0, p1, p2, ior, tab.plan, gtri)
        return (gcam, gsph, *cots, None, None, None, None, None, None)


def render_mesh_differentiable(scene: Scene, cfg: RenderConfig,
                               seed: int = 0, flags=None, plan=None):
    """(H, W, 3) image of a mesh scene through ``MeshRenderFn``: autograd
    reaches the camera and spheres through the table builders and the
    triangles through the mesh backward's cotangents.  flags default to
    ``specialize_mesh_flags(scene)``; plan, the order of the mesh tables,
    to the scene's own (a fit passes its first plan: the tables follow the
    moved vertices, the order stays)."""
    reason = unsupported_grad_mesh_reason(scene)
    if reason is not None:
        raise NotImplementedError(reason)
    frozen = detached(scene)
    t = scene.triangles
    return MeshRenderFn.apply(
        mesh_camera_table(scene), sphere_table(scene), t.p0, t.p1, t.p2,
        t.albedo, t.fuzz, t.ior, scene.spheres.count,
        mesh_tables(frozen, plan=plan), cfg, scene.sky.kind,
        flags if flags is not None else specialize_mesh_flags(frozen), seed)


def _emit_empty(n_samples: int, n_pix: int, device):
    """K6's outputs before any sample: every direction (0, 0, 1), every
    throughput and sum 0."""
    emit = torch.zeros((EMIT_ROWS, n_samples, n_pix), dtype=torch.float32,
                       device=device)
    emit[2] = 1.0
    return emit, torch.zeros((3, n_pix), dtype=torch.float32, device=device)


def hdr_emit(cam, sph, n_spheres: int, tab: MeshTables, cfg: RenderConfig,
             flags, seed: int, n_pix: int, pix_offset: int = 0,
             sample_base: int = 0, n_samples: int | None = None,
             counts=None):
    """K6, the HDR backward's first pass: (emit (6, n_samples, n_pix),
    emis (3, n_pix)) for n_pix pixels from global pixel ``pix_offset`` over
    n_samples samples (cfg.spp when None) from global sample
    ``sample_base``.  emit rows 0-2 hold each sample's miss direction
    ((0, 0, 1) where the sample did not miss), rows 3-5 its throughput
    there (0 where it did not); emis each pixel's sum of the contributions
    that are not sky, clamped when cfg.clamp_samples, NaN as 0.

    cam: ``megamesh.mesh_camera_table``; sph: ``sphere_table``; tab:
    ``intersect_mm.mesh_tables``, or ``empty_tables`` for a scene without
    triangles; flags: ``specialize_mesh_flags``; counts: optional (2,)
    int64 tensor that receives the bounces replayed and the triangle
    tests.  CUDA tensors launch the kernel; CPU tensors run
    ``hdr_emit_plain``."""
    global EMIT_LAUNCHES
    n_samples = cfg.spp if n_samples is None else n_samples
    _check_args(cam, sph, n_spheres, cfg, KIND_HDR, (), n_pix, pix_offset,
                n_samples, counts, tab, n_counts=2)
    if cam.device.type == "cpu":
        return hdr_emit_plain(cam, sph, n_spheres, tab, cfg, flags, seed,
                              n_pix, pix_offset, sample_base, n_samples,
                              counts)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    if n_pix == 0 or n_samples == 0:
        return _emit_empty(n_samples, n_pix, cam.device)
    bits = _flag_bits(cfg.replace(nan_policy="zero"), KIND_HDR, flags[:5])
    emit = torch.empty((EMIT_ROWS, n_samples, n_pix), dtype=torch.float32,
                       device=cam.device)
    emis = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().hdr_emit_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            *table_args(tab),
            int(flags[5]), emit.data_ptr(), emis.data_ptr(),
            counts.data_ptr() if counts is not None else None, n_pix,
            pix_offset, seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF,
            n_samples, cfg.width, cfg.height, cfg.max_depth, cfg.t_min,
            bits, stream)
    if rc != 0:
        raise RuntimeError(f"HDR emit launch failed: CUDA error {rc}")
    EMIT_LAUNCHES += 1
    return emit, emis


@torch.no_grad()
def hdr_emit_plain(cam, sph, n_spheres: int, tab: MeshTables,
                   cfg: RenderConfig, flags, seed: int, n_pix: int,
                   pix_offset: int = 0, sample_base: int = 0,
                   n_samples: int | None = None, counts=None,
                   pix_chunk: int = _PLAIN_PIX_CHUNK):
    """The plain PyTorch version of ``hdr_emit``, on the tables' device:
    the plain wavefront over the scene the tables hold (the mesh
    megakernel's plain hit) under the "zero" NaN policy, recording each
    miss's direction and throughput in place of the sky's radiance, which
    it takes as 0, so that what it sums is the rest; in chunks of at most
    pix_chunk pixels.  counts[0] receives the bounces traced, counts[1]
    the plain fold's triangle tests.  ``flags`` give the mesh's material
    type and otherwise only prune the kernel's code."""
    n_samples = cfg.spp if n_samples is None else n_samples
    dev = cam.device
    gcfg = cfg.replace(nan_policy="zero")
    scene, frame = scene_from_tables(cam, sph, n_spheres, KIND_HDR,
                                     torch.zeros((1, 1, 3), device=dev))
    hit_fn = plain_hit_fn(cam, scene, tab, cfg, flags,
                          counts[1:2] if counts is not None else None)
    emit, emis = _emit_empty(n_samples, n_pix, dev)
    for p0 in range(0, n_pix, pix_chunk):
        m = min(pix_chunk, n_pix - p0)
        lin = torch.arange(pix_offset + p0, pix_offset + p0 + m, device=dev)

        def miss_fn(d, sample, throughput, miss, p0=p0):
            r = torch.nonzero(miss)[:, 0]
            s = sample[r] - sample_base
            emit[0:3, s, p0 + r] = d[r].T
            emit[3:6, s, p0 + r] = throughput[r].T
            return torch.zeros_like(d)

        acc = render_rows_wavefront(
            scene, gcfg, lin // cfg.width, lin % cfg.width, lin, seed,
            sample_base, n_samples, frame=frame,
            bounces=counts[0:1] if counts is not None else None,
            hit_fn=hit_fn, miss_fn=miss_fn)
        emis[:, p0:p0 + m] = acc.T
    return emit, emis


def _check_sky_rows(sky_rows, n_samples: int, n_pix: int, device) -> None:
    if (sky_rows.dtype != torch.float32 or not sky_rows.is_contiguous()
            or sky_rows.shape != (3, n_samples, n_pix)
            or sky_rows.device != device):
        raise ValueError("sky_rows must be contiguous float32 of shape "
                         "(3, n_samples, n_pix) on the tables' device")


def hdr_consume(cam, sph, n_spheres: int, tab: MeshTables,
                cfg: RenderConfig, flags, g_r, g_g, g_b, sky_rows, seed: int,
                n_pix: int, pix_offset: int = 0, sample_base: int = 0,
                n_samples: int | None = None, counts=None):
    """K7, the HDR backward's second pass: the cotangents (gcam (1, 128),
    gsph (16, W), gtri (10, T_pad)) of ``render_grad_mesh_tables`` for an
    HDR scene, where the sky value of each sample that missed is
    sky_rows[:, sample, pixel] ((3, n_samples, n_pix): the texels of K6's
    directions), a constant.  Arguments as ``hdr_emit``'s and
    ``render_grad_mesh_tables``'s; counts: optional (4,) int64 tensor, as
    K5's.  CUDA tensors launch the kernel; CPU tensors run
    ``hdr_consume_plain``."""
    global CONSUME_LAUNCHES
    n_samples = cfg.spp if n_samples is None else n_samples
    planes = (g_r, g_g, g_b)
    _check_args(cam, sph, n_spheres, cfg, KIND_HDR, planes, n_pix,
                pix_offset, n_samples, counts, tab)
    _check_sky_rows(sky_rows, n_samples, n_pix, cam.device)
    if cam.device.type == "cpu":
        return hdr_consume_plain(cam, sph, n_spheres, tab, cfg, flags, g_r,
                                 g_g, g_b, sky_rows, seed, n_pix, pix_offset,
                                 sample_base, n_samples, counts)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg.replace(nan_policy="zero"), KIND_HDR, flags[:5])
    lib = _library()
    gsph = torch.zeros_like(sph)
    t_pad = tab.tri.shape[1]
    gtri = torch.zeros((GTRI_ROWS, t_pad), dtype=torch.float32,
                       device=cam.device)
    with torch.cuda.device(cam.device):
        n_threads = lib.hdr_consume_threads(max(n_pix * n_samples, 1),
                                            n_spheres)
        if n_threads <= 0:
            raise RuntimeError("HDR consume: occupancy query failed")
        rec = torch.empty(n_threads * cfg.max_depth * _REC,
                          dtype=torch.float32, device=cam.device)
        cam_part = torch.zeros((n_threads // _THREADS, _CAM_USED),
                               dtype=torch.float32, device=cam.device)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.hdr_consume_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            *table_args(tab),
            int(flags[5]), g_r.data_ptr(), g_g.data_ptr(), g_b.data_ptr(),
            sky_rows.data_ptr(), cam_part.data_ptr(), gsph.data_ptr(),
            gtri.data_ptr(), rec.data_ptr(), n_threads,
            counts.data_ptr() if counts is not None else None, n_pix,
            pix_offset, seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF,
            n_samples, cfg.width, cfg.height, cfg.max_depth, cfg.t_min,
            bits, stream)
    if rc != 0:
        raise RuntimeError(f"HDR consume launch failed: CUDA error {rc}")
    CONSUME_LAUNCHES += 1
    gcam = torch.zeros_like(cam)
    gcam[0, :_CAM_USED] = cam_part.sum(dim=0)
    return gcam, gsph, gtri


def hdr_consume_plain(cam, sph, n_spheres: int, tab: MeshTables,
                      cfg: RenderConfig, flags, g_r, g_g, g_b, sky_rows,
                      seed: int, n_pix: int, pix_offset: int = 0,
                      sample_base: int = 0, n_samples: int | None = None,
                      counts=None, pix_chunk: int = _PLAIN_PIX_CHUNK,
                      spp_chunk: int = _PLAIN_SPP_CHUNK):
    """The plain PyTorch version of ``hdr_consume``, on the tables' device:
    ``render_grad_mesh_tables_plain``'s autograd of the plain wavefront
    with each miss's sky value taken from sky_rows as a constant (and, for
    tables without triangles, the spheres' winner-only hit).  gtri row 8
    receives the whole ior cotangent and row 9 stays 0; counts[0]
    receives the bounces traced.  ``flags`` only prune the kernel's
    code."""
    return _mesh_vjp_plain(cam, sph, n_spheres, tab, cfg, KIND_HDR,
                           (g_r, g_g, g_b), seed, n_pix, pix_offset,
                           sample_base, n_samples, counts, pix_chunk,
                           spp_chunk, sky_rows=sky_rows)


def hdr_lookup(image, emit):
    """The sky values of K6's miss directions: (3, n_samples, n_pix) texels
    of the (H, W, 3) image, and the flat texel index y * W + x of each
    (``scene.sky.texel_index``, the lookup of the plain tracer and of the
    mesh megakernel).  The lookup is constant in the direction."""
    ty, tx = texel_index(image, emit[0:3].permute(1, 2, 0))
    flat = ty * image.shape[1] + tx
    return image.reshape(-1, 3)[flat].permute(2, 0, 1).contiguous(), flat


def _sky_terms(emit, sky, clamp: bool):
    """Each sample's sky term thr * sky, (3, n_samples, n_pix)."""
    x = emit[3:6] * sky
    return clip01(x) if clamp else x


def hdr_image(emit, emis, sky, cfg: RenderConfig):
    """(3, n_pix) mean radiance from K6's outputs and the sky values: the
    non-sky sum plus each sample's sky term (clamped, NaN as 0, as the
    estimator takes it), over cfg.spp."""
    x = _sky_terms(emit, sky, cfg.clamp_samples)
    x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    return div(emis + x.sum(dim=1), cfg.spp)


def hdr_sky_cot(image, emit, sky, flat, g_r, g_g, g_b,
                clamp: bool = True):
    """The cotangent of the (H, W, 3) sky image for the cotangent planes
    g_r, g_g, g_b ((n_pix,), divided by the number of samples): each
    sample's throughput times its pixel's cotangent, times the clamp's
    subgradient at its sky term (1 below 1, 1/2 at 1, 0 above, 0 for NaN,
    the JAX package's ``_hdr_sky_cot``), added at its texel ``flat``
    (``hdr_lookup``).  A sample that did not miss has throughput 0."""
    g = torch.stack([g_r, g_g, g_b])[:, None, :]
    contrib = emit[3:6] * g
    if clamp:
        x = emit[3:6] * sky
        one = torch.ones_like(x)
        cf = torch.where(x < 1.0, one,
                         torch.where(x > 1.0, torch.zeros_like(x), one / 2))
        cf = torch.where(torch.isnan(x), torch.zeros_like(x), cf)
        contrib = contrib * cf
    out = torch.zeros((image.shape[0] * image.shape[1], 3),
                      dtype=torch.float32, device=image.device)
    # index_add_ adds with atomics on the card; index_put_(accumulate=True)
    # sorts the indices first: 17.6 ms for the 4.6 M samples of the
    # flagship scene at REFERENCE_DEFAULTS on an NVIDIA H100 80GB HBM3 at
    # 700 W (tools/hdr_host_profile.py)
    out.index_add_(0, flat.reshape(-1),
                   contrib.permute(1, 2, 0).reshape(-1, 3))
    return out.reshape(image.shape)


class HdrRenderFn(torch.autograd.Function):
    """(H, W, 3) image of an HDR scene's tables from ``hdr_emit`` (K6 on
    CUDA), its texels (``hdr_lookup``) and ``hdr_image``, whose backward is
    ``hdr_consume`` (K7) with the texels' values, ``hdr_sky_cot`` for the
    sky image and ``tri_cotangents`` for the triangles: the JAX package's
    ``render_grad_hdr_fused``, in which a forward and backward trace each
    path twice and the mesh megakernel not at all.  Both passes take the
    "zero" NaN policy.

    apply(cam, sph, p0, p1, p2, albedo, fuzz, ior, image, n_spheres, tab,
    cfg, flags, seed): as ``MeshRenderFn``'s, with the sky image; tab
    ``empty_tables`` for a scene without triangles."""

    @staticmethod
    def forward(ctx, cam, sph, p0, p1, p2, albedo, fuzz, ior, image,
                n_spheres, tab, cfg, flags, seed):
        n_pix = cfg.width * cfg.height
        emit, emis = hdr_emit(cam.detach(), sph.detach(), n_spheres, tab,
                              cfg, flags, seed, n_pix)
        sky, flat = hdr_lookup(image.detach(), emit)
        img = hdr_image(emit, emis, sky, cfg)
        ctx.save_for_backward(cam, sph, p0, p1, p2, ior, image)
        ctx.stash = (emit, sky, flat)
        ctx.args = (n_spheres, tab, cfg, flags, seed)
        return img.T.reshape(cfg.height, cfg.width, 3)

    @staticmethod
    def backward(ctx, g_img):
        cam, sph, p0, p1, p2, ior, image = ctx.saved_tensors
        emit, sky, flat = ctx.stash
        n_spheres, tab, cfg, flags, seed = ctx.args
        planes = _planes(g_img, cfg.spp)
        g_sky = hdr_sky_cot(image, emit, sky, flat, *planes,
                            clamp=cfg.clamp_samples)
        gcam, gsph, gtri = hdr_consume(
            cam.detach(), sph.detach(), n_spheres, tab, cfg, flags, *planes,
            sky, seed, cfg.width * cfg.height)
        cots = ((None,) * 6 if tab.plan is None
                else tri_cotangents(p0, p1, p2, ior, tab.plan, gtri))
        return (gcam, gsph, *cots, g_sky, None, None, None, None, None)


def render_hdr_differentiable(scene: Scene, cfg: RenderConfig,
                              seed: int = 0, flags=None, plan=None):
    """(H, W, 3) image of an HDR scene through ``HdrRenderFn``: autograd
    reaches the camera and spheres through the table builders, the
    triangles through K7's cotangents and the sky image through the
    texels' scatter.  flags default to ``specialize_mesh_flags(scene)``;
    plan, the order of the mesh tables, to the scene's own (a fit passes
    its first plan).  The caller holds the scene to ``supports_grad_hdr``
    (a fit holds its initial scene: a step may carry a texel past 1, which
    the passes still compute exactly, the image and both cotangents taking
    the clamp where the sky term exceeds 1)."""
    frozen = detached(scene)
    t = scene.triangles
    tab = (mesh_tables(frozen, plan=plan) if t.count
           else empty_tables(scene.spheres.center.device))
    return HdrRenderFn.apply(
        mesh_camera_table(scene), sphere_table(scene), t.p0, t.p1, t.p2,
        t.albedo, t.fuzz, t.ior, scene.sky.image.contiguous(),
        scene.spheres.count, tab, cfg,
        flags if flags is not None else specialize_mesh_flags(frozen), seed)


def render_grad_hdr_fused(scene: Scene, cfg: RenderConfig, loss_fn,
                          seed: int = 0, plan=None):
    """(loss, image, gradient Scene) of an HDR scene in one pass of K6 and
    one of K7 (``render_hdr_differentiable``), the JAX package's fused
    pipeline: the image is rebuilt from K6's outputs, the loss's image
    cotangent taken from it, and K7 walks the paths back; no separate
    forward render runs.  grads.sky.image holds the per-texel cotangent.
    Runs on the scene's device; the caller holds the scene to
    ``supports_grad_hdr``, as ``render_grad_sampled`` does."""
    s = requiring_grad(scene)
    img = render_hdr_differentiable(s, cfg, seed, plan=plan)
    loss = loss_fn(img)
    leaves = float_leaves(s)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return (loss.detach(), img.detach(),
            gradient_scene(s, dict(zip(leaves, grads))))
