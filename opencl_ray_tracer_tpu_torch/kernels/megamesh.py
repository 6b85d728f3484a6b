"""The mesh megakernel: forward render of mesh scenes on the card.

``render_mesh`` is the wrapper of the CUDA kernel in ``csrc/megamesh.cu``
(the sphere megakernel's per-pixel estimator with a culled triangle hit;
see the note at the top of that file).  The kernel replaces the mesh body
of the JAX package's Pallas ``kernels/megamesh.py::_make_kernel`` for
gradient and constant skies; its HDR body is the HDR slice's (slice 4).
``render_mesh_plain`` is its plain PyTorch version with the same
signature: the wavefront tracer over the scene the tables hold, with
``intersect_mm.closest_tri_plain`` as the triangle hit, in the same plan
order.  The wrapper runs it for tensors on the CPU and nowhere else.

A scene is in scope (``supports_mesh``) when it has triangles of one
uniform material (the reference gives each mesh one, ``utility.cpp:99``)
in one or more gating boxes, at most 128 spheres and a gradient or
constant sky.  The mesh material rides in camera-table slots ``C_MA_R`` ..
``C_M_INVIOR`` and the flags.  ``mesh_inputs`` keeps the kernel's inputs of
the last few scenes, keyed by a digest of every leaf, so that rendering a
scene again reads it to the host and hashes it, and builds nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._fp import div
from ..config import RenderConfig
from ..scene import Scene, scene_to_numpy
from ..scene import materials as mat
from ..scene.sky import KIND_CONST, KIND_GRADIENT, KIND_HDR
from ..tracer.wavefront import render_rows_wavefront
from . import _build
from .intersect_mm import (MeshTables, cached, check_tables,
                           closest_tri_plain, leaves_key, mesh_tables,
                           tri_hit_fn)
from .megakernel import (LANES, MAX_SPHERES, N_FIELDS, _flag_bits,
                         camera_table, scene_from_tables, specialize_flags,
                         sphere_table)

# Camera-table slots of the uniform mesh material (after C_SKY2 = 21).
(C_MA_R, C_MA_G, C_MA_B, C_M_FUZZ, C_M_IOR, C_M_INVIOR) = range(22, 28)

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"mesh_megakernel_launch": (
    [_P, _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I,
     _I, ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I, ctypes.c_float,
     _I, _P], _I)}


def _library():
    return _build.load("megamesh", _SYMBOLS)


def _uniform_material(albedo, fuzz, ior, mat_type):
    """(albedo(3,), fuzz, ior, mat_type) of numpy per-triangle materials
    when every triangle has the same, else None."""
    if mat_type.shape[0] == 0:
        return ((0.0, 0.0, 0.0), 0.0, 0.0, 0)
    if not ((albedo == albedo[0]).all() and (fuzz == fuzz[0]).all()
            and (ior == ior[0]).all() and (mat_type == mat_type[0]).all()):
        return None
    return (tuple(float(x) for x in albedo[0]), float(fuzz[0]),
            float(ior[0]), int(mat_type[0]))


def _mesh_uniform_material(scene: Scene):
    t = scene.triangles
    return _uniform_material(*(x.detach().cpu().numpy() for x in
                               (t.albedo, t.fuzz, t.ior, t.mat_type)))


def unsupported_mesh_reason(scene: Scene) -> str | None:
    """Why the mesh megakernel does not cover this scene, or None."""
    if scene.sky.kind == KIND_HDR:
        return ("HDR skies are not ported yet: the HDR slice (slice 4) "
                "ports them")
    if scene.sky.kind not in (KIND_GRADIENT, KIND_CONST):
        return f"unknown sky kind {scene.sky.kind}"
    if scene.triangles.count == 0:
        return "the mesh megakernel renders scenes with triangles"
    if scene.boxes.count == 0:
        return "the mesh megakernel takes triangles in gating boxes"
    if scene.spheres.count > MAX_SPHERES:
        return f"the mesh megakernel takes at most {MAX_SPHERES} spheres"
    if _mesh_uniform_material(scene) is None:
        return "the mesh megakernel takes one uniform mesh material"
    return None


def supports_mesh(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the mesh megakernel covers this scene and config."""
    return unsupported_mesh_reason(scene) is None


def _with_mesh(flags, material, conservative: bool):
    if material is None:
        raise ValueError("the mesh material must be uniform")
    _, m_fuzz, _, m_type = material
    metal, diel, emit, fuzz, aperture = flags
    metal = metal or m_type == mat.METAL
    fuzz = (metal if conservative
            else fuzz or (m_type == mat.METAL and m_fuzz > 0))
    return (metal, diel or m_type == mat.DIELECTRIC,
            emit or m_type == mat.EMISSIVE, fuzz, aperture, m_type)


def specialize_mesh_flags(scene: Scene, conservative: bool = False):
    """(has_metal, has_diel, has_emit, has_fuzz, has_aperture, mesh_type):
    ``megakernel.specialize_flags`` with the mesh material counted in."""
    return _with_mesh(specialize_flags(scene, conservative),
                      _mesh_uniform_material(scene), conservative)


def mesh_camera_table(scene: Scene) -> torch.Tensor:
    """``camera_table`` with the mesh material in slots C_MA_R..C_M_INVIOR
    (the first triangle's: the material is uniform)."""
    tab = camera_table(scene)
    tris = scene.triangles
    if tris.count:
        ior = tris.ior[0]
        tab[0, C_MA_R:C_MA_B + 1] = tris.albedo[0]
        tab[0, C_M_FUZZ] = tris.fuzz[0]
        tab[0, C_M_IOR] = ior
        tab[0, C_M_INVIOR] = 1.0 / torch.clamp(ior, min=1e-8)
    return tab


def _check_args(cam, sph, n_spheres, tab, n_pix, pix_offset, cfg, sky_kind,
                counts):
    if sky_kind not in (KIND_GRADIENT, KIND_CONST):
        raise ValueError(f"the kernel takes a gradient or constant sky, "
                         f"not kind {sky_kind}")
    for name, t, rows in (("camera", cam, 1), ("sphere", sph, N_FIELDS)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} table must be contiguous float32")
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} table has shape {tuple(t.shape)}")
        if t.device != tab.tri.device:
            raise ValueError("the tables are on different devices")
    if cam.shape[1] != LANES or sph.shape[1] < max(LANES, n_spheres):
        raise ValueError("table widths do not match the table builders")
    if not 0 <= n_spheres <= MAX_SPHERES:
        raise ValueError(f"n_spheres must be in 0..{MAX_SPHERES}")
    check_tables(tab)
    if (n_pix < 0 or pix_offset < 0 or pix_offset + n_pix >= 2**31
            or cfg.spp * cfg.max_depth >= 2**31):
        raise ValueError("pixel or iteration counts out of range")
    if counts is not None and (counts.dtype != torch.int64
                               or counts.shape != (2,)
                               or counts.device != cam.device):
        raise ValueError("counts must be two int64 on the tables' device")


def render_mesh(cam, sph, n_spheres: int, tab: MeshTables, cfg: RenderConfig,
                sky_kind: int, flags, seed: int, n_pix: int,
                pix_offset: int = 0, sample_base: int = 0, counts=None):
    """Mean radiance of n_pix pixels from global pixel ``pix_offset`` on,
    over cfg.spp samples with global ids from ``sample_base``: R, G and B
    planes of shape (n_pix,).

    cam: ``mesh_camera_table``; sph: ``sphere_table``; tab:
    ``intersect_mm.mesh_tables``; flags: ``specialize_mesh_flags``;
    counts: optional (2,) int64 tensor that receives the bounces traced and
    the triangle tests run.  CUDA tensors launch the kernel; CPU tensors
    run ``render_mesh_plain``."""
    global LAUNCHES
    _check_args(cam, sph, n_spheres, tab, n_pix, pix_offset, cfg, sky_kind,
                counts)
    if cam.device.type == "cpu":
        return render_mesh_plain(cam, sph, n_spheres, tab, cfg, sky_kind,
                                 flags, seed, n_pix, pix_offset, sample_base,
                                 counts)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg, sky_kind, flags[:5])
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().mesh_megakernel_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            tab.tri.data_ptr(), tab.tri.shape[1], tab.cluster.data_ptr(),
            tab.sub.data_ptr(), tab.chunk_box.data_ptr(),
            tab.chunk_box.shape[0], tab.boxes.data_ptr(), tab.boxes.shape[0],
            int(flags[5]), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(),
            counts.data_ptr() if counts is not None else None, n_pix,
            pix_offset, seed & 0xFFFFFFFF, sample_base & 0xFFFFFFFF,
            cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.t_min, bits,
            stream)
    if rc != 0:
        raise RuntimeError(f"mesh megakernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1], out[2]


def render_mesh_plain(cam, sph, n_spheres: int, tab: MeshTables,
                      cfg: RenderConfig, sky_kind: int, flags, seed: int,
                      n_pix: int, pix_offset: int = 0, sample_base: int = 0,
                      counts=None):
    """The plain PyTorch version of ``render_mesh``, on the tables' device:
    the wavefront tracer over the spheres of the sphere table and the
    triangles of the mesh tables, with the mesh material of the camera
    table and ``flags``.  ``flags`` otherwise only prune the kernel's code.
    counts[1] receives the plain fold's triangle tests (of every chunk a
    ray enters; the kernel culls more)."""
    dev = cam.device
    scene, frame = scene_from_tables(cam, sph, n_spheres, sky_kind)
    t_pad = tab.tri.shape[1]
    material = (cam[0, C_MA_R:C_MA_B + 1].expand(t_pad, 3),
                cam[0, C_M_FUZZ].expand(t_pad), cam[0, C_M_IOR].expand(t_pad),
                torch.full((t_pad,), int(flags[5]), dtype=torch.int32,
                           device=dev))
    tests = counts[1:2] if counts is not None else None

    def closest(tab_, o, d, t_min):
        return closest_tri_plain(tab_, o, d, t_min, tests)

    hit_fn = tri_hit_fn(tab, scene, cfg.t_min, closest, material)
    lin = torch.arange(pix_offset, pix_offset + n_pix, device=dev)
    acc = render_rows_wavefront(
        scene, cfg, lin // cfg.width, lin % cfg.width, lin, seed,
        sample_base, cfg.spp, frame=frame,
        bounces=counts[0:1] if counts is not None else None, hit_fn=hit_fn)
    img = div(acc, cfg.spp)
    return img[:, 0], img[:, 1], img[:, 2]


_INPUTS: dict = {}


def mesh_inputs(scene: Scene, device) -> tuple:
    """The kernel's inputs for a supported scene on ``device``: (camera
    table, sphere table, sphere count, mesh tables, flags), cached under a
    digest of every leaf of the scene as given, so that a hit moves
    nothing to the device."""
    leaves = scene_to_numpy(scene)
    device = torch.device(device)

    def build():
        s = scene.to(device)
        material = _uniform_material(*(leaves[f"triangles.{f}"] for f in
                                       ("albedo", "fuzz", "ior", "mat_type")))
        return (mesh_camera_table(s), sphere_table(s), s.spheres.count,
                mesh_tables(s, leaves),
                _with_mesh(specialize_flags(s), material, False))

    return cached(_INPUTS, leaves_key(leaves, scene.sky.kind, str(device)),
                  build)


def render_megamesh(scene: Scene, cfg: RenderConfig, seed: int = 0,
                    device=None):
    """(H, W, 3) image of a supported scene through ``render_mesh`` on
    ``device`` (None: the scene's)."""
    device = scene.triangles.p0.device if device is None else device
    cam, sph, n_spheres, tab, flags = mesh_inputs(scene, device)
    r, g, b = render_mesh(cam, sph, n_spheres, tab, cfg, scene.sky.kind,
                          flags, seed, cfg.width * cfg.height)
    return torch.stack([r, g, b], dim=-1).reshape(cfg.height, cfg.width, 3)
