"""The mesh megakernel: forward render of mesh scenes on the card.

``render_mesh`` is the wrapper of the CUDA kernel in ``csrc/megamesh.cu``
(the sphere megakernel's per-pixel estimator with a culled triangle hit;
see the note at the top of that file).  The kernel replaces the mesh body
of the JAX package's Pallas ``kernels/megamesh.py::_make_kernel``, for
gradient, constant and HDR skies.  ``render_mesh_plain`` is its plain
PyTorch version with the same
signature: the wavefront tracer over the scene the tables hold, with
``intersect_mm.closest_tri_plain`` as the triangle hit, in the same plan
order.  The wrapper runs it for tensors on the CPU and nowhere else.

A scene is in scope (``supports_mesh``) when it has at most 128 spheres
and either triangles of one uniform material (the reference gives each
mesh one, ``utility.cpp:99``) in one or more gating boxes under a gradient
or constant sky, or an HDR sky, with or without such triangles.  The JAX
package's HDR body also needs texels and albedos of at most 1: it defers
the lookup to records it sums afterwards, past the clamp before the
average, so a sky term above 1 would escape the clamp.  The CUDA kernel
looks the texel up where the ray misses and clamps the sample's term as
for any other sky, so it takes any texels and albedos.  The mesh
material rides in camera-table slots ``C_MA_R`` .. ``C_M_INVIOR`` and the
flags.  ``mesh_inputs`` keeps
the kernel's inputs of the last few scenes, keyed by a digest of every
leaf, so that rendering a scene again reads it to the host and hashes it,
and builds nothing.
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
from .intersect_mm import (TABLE_ARGTYPES, MeshTables, cached, check_tables,
                           closest_tri_plain, empty_tables, leaves_key,
                           mesh_tables, table_args, tri_hit_fn)
from .megakernel import (FLAG_RAW_SUM, LANES, MAX_SPHERES, N_FIELDS,
                         _flag_bits, acc0_planes, camera_table, check_acc0,
                         scene_from_tables, specialize_flags, sphere_table)

# Camera-table slots of the uniform mesh material (after C_SKY2 = 21).
(C_MA_R, C_MA_G, C_MA_B, C_M_FUZZ, C_M_IOR, C_M_INVIOR) = range(22, 28)

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"mesh_megakernel_launch": (
    [_P, _P, _I, _I, *TABLE_ARGTYPES, _I, _P, _P, _P, _P, _P, _P,
     _I, _I, ctypes.c_uint32, ctypes.c_uint32, _I, _I, _I, _I,
     ctypes.c_float, _I, _P, _I, _I, _P], _I),
    "hdr_texel_launch": ([_P, _I, _I, _I, _P, _P], _I)}


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
    hdr = scene.sky.kind == KIND_HDR
    if not hdr and scene.sky.kind not in (KIND_GRADIENT, KIND_CONST):
        return f"unknown sky kind {scene.sky.kind}"
    if scene.spheres.count > MAX_SPHERES:
        return f"the mesh megakernel takes at most {MAX_SPHERES} spheres"
    if scene.triangles.count == 0 and not hdr:
        return "the mesh megakernel renders scenes with triangles"
    if scene.triangles.count > 0:
        if scene.boxes.count == 0:
            return "the mesh megakernel takes triangles in gating boxes"
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


def check_sky_image(sky_kind: int, sky_image, device) -> None:
    """Raise unless an HDR sky comes with its (H, W, 3) contiguous float32
    image on ``device``, and another sky without one."""
    if sky_kind not in (KIND_GRADIENT, KIND_CONST, KIND_HDR):
        raise ValueError(f"unknown sky kind {sky_kind}")
    if sky_kind != KIND_HDR:
        if sky_image is not None:
            raise ValueError("only an HDR sky takes an image")
        return
    if (sky_image is None or sky_image.dtype != torch.float32
            or sky_image.dim() != 3 or sky_image.shape[2] != 3
            or not sky_image.is_contiguous() or sky_image.device != device
            or sky_image.shape[0] * sky_image.shape[1] == 0):
        raise ValueError("an HDR sky takes its (H, W, 3) contiguous float32 "
                         "image on the tables' device")


def sky_args(sky_image) -> tuple:
    """The launchers' sky arguments: the image's pointer, width, height."""
    if sky_image is None:
        return None, 0, 0
    return sky_image.data_ptr(), sky_image.shape[1], sky_image.shape[0]


def _check_args(cam, sph, n_spheres, tab, n_pix, pix_offset, cfg, sky_kind,
                counts, sky_image):
    check_sky_image(sky_kind, sky_image, cam.device)
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
    check_tables(tab, allow_empty=sky_kind == KIND_HDR)
    if (n_pix < 0 or pix_offset < 0 or pix_offset + n_pix >= 2**31
            or cfg.spp * cfg.max_depth >= 2**31):
        raise ValueError("pixel or iteration counts out of range")
    if counts is not None and (counts.dtype != torch.int64
                               or counts.shape != (2,)
                               or counts.device != cam.device):
        raise ValueError("counts must be two int64 on the tables' device")


def render_mesh(cam, sph, n_spheres: int, tab: MeshTables, cfg: RenderConfig,
                sky_kind: int, flags, seed: int, n_pix: int,
                pix_offset: int = 0, sample_base: int = 0, counts=None,
                sky_image=None, acc0=None, mean: bool = True):
    """Mean radiance of n_pix pixels from global pixel ``pix_offset`` on,
    over cfg.spp samples with global ids from ``sample_base``: R, G and B
    planes of shape (n_pix,); with acc0 and mean False the sum of a sample
    window, as ``megakernel.render_spheres``.

    cam: ``mesh_camera_table``; sph: ``sphere_table``; tab:
    ``intersect_mm.mesh_tables`` (``empty_tables`` for a scene without
    triangles under an HDR sky); flags: ``specialize_mesh_flags``; counts:
    optional (2,) int64 tensor that receives the bounces traced and the
    triangle tests run; sky_image: the (H, W, 3) image of an HDR sky.
    CUDA tensors launch the kernel; CPU tensors run
    ``render_mesh_plain``."""
    global LAUNCHES
    _check_args(cam, sph, n_spheres, tab, n_pix, pix_offset, cfg, sky_kind,
                counts, sky_image)
    check_acc0(acc0, n_pix, cam.device)
    if cam.device.type == "cpu":
        return render_mesh_plain(cam, sph, n_spheres, tab, cfg, sky_kind,
                                 flags, seed, n_pix, pix_offset, sample_base,
                                 counts, sky_image, acc0, mean)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = (_flag_bits(cfg, sky_kind, flags[:5])
            | (0 if mean else FLAG_RAW_SUM))
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    # the pixels the lanes take after their first, counted from 0
    work = torch.zeros(1, dtype=torch.int32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _library().mesh_megakernel_launch(
            cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
            *table_args(tab),
            int(flags[5]), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), acc0.data_ptr() if acc0 is not None else None,
            counts.data_ptr() if counts is not None else None,
            work.data_ptr(), n_pix, pix_offset, seed & 0xFFFFFFFF,
            sample_base & 0xFFFFFFFF,
            cfg.width, cfg.height, cfg.spp, cfg.max_depth, cfg.t_min, bits,
            *sky_args(sky_image), stream)
    if rc != 0:
        raise RuntimeError(f"mesh megakernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1], out[2]


def hdr_texels(d, width: int, height: int):
    """The flat texel index y * width + x that the kernel's HDR lookup
    (``csrc/common.cuh::hdr_texel``) gives for each direction of d (n, 3),
    contiguous float32 on the card: the lookup alone, which
    ``scene.sky.texel_index`` computes as torch ops, for holding the two
    against each other.  Not on a render's path."""
    if (d.device.type != "cuda" or d.dtype != torch.float32
            or d.dim() != 2 or d.shape[1] != 3 or not d.is_contiguous()):
        raise ValueError("d must be contiguous float32 (n, 3) on the card")
    out = torch.empty((d.shape[0],), dtype=torch.int32, device=d.device)
    with torch.cuda.device(d.device):
        rc = _library().hdr_texel_launch(
            d.data_ptr(), d.shape[0], width, height, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"HDR texel launch failed: CUDA error {rc}")
    return out.long()


def plain_hit_fn(cam, scene, tab: MeshTables, cfg: RenderConfig, flags,
                 tests=None):
    """hit_fn of the mesh kernels' plain versions on the scene of
    ``scene_from_tables``: its spheres' hit merged with
    ``closest_tri_plain`` on the tables, a triangle taking the mesh
    material of the camera table and ``flags``; None (the spheres' hit)
    without triangles.  tests receives the plain fold's triangle tests."""
    t_pad = tab.tri.shape[1]
    if t_pad == 0:
        return None
    material = (cam[0, C_MA_R:C_MA_B + 1].expand(t_pad, 3),
                cam[0, C_M_FUZZ].expand(t_pad), cam[0, C_M_IOR].expand(t_pad),
                torch.full((t_pad,), int(flags[5]), dtype=torch.int32,
                           device=cam.device))

    def closest(tab_, o, d, t_min):
        return closest_tri_plain(tab_, o, d, t_min, tests)

    return tri_hit_fn(tab, scene, cfg.t_min, closest, material)


def render_mesh_plain(cam, sph, n_spheres: int, tab: MeshTables,
                      cfg: RenderConfig, sky_kind: int, flags, seed: int,
                      n_pix: int, pix_offset: int = 0, sample_base: int = 0,
                      counts=None, sky_image=None, acc0=None,
                      mean: bool = True):
    """The plain PyTorch version of ``render_mesh``, on the tables' device:
    the wavefront tracer over the spheres of the sphere table and the
    triangles of the mesh tables, with the mesh material of the camera
    table and ``flags``, under the sky of ``sky_kind`` and ``sky_image``.
    ``flags`` otherwise only prune the kernel's code.  counts[1] receives
    the plain fold's triangle tests (of every chunk a ray enters; the
    kernel culls more)."""
    dev = cam.device
    scene, frame = scene_from_tables(cam, sph, n_spheres, sky_kind,
                                     sky_image)
    hit_fn = plain_hit_fn(cam, scene, tab, cfg, flags,
                          counts[1:2] if counts is not None else None)
    lin = torch.arange(pix_offset, pix_offset + n_pix, device=dev)
    acc = render_rows_wavefront(
        scene, cfg, lin // cfg.width, lin % cfg.width, lin, seed,
        sample_base, cfg.spp, frame=frame,
        bounces=counts[0:1] if counts is not None else None, hit_fn=hit_fn,
        acc0=None if acc0 is None else acc0.T)
    img = div(acc, cfg.spp) if mean else acc
    return img[:, 0], img[:, 1], img[:, 2]


_INPUTS: dict = {}


def mesh_inputs(scene: Scene, device) -> tuple:
    """The kernel's inputs for a supported scene on ``device``: (camera
    table, sphere table, sphere count, mesh tables, flags, sky image: the
    HDR sky's, else None), cached under a digest of every leaf of the scene
    as given, so that a hit moves nothing to the device.  A scene without
    triangles (under an HDR sky) takes ``empty_tables``."""
    leaves = scene_to_numpy(scene)
    device = torch.device(device)

    def build():
        s = scene.to(device)
        material = _uniform_material(*(leaves[f"triangles.{f}"] for f in
                                       ("albedo", "fuzz", "ior", "mat_type")))
        hdr = s.sky.kind == KIND_HDR
        return (mesh_camera_table(s), sphere_table(s), s.spheres.count,
                mesh_tables(s, leaves) if s.triangles.count
                else empty_tables(device),
                _with_mesh(specialize_flags(s), material, False),
                s.sky.image.contiguous() if hdr else None)

    return cached(_INPUTS, leaves_key(leaves, scene.sky.kind, str(device)),
                  build)


def render_megamesh(scene: Scene, cfg: RenderConfig, seed: int = 0,
                    device=None, rows: int | None = None,
                    pix_offset: int = 0, sample_offset: int = 0,
                    mean: bool = True, acc0=None):
    """(rows, W, 3) image of a supported scene through ``render_mesh`` on
    ``device`` (None: the scene's): ``rows`` whole rows (None: cfg.height)
    from global pixel ``pix_offset`` on, the mean over cfg.spp samples from
    ``sample_offset``, or with mean False their sum from the sums acc0
    ((rows, W, 3) or None), as ``megakernel.render_megakernel``."""
    device = scene.triangles.p0.device if device is None else device
    cam, sph, n_spheres, tab, flags, image = mesh_inputs(scene, device)
    rows = cfg.height if rows is None else rows
    n_pix = rows * cfg.width
    r, g, b = render_mesh(cam, sph, n_spheres, tab, cfg, scene.sky.kind,
                          flags, seed, n_pix, pix_offset, sample_offset,
                          sky_image=image,
                          acc0=acc0_planes(acc0, n_pix, cam.device),
                          mean=mean)
    return torch.stack([r, g, b], dim=-1).reshape(rows, cfg.width, 3)
