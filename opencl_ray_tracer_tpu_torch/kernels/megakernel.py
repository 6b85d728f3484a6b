"""The sphere megakernel: forward render of sphere scenes on the card.

``render_spheres`` is the wrapper of the CUDA kernel in
``csrc/megakernel.cu`` (persistent blocks whose lanes take pixels from a
work counter, path regeneration, one draw per lane and iteration; see the
note at the top of that file for what bounds it).  The kernel replaces the
JAX package's Pallas ``kernels/megakernel.py::_make_kernel``.
``render_spheres_plain`` is its plain PyTorch version with the same
signature, built from the tracer modules; the wrapper runs it for tensors
on the CPU and nowhere else.

The library is compiled with ``nvcc`` at first use (``_build.py``) and
loaded with ctypes.
"""

from __future__ import annotations

import ctypes

import torch

from .._fp import div
from ..config import RenderConfig
from ..scene import (BoundingBoxes, Scene, Sky, Spheres, Triangles,
                     camera_frame)
from ..scene import materials as mat
from ..scene.sky import KIND_CONST, KIND_GRADIENT, KIND_HDR
from ..tracer.wavefront import render_rows_wavefront
from . import _build

LANES = 128
MAX_SPHERES = 128

# Sphere-table rows of a (16, max(128, n)) f32 table.
(F_CX, F_CY, F_CZ, F_R, F_ALR, F_ALG, F_ALB, F_FUZZ, F_IOR, F_TYPE,
 F_R2, F_INVR, F_INVIOR) = range(13)
N_FIELDS = 16

# Camera-table slots of a (1, 128) f32 table.
(C_OX, C_OY, C_OZ, C_HX, C_HY, C_HZ, C_VX, C_VY, C_VZ,
 C_LX, C_LY, C_LZ, C_DUX, C_DUY, C_DUZ, C_DVX, C_DVY, C_DVZ,
 C_APERTURE, C_SKY0, C_SKY1, C_SKY2) = range(22)

# Flag bits of the kernel's ``flags`` argument.
FLAG_METAL = 1
FLAG_DIEL = 2
FLAG_EMIT = 4
FLAG_FUZZ = 8
FLAG_APERTURE = 16
FLAG_CLAMP = 32
FLAG_NAN_RUNNING_SUM = 64
FLAG_SKY_CONST = 128
FLAG_SKY_HDR = 256
FLAG_RAW_SUM = 512

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SYMBOLS = {"sphere_megakernel_launch": (
    [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_uint32,
     ctypes.c_uint32, _I, _I, _I, _I, ctypes.c_float, _I, _P], _I)}


def _library():
    return _build.load("megakernel", _SYMBOLS)


def unsupported_reason(scene: Scene) -> str | None:
    """Why the kernel does not cover this scene, or None when it does.
    The gradient entry points take their scope from here."""
    if scene.triangles.count > 0:
        return ("the sphere megakernel takes no triangles: a mesh scene "
                "renders through the mesh megakernel (K2) and differentiates "
                "through the mesh backward kernel (K5)")
    if scene.sky.kind == KIND_HDR:
        return ("the sphere megakernel takes a gradient or constant sky: "
                "an HDR scene renders through the mesh megakernel's HDR "
                "body (K2) and differentiates through K6 and K7")
    if not 0 < scene.spheres.count <= MAX_SPHERES:
        return (f"the sphere megakernel takes 1 to {MAX_SPHERES} spheres; "
                "render() draws larger sphere scenes with the plain tracer")
    return None


def supports(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the megakernel covers this scene and config."""
    return unsupported_reason(scene) is None


def specialize_flags(scene: Scene, conservative: bool = False):
    """Material presence: (has_metal, has_diel, has_emit, has_fuzz,
    has_aperture), read from the scene's values on the host.

    The fuzz and aperture bits prune code on values (fuzz > 0, aperture >
    0), which an optimizer may change.  ``conservative`` sets them from
    what the values could become: has_fuzz = has_metal and has_aperture =
    True, so one set of flags serves every step of a fit.  The image does
    not change: a zero fuzz or aperture adds exactly zero."""
    types = scene.spheres.mat_type.cpu()
    is_metal = types == mat.METAL
    has_metal = bool(is_metal.any())
    if conservative:
        has_fuzz, has_aperture = has_metal, True
    else:
        fuzz = scene.spheres.fuzz.detach().cpu()
        has_fuzz = bool((fuzz[is_metal] > 0).any())
        has_aperture = float(scene.camera.aperture_deg.detach()) > 0.0
    return (has_metal, bool((types == mat.DIELECTRIC).any()),
            bool((types == mat.EMISSIVE).any()), has_fuzz, has_aperture)


def camera_table(scene: Scene) -> torch.Tensor:
    """(1, 128) f32: the camera frame and the constant sky colour."""
    f = camera_frame(scene.camera)
    vals = torch.cat([
        f["origin"], f["horizontal"], f["vertical"], f["lower_left_corner"],
        f["defocus_disc_u"], f["defocus_disc_v"], f["aperture_rad"][None],
        scene.sky.const_colour.reshape(3).to(f["origin"].device),
    ]).to(torch.float32)
    tab = torch.zeros((1, LANES), dtype=torch.float32, device=vals.device)
    tab[0, :vals.shape[0]] = vals
    return tab


def sphere_table(scene: Scene) -> torch.Tensor:
    """(16, max(128, n)) f32: one row per F_* field, reciprocals included."""
    s = scene.spheres
    n = s.count
    tab = torch.zeros((N_FIELDS, max(LANES, n)), dtype=torch.float32,
                      device=s.center.device)
    tab[F_CX:F_CZ + 1, :n] = s.center.T
    tab[F_R, :n] = s.radius
    tab[F_ALR:F_ALB + 1, :n] = s.albedo.T
    tab[F_FUZZ, :n] = s.fuzz
    tab[F_IOR, :n] = s.ior
    tab[F_TYPE, :n] = s.mat_type.to(torch.float32)
    tab[F_R2, :n] = s.radius * s.radius
    tab[F_INVR, :n] = 1.0 / s.radius
    tab[F_INVIOR, :n] = 1.0 / torch.clamp(s.ior, min=1e-8)
    return tab


def _flag_bits(cfg: RenderConfig, sky_kind: int, flags) -> int:
    has_metal, has_diel, has_emit, has_fuzz, has_aperture = flags
    if cfg.nan_policy not in ("running_sum", "zero"):
        raise ValueError(f"unknown nan_policy: {cfg.nan_policy}")
    return ((FLAG_METAL if has_metal else 0)
            | (FLAG_DIEL if has_diel else 0)
            | (FLAG_EMIT if has_emit else 0)
            | (FLAG_FUZZ if has_fuzz else 0)
            | (FLAG_APERTURE if has_aperture else 0)
            | (FLAG_CLAMP if cfg.clamp_samples else 0)
            | (FLAG_NAN_RUNNING_SUM if cfg.nan_policy == "running_sum" else 0)
            | (FLAG_SKY_CONST if sky_kind == KIND_CONST else 0)
            | (FLAG_SKY_HDR if sky_kind == KIND_HDR else 0))


def check_acc0(acc0, n_pix: int, device) -> None:
    """Raise unless acc0 is None or the (3, n_pix) contiguous float32
    planes of a window's starting sums on ``device``."""
    if acc0 is not None and (acc0.dtype != torch.float32
                             or acc0.shape != (3, n_pix)
                             or not acc0.is_contiguous()
                             or acc0.device != device):
        raise ValueError("acc0 must be (3, n_pix) contiguous float32 planes "
                         "on the tables' device")


def acc0_planes(acc0, n_pix: int, device):
    """A window's starting sums as the kernels take them: (3, n_pix)
    contiguous float32 planes on ``device``, from (..., 3) pixel sums (a
    tensor or an array); None stays None."""
    if acc0 is None:
        return None
    if not isinstance(acc0, torch.Tensor):
        acc0 = torch.tensor(acc0)   # a copy: the array may be read-only
    acc0 = acc0.to(device=device, dtype=torch.float32)
    return acc0.reshape(n_pix, 3).T.contiguous()


def _check_args(cam, sph, n_spheres, n_pix, pix_offset, cfg, sky_kind,
                bounces):
    if sky_kind not in (KIND_GRADIENT, KIND_CONST):
        raise ValueError(f"the kernel takes a gradient or constant sky, "
                         f"not kind {sky_kind}")
    if cam.device != sph.device:
        raise ValueError("camera and sphere tables are on different devices")
    for name, t, rows in (("camera", cam, 1), ("sphere", sph, N_FIELDS)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} table must be contiguous float32")
        if t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"{name} table has shape {tuple(t.shape)}")
    if cam.shape[1] != LANES or sph.shape[1] < max(LANES, n_spheres):
        raise ValueError("table widths do not match the table builders")
    if not 0 < n_spheres <= MAX_SPHERES:
        raise ValueError(f"n_spheres must be in 1..{MAX_SPHERES}")
    if (n_pix < 0 or pix_offset < 0 or pix_offset + n_pix >= 2**31
            or cfg.spp * cfg.max_depth >= 2**31):
        raise ValueError("pixel or iteration counts out of range")
    if bounces is not None and (bounces.dtype != torch.int64
                                or bounces.numel() != 1
                                or bounces.device != cam.device):
        raise ValueError("bounces must be one int64 on the tables' device")


def render_spheres(cam, sph, n_spheres: int, cfg: RenderConfig,
                   sky_kind: int, flags, seed: int, n_pix: int,
                   pix_offset: int = 0, sample_base: int = 0, bounces=None,
                   acc0=None, mean: bool = True):
    """Mean radiance of n_pix pixels from global pixel ``pix_offset`` on,
    over cfg.spp samples with global ids from ``sample_base``: R, G and B
    planes of shape (n_pix,).

    cam/sph: ``camera_table``/``sphere_table``; flags: ``specialize_flags``;
    bounces: optional one-element int64 tensor that receives the number of
    bounces traced.  A sample window of a checkpointed render: acc0, the
    (3, n_pix) planes of the pixels' sums over the samples before
    ``sample_base`` (``acc0_planes``), seeds each pixel's running sum, and
    mean False returns the sum, acc0 included, instead of the mean.  CUDA
    tensors launch the kernel; CPU tensors run ``render_spheres_plain``.
    """
    global LAUNCHES
    _check_args(cam, sph, n_spheres, n_pix, pix_offset, cfg, sky_kind,
                bounces)
    check_acc0(acc0, n_pix, cam.device)
    if cam.device.type == "cpu":
        return render_spheres_plain(cam, sph, n_spheres, cfg, sky_kind, flags,
                                    seed, n_pix, pix_offset, sample_base,
                                    bounces, acc0, mean)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg, sky_kind, flags) | (0 if mean else FLAG_RAW_SUM)
    fn = _library().sphere_megakernel_launch
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    # the pixels the lanes take after their first, counted from 0
    work = torch.zeros(1, dtype=torch.int32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                acc0.data_ptr() if acc0 is not None else None,
                bounces.data_ptr() if bounces is not None else None,
                work.data_ptr(), n_pix, pix_offset, seed & 0xFFFFFFFF,
                sample_base & 0xFFFFFFFF, cfg.width, cfg.height, cfg.spp,
                cfg.max_depth, cfg.t_min, bits, stream)
    if rc != 0:
        raise RuntimeError(f"sphere megakernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1], out[2]


def scene_from_tables(cam, sph, n_spheres: int, sky_kind: int,
                      sky_image=None):
    """The scene the tables hold, for the plain tracer: (scene, frame).
    Spheres are rebuilt from the centre, radius, albedo, fuzz, ior and type
    rows; the camera enters as the frame of the camera table; an HDR sky
    takes ``sky_image``."""
    c = cam[0]
    frame = dict(origin=c[C_OX:C_OZ + 1], horizontal=c[C_HX:C_HZ + 1],
                 vertical=c[C_VX:C_VZ + 1],
                 lower_left_corner=c[C_LX:C_LZ + 1],
                 defocus_disc_u=c[C_DUX:C_DUZ + 1],
                 defocus_disc_v=c[C_DVX:C_DVZ + 1],
                 aperture_rad=c[C_APERTURE])
    n = n_spheres
    spheres = Spheres(center=sph[F_CX:F_CZ + 1, :n].T, radius=sph[F_R, :n],
                      albedo=sph[F_ALR:F_ALB + 1, :n].T, fuzz=sph[F_FUZZ, :n],
                      ior=sph[F_IOR, :n],
                      mat_type=sph[F_TYPE, :n].detach().to(torch.int32))
    image = (sky_image if sky_image is not None
             else torch.zeros((1, 1, 3), device=cam.device))
    sky = Sky(image, c[C_SKY0:C_SKY2 + 1], sky_kind)
    # the camera enters as `frame`
    return Scene(None, spheres, Triangles.empty(), BoundingBoxes.empty(),
                 sky), frame


def render_spheres_plain(cam, sph, n_spheres: int, cfg: RenderConfig,
                         sky_kind: int, flags, seed: int, n_pix: int,
                         pix_offset: int = 0, sample_base: int = 0,
                         bounces=None, acc0=None, mean: bool = True):
    """The plain PyTorch version of ``render_spheres``, on the tables'
    device: the wavefront tracer over the scene the tables hold.  ``flags``
    only prune the kernel's code; the result does not depend on them."""
    dev = cam.device
    scene, frame = scene_from_tables(cam, sph, n_spheres, sky_kind)
    lin = torch.arange(pix_offset, pix_offset + n_pix, device=dev)
    acc = render_rows_wavefront(scene, cfg, lin // cfg.width, lin % cfg.width,
                                lin, seed, sample_base, cfg.spp, frame=frame,
                                bounces=bounces,
                                acc0=None if acc0 is None else acc0.T)
    img = div(acc, cfg.spp) if mean else acc
    return img[:, 0], img[:, 1], img[:, 2]


def render_megakernel(scene: Scene, cfg: RenderConfig, seed: int = 0,
                      rows: int | None = None, pix_offset: int = 0,
                      sample_offset: int = 0, mean: bool = True, acc0=None):
    """(rows, W, 3) image of a supported scene through ``render_spheres``
    on the scene's device: ``rows`` whole rows (None: cfg.height) from
    global pixel ``pix_offset`` on, the mean over cfg.spp samples from
    ``sample_offset``, or with mean False their sum from the sums acc0
    ((rows, W, 3) or None)."""
    rows = cfg.height if rows is None else rows
    n_pix = rows * cfg.width
    cam = camera_table(scene)
    r, g, b = render_spheres(cam, sphere_table(scene),
                             scene.spheres.count, cfg, scene.sky.kind,
                             specialize_flags(scene), seed, n_pix,
                             pix_offset, sample_offset,
                             acc0=acc0_planes(acc0, n_pix, cam.device),
                             mean=mean)
    return torch.stack([r, g, b], dim=-1).reshape(rows, cfg.width, 3)
