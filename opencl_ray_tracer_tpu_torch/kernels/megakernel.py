"""The sphere megakernel: forward render of sphere scenes on the card.

``render_spheres`` is the wrapper of the CUDA kernel in
``csrc/megakernel.cu`` (one thread per pixel, path regeneration; see the
note at the top of that file for what bounds it).  The kernel replaces the
JAX package's Pallas ``kernels/megakernel.py::_make_kernel``.
``render_spheres_plain`` is its plain PyTorch version with the same
signature, built from the tracer modules; the wrapper runs it for tensors
on the CPU and nowhere else.

The library is compiled with ``nvcc`` at first use from the source in this
package into ``_build/`` beside the package, keyed on a hash of the source
and flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from .._fp import div
from ..config import RenderConfig
from ..scene import (BoundingBoxes, Scene, Sky, Spheres, Triangles,
                     camera_frame)
from ..scene import materials as mat
from ..scene.sky import KIND_CONST, KIND_GRADIENT, KIND_HDR
from ..tracer.wavefront import render_rows_wavefront

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

# Launches of the CUDA kernel since the count was last set to 0.
LAUNCHES = 0

_SRC = pathlib.Path(__file__).parent / "csrc" / "megakernel.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC"]
_LIB = None


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> pathlib.Path:
    """Compile the kernel library if it is not built yet; its path.  The
    compiler's report (registers, spills) is kept beside it as ``.log``."""
    src = _SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = _BUILD_DIR / f"megakernel_{key}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.sphere_megakernel_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, p, p, p, p, i, i, ctypes.c_uint32,
                       ctypes.c_uint32, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def unsupported_reason(scene: Scene) -> str | None:
    """Why the kernel does not cover this scene, or None when it does."""
    if scene.triangles.count > 0:
        return ("triangle meshes are not ported yet: the mesh slice "
                "(slice 3) ports the fused mesh kernel")
    if scene.sky.kind == KIND_HDR:
        return ("HDR skies are not ported yet: the HDR slice (slice 4) "
                "ports them")
    if not 0 < scene.spheres.count <= MAX_SPHERES:
        return (f"the sphere megakernel takes 1 to {MAX_SPHERES} spheres; "
                "larger scenes go through the fused mesh kernel, ported in "
                "the mesh slice (slice 3)")
    return None


def supports(scene: Scene, cfg: RenderConfig) -> bool:
    """True when the megakernel covers this scene and config."""
    return unsupported_reason(scene) is None


def specialize_flags(scene: Scene):
    """Material presence: (has_metal, has_diel, has_emit, has_fuzz,
    has_aperture), read from the scene's values on the host."""
    types = scene.spheres.mat_type.cpu()
    fuzz = scene.spheres.fuzz.cpu()
    is_metal = types == mat.METAL
    return (bool(is_metal.any()),
            bool((types == mat.DIELECTRIC).any()),
            bool((types == mat.EMISSIVE).any()),
            bool((fuzz[is_metal] > 0).any()),
            float(scene.camera.aperture_deg) > 0.0)


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
            | (FLAG_SKY_CONST if sky_kind == KIND_CONST else 0))


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
                   pix_offset: int = 0, sample_base: int = 0, bounces=None):
    """Mean radiance of n_pix pixels from global pixel ``pix_offset`` on,
    over cfg.spp samples with global ids from ``sample_base``: R, G and B
    planes of shape (n_pix,).

    cam/sph: ``camera_table``/``sphere_table``; flags: ``specialize_flags``;
    bounces: optional one-element int64 tensor that receives the number of
    bounces traced.  CUDA tensors launch the kernel; CPU tensors run
    ``render_spheres_plain``.
    """
    global LAUNCHES
    _check_args(cam, sph, n_spheres, n_pix, pix_offset, cfg, sky_kind,
                bounces)
    if cam.device.type == "cpu":
        return render_spheres_plain(cam, sph, n_spheres, cfg, sky_kind, flags,
                                    seed, n_pix, pix_offset, sample_base,
                                    bounces)
    if cam.device.type != "cuda":
        raise ValueError(f"no kernel for device {cam.device}")
    bits = _flag_bits(cfg, sky_kind, flags)
    fn = _library().sphere_megakernel_launch
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    with torch.cuda.device(cam.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(cam.data_ptr(), sph.data_ptr(), sph.shape[1], n_spheres,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                bounces.data_ptr() if bounces is not None else None,
                n_pix, pix_offset, seed & 0xFFFFFFFF,
                sample_base & 0xFFFFFFFF, cfg.width, cfg.height, cfg.spp,
                cfg.max_depth, cfg.t_min, bits, stream)
    if rc != 0:
        raise RuntimeError(f"sphere megakernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out[0], out[1], out[2]


def render_spheres_plain(cam, sph, n_spheres: int, cfg: RenderConfig,
                         sky_kind: int, flags, seed: int, n_pix: int,
                         pix_offset: int = 0, sample_base: int = 0,
                         bounces=None):
    """The plain PyTorch version of ``render_spheres``, on the tables'
    device: the wavefront tracer over the scene the tables hold.  ``flags``
    only prune the kernel's code; the result does not depend on them."""
    dev = cam.device
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
                      mat_type=sph[F_TYPE, :n].to(torch.int32))
    sky = Sky(torch.zeros((1, 1, 3), device=dev), c[C_SKY0:C_SKY2 + 1],
              sky_kind)
    # the camera enters as `frame`
    scene = Scene(None, spheres, Triangles.empty(), BoundingBoxes.empty(),
                  sky)
    lin = torch.arange(pix_offset, pix_offset + n_pix, device=dev)
    acc = render_rows_wavefront(scene, cfg, lin // cfg.width, lin % cfg.width,
                                lin, seed, sample_base, cfg.spp, frame=frame,
                                bounces=bounces)
    img = div(acc, cfg.spp)
    return img[:, 0], img[:, 1], img[:, 2]


def render_megakernel(scene: Scene, cfg: RenderConfig, seed: int = 0):
    """(H, W, 3) image of a supported scene through ``render_spheres`` on
    the scene's device."""
    r, g, b = render_spheres(camera_table(scene), sphere_table(scene),
                             scene.spheres.count, cfg, scene.sky.kind,
                             specialize_flags(scene), seed,
                             cfg.width * cfg.height)
    return torch.stack([r, g, b], dim=-1).reshape(cfg.height, cfg.width, 3)
