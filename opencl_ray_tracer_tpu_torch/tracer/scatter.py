"""Material scattering for a ray batch: every candidate direction is
computed for every ray and selected by material type.

``LambertianScatter`` ``gpu_kernel.cl:398-413``, ``MetalScatter``
``:415-423``, ``TransparentScatter`` ``:425-451``, emissive termination
``:326-329``.  Draws come from fixed slots, so a material never shifts
another's random numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..rng import in_unit_sphere_from_uniforms, unit_vector_from_uniforms
from ..scene import materials as mat
from .._fp import dot3, fma

NEAR_ZERO = 1e-8  # Vec3NearZero, gpu_kernel.cl:203-207


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # (R,3) scattered direction
    attenuation: torch.Tensor  # (R,3)
    absorbed: torch.Tensor     # (R,) bool: metal absorb -> black
    emitted: torch.Tensor      # (R,) bool: emissive terminate


def _unit(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def reflect(v, n):
    """Vec3Reflect (gpu_kernel.cl:209-212)."""
    return fma(-n, (2.0 * dot3(v, n))[..., None], v)


def refract(uv, n, etai_over_etat):
    """Vec3Refract (gpu_kernel.cl:214-220)."""
    cos_theta = torch.clamp(dot3(-uv, n), max=1.0)
    r_perp = fma(n, cos_theta[..., None], uv) * etai_over_etat[..., None]
    r_par = -n * torch.sqrt(torch.clamp(
        torch.abs(1.0 - dot3(r_perp, r_perp)), min=1e-20))[..., None]
    return r_perp + r_par


def reflectance(cosine, ref_idx):
    """Schlick approximation (Vec3Reflectance, gpu_kernel.cl:222-227).
    The fifth power is x * (x^2)^2, the order the JAX package and the CUDA
    kernel use."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return fma(1.0 - r0, x * (x2 * x2), r0)


def scatter(d, normal, front_face, albedo, fuzz, ior, mat_type,
            u) -> ScatterResult:
    """All-material scatter.  d: (R,3) incoming direction; normal: (R,3)
    front-facing; u: (R,8) uniforms for this bounce (0-1 Lambertian unit
    vector, 2-4 metal fuzz ball, 5 dielectric reflect choice)."""
    rand_unit = unit_vector_from_uniforms(u[:, 0], u[:, 1])
    lam_dir = normal + rand_unit
    near_zero = torch.all(torch.abs(lam_dir) < NEAR_ZERO, dim=-1)
    lam_dir = torch.where(near_zero[:, None], normal, lam_dir)

    unit_d = _unit(d)
    reflected = reflect(unit_d, normal)
    fuzz_vec = in_unit_sphere_from_uniforms(u[:, 2], u[:, 3], u[:, 4])
    metal_dir = fma(fuzz_vec, fuzz[:, None], reflected)
    metal_absorbed = dot3(metal_dir, normal) <= 0.0

    ratio = torch.where(front_face, 1.0 / torch.clamp(ior, min=1e-8), ior)
    cos_theta = torch.clamp(dot3(-unit_d, normal), max=1.0)
    sin_theta = torch.sqrt(torch.clamp(fma(-cos_theta, cos_theta, 1.0),
                                       min=1e-20))
    cannot_refract = ratio * sin_theta > 1.0
    choose_reflect = cannot_refract | (reflectance(cos_theta, ratio) > u[:, 5])
    diel_dir = torch.where(choose_reflect[:, None], reflected,
                           refract(unit_d, normal, ratio))

    is_metal = mat_type == mat.METAL
    is_diel = mat_type == mat.DIELECTRIC
    is_emit = mat_type == mat.EMISSIVE
    direction = torch.where(is_diel[:, None], diel_dir,
                            torch.where(is_metal[:, None], metal_dir, lam_dir))
    attenuation = torch.where(is_diel[:, None], torch.ones_like(albedo),
                              albedo)
    return ScatterResult(direction=direction, attenuation=attenuation,
                         absorbed=is_metal & metal_absorbed, emitted=is_emit)
