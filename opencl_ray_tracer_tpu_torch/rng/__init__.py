"""Counter-based RNG and analytic samplers.

Every uniform draw is a pure function of ``(pixel_id, sample_id, slot,
seed)`` through the pcg4d hash (Jarzynski & Olano, "Hash Functions for GPU
Rendering", JCGT 2020), so an image does not depend on the order in which
pixels or samples are computed.  The hashes are bit-equal to the JAX
package's ``rng`` and to the CUDA kernel's ``uint32_t`` version.

PyTorch has no unsigned 32-bit arithmetic on the CPU, so the hash runs in
int64 and masks to 32 bits after every step.  A product of two 32-bit
values does not fit in int64; ``_mul32`` splits one factor into 16-bit
halves so that every partial product does.

The samplers are exact inverse-CDF forms of the reference's rejection loops
(``Vec3RandInUnitSphere`` ``gpu_kernel.cl:182-196``, ``Vec3RandInUnitDisk``
``:243-257``).
"""

from __future__ import annotations

import math

import torch

from .._fp import fma

# Draw-slot layout within one (pixel, sample) stream: slots 0..3 are the
# camera draws; bounce d uses slots BOUNCE_BASE + d*BOUNCE_STRIDE and the
# one after it (two hashes, eight uniforms).
SLOT_PIXEL_U = 0
SLOT_PIXEL_V = 1
SLOT_LENS = 2
BOUNCE_BASE = 4
BOUNCE_STRIDE = 2

_MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def _u32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & _MASK


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(x * y) mod 2^32 for x, y in [0, 2^32), without int64 overflow."""
    lo = (x & 0xFFFF) * y
    hi = ((x >> 16) * y) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def pcg4d(a, b, c, d):
    """pcg4d hash: four uint32 values (held in int64) in, four out, on the
    device of the tensor arguments."""
    device = next((x.device for x in (a, b, c, d)
                   if isinstance(x, torch.Tensor)), None)
    a, b, c, d = (_u32(x, device) for x in (a, b, c, d))
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    a = (a * _MUL + _INC) & _MASK
    b = (b * _MUL + _INC) & _MASK
    c = (c * _MUL + _INC) & _MASK
    d = (d * _MUL + _INC) & _MASK
    a = (a + _mul32(b, d)) & _MASK
    b = (b + _mul32(c, a)) & _MASK
    c = (c + _mul32(a, b)) & _MASK
    d = (d + _mul32(b, c)) & _MASK
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = (a + _mul32(b, d)) & _MASK
    b = (b + _mul32(c, a)) & _MASK
    c = (c + _mul32(a, b)) & _MASK
    d = (d + _mul32(b, c)) & _MASK
    return a, b, c, d


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 -> float32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform4(seed, pixel_id, sample_id, slot):
    """Four independent U[0,1) draws for counter (pixel, sample, slot)."""
    a, b, c, d = pcg4d(pixel_id, sample_id, slot, seed)
    return (_to_unit_float(a), _to_unit_float(b),
            _to_unit_float(c), _to_unit_float(d))


def unit_vector_from_uniforms(u1, u2):
    """Uniform direction on S^2 from two uniforms; (..., 3).

    Replaces ``Vec3RandUnitVector`` (gpu_kernel.cl:198-201)."""
    z = 2.0 * u1 - 1.0
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(fma(-z, z, 1.0), min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere_from_uniforms(u1, u2, u3):
    """Uniform point in the unit ball (``Vec3RandInUnitSphere``).

    The radius is u3 ** (1/3): PyTorch has no cube root."""
    return unit_vector_from_uniforms(u1, u2) * torch.pow(u3, 1.0 / 3.0)[..., None]


def in_unit_disk_from_uniforms(u1, u2):
    """Uniform point in the unit disk, z = 0 (``Vec3RandInUnitDisk``)."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)
