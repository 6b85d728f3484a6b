"""Counter-based random numbers of the reference: the pcg4d hash (Jarzynski
and Olano, "Hash Functions for GPU Rendering", JCGT 2020) keyed on (pixel,
sample, slot, seed), and the samplers built on it.  A frozen copy of the
path tracer's draws: every uniform is a pure function of its counters, so
the reference draws what the program draws for any pixel and sample,
whatever order either computes them in.
"""

from __future__ import annotations

import math

import torch

from .fp import cbrt, cos, fma, sin

SLOT_PIXEL_U = 0
BOUNCE_BASE = 4
BOUNCE_STRIDE = 2

_MASK = 0xFFFFFFFF
_MUL = 1664525
_INC = 1013904223


def _mul32(x, y):
    """(x * y) mod 2^32 for x, y in [0, 2^32), held in int64."""
    lo = (x & 0xFFFF) * y
    hi = ((x >> 16) * y) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def pcg4d(a, b, c, d):
    """Four uint32 values (int64 tensors or ints) in, four out."""
    device = next(x.device for x in (a, b, c, d)
                  if isinstance(x, torch.Tensor))
    a, b, c, d = (torch.as_tensor(x, dtype=torch.int64, device=device)
                  & _MASK for x in (a, b, c, d))
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


def uniform4(seed, pixel_id, sample_id, slot, dtype=torch.float32):
    """Four U[0,1) draws from the top 24 bits of each hash output."""
    return tuple((x >> 8).to(dtype) * (1.0 / (1 << 24))
                 for x in pcg4d(pixel_id, sample_id, slot, seed))


def bounce_uniforms(seed, pixel_id, sample_id, depth, dtype=torch.float32):
    """The eight uniforms of one bounce, (R, 8): two hashes."""
    slot = BOUNCE_BASE + depth * BOUNCE_STRIDE
    a = uniform4(seed, pixel_id, sample_id, slot, dtype)
    b = uniform4(seed, pixel_id, sample_id, slot + 1, dtype)
    return torch.stack(a + b, dim=-1)


def unit_vector(u1, u2):
    """Uniform direction on the sphere, (..., 3)."""
    z = 2.0 * u1 - 1.0
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp(fma(-z, z, 1.0), min=0.0))
    return torch.stack([r * cos(phi), r * sin(phi), z], dim=-1)


def in_unit_sphere(u1, u2, u3):
    """Uniform point in the unit ball: radius powf(u3, 1/3)."""
    return unit_vector(u1, u2) * cbrt(u3)[..., None]


def in_unit_disk(u1, u2):
    """Uniform point in the unit disk, z = 0."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    return torch.stack([r * cos(theta), r * sin(theta),
                        torch.zeros_like(r)], dim=-1)
