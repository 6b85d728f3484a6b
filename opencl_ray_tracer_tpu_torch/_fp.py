"""Float32 helpers shared by the plain tracer and mirrored by the CUDA kernel.

The JAX package's tracer, compiled by XLA, evaluates a dot product as a
chain of fused multiply-adds, fma(z, z', fma(y, y', x * x')), and
``p*q - r*s`` as fma(p, q, -(r*s)).  The plain tracer does the same, so
that it agrees with the JAX reference where a sphere test cancels (the
book cover's ground sphere of radius 1000 makes |oc|^2 - r^2 a difference
of two numbers near 1e6), and the CUDA kernel calls ``fmaf`` at the same
places.  ``fma`` rounds once: a product of two float32 values is exact in
float64.
"""

from __future__ import annotations

import torch


def fma(a, b, c):
    """a * b + c with one rounding to float32."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def div(x, s):
    """x / s for a Python number s, as an IEEE division on every device:
    on CUDA, ATen turns a division by a Python scalar into a
    multiplication by its reciprocal, which the kernel does not do."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def dot3(a, b):
    """Dot product over the last axis of size 3, as an fma chain."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def clip01(x):
    """Clamp to [0, 1] as ``jnp.clip`` (min of max): NaN passes, and at a
    tie with 0 or 1 the gradient is halved, where ``torch.clamp`` would pass
    it whole."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)
