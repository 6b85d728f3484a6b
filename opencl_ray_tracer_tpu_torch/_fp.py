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


def sqrt(x):
    """IEEE float32 square root on every device: ATen's vectorised CPU sqrt
    is an approximation that misses the correctly rounded value in 0.65% of
    arguments, so on the CPU the float64 root is rounded to float32; ATen's
    CUDA sqrt is already correctly rounded, as a kernel's ``sqrtf``."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def atan2(y, x):
    """atan2(y, x) as XLA computes it: on the CPU glibc's ``atan2f``, which
    XLA:CPU calls and ATen's CPU kernel calls on operands with a non-unit
    stride (on contiguous ones it takes a SIMD approximation that differs
    in 15% of arguments); on CUDA, ATen's ``atan2``, which is CUDA's
    ``atan2f`` as a kernel calls it."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    y, x = torch.broadcast_tensors(y, x)
    ys = torch.empty(y.shape + (2,), dtype=y.dtype)[..., 0]
    xs = torch.empty(x.shape + (2,), dtype=x.dtype)[..., 0]
    ys.copy_(y)
    xs.copy_(x)
    return torch.atan2(ys, xs).contiguous()


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
