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

import ctypes
import ctypes.util

import numpy as np
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


_GLIBC: dict = {}


def _glibc(name: str, nargs: int = 1):
    """libm's float32 function ``name`` as a numpy ufunc over Python
    floats, one call per element."""
    if name not in _GLIBC:
        fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
        fn.argtypes = [ctypes.c_float] * nargs
        fn.restype = ctypes.c_float
        _GLIBC[name] = np.frompyfunc(fn, nargs, 1)
    return _GLIBC[name]


def _libm(x, op, name, *extra):
    """op(x) on CUDA; on the CPU glibc's ``name`` per element (what
    XLA:CPU calls; ATen's vectorised CPU sin, cos, tan and pow differ from
    it in 1.5 to 5% of arguments), with op's gradient where x requires
    one."""
    t = op(x)
    if x.device.type != "cpu":
        return t
    vals = _glibc(name, 1 + len(extra))(x.detach().numpy(), *extra)
    g = torch.from_numpy(np.asarray(vals, dtype=np.float32).reshape(x.shape))
    return t + (g - t).detach() if t.requires_grad else g


def sin(x):
    """sin as XLA computes it: glibc's ``sinf`` on the CPU, CUDA's on the
    card."""
    return _libm(x, torch.sin, "sinf")


def cos(x):
    """cos as XLA computes it (glibc's ``cosf`` on the CPU)."""
    return _libm(x, torch.cos, "cosf")


def tan(x):
    """tan as XLA computes it (glibc's ``tanf`` on the CPU)."""
    return _libm(x, torch.tan, "tanf")


_THIRD = np.float32(1.0 / 3.0)


def cbrt(x):
    """The cube root as XLA:CPU computes ``cbrt``, ``powf(x, 1/3)`` (glibc's
    on the CPU); on the card ``torch.pow(x, 1/3)``, as the backward kernels'
    ``powf``."""
    return _libm(x, lambda v: torch.pow(v, 1.0 / 3.0), "powf", _THIRD)


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
