"""Floating-point helpers of the plain reference.

A frozen copy of the rounding rules the path tracer's plain version
follows (fused multiply-adds where XLA fuses, IEEE divisions by constants,
correctly rounded roots, libm's float32 transcendentals on the CPU), so
that the reference agrees with the program to rounding.  Every helper
keeps the floating type of its first tensor argument: the reference runs
in float32, and its control in bfloat16.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np
import torch


def fma(a, b, c):
    """a * b + c with one rounding to a's type."""
    return (a.to(torch.float64) * b + c).to(a.dtype)


def div(x, s):
    """x / s for a Python number s, as an IEEE division on every device."""
    return x / torch.tensor(s, dtype=x.dtype, device=x.device)


def sqrt(x):
    """The correctly rounded square root on every device."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def atan2(y, x):
    """atan2: CUDA's on the card, glibc's on the CPU (ATen's CPU kernel
    calls it on operands with a non-unit stride)."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    y, x = torch.broadcast_tensors(y, x)
    ys = torch.empty(y.shape + (2,), dtype=y.dtype)[..., 0]
    xs = torch.empty(x.shape + (2,), dtype=x.dtype)[..., 0]
    ys.copy_(y)
    xs.copy_(x)
    return torch.atan2(ys, xs).contiguous()


_GLIBC: dict = {}


def _glibc(name: str, nargs: int):
    if name not in _GLIBC:
        fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
        fn.argtypes = [ctypes.c_float] * nargs
        fn.restype = ctypes.c_float
        _GLIBC[name] = np.frompyfunc(fn, nargs, 1)
    return _GLIBC[name]


def _libm(x, op, name, *extra):
    """op(x) on the card and outside float32; glibc's float32 ``name`` per
    element on the CPU, with op's gradient where x requires one."""
    t = op(x)
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return t
    vals = _glibc(name, 1 + len(extra))(x.detach().numpy(), *extra)
    g = torch.from_numpy(np.asarray(vals, dtype=np.float32).reshape(x.shape))
    return t + (g - t).detach() if t.requires_grad else g


def sin(x):
    return _libm(x, torch.sin, "sinf")


def cos(x):
    return _libm(x, torch.cos, "cosf")


def tan(x):
    return _libm(x, torch.tan, "tanf")


_THIRD = np.float32(1.0 / 3.0)


def cbrt(x):
    """powf(x, 1/3)."""
    return _libm(x, lambda v: torch.pow(v, 1.0 / 3.0), "powf", _THIRD)


def dot3(a, b):
    """Dot product over the last axis of size 3, as an fma chain."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1],
                                         a[..., 0] * b[..., 0]))


def cross(a, b):
    """Cross product over the last axis, each component fma(p, q, -(r*s))."""
    return torch.stack([fma(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                        fma(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                        fma(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))],
                       dim=-1)


def clip01(x):
    """min(max(x, 0), 1): NaN passes."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)
