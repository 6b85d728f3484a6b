"""Sky models: the RTiOW gradient (the dead-code vestige at
``gpu_kernel.cl:268-269``), a constant colour, and the reference's
equirectangular HDR lookup (``gpu_kernel.cl:342-347`` via ``Vec3ToUV``,
``:234-241``).  ``kind`` selects."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._fp import atan2, dot3, fma, sqrt
from .geometry import tensors_to

KIND_GRADIENT = 0
KIND_HDR = 1
KIND_CONST = 2

# float32 1/(2 pi) and 1/pi: XLA turns the lookup's divisions by 2 pi and
# pi into multiplications by these, fused with the add of 0.5
INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))
INV_PI = float(np.float32(1.0 / np.pi))


@dataclasses.dataclass(frozen=True)
class Sky:
    """image: (H,W,3) f32 for HDR skies (a 1x1 dummy otherwise);
    const_colour: (3,) for constant skies; kind: one of KIND_*."""

    image: torch.Tensor
    const_colour: torch.Tensor
    kind: int = KIND_GRADIENT

    def to(self, device) -> "Sky":
        return tensors_to(self, device)

    @staticmethod
    def gradient() -> "Sky":
        return Sky(torch.zeros((1, 1, 3)), torch.zeros((3,)), KIND_GRADIENT)

    @staticmethod
    def hdr(image) -> "Sky":
        return Sky(torch.as_tensor(image, dtype=torch.float32),
                   torch.zeros((3,)), KIND_HDR)

    @staticmethod
    def constant(colour) -> "Sky":
        return Sky(torch.zeros((1, 1, 3)),
                   torch.as_tensor(colour, dtype=torch.float32), KIND_CONST)


def _unit(d):
    return d / torch.sqrt(dot3(d, d))[..., None]


def direction_to_uv(d):
    """Equirect direction -> (u, v) (Vec3ToUV, gpu_kernel.cl:234-241).
    d: (..., 3), need not be normalized.

    The forms are those XLA compiles the JAX package's lookup to, so that
    both pick the same texel: d / sqrt(fma chain of |d|^2) with an IEEE
    root, u = fma(atan2(z, x), f32(1/(2 pi)), 0.5), arcsin(y) =
    2 atan2(y, 1 + sqrt((1 - y)(1 + y))) and v = fma(arcsin(y), -f32(1/pi),
    0.5); ``csrc/common.cuh::hdr_texel`` computes the same on the card."""
    n = d / sqrt(dot3(d, d))[..., None]
    u = fma(atan2(n[..., 2], n[..., 0]), INV_TWO_PI, 0.5)
    y = torch.clamp(n[..., 1], -1.0, 1.0)
    asin = 2.0 * atan2(y, 1.0 + sqrt((1.0 - y) * (1.0 + y)))
    v = fma(asin, -INV_PI, 0.5)
    return u, v


def texel_index(image, d):
    """(y, x) int64 indices of the texels the HDR lookup reads for the
    directions d (..., 3): x = int(u*W), y = int(v*H), truncated toward zero
    and clamped to the image (the reference reads out of bounds at u == 1).
    The index has no derivative in d."""
    h, w = image.shape[0], image.shape[1]
    u, v = direction_to_uv(d.detach())
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return y, x


def sky_colour(sky: Sky, d):
    """Radiance for a miss ray with direction d (..., 3)."""
    if sky.kind == KIND_GRADIENT:
        t = 0.5 * (_unit(d)[..., 1] + 1.0)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
        # (1 - t) * white + t * blue, with white = 1
        return fma(t[..., None], blue, (1.0 - t)[..., None])
    if sky.kind == KIND_CONST:
        return sky.const_colour.to(d.device).expand(d.shape[:-1] + (3,))
    y, x = texel_index(sky.image, d)
    return sky.image[y, x]
