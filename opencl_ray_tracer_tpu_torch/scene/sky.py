"""Sky models: the RTiOW gradient (the dead-code vestige at
``gpu_kernel.cl:268-269``), a constant colour, and the reference's
equirectangular HDR lookup (``gpu_kernel.cl:342-347`` via ``Vec3ToUV``,
``:234-241``).  ``kind`` selects."""

from __future__ import annotations

import dataclasses
import math

import torch

from .._fp import dot3, fma
from .geometry import tensors_to

KIND_GRADIENT = 0
KIND_HDR = 1
KIND_CONST = 2


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
    d: (..., 3), need not be normalized."""
    n = _unit(d)
    u = 0.5 + torch.atan2(n[..., 2], n[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(n[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def sky_colour(sky: Sky, d):
    """Radiance for a miss ray with direction d (..., 3)."""
    if sky.kind == KIND_GRADIENT:
        t = 0.5 * (_unit(d)[..., 1] + 1.0)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
        # (1 - t) * white + t * blue, with white = 1
        return fma(t[..., None], blue, (1.0 - t)[..., None])
    if sky.kind == KIND_CONST:
        return sky.const_colour.to(d.device).expand(d.shape[:-1] + (3,))
    # HDR lookup: x = int(u*W), y = int(v*H), truncated toward zero and
    # clamped to the image (the reference reads out of bounds at u == 1).
    h, w = sky.image.shape[0], sky.image.shape[1]
    u, v = direction_to_uv(d)
    x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
    y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return sky.image[y, x]
