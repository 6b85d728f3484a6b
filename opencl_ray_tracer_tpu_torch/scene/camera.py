"""Look-at camera.

- ``camera_frame`` is ``CalculateCamera`` (``cl_camera.cpp:3-44``), with the
  reference's quirk that the aperture is given in **degrees** and converted
  to radians (``cl_camera.cpp:6``): ``defocusRadius = focusDist *
  tan(aperture_rad / 2)`` (``:27``).
- ``make_rays`` is the device-side ``GetRay`` (``gpu_kernel.cl:559-578``):
  a pinhole when the aperture is <= 0, else the origin is jittered on the
  defocus disc.
"""

from __future__ import annotations

import dataclasses

import torch

from .._fp import dot3, fma, tan
from ..rng import in_unit_disk_from_uniforms
from .geometry import tensors_to

# The reference's pi literal.
_DEG = float(3.141592654 / 180.0)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters: (3,) f32 vectors and 0-d f32 scalars."""

    look_from: torch.Tensor
    look_at: torch.Tensor
    vup: torch.Tensor
    vfov_deg: torch.Tensor
    aspect_ratio: torch.Tensor
    focus_dist: torch.Tensor
    aperture_deg: torch.Tensor

    def to(self, device) -> "Camera":
        return tensors_to(self, device)

    @staticmethod
    def create(look_from, look_at, vup=(0.0, 1.0, 0.0), vfov_deg=60.0,
               aspect_ratio=16.0 / 9.0, focus_dist=2.0,
               aperture_deg=1.2) -> "Camera":
        def f32(x):
            return torch.tensor(x, dtype=torch.float32)
        return Camera(f32(look_from), f32(look_at), f32(vup), f32(vfov_deg),
                      f32(aspect_ratio), f32(focus_dist), f32(aperture_deg))


def _cross(a, b):
    return torch.stack([fma(a[1], b[2], -(a[2] * b[1])),
                        fma(a[2], b[0], -(a[0] * b[2])),
                        fma(a[0], b[1], -(a[1] * b[0]))])


def _unit(v):
    return v / torch.sqrt(dot3(v, v))


def camera_frame(cam: Camera) -> dict:
    """Derived camera quantities (CalculateCamera, cl_camera.cpp:3-44):
    origin, horizontal, vertical, lower_left_corner, defocus_disc_u,
    defocus_disc_v (all (3,)) and aperture_rad (0-d)."""
    aperture = cam.aperture_deg * _DEG          # cl_camera.cpp:6
    theta = cam.vfov_deg * _DEG                 # cl_camera.cpp:9
    h = tan(theta / 2.0)
    viewport_h = 2.0 * h * cam.focus_dist       # cl_camera.cpp:11
    viewport_w = cam.aspect_ratio * viewport_h

    w = _unit(cam.look_from - cam.look_at)      # cl_camera.cpp:15-17
    u = _unit(_cross(cam.vup, w))
    v = _cross(w, u)

    horizontal = u * viewport_w                 # cl_camera.cpp:20-21
    vertical = v * viewport_h
    lower_left = fma(-w, cam.focus_dist,        # cl_camera.cpp:24
                     cam.look_from - horizontal / 2.0 - vertical / 2.0)
    defocus_radius = cam.focus_dist * tan(aperture / 2.0)  # :27
    return dict(
        origin=cam.look_from,
        horizontal=horizontal,
        vertical=vertical,
        lower_left_corner=lower_left,
        defocus_disc_u=u * defocus_radius,
        defocus_disc_v=v * defocus_radius,
        aperture_rad=aperture,
    )


def rays_from_frame(frame: dict, uu, vv, lens_u1, lens_u2):
    """GetRay from a precomputed ``camera_frame``; see ``make_rays``."""
    p = in_unit_disk_from_uniforms(lens_u1, lens_u2)
    lens_offset = fma(frame["defocus_disc_v"], p[..., 1:2],
                      frame["defocus_disc_u"] * p[..., 0:1])
    origin = torch.where(frame["aperture_rad"] > 0.0,
                         frame["origin"] + lens_offset,
                         frame["origin"].expand(lens_offset.shape))
    target = fma(frame["vertical"], vv[..., None],
                 fma(frame["horizontal"], uu[..., None],
                     frame["lower_left_corner"]))
    return origin, target - origin


def make_rays(cam: Camera, uu, vv, lens_u1, lens_u2):
    """Camera rays (GetRay, gpu_kernel.cl:559-578).

    uu, vv: (...,) viewport coordinates in [0,1] (v = 0 at the image
    bottom); lens_u1/u2: (...,) uniforms for the defocus-disc sample.
    Returns (origin, direction), each (..., 3); the direction is not
    normalized, as in the reference.
    """
    return rays_from_frame(camera_frame(cam), uu, vv, lens_u1, lens_u2)
