"""Scene geometry: structure-of-arrays dataclasses of tensors.

The reference passes array-of-structs buffers to the device
(``src/cpp/opencl_objects/*``, mirrored at ``gpu_kernel.cl:3-69``); here each
field is one contiguous (N,) or (N,3) tensor.  A triangle is tested only
when the ray hits the bounding box its ``box_id`` names
(``gpu_kernel.cl:374-391``); ``tracer.intersect`` and the mesh kernels
intersect both.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

_F32 = torch.float32
_I32 = torch.int32


def tensors_to(obj, device):
    """A copy of a dataclass of tensors with every tensor field on device."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class Spheres:
    """Sphere batch (reference ``cl_sphere.hpp:7-13``).

    center: (N,3) f32; radius: (N,) f32; albedo: (N,3) f32;
    fuzz/ior: (N,) f32; mat_type: (N,) i32.
    """

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat_type: torch.Tensor

    @property
    def count(self) -> int:
        return self.center.shape[0]

    def to(self, device) -> "Spheres":
        return tensors_to(self, device)

    @staticmethod
    def empty() -> "Spheres":
        z = torch.zeros((0,), dtype=_F32)
        v = torch.zeros((0, 3), dtype=_F32)
        return Spheres(v, z, v, z, z, torch.zeros((0,), dtype=_I32))

    @staticmethod
    def from_list(entries: Sequence[tuple]) -> "Spheres":
        """entries: (center(3,), radius, albedo(3,), fuzz, ior, mat_type)."""
        if not entries:
            return Spheres.empty()
        c, r, a, f, i, t = zip(*entries)
        return Spheres(
            torch.tensor(np.array(c), dtype=_F32),
            torch.tensor(np.array(r), dtype=_F32),
            torch.tensor(np.array(a), dtype=_F32),
            torch.tensor(np.array(f), dtype=_F32),
            torch.tensor(np.array(i), dtype=_F32),
            torch.tensor(np.array(t), dtype=_I32),
        )


@dataclasses.dataclass(frozen=True)
class Triangles:
    """Triangle batch (reference ``cl_triangle.hpp:7-14``).

    p0/p1/p2: (T,3) f32; albedo (T,3); fuzz/ior (T,); mat_type (T,) i32;
    box_id (T,) i32, the bounding box that gates the triangle.
    """

    p0: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat_type: torch.Tensor
    box_id: torch.Tensor

    @property
    def count(self) -> int:
        return self.p0.shape[0]

    def to(self, device) -> "Triangles":
        return tensors_to(self, device)

    @staticmethod
    def empty() -> "Triangles":
        v = torch.zeros((0, 3), dtype=_F32)
        z = torch.zeros((0,), dtype=_F32)
        zi = torch.zeros((0,), dtype=_I32)
        return Triangles(v, v, v, v, z, z, zi, zi)

    @staticmethod
    def from_vertices(tri_verts, albedo, fuzz, ior, mat_type,
                      box_id=0) -> "Triangles":
        """tri_verts: (T,3,3) triangle corners; one shared material, as the
        reference gives each mesh (``utility.cpp:99``)."""
        tv = torch.as_tensor(np.asarray(tri_verts), dtype=_F32)
        t = tv.shape[0]
        return Triangles(
            tv[:, 0].clone(), tv[:, 1].clone(), tv[:, 2].clone(),
            torch.tensor(albedo, dtype=_F32).expand(t, 3).clone(),
            torch.full((t,), float(np.float32(fuzz)), dtype=_F32),
            torch.full((t,), float(np.float32(ior)), dtype=_F32),
            torch.full((t,), int(mat_type), dtype=_I32),
            torch.full((t,), int(box_id), dtype=_I32))


@dataclasses.dataclass(frozen=True)
class BoundingBoxes:
    """AABB batch (reference ``cl_bounding_box.hpp:6-11``); (B,3) f32."""

    box_min: torch.Tensor
    box_max: torch.Tensor

    @property
    def count(self) -> int:
        return self.box_min.shape[0]

    def to(self, device) -> "BoundingBoxes":
        return tensors_to(self, device)

    @staticmethod
    def empty() -> "BoundingBoxes":
        v = torch.zeros((0, 3), dtype=_F32)
        return BoundingBoxes(v, v)

    @staticmethod
    def single(box_min, box_max) -> "BoundingBoxes":
        return BoundingBoxes(
            torch.as_tensor(np.asarray(box_min), dtype=_F32)[None].clone(),
            torch.as_tensor(np.asarray(box_max), dtype=_F32)[None].clone())
