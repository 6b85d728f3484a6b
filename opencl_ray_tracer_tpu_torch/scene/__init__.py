"""Scene data model: dataclasses of tensors (structure of arrays).

``Scene.to(device)`` moves every leaf.  ``scene_from_numpy`` builds a scene
from flat ``"group.field"`` numpy leaves, the form in which a scene made by
another program (the JAX package, a file) is carried across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import materials
from .camera import Camera, camera_frame, make_rays, rays_from_frame
from .geometry import BoundingBoxes, Spheres, Triangles
from .sky import Sky, direction_to_uv, sky_colour


@dataclasses.dataclass(frozen=True)
class Scene:
    camera: Camera
    spheres: Spheres
    triangles: Triangles
    boxes: BoundingBoxes
    sky: Sky

    def to(self, device) -> "Scene":
        return Scene(*(getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)))


_GROUPS = (("camera", Camera), ("spheres", Spheres),
           ("triangles", Triangles), ("boxes", BoundingBoxes), ("sky", Sky))


def scene_from_numpy(leaves: dict, kind: int, device="cpu") -> Scene:
    """Scene from numpy leaves keyed ``"camera.look_from"``, ...,
    ``"spheres.center"``, ..., ``"sky.const_colour"``; ``kind`` is the
    sky kind (``sky.KIND_*``).  Integer leaves become int32, the rest
    float32.  Every field of every group must be present."""
    groups = {}
    for group, cls in _GROUPS:
        vals = {}
        for f in dataclasses.fields(cls):
            if f.name == "kind":
                continue
            arr = np.asarray(leaves[f"{group}.{f.name}"])
            dtype = (torch.int32 if np.issubdtype(arr.dtype, np.integer)
                     else torch.float32)
            vals[f.name] = torch.tensor(arr, dtype=dtype, device=device)
        if cls is Sky:
            vals["kind"] = int(kind)
        groups[group] = cls(**vals)
    return Scene(**groups)


from .presets import book_cover_scene, readme_scene, reference_scene  # noqa: E402

__all__ = [
    "Scene", "Camera", "Spheres", "Triangles", "BoundingBoxes", "Sky",
    "camera_frame", "make_rays", "rays_from_frame", "sky_colour",
    "direction_to_uv", "materials", "readme_scene", "reference_scene",
    "book_cover_scene", "scene_from_numpy",
]
