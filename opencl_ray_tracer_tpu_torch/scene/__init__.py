"""Scene data model: dataclasses of tensors (structure of arrays).

``Scene.to(device)`` moves every leaf.  ``scene_from_numpy`` builds a scene
from flat ``"group.field"`` numpy leaves, the form in which a scene made by
another program (the JAX package, a file) is carried across, and
``scene_to_numpy`` gives them back.  Leaves are addressed by the same
``"group.field"`` paths for gradients: ``requiring_grad`` copies a scene
with float leaves that require grad (the frozen dataclasses are never
changed in place), and ``gradient_scene`` packs gradients into a Scene whose
integer leaves are None.
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


def _leaf_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_to_numpy(scene) -> dict:
    """Flat ``"group.field"`` numpy leaves of a scene or of a gradient scene,
    the inverse of ``scene_from_numpy``.  Any tree of dataclasses with these
    group and field names converts, the JAX package's scenes and gradient
    trees included.  The sky's kind, None leaves and JAX's float0 leaves
    (the cotangents of integer leaves) are left out."""
    out = {}
    for group, cls in _GROUPS:
        obj = getattr(scene, group)
        for f in dataclasses.fields(cls):
            value = getattr(obj, f.name, None)
            if f.name == "kind" or value is None:
                continue
            arr = _leaf_numpy(value)
            if arr.dtype.kind != "V":
                out[f"{group}.{f.name}"] = arr
    return out


def get_leaf(scene: Scene, path: str):
    """The leaf at ``"group.field"``."""
    group, field = path.split(".")
    return getattr(getattr(scene, group), field)


def replace_leaves(scene: Scene, leaves: dict) -> Scene:
    """A copy of scene with the ``"group.field"`` leaves replaced."""
    by_group = {}
    for path, value in leaves.items():
        group, field = path.split(".")
        by_group.setdefault(group, {})[field] = value
    return dataclasses.replace(scene, **{
        group: dataclasses.replace(getattr(scene, group), **fields)
        for group, fields in by_group.items()})


def float_leaves(scene: Scene) -> dict:
    """The scene's floating-point tensor leaves by ``"group.field"``."""
    out = {}
    for group, cls in _GROUPS:
        obj = getattr(scene, group)
        for f in dataclasses.fields(cls):
            value = getattr(obj, f.name)
            if isinstance(value, torch.Tensor) and value.is_floating_point():
                out[f"{group}.{f.name}"] = value
    return out


def requiring_grad(scene: Scene) -> Scene:
    """A copy of scene whose float leaves are detached copies that require
    grad."""
    return replace_leaves(scene, {
        path: value.detach().clone().requires_grad_()
        for path, value in float_leaves(scene).items()})


def detached(scene: Scene) -> Scene:
    """A copy of scene whose float leaves are detached from autograd."""
    return replace_leaves(scene, {path: value.detach() for path, value in
                                  float_leaves(scene).items()})


def gradient_scene(scene: Scene, grads: dict) -> Scene:
    """A Scene of gradients: float leaves from ``grads`` by
    ``"group.field"`` (zeros where a leaf has none), integer leaves None."""
    leaves = {}
    for group, cls in _GROUPS:
        obj = getattr(scene, group)
        for f in dataclasses.fields(cls):
            value = getattr(obj, f.name)
            if not isinstance(value, torch.Tensor):
                continue
            path = f"{group}.{f.name}"
            if not value.is_floating_point():
                leaves[path] = None
            elif grads.get(path) is None:
                leaves[path] = torch.zeros_like(value)
            else:
                leaves[path] = grads[path]
    return replace_leaves(scene, leaves)


from .presets import (book_cover_scene, flagship_scene,  # noqa: E402
                      readme_scene, reference_scene)
from .builder import scene_from_json, scene_to_json  # noqa: E402

__all__ = [
    "Scene", "Camera", "Spheres", "Triangles", "BoundingBoxes", "Sky",
    "camera_frame", "make_rays", "rays_from_frame", "sky_colour",
    "direction_to_uv", "materials", "readme_scene", "reference_scene",
    "book_cover_scene", "flagship_scene", "scene_from_numpy", "scene_to_numpy", "get_leaf",
    "replace_leaves", "float_leaves", "requiring_grad", "detached",
    "gradient_scene",
    "scene_from_json", "scene_to_json",
]
