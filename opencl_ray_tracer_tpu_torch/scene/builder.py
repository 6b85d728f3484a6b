"""JSON scene descriptor, the schema of the JAX package's
``scene/builder.py`` (the reference's own to-do item, ``README.md:56``).

{
  "camera": {"look_from": [x,y,z], "look_at": [x,y,z], "vup": [0,1,0],
             "vfov_deg": 60, "aspect_ratio": 1.7777, "focus_dist": 2.0,
             "aperture_deg": 1.2},
  "spheres": [{"center": [..], "radius": r, "albedo": [..], "fuzz": f,
               "ior": i, "material": "lambertian|metal|dielectric|emissive"}],
  "meshes": [{"path": "model.obj", "scale": [..], "translate": [..],
              "albedo": [..], "fuzz": f, "ior": i, "material": "metal"}],
  "sky": {"kind": "gradient"} | {"kind": "const", "colour": [r,g,b]}
        | {"kind": "hdr", "path": "sky.hdr", "tonemap": true}
}

Every field is optional, with the reference's defaults.  Mesh ``i`` is
gated by bounding box ``i``, the AABB of its transformed vertices
(``main.cpp:119-120``).  An HDR sky's path is relative to the same base
directory; ``tonemap`` (default true) applies the reference's tone map.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import Scene
from . import materials as mat
from .camera import Camera
from .geometry import BoundingBoxes, Spheres, Triangles
from .sky import Sky


def _mat_type(name) -> int:
    if isinstance(name, int):
        return name
    return mat.MATERIAL_NAMES[str(name).lower()]


def scene_from_json(source: str, base_dir: str | None = None) -> Scene:
    """A Scene from a JSON string or the path of a JSON file; mesh and HDR
    paths are relative to base_dir (default: the file's directory, or
    ".")."""
    if os.path.exists(source):
        base_dir = base_dir or os.path.dirname(os.path.abspath(source))
        with open(source) as f:
            spec = json.load(f)
    else:
        spec = json.loads(source)
        base_dir = base_dir or "."

    cam_spec = spec.get("camera", {})
    camera = Camera.create(
        look_from=cam_spec.get("look_from", (-1.3, 0.2, 0.5)),
        look_at=cam_spec.get("look_at", (0.2, 0.0, -1.5)),
        vup=cam_spec.get("vup", (0.0, 1.0, 0.0)),
        vfov_deg=cam_spec.get("vfov_deg", 60.0),
        aspect_ratio=cam_spec.get("aspect_ratio", 16.0 / 9.0),
        focus_dist=cam_spec.get("focus_dist", 2.0),
        aperture_deg=cam_spec.get("aperture_deg", 1.2),
    )

    spheres = Spheres.from_list([
        (tuple(s["center"]), float(s["radius"]),
         tuple(s.get("albedo", (1.0, 1.0, 1.0))), float(s.get("fuzz", 0.0)),
         float(s.get("ior", 0.0)), _mat_type(s.get("material", "lambertian")))
        for s in spec.get("spheres", [])])

    sky_spec = spec.get("sky", {"kind": "gradient"})
    kind = sky_spec.get("kind", "gradient")
    if kind == "gradient":
        sky = Sky.gradient()
    elif kind == "const":
        sky = Sky.constant(sky_spec.get("colour", (1.0, 1.0, 1.0)))
    elif kind == "hdr":
        from ..io.hdr import load_hdr, tone_map
        img = load_hdr(os.path.join(base_dir, sky_spec["path"]))
        if sky_spec.get("tonemap", True):
            img = tone_map(img)
        sky = Sky.hdr(img)
    else:
        raise ValueError(f"unknown sky kind: {kind}")

    tris, boxes = Triangles.empty(), BoundingBoxes.empty()
    mesh_specs = spec.get("meshes", [])
    if mesh_specs:
        from ..io.obj import load_obj
        parts, lo, hi = [], [], []
        for box_id, m in enumerate(mesh_specs):
            verts, aabb = load_obj(
                os.path.join(base_dir, m["path"]),
                scale=m.get("scale", (1.0, 1.0, 1.0)),
                translate=m.get("translate", (0.0, 0.0, 0.0)))
            parts.append(Triangles.from_vertices(
                verts, albedo=m.get("albedo", (0.8, 0.6, 0.2)),
                fuzz=m.get("fuzz", 0.0), ior=m.get("ior", 0.0),
                mat_type=_mat_type(m.get("material", "metal")),
                box_id=box_id))
            lo.append(np.asarray(aabb[0], np.float32))
            hi.append(np.asarray(aabb[1], np.float32))
        tris = Triangles(*(torch.cat([getattr(p, name) for p in parts])
                           for name in Triangles.__dataclass_fields__))
        boxes = BoundingBoxes(torch.tensor(np.stack(lo)),
                              torch.tensor(np.stack(hi)))
    return Scene(camera, spheres, tris, boxes, sky)


def scene_to_json(scene: Scene) -> str:
    """The camera, spheres and sky kind of a Scene in the JSON schema.
    Meshes are file-backed and, as in the JAX package, not written;
    sphere scenes round-trip exactly."""
    cam = scene.camera

    def vec(x):
        return x.detach().cpu().numpy().tolist()

    def num(x):
        return float(x.detach().cpu())

    s = scene.spheres
    spec = {
        "camera": {
            "look_from": vec(cam.look_from),
            "look_at": vec(cam.look_at),
            "vup": vec(cam.vup),
            "vfov_deg": num(cam.vfov_deg),
            "aspect_ratio": num(cam.aspect_ratio),
            "focus_dist": num(cam.focus_dist),
            "aperture_deg": num(cam.aperture_deg),
        },
        "spheres": [
            {"center": vec(s.center[i]), "radius": num(s.radius[i]),
             "albedo": vec(s.albedo[i]), "fuzz": num(s.fuzz[i]),
             "ior": num(s.ior[i]), "material": int(s.mat_type[i])}
            for i in range(s.count)],
        "sky": {"kind": ["gradient", "hdr", "const"][scene.sky.kind]},
    }
    return json.dumps(spec, indent=2)
