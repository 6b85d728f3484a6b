"""Built-in sphere scenes, value for value those of the JAX package.

- ``readme_scene``: the reference README benchmark scene
  (``README.md:30-38``): 5 spheres, gradient sky.
- ``reference_scene``: the 8 spheres, camera and (given its triangles) the
  mesh in its gating box hardcoded in ``main.cpp:80-133``.
- ``book_cover_scene``: the RTiOW random-spheres scene, deterministic in
  its seed.
- ``flagship_scene``: the reference executable's default render, the
  reference scene with its mesh and a tone-mapped HDR sky, from assets.
"""

from __future__ import annotations

import numpy as np

from . import materials as mat
from .camera import Camera
from .geometry import BoundingBoxes, Spheres, Triangles
from .sky import Sky
from . import Scene


def _scene(camera, spheres, sky=None):
    return Scene(camera, spheres, Triangles.empty(), BoundingBoxes.empty(),
                 sky if sky is not None else Sky.gradient())


def readme_scene(aspect_ratio: float = 16.0 / 9.0):
    """README.md:32-38 scene with the RTiOW front view (pinhole)."""
    spheres = Spheres.from_list([
        ((0.0, -100.5, -1.0), 100.0, (0.0, 0.8, 0.7), 0.0, 0.0, mat.LAMBERTIAN),
        ((0.0, 0.5, -1.0), 0.5, (1.0, 0.5, 0.3), 0.0, 0.0, mat.LAMBERTIAN),
        ((-0.9, 0.0, -1.0), 0.5, (0.8, 0.5, 0.5), 0.1, 0.0, mat.METAL),
        ((0.9, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.5, 0.0, mat.METAL),
        ((0.0, -0.3, -1.0), 0.2, (0.8, 0.8, 0.8), 0.0, 0.0, mat.METAL),
    ])
    camera = Camera.create(
        look_from=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, -1.0),
        vfov_deg=90.0, aspect_ratio=aspect_ratio,
        focus_dist=1.0, aperture_deg=0.0)
    return _scene(camera, spheres)


def reference_scene(aspect_ratio: float = 16.0 / 9.0, mesh_tris=None,
                    mesh_aabb=None, sky=None):
    """The scene of main.cpp:80-133.  mesh_tris: optional (T,3,3) triangle
    corners (``io.load_obj``), in one gating box mesh_aabb = (min(3,),
    max(3,)), with the reference's mesh material (fuzzy metal,
    main.cpp:127); gradient sky unless ``sky`` is given."""
    spheres = Spheres.from_list([
        # main.cpp:100-107
        ((0.0, -100.5, -1.0), 100.0, (0.3, 0.5, 0.4), 0.0, 0.0, mat.LAMBERTIAN),
        ((1.6, 0.0, -1.3), 0.5, (0.7, 0.3, 0.9), 0.0, 0.0, mat.LAMBERTIAN),
        ((-0.5, 0.0, -2.0), 0.5, (0.8, 0.5, 0.5), 0.2, 0.0, mat.METAL),
        ((0.6, 0.1, -1.9), 0.6, (0.8, 0.8, 0.8), 0.0, 0.0, mat.METAL),
        ((0.2, -0.35, -0.4), 0.15, (0.8, 0.8, 0.8), 0.0, 1.5, mat.DIELECTRIC),
        ((-0.4, -0.4, -0.6), 0.1, (1.0, 1.0, 1.0), 0.0, 0.0, mat.EMISSIVE),
        ((-0.2, -0.1, 0.6), 0.4, (0.5, 0.5, 0.8), 0.0, 0.0, mat.METAL),
        ((-1.5, -0.1, -5.0), 0.5, (0.5, 0.8, 0.5), 0.0, 0.0, mat.METAL),
    ])
    camera = Camera.create(
        # main.cpp:82-91
        look_from=(-1.3, 0.2, 0.5), look_at=(0.2, 0.0, -1.5),
        vfov_deg=60.0, aspect_ratio=aspect_ratio,
        focus_dist=2.0, aperture_deg=1.2)
    if mesh_tris is None:
        return _scene(camera, spheres, sky)
    tris = Triangles.from_vertices(mesh_tris, albedo=(0.8, 0.6, 0.2),
                                   fuzz=0.5, ior=0.0, mat_type=mat.METAL,
                                   box_id=0)
    return Scene(camera, spheres, tris, BoundingBoxes.single(*mesh_aabb),
                 sky if sky is not None else Sky.gradient())


def book_cover_scene(n_random: int = 96, seed: int = 3,
                     aspect_ratio: float = 16.0 / 9.0):
    """RTiOW final-scene style random spheres (4 + n_random)."""
    rng = np.random.default_rng(seed)
    entries = [
        ((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), 0.0, 0.0, mat.LAMBERTIAN),
        ((0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), 0.0, 1.5, mat.DIELECTRIC),
        ((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), 0.0, 0.0, mat.LAMBERTIAN),
        ((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0, 0.0, mat.METAL),
    ]
    placed = 0
    while placed < n_random:
        a = rng.uniform(-11, 11)
        b = rng.uniform(-11, 11)
        center = (a + 0.9 * rng.uniform(), 0.2, b + 0.9 * rng.uniform())
        if np.linalg.norm(np.array(center) - np.array([4, 0.2, 0])) < 0.9:
            continue
        choose = rng.uniform()
        if choose < 0.8:
            albedo = tuple(rng.uniform(size=3) * rng.uniform(size=3))
            entries.append((center, 0.2, albedo, 0.0, 0.0, mat.LAMBERTIAN))
        elif choose < 0.95:
            albedo = tuple(rng.uniform(0.5, 1.0, size=3))
            entries.append((center, 0.2, albedo, rng.uniform(0, 0.5), 0.0,
                            mat.METAL))
        else:
            entries.append((center, 0.2, (1.0, 1.0, 1.0), 0.0, 1.5,
                            mat.DIELECTRIC))
        placed += 1
    camera = Camera.create(
        look_from=(13.0, 2.0, 3.0), look_at=(0.0, 0.0, 0.0),
        vfov_deg=20.0, aspect_ratio=aspect_ratio,
        focus_dist=10.0, aperture_deg=0.6)
    return _scene(camera, Spheres.from_list(entries))


def flagship_scene(aspect_ratio: float = 16.0 / 9.0, obj_path: str = None,
                   hdr_path: str = None):
    """The reference executable's default render (``main.cpp:118-150``),
    assembled from assets: the mesh at ``obj_path`` (the F1 car, which
    this repository does not bundle; by default the bundled
    ``assets/torus.obj``) under the reference transform, the 8 spheres,
    and an HDR sky (``hdr_path``, by default the procedural
    ``make_sky_image(1024, 512)``: the reference's skybox is a missing LFS
    blob), tone-mapped (``main.cpp:150``)."""
    import os

    from ..io.hdr import load_hdr, tone_map
    from ..io.obj import load_obj
    from ..io.procgen import make_sky_image

    assets = os.path.join(os.path.dirname(__file__), "..", "..", "assets")
    if obj_path is None:
        obj_path = os.path.join(assets, "torus.obj")
    tris, aabb = load_obj(obj_path, scale=(0.15, 0.15, 0.15),
                          translate=(0.0, -0.5, -1.0))
    img = (load_hdr(hdr_path) if hdr_path is not None
           else make_sky_image(1024, 512))
    return reference_scene(aspect_ratio=aspect_ratio, mesh_tris=tris,
                           mesh_aabb=aabb, sky=Sky.hdr(tone_map(img)))
