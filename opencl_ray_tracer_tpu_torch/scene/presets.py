"""Built-in sphere scenes, value for value those of the JAX package.

- ``readme_scene``: the reference README benchmark scene
  (``README.md:30-38``): 5 spheres, gradient sky.
- ``reference_scene``: the 8 spheres and camera hardcoded in
  ``main.cpp:80-129``, without the mesh (the mesh slice adds it).
- ``book_cover_scene``: the RTiOW random-spheres scene, deterministic in
  its seed.
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


def reference_scene(aspect_ratio: float = 16.0 / 9.0, sky=None):
    """The spheres and camera of main.cpp:80-129; gradient sky unless
    ``sky`` is given."""
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
    return _scene(camera, spheres, sky)


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
