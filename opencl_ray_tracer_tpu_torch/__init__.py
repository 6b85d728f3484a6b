"""opencl_ray_tracer_tpu_torch: the path tracer in PyTorch, with kernels
written by hand in CUDA for NVIDIA Hopper (H100).

It does what the JAX package beside it does, module for module, and is
held against it by the tests.  ``render`` runs on the card unless the
caller passes ``device="cpu"``, which selects the plain PyTorch tracer.
This release covers the forward render of sphere scenes under a gradient
or constant sky.
"""

from .config import README_BENCH, REFERENCE_DEFAULTS, RenderConfig
from .scene import (BoundingBoxes, Camera, Scene, Sky, Spheres, Triangles,
                    book_cover_scene, materials, readme_scene,
                    reference_scene, scene_from_numpy)
from .tracer import render, render_rows

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "REFERENCE_DEFAULTS", "README_BENCH",
    "Scene", "Camera", "Spheres", "Triangles", "BoundingBoxes", "Sky",
    "materials", "readme_scene", "reference_scene", "book_cover_scene",
    "scene_from_numpy", "render", "render_rows",
]
