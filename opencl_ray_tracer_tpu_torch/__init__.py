"""opencl_ray_tracer_tpu_torch: the path tracer in PyTorch, with kernels
written by hand in CUDA for NVIDIA Hopper (H100).

It does what the JAX package beside it does, module for module, and is
held against it by the tests.  ``render`` runs on the card unless the
caller passes ``device="cpu"``, which selects the plain PyTorch tracer.
This release covers scenes of spheres and triangle meshes under a
gradient, constant or HDR sky, in the forward render (whole, in row blocks
with ``render(progress=)``, or checkpointed in sample windows with
``render_checkpointed``), the scene gradients (``render_and_grad``,
``render_grad_sampled``), soft-visibility rendering for geometry gradients
(``render_soft``), fitting (``fit_scene``, with ``soft=True`` for
geometry, which can checkpoint and resume), device traces
(``utils.profiling.device_trace``), the command line (``python -m
opencl_ray_tracer_tpu_torch.cli``) and renders, gradients and training
steps sharded over several devices, one process each (``parallel``).
"""

from .config import README_BENCH, REFERENCE_DEFAULTS, RenderConfig
from .scene import (BoundingBoxes, Camera, Scene, Sky, Spheres, Triangles,
                    book_cover_scene, flagship_scene, materials,
                    readme_scene,
                    reference_scene, scene_from_json, scene_from_numpy,
                    scene_to_json, scene_to_numpy)
from .optimize import fit_scene
from .parallel import render_checkpointed
from .tracer import (render, render_and_grad, render_grad_sampled,
                     render_rows, render_soft, render_window)

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "REFERENCE_DEFAULTS", "README_BENCH",
    "Scene", "Camera", "Spheres", "Triangles", "BoundingBoxes", "Sky",
    "materials", "readme_scene", "reference_scene", "book_cover_scene",
    "flagship_scene",
    "scene_from_numpy", "scene_to_numpy", "scene_from_json",
    "scene_to_json", "render", "render_rows", "render_window",
    "render_checkpointed", "render_and_grad", "render_grad_sampled",
    "render_soft", "fit_scene",
]
