"""Kernels written by hand for the card, each with its plain PyTorch
version.  Importing this package builds nothing; a kernel is compiled at
its first launch."""

from .intersect_mm import closest_tri, closest_tri_plain, mesh_tables
from .megakernel import render_spheres, render_spheres_plain, supports
from .megamesh import render_mesh, render_mesh_plain, supports_mesh

__all__ = ["render_spheres", "render_spheres_plain", "supports",
           "closest_tri", "closest_tri_plain", "mesh_tables", "render_mesh",
           "render_mesh_plain", "supports_mesh"]
