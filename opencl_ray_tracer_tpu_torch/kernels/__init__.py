"""Kernels written by hand for the card, each with its plain PyTorch
version.  Importing this package builds nothing; a kernel is compiled at
its first launch."""

from .megakernel import render_spheres, render_spheres_plain, supports

__all__ = ["render_spheres", "render_spheres_plain", "supports"]
