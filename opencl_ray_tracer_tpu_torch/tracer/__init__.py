"""The plain PyTorch tracer (intersect, scatter, estimator, wavefront) and
the render entry points."""

from .render import render, render_rows

__all__ = ["render", "render_rows"]
