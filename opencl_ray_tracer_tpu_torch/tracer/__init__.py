"""The plain PyTorch tracer (intersect, scatter, estimator, wavefront,
diffhit) and the render and gradient entry points."""

from .render import render, render_and_grad, render_grad_sampled, render_rows

__all__ = ["render", "render_rows", "render_and_grad", "render_grad_sampled"]
