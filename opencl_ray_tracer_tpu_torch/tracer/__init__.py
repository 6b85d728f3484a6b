"""The plain PyTorch tracer (intersect, scatter, estimator, wavefront,
diffhit) and the render and gradient entry points.  The scatter function
is ``tracer.scatter.scatter``: the name ``scatter`` here is its module."""

from .estimator import accumulate_sample, trace
from .intersect import HitInfo, closest_hit, hit_aabbs, hit_spheres
from .render import (render, render_and_grad, render_grad_sampled,
                     render_rows, render_window)
from .scatter import reflect, reflectance, refract

__all__ = [
    "trace", "accumulate_sample", "closest_hit", "hit_spheres", "hit_aabbs",
    "HitInfo", "render", "render_rows", "render_window", "render_and_grad",
    "render_grad_sampled", "reflect", "refract", "reflectance",
]
