"""Render configuration.

The same dataclass, fields and JSON as the JAX package's ``config.py``, so a
configuration written by one package loads in the other.  The reference
hardcodes these as ``#define``s (``src/cpp/globals.hpp:8-14``: 1280x720, SPP
5, MAX_DEPTH 32).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings.

    width/height/spp/max_depth mirror ``globals.hpp:9-14``.  ``t_min`` is the
    reference's hardcoded 0.001 epsilon (``gpu_kernel.cl:278``).

    nan_policy:
      - "running_sum": a NaN sample channel is replaced by the running *sum*
        of that channel so far (``gpu_kernel.cl:640-642``).
      - "zero": NaN samples contribute 0.
    clamp_samples: per-sample clamp to [0,1] *before* averaging
      (``gpu_kernel.cl:632-638``).
    row_chunk: pixel rows per call of the plain tracer (bounds its memory);
      None renders the whole image at once.
    early_stop: the plain tracer's forward loop form: True runs the
      path-regeneration wavefront, False the per-sample bounce loop.  Both
      give the same image.

    backend: on the card, "auto" and "pallas" render a scene in the mesh
      megakernel's or the sphere megakernel's scope through that kernel;
      any other value, and every scene outside both, takes the plain
      tracer.  The CPU always takes the plain tracer.
    tri_backend: the plain tracer's triangle hit: "pallas" the
      closest-triangle kernel (its plain version on the CPU); "mm" the
      matmul-form fold; "auto" the kernel on the card from 256 triangles,
      the matmul form on the CPU from 256, the direct form below
      (``tracer.render``).
    """

    width: int = 1280
    height: int = 720
    spp: int = 5
    max_depth: int = 32
    t_min: float = 1e-3
    gamma: float = 2.0
    clamp_samples: bool = True
    nan_policy: str = "running_sum"
    backend: str = "auto"
    tri_backend: str = "auto"
    row_chunk: int | None = None
    early_stop: bool = True

    @property
    def aspect_ratio(self) -> float:
        return self.width / self.height

    def replace(self, **kw: Any) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))


# The reference's default build config (globals.hpp:8-14).
REFERENCE_DEFAULTS = RenderConfig(width=1280, height=720, spp=5, max_depth=32)

# The reference's README benchmark config (README.md:24-29).
README_BENCH = RenderConfig(width=1280, height=720, spp=250, max_depth=50)
