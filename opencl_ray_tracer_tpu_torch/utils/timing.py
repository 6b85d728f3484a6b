"""Phase timing and throughput.

The reference prints two wall-clock spans, the kernel build and the render
(``main.cpp:33, 207-208, 219, 276-277``).  ``PhaseTimer`` names any number
of phases and ends each one after the card's work has finished, and
``rays_per_second`` gives the throughput of a render.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


def _on_cuda(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.device.type == "cuda"
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    return False


class PhaseTimer:
    """Wall-clock seconds per named phase, summed over repeats."""

    def __init__(self, verbose: bool = True):
        self.spans: dict[str, float] = {}
        self.verbose = verbose

    @contextmanager
    def phase(self, name: str, sync_on=None):
        """Time the block; when ``sync_on`` (a tensor, or a list, tuple or
        dict of them, read when the block ends) lies on the card, wait for
        the card with ``torch.cuda.synchronize()`` before the clock
        stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if _on_cuda(sync_on):
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            if self.verbose:
                print(f" === {name}: {dt:.6f} s ===")

    def __getitem__(self, name: str) -> float:
        return self.spans[name]


def rays_per_second(width: int, height: int, spp: int, seconds: float,
                    mean_bounces: float = 1.0) -> dict:
    """Camera samples per second and rays per second,
    W * H * spp * (1 + mean bounces) / seconds."""
    samples = width * height * spp
    return {
        "camera_samples_per_s": samples / seconds,
        "rays_per_s": samples * (1.0 + mean_bounces) / seconds,
        "seconds": seconds,
    }
