"""Diagnostics, timing and progress for the command line (the reference's
device dump, timers and per-block progress, headless)."""

from .device_info import device_info, print_device_info
from .progress import ProgressReporter
from .timing import PhaseTimer, rays_per_second

__all__ = ["device_info", "print_device_info", "PhaseTimer",
           "rays_per_second", "ProgressReporter"]
