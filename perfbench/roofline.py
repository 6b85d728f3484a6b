"""A kernel's share of its roofline: the least time its work could take on
the card (the larger of its FP32 operations over the peak rate and its
bytes, each input and output once, over the peak bandwidth) over its
mean time a launch in the device trace.

The work of kernel ``<k>`` is ``perfbench/work/<k>.py``: ``KERNEL``, a
regular expression of its name in the trace, and ``work(counts)``, the
(FP32 operations, bytes) of one launch from the reference's path counts
for the run's inputs (``run["work"]``), or None where they are missing.
"""

from __future__ import annotations

import importlib
import re

from perfbench.peaks import PEAKS
from perfbench.tracing import kernel_time


def bound_s(flops: float, io_bytes: float, kind: str) -> float | None:
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(flops / peak["fp32_flops"], io_bytes / peak["hbm_bytes"])


def share(run: dict, kernel: str) -> float | None:
    """Percent of the roofline that ``kernel`` reached in the run, or None
    where the run holds no trace, no launch of it or no work count."""
    trace = run.get("trace")
    if not trace or not run.get("work"):
        return None
    mod = importlib.import_module(f"perfbench.work.{kernel}")
    timed = kernel_time(trace, re.compile(mod.KERNEL))
    work = mod.work(run["work"])
    if timed is None or work is None:
        return None
    bound = bound_s(*work, run["device"]["kind"])
    if bound is None:
        return None
    launches, seconds = timed
    return 100.0 * bound / (seconds / launches)
