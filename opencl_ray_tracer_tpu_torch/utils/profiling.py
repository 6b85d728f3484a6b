"""Device traces.

The reference's only profiling is two host wall-clock spans
(``main.cpp:33,207-208,219,276-277``); here a block of work is traced with
``torch.profiler``: the CPU's ops and, when the card is in use, its
kernels, written as a Chrome trace (open it in ui.perfetto.dev, or point
TensorBoard's PyTorch profiler plugin at the directory).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/oclrt_trace"):
    """Trace a block into ``log_dir/trace_<pid>_<ns>.pt.trace.json``:

        with device_trace("/tmp/trace"):
            img = render(...)
            torch.cuda.synchronize()

    Yields log_dir.  CUDA activity is recorded when a card is available."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named span inside a trace (a context manager)."""
    return record_function(name)
