"""The port's device traces (``utils/profiling.py``) on the CPU: the
trace file is written into the directory that ``device_trace`` yields, and
it holds the ops run inside the block and the span that ``annotate``
names."""

import json
import os

import torch

from opencl_ray_tracer_tpu_torch.utils.profiling import annotate, device_trace


def test_device_trace_writes_the_annotated_span(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir) as got:
        assert got == log_dir
        with annotate("oclrt_soft_step"):
            x = torch.ones(64, 3)
            (x * 2.0).sum()
    names = os.listdir(log_dir)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    with open(os.path.join(log_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    spans = {e.get("name") for e in events}
    assert "oclrt_soft_step" in spans
    assert "aten::mul" in spans
