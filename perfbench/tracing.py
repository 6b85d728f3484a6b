"""The device trace of a run's window: ``torch.profiler`` with CPU and CUDA
activity, written as a Chrome trace under the run's temporary directory,
read back and deleted.

``summarize`` reduces it to what the per-layer metrics read: the traced
window's seconds (the span of the ``WINDOW`` annotation the entry puts
around its measured work), the seconds in which an operation ran on the
device (the union of kernel, copy and set intervals within the window),
each kernel's launches and seconds by name, the device time by device
operation (its name, shortened, with the host op that launched it where
the trace links the two by an External id), and the device's idle gaps by
the host op running where each gap begins.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10
NAME_CHARS = 120


@contextlib.contextmanager
def traced_window(enabled: bool, out: dict):
    """Trace the block when ``enabled``; its summary goes to out["trace"].
    The block runs inside the ``WINDOW`` annotation either way."""
    if not enabled:
        with record_function(WINDOW):
            yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="perfbench_trace_") as tmp:
        path = os.path.join(tmp, "window.json")
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                yield
        prof.export_chrome_trace(path)
        out["trace"] = summarize(path)


def _merge(intervals):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _short(name: str) -> str:
    """A kernel's name without its return type and anonymous namespaces,
    cut to ``NAME_CHARS``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ")[:NAME_CHARS]


def summarize(path: str) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if not windows:
        raise RuntimeError("the trace holds no window annotation")
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    kernels: dict = {}
    for e in device:
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e6
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    by_op: dict = {}
    for e in device:
        name = _short(e["name"])
        op = ops.get(e.get("args", {}).get("External id"))
        if op is not None:
            name = f"{name} [{op}]"
        by_op[name] = by_op.get(name, 0.0) + e["dur"] / 1e6
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                  for e in device)
    busy_us = sum(e - s for s, e in busy)

    # idle gaps inside the window, each named by the innermost host op on
    # the window's thread that is running where the gap begins
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(((e["ts"], -e["dur"], e["name"]) for e in events
                   if e.get("cat") in HOST_CATS and e.get("tid") == win["tid"]
                   and e.get("pid") == win["pid"] and e is not win),
                  key=lambda x: (x[0], x[1]))
    starts = [h[0] for h in host]
    by_gap: dict = {}
    stack: list = []
    j = 0
    for g0, g1 in gaps:
        k = bisect.bisect_right(starts, g0)
        while j < k:
            ts, neg_dur, name = host[j]
            while stack and stack[-1][0] <= ts:
                stack.pop()
            stack.append((ts - neg_dur, name))
            j += 1
        while stack and stack[-1][0] <= g0:
            stack.pop()
        name = stack[-1][1] if stack else "host Python, outside any op"
        by_gap[name] = by_gap.get(name, 0.0) + (g1 - g0) / 1e6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(by_gap.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                kernels=kernels,
                n_kernels=sum(k[0] for k in kernels.values()),
                device_ops=[[n, s] for n, s in top],
                idle_gaps=[[n, s] for n, s in idle])


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``."""
    return {"device_ops": summary["device_ops"],
            "idle_gaps": summary["idle_gaps"]}


def kernel_time(summary: dict, pattern) -> tuple | None:
    """(launches, seconds) of the kernels whose name ``pattern`` (a
    compiled regular expression) matches, or None without any."""
    hits = [v for n, v in summary["kernels"].items() if pattern.search(n)]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


def idle_share(run: dict, kind: str):
    """100 (1 - busy / window) of the traced window, in a run of ``kind``;
    None without a trace."""
    trace = run.get("trace")
    if run.get("kind") != kind or not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
