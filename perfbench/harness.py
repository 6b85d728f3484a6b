"""Running one cell of the benchmark once.

Everything is found by name, so that a cell, a configuration or a metric
is added as files alone:

- ``BENCHMARK.json`` (the root of the checkout) lists the cells and the
  metrics; a metric applies to the cells its ``workloads`` lists, or to
  every cell without one;
- ``perfbench/workloads/<cell>.json``: the cell's configuration, its entry
  (``perfbench/entries/<entry>.py``: the traffic generator and the check
  against the reference) and the entry's parameters and limits;
- ``perfbench/configs/<config>.json``: the scene and the render settings;
- ``perfbench/metrics/<metric>.py``: ``read(run)``, the metric's value
  from the run's record, or None where the run has nothing to read.

The run's record (a dict) carries what the entry measured: the window's
seconds and its items' times, the set-up's seconds, the reference's path
counts and, traced, the device trace's summary.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

import torch

from . import tracing

# modules a run may not hold once its window has closed: JAX and the JAX
# package the program was ported from (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "opencl_ray_tracer_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, name: str):
    """The Python file at ``path`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(root: pathlib.Path, cell: str) -> dict:
    """The cell's manifest entry, workload file and configuration file."""
    bench = load_json(root / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == cell]
    if not entries:
        raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
    base = root / "perfbench"
    workload = load_json(base / "workloads" / f"{cell}.json")
    if workload["config"] != entries[0]["config"]:
        raise SystemExit(f"{cell}: the workload file names configuration "
                         f"{workload['config']!r}, BENCHMARK.json "
                         f"{entries[0]['config']!r}")
    return dict(manifest=bench, entry=entries[0], workload=workload,
                config=load_json(base / "configs"
                                 / f"{workload['config']}.json"))


def metrics_of(manifest: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    traced, its per-layer metrics."""
    listed = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in listed if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is in FORBIDDEN."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def device_record(device, peak: int) -> dict:
    """The result line's ``device``; ``peak`` is the program's memory
    peak as the entry read it when the window closed: from the program's
    set-up on, after the inputs were made (a fit's target is the
    reference's image) and before the reference checked the window."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "memory_peak_bytes": peak}


def run_cell(root: pathlib.Path, cell: str, seed: int, seconds: float,
             traced: bool, t0: float, device) -> dict:
    """One run of ``cell`` on ``device``: the result line's fields, the
    compared numbers under "checks"."""
    spec = load_cell(root, cell)
    workload = spec["workload"]
    entry = load_module(root / "perfbench" / "entries"
                        / f"{workload['entry']}.py", workload["entry"])
    run = entry.run(config=spec["config"], params=workload["params"],
                    seed=seed, seconds=seconds, traced=traced, t0=t0,
                    device=torch.device(device),
                    limits=workload["limits"])
    print(f"perfbench: {cell} seed {seed}: setup_s {run['setup_s']!r}, "
          f"window_s {run['window_s']!r}, attempted {run['attempted']}, "
          f"reference_s {run['reference_s']!r}", file=sys.stderr)
    if run.get("host_s"):
        # host_ms.render is read in traced runs alone: its untraced value
        print(f"perfbench: host ms a call, {'' if traced else 'un'}traced, "
              f"{1e3 * sum(run['host_s']) / len(run['host_s'])!r}",
              file=sys.stderr)
    run["device"] = device_record(torch.device(device),
                                  run.get("memory_peak_bytes", 0))
    metrics = {}
    for m in metrics_of(spec["manifest"], cell, traced):
        reader = load_module(root / "perfbench" / "metrics"
                             / f"{m['name']}.py", m["name"])
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in run["checks"].values())
              and run["failed"] == 0,
              "attempted": run["attempted"], "failed": run["failed"],
              "metrics": metrics, "device": run["device"]}
    if traced and run.get("trace"):
        result["device"]["busy_s"] = run["trace"]["busy_s"]
        result["device"]["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = tracing.breakdown(run["trace"])
    result["checks"] = run["checks"]
    return result


def main(root, cell: str, seed: int, seconds: float, traced: bool,
         t0: float) -> int:
    spec = load_cell(pathlib.Path(root), cell)
    chips = spec["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {cell} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    result = run_cell(pathlib.Path(root), cell, seed, seconds, traced, t0,
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

