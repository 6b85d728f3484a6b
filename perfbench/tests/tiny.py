"""A copy of the benchmark at a size a CPU test can run: the same files,
with each configuration's image, mesh and sky made small and each cell's
checks and steps cut down."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def tiny_copy(dest: pathlib.Path) -> pathlib.Path:
    """``dest`` holding BENCHMARK.json and a shrunk copy of perfbench/."""
    shutil.copytree(BENCH, dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "perfbench" / "configs").glob("*.json"):
        config = json.loads(path.read_text())
        config["render"] = {"width": 24, "height": 12, "spp": 2,
                            "max_depth": 5}
        if "mesh" in config:
            config["mesh"]["torus"].update(n_major=8, n_minor=6)
        if "procedural" in config["sky"]:
            config["sky"]["procedural"].update(width=64, height=32)
        path.write_text(json.dumps(config))
    for path in (dest / "perfbench" / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        p = cell["params"]
        if "check_rows" in p:
            p.update(check_images=1, check_among=1, check_rows=4)
        if "min_steps" in p:
            p.update(min_steps=2, warmup_steps=1, target_spp=1)
        path.write_text(json.dumps(cell))
    return dest


def run(root: pathlib.Path, cell: str, traced: bool = False,
        seed: int = 2**40 + 3) -> dict:
    """One run of ``cell`` from ``root`` on the CPU, the card's check
    skipped."""
    from perfbench import harness
    return harness.run_cell(root, cell, seed, 0.01, traced,
                            time.perf_counter(), torch.device("cpu"))
