"""What a run may load, and what it does without a card."""

import json
import pathlib
import shutil
import subprocess
import sys
import types

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import BENCH, ROOT


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    for name in ("opencl_ray_tracer_tpu_torch_x", "jaxtyping",
                 "flaxen.sub", "perfbench_jax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "opencl_ray_tracer_tpu.scene",
                        types.ModuleType("opencl_ray_tracer_tpu.scene"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib",
                                           "opencl_ray_tracer_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.fit, "
            "perfbench.reference.tracer, perfbench.scenes; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout))
    assert not loaded & {"opencl_ray_tracer_tpu_torch",
                         "opencl_ray_tracer_tpu", "jax", "jaxlib", "flax"}
    for path in (BENCH / "reference").glob("*.py"):
        assert "opencl_ray_tracer" not in path.read_text().split(
            '"""', 2)[-1], path


def test_no_card_no_result(no_card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "readme.render",
         "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_alone_in_a_directory_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cell = manifest["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""
    assert pathlib.Path(tmp_path / "perfbench" / "run.py").is_file()
