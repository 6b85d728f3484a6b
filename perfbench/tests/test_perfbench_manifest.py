"""BENCHMARK.json, the configurations and the cells, as files."""

import json
import re

import numpy as np
import pytest

from perfbench import harness, scenes
from perfbench.tests.tiny import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_files(manifest):
    assert set(manifest) == KEYS
    assert manifest["paths"] == ["perfbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    configs = {c["name"]: c for c in manifest["configs"]}
    assert len(configs) == len(manifest["configs"])
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
    cells = [w["name"] for w in manifest["workloads"]]
    assert len(set(cells)) == len(cells)
    assert {w["config"] for w in manifest["workloads"]} == set(configs)
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        spec = harness.load_cell(ROOT, w["name"])
        assert spec["workload"]["config"] == w["config"]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        names = [m["name"] for m in harness.metrics_of(manifest, cell,
                                                       False)]
        assert "setup_s" in names and len(names) >= 2
        assert harness.metrics_of(manifest, cell, True)


@pytest.mark.parametrize("name", ["readme", "flagship"])
def test_configuration_is_the_port_preset(name, tmp_path):
    """The configuration's scene is the port's preset of the same name,
    leaf for leaf, the flagship's with its 15,360-triangle torus."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io.hdr import tone_map
    from opencl_ray_tracer_tpu_torch.io.obj import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import (make_sky_image,
                                                        make_torus_obj)
    from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

    config = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    leaves, kind = scenes.scene_leaves(config)
    if name == "readme":
        port = ot.readme_scene()
    else:
        tris, aabb = parse_obj(make_torus_obj(128, 60), (0.15,) * 3,
                               (0.0, -0.5, -1.0))
        port = ot.reference_scene(16 / 9, tris, aabb, ot.Sky.hdr(
            tone_map(make_sky_image(1024, 512))))
    want = scene_to_numpy(port)
    assert kind == port.sky.kind
    assert sorted(leaves) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(leaves[key], value, err_msg=key)
