"""A configuration, a cell and a per-layer metric added as files alone are
found by the harness."""

import json

from perfbench.tests.tiny import run, tiny_copy


def test_new_config_cell_and_metric_are_found(tmp_path):
    root = tiny_copy(tmp_path)
    base = root / "perfbench"
    config = json.loads((base / "configs" / "readme.json").read_text())
    config["name"] = "readme_wide"
    config["render"].update(width=20, height=6)
    (base / "configs" / "readme_wide.json").write_text(json.dumps(config))
    cell = json.loads((base / "workloads" / "readme.render.json")
                      .read_text())
    cell["config"] = "readme_wide"
    (base / "workloads" / "readme_wide.render.json").write_text(
        json.dumps(cell))
    (base / "metrics" / "pixels_a_run.py").write_text(
        "def read(run):\n"
        "    return run['work']['n_pix'] * run['attempted']\n")
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "readme_wide", "source": "https://example.org/readme",
        "file": "perfbench/configs/readme_wide.json", "reduced": [],
        "why": "a test's configuration"})
    manifest["workloads"].append({
        "name": "readme_wide.render", "config": "readme_wide",
        "traffic": "render", "chips": 1, "why": "a test's cell"})
    for m in manifest["end_to_end"]:
        if "readme.render" in m.get("workloads", []):
            m["workloads"].append("readme_wide.render")
    manifest["per_layer"].append({
        "name": "pixels_a_run", "unit": "pixels", "better": "higher",
        "source": "program_counter", "layer": "entry and host tables",
        "moves": "render_ms", "workloads": ["readme_wide.render"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    traced = run(root, "readme_wide.render", traced=True)
    assert traced["correct"]
    assert (traced["metrics"]["pixels_a_run"]["value"]
            == 120 * traced["attempted"])
    plain = run(root, "readme_wide.render")
    assert plain["correct"]
    assert {"render_ms", "render_p95_ms", "setup_s"} == set(plain["metrics"])
