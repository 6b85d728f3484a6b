"""The trace's arithmetic on a synthetic Chrome trace."""

import json
import re

import pytest

from perfbench import tracing


def _x(name, cat, ts, dur, tid=1, ext=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid, "args": {}}
    if ext is not None:
        e["args"]["External id"] = ext
    return e


@pytest.fixture
def summary(tmp_path):
    events = [
        _x(tracing.WINDOW, "user_annotation", 100, 1000),
        _x("aten::add", "cpu_op", 150, 50, ext=7),
        _x("add_kernel", "kernel", 210, 50, tid=7, ext=7),
        _x("void sphere_megakernel<0>(Params)", "kernel", 300, 200, tid=7),
        _x("aten::item", "cpu_op", 480, 310, ext=9),
        _x("aten::_local_scalar_dense", "cpu_op", 490, 290, ext=10),
        _x("Memcpy DtoH", "gpu_memcpy", 800, 100, tid=7, ext=10),
        _x("void sphere_megakernel<0>(Params)", "kernel", 1050, 100,
           tid=7),
        _x("outside", "kernel", 2000, 10, tid=7),
        {"ph": "i", "name": "marker", "ts": 0, "pid": 1, "tid": 1},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return tracing.summarize(str(path))


def test_window_busy_and_kernels(summary):
    assert summary["window_s"] == pytest.approx(1000e-6)
    # 50 + 200 + 100 + the 50 of the last kernel inside the window
    assert summary["busy_s"] == pytest.approx(400e-6)
    assert summary["n_kernels"] == 3
    assert summary["kernels"]["void sphere_megakernel<0>(Params)"] == \
        [2, pytest.approx(300e-6)]
    assert tracing.kernel_time(summary, re.compile(r"sphere_megakernel")) \
        == (2, pytest.approx(300e-6))
    assert tracing.kernel_time(summary, re.compile(r"megagrad")) is None


def test_device_time_by_operation_and_launching_op(summary):
    ops = dict(summary["device_ops"])
    assert ops["add_kernel [aten::add]"] == pytest.approx(50e-6)
    assert ops["Memcpy DtoH [aten::_local_scalar_dense]"] == \
        pytest.approx(100e-6)
    assert ops["sphere_megakernel<0>(Params)"] == pytest.approx(300e-6)
    assert list(ops)[0] == "sphere_megakernel<0>(Params)"


def test_idle_gaps_by_host_op(summary):
    gaps = dict(summary["idle_gaps"])
    # [100, 210) and [260, 300): no op runs where they begin; [500, 800):
    # the innermost op at 500 is the scalar read inside aten::item;
    # [900, 1050) again outside any op
    assert gaps["host Python, outside any op"] == pytest.approx(300e-6)
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(300e-6)
    assert sum(gaps.values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"])
    assert tracing.breakdown(summary) == {
        "device_ops": summary["device_ops"],
        "idle_gaps": summary["idle_gaps"]}


def test_idle_share(summary):
    run = {"kind": "render", "trace": summary}
    assert tracing.idle_share(run, "render") == pytest.approx(60.0)
    assert tracing.idle_share(run, "fit") is None
    assert tracing.idle_share({"kind": "render", "trace": None},
                              "render") is None
