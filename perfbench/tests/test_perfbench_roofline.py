"""The roofline share's arithmetic."""

import re

import pytest

from perfbench import roofline
from perfbench.work import constants as c
from perfbench.work import k1, k2, k7

WORK = dict(camera_rays=1000, segments=3000, sphere_hits=1500,
            tri_hits=200, box_segments=400, n_pix=100, spp=10,
            n_spheres=5, n_tris=50, sky_texels=64)
H100 = "NVIDIA H100 80GB HBM3"


def _run(kernels, kind=H100, work=WORK):
    return {"trace": {"kernels": kernels}, "work": work,
            "device": {"kind": kind}}


def test_k1_share():
    flops = (3000 * 5 * c.SPHERE_TEST + 1500 * c.SPHERE_HIT
             + 1000 * c.CAMERA_RAY)
    io = (5 * 16 + 128 + 300) * 4
    assert k1.work(WORK) == (flops, io)
    bound = max(flops / 67e12, io / 3.35e12)
    run = _run({"void sphere_megakernel<0>(Params)": [4, 4e-3]})
    assert roofline.share(run, "k1") == pytest.approx(100 * bound / 1e-3)


def test_share_is_none_without_a_reading():
    assert roofline.share(_run({"other": [1, 1.0]}), "k1") is None
    assert roofline.share(_run({"sphere_megakernel": [1, 1.0]},
                               kind="cpu"), "k1") is None
    assert roofline.share({"trace": None, "work": WORK}, "k1") is None
    assert roofline.share(_run({"sphere_megakernel": [1, 1.0]}, work={}),
                          "k1") is None


@pytest.mark.parametrize("mod, yes, no", [
    (k1, "void sphere_megakernel<0>(Params)", "sphere_megakernel_earlier"),
    (k2, "void mesh_megakernel<7>(Params)", "void mesh_megagrad<2, 0>"),
    (k7, "void mesh_megagrad<2, 0>(Params)", "void mesh_megagrad<1, 0>"),
])
def test_kernel_names(mod, yes, no):
    assert re.search(mod.KERNEL, yes)
    assert not re.search(mod.KERNEL, no)


@pytest.mark.parametrize("mod", [k1, k2, k7])
def test_work_needs_counts(mod):
    assert mod.work({}) is None
    flops, io = mod.work(WORK)
    assert flops > 0 and io > 0
