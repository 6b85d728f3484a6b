"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Without a CUDA device every test here skips.  The file imports no
JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerance (tests/test_megakernel.py::_compare): at most 0.5% of pixels
differ by more than 1e-3, more than 99% agree within 1e-4, and the means
within 2e-3.  The kernel rounds as the plain version does (see the note in
csrc/megakernel.cu), so a pixel moves only where cbrtf and pow(x, 1/3),
or fmaf and the plain version's fma rounded through float64, differ by an
ulp across a discrete event.
"""

import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk

torch.set_num_threads(1)


def _scenes():
    readme = ot.readme_scene()
    const = ot.Scene(readme.camera, readme.spheres, readme.triangles,
                     readme.boxes, ot.Sky.constant((0.2, 0.4, 0.6)))
    return {"readme": (readme, {}),
            "reference_spheres": (ot.reference_scene(), {}),
            "const_sky": (const, {}),
            "nan_zero_no_clamp": (readme, dict(nan_policy="zero",
                                               clamp_samples=False)),
            "book_cover": (ot.book_cover_scene(), {})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_scenes()))
def test_kernel_matches_plain_on_card(cuda, case):
    scene, kw = _scenes()[case]
    scene = scene.to(cuda)
    # 50x30 pixels: not a multiple of the 128-thread block
    cfg = ot.RenderConfig(width=50, height=30, spp=4, max_depth=6, **kw)
    before = mk.LAUNCHES
    got = ot.render(scene, cfg, seed=3)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    r, g, b = mk.render_spheres_plain(
        mk.camera_table(scene), mk.sphere_table(scene), scene.spheres.count,
        cfg, scene.sky.kind, mk.specialize_flags(scene), 3,
        cfg.width * cfg.height)
    want = torch.stack([r, g, b], -1).reshape(got.shape)
    diff = (got - want).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    assert abs(float(got.mean() - want.mean())) < 2e-3


@pytest.mark.gpu
def test_kernel_pixel_window_and_bounces(cuda):
    """pix_offset/sample_base select a pixel and sample window; the
    bounce counter agrees with the plain version's."""
    scene = ot.reference_scene().to(cuda)
    cfg = ot.RenderConfig(width=40, height=20, spp=3, max_depth=5)
    args = (mk.camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, cfg, scene.sky.kind,
            mk.specialize_flags(scene), 11, 300)
    kb = torch.zeros(1, dtype=torch.int64, device=cuda)
    pb = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = torch.stack(mk.render_spheres(*args, pix_offset=170, sample_base=5,
                                        bounces=kb), -1)
    want = torch.stack(mk.render_spheres_plain(*args, pix_offset=170,
                                               sample_base=5, bounces=pb), -1)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 1e-3
    assert abs(kb.item() - pb.item()) <= 0.001 * pb.item() + 2
