"""The port's backward-kernel module (kernels/megagrad.py) on the CPU.

The CUDA kernel itself runs only on the card (test_torch_kernels_gpu.py,
chip_smoke.py).  Here: its wrapper takes the plain version for CPU tensors
and only then; the plain version chains to the same scene gradients as the
plain tracer's autograd (and so, by test_torch_grad.py, as the JAX
package's jnp VJP, which the JAX suite holds its own kernel against); the
argument checks; the scope; and that a failing kernel raises instead of
falling back.
"""

import dataclasses

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu_torch.kernels import _build
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

torch.set_num_threads(1)

CFG = ot.RenderConfig(width=16, height=10, spp=2, max_depth=4,
                      nan_policy="zero")


def loss(img):
    return torch.mean(img ** 2)


def assert_scene_grads_close(got, want):
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    assert sorted(a) == sorted(b)
    for k in a:
        if b[k].size:
            np.testing.assert_allclose(
                a[k], b[k], rtol=1e-4,
                atol=1e-6 * np.abs(b[k]).max() + 1e-12, err_msg=k)


def _args(scene, cfg=CFG, n_pix=None):
    n_pix = cfg.width * cfg.height if n_pix is None else n_pix
    g = torch.linspace(0.0, 1.0, 3 * n_pix).reshape(3, n_pix).contiguous()
    return (mk.camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, cfg, scene.sky.kind,
            mk.specialize_flags(scene), g[0], g[1], g[2], 3, n_pix)


def test_wrapper_takes_plain_path_on_cpu():
    scene = ot.reference_scene()
    before = mg.LAUNCHES
    counts = torch.zeros(2, dtype=torch.int64)
    gcam, gsph = mg.render_grad_tables(*_args(scene), counts=counts)
    assert mg.LAUNCHES == before
    pcam, psph = mg.render_grad_tables_plain(*_args(scene))
    assert torch.equal(gcam, pcam) and torch.equal(gsph, psph)
    assert gcam.shape == (1, mk.LANES) and gsph.shape == (mk.N_FIELDS, 128)
    n = scene.spheres.count
    assert gsph[list(mg.DIFF_FIELDS[:3]), :n].abs().max() > 0
    assert gcam[0, list(mg.CAM_SLOTS[:12])].abs().max() > 0
    assert gsph[:, n:].abs().max() == 0
    assert counts[0] >= CFG.width * CFG.height * CFG.spp


def test_pixel_and_sample_windows_add_up():
    """Windows of pixels and samples sum to the whole: the RNG is keyed
    on global ids and the "zero" policy is linear in the samples."""
    scene = ot.readme_scene()
    cam, sph, n, cfg, kind, flags, gr, gg, gb, seed, n_pix = _args(scene)
    whole = mg.render_grad_tables(cam, sph, n, cfg, kind, flags, gr, gg, gb,
                                  seed, n_pix)
    parts = [mg.render_grad_tables(cam, sph, n, cfg, kind, flags,
                                   gr[p0:p1], gg[p0:p1], gb[p0:p1], seed,
                                   p1 - p0, pix_offset=p0, sample_base=s,
                                   n_samples=1)
             for p0, p1 in ((0, 70), (70, n_pix)) for s in range(cfg.spp)]
    for k in range(2):
        torch.testing.assert_close(sum(p[k] for p in parts), whole[k],
                                   rtol=1e-4, atol=1e-7)


def test_render_grad_scene_matches_plain_sampled():
    scene = ot.reference_scene()
    _, img, gs = ot.render_grad_sampled(scene, CFG, loss, seed=3,
                                        grad_backend="plain", device="cpu")
    g_img = (2.0 / img.numel()) * img
    before = mg.LAUNCHES
    gk = mg.render_grad_scene(scene, CFG, g_img, seed=3)
    assert mg.LAUNCHES == before
    assert_scene_grads_close(gk, gs)


def test_sphere_render_fn_routes_through_the_wrappers():
    """render_grad_sampled(grad_backend="kernel") on CPU tensors runs both
    wrappers' plain versions, launches nothing, and matches autograd of
    the per-sample tracer through the scene itself (render_and_grad),
    which no table builder is on."""
    scene = ot.readme_scene()
    launches = (mk.LAUNCHES, mg.LAUNCHES)
    l1, i1, g1 = ot.render_grad_sampled(scene, CFG, loss, seed=5,
                                        grad_backend="kernel", device="cpu")
    assert (mk.LAUNCHES, mg.LAUNCHES) == launches
    l2, g2 = ot.render_and_grad(scene, CFG, loss, seed=5, device="cpu")
    i2 = ot.render(scene, CFG, seed=5, device="cpu")
    torch.testing.assert_close(i1, i2, rtol=0, atol=1e-6)
    torch.testing.assert_close(l1, l2)
    assert_scene_grads_close(g1, g2)


def test_wrapper_checks_arguments():
    scene = ot.readme_scene()
    args = list(_args(scene))
    for i, bad in ((0, args[0].double()), (1, args[1][:, :64]),
                   (6, args[6][:-1]), (7, args[7].double())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            mg.render_grad_tables(*wrong)
    with pytest.raises(ValueError, match="sky"):
        mg.render_grad_tables(*args[:4], 1, *args[5:])
    wide = torch.zeros((mk.N_FIELDS, 300))
    with pytest.raises(ValueError, match="n_spheres"):
        mg.render_grad_tables(args[0], wide, 300, *args[3:])
    with pytest.raises(ValueError, match="counts"):
        mg.render_grad_tables(*args, counts=torch.zeros(2))
    with pytest.raises(ValueError, match="no kernel"):
        mg.render_grad_tables(*(a.to("meta") if torch.is_tensor(a) else a
                                for a in args))


def test_scope():
    cfg = CFG
    assert mg.supports_grad(ot.readme_scene(), cfg)
    assert mg.supports_grad(ot.book_cover_scene(n_random=196), cfg)
    assert not mg.supports_grad(ot.book_cover_scene(n_random=300), cfg)
    # an HDR sky takes the HDR passes (K6, K7), texels above 1 too; more
    # than 128 spheres under it are out of the kernels' scope, and an
    # explicit kernel route refuses them, naming the bound, before
    # touching the device
    hdr = dataclasses.replace(ot.readme_scene(),
                              sky=ot.Sky.hdr(torch.ones((4, 8, 3))))
    assert mg.unsupported_grad_reason(hdr) is None
    assert mg.supports_grad_hdr(hdr, cfg)
    bright = dataclasses.replace(
        hdr, sky=ot.Sky.hdr(torch.full((4, 8, 3), 2.0)))
    assert mg.unsupported_grad_reason(bright) is None
    crowded = dataclasses.replace(ot.book_cover_scene(n_random=196),
                                  sky=bright.sky)
    assert "128" in mg.unsupported_grad_reason(crowded)
    # the forward kernel takes 128 spheres: on CUDA the kernel route of the
    # gradient refuses more, before touching the device
    with pytest.raises(NotImplementedError, match="1 to 128"):
        ot.render_grad_sampled(ot.book_cover_scene(n_random=196), cfg, loss,
                               device="cuda")
    with pytest.raises(NotImplementedError, match="128"):
        ot.fit_scene(torch.zeros((10, 16, 3)), crowded, cfg,
                     param_paths=("sky.image",), grad_backend="kernel",
                     device="cuda")


def test_conservative_flags():
    scene = ot.readme_scene()    # fuzzy metal, no aperture
    assert mk.specialize_flags(scene) == (True, False, False, True, False)
    assert mk.specialize_flags(scene, conservative=True) == (
        True, False, False, True, True)
    plain = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, fuzz=torch.zeros(5)))
    assert mk.specialize_flags(plain)[3] is False
    assert mk.specialize_flags(plain, conservative=True)[3] is True


def test_kernel_failures_raise(monkeypatch):
    """No fallback: a build failure raises from the loader, and a failing
    backward raises out of the entry point."""
    def no_nvcc(name, defines=()):
        raise RuntimeError(f"nvcc failed on {name}")

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed on megagrad"):
        mg._library()

    def failing_launch(*args, **kwargs):
        raise RuntimeError("sphere megagrad launch failed: CUDA error 700")

    monkeypatch.setattr(mg, "render_grad_tables", failing_launch)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ot.render_grad_sampled(ot.readme_scene(), CFG, loss,
                               grad_backend="kernel", device="cpu")

