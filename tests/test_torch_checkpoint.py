"""The port's checkpointed, windowed and progressive renders and its
checkpointed fits on the CPU, against the JAX package's.

- ``render_checkpointed`` (interrupted, then resumed) against JAX
  ``parallel.render_checkpointed`` under the "zero" and "running_sum" NaN
  policies (tests/test_sharding.py:250, :267), and a checkpoint written by
  either package resumed in the other.  Images are held to the golden
  tolerance of tests/test_golden.py: at most 0.2% of values off by more
  than 1e-4 and means within 1e-4.  Against the port's own ``render`` a
  checkpointed render is equal bit for bit.
- The kernels' plain versions in window mode (``sample_base``, ``acc0``,
  the raw sum): the sphere one against JAX ``render_pallas(interpret=True,
  sample_offset=, mean=False, acc0=)`` (tests/test_megakernel.py:92,
  tests/test_sharding.py:583), the mesh one against the JAX tracer's
  window (``render_rows(sample_offset=, mean=False, acc0=)``, the oracle of
  the JAX mesh kernel's tests), under the kernel tolerance of
  tests/test_megakernel.py (at most 0.5% of values off by more than 1e-3,
  more than 99% within 1e-4, means within 2e-3); and windows that tile the
  samples summing to the one-shot twin bit for bit (sphere, mesh and HDR).
- ``render(progress=)`` equal to ``render`` bit for bit, with the
  callback's counts (tests/test_cli.py:114).
- ``fit_scene(checkpoint_path=)`` interrupted and resumed equal to the
  uninterrupted fit bit for bit, and the JAX package's resumed fit of
  tests/test_inverse.py:167 within rtol 1e-4 on the losses and 1e-4 on the
  albedo (tests/test_torch_optimize.py's fit tolerance).
- The checkpoint file's keys and dtypes, its checks, and the entry points'
  need of a card without ``device="cpu"``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu import parallel as jpar
from opencl_ray_tracer_tpu.kernels import render_pallas
from opencl_ray_tracer_tpu.optimize import fit_scene as jax_fit_scene
from opencl_ray_tracer_tpu.tracer.render import _render_rows_jit
from opencl_ray_tracer_tpu_torch import parallel as tpar
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm

torch.set_num_threads(1)

SIZE = dict(width=32, height=16, max_depth=4)
# windows of the sample ids [0, 6) as tests/test_megakernel.py:92 tiles them
WINDOWS = ((0, 2), (2, 3), (5, 1))


def assert_golden_close(got, want):
    """tests/test_golden.py's tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() < 0.002, diff.max()
    assert abs(got.mean() - want.mean()) < 1e-4


def assert_kernel_close(got, want):
    """tests/test_megakernel.py::_compare's tolerance."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert (diff > 1e-3).mean() < 0.005
    assert (diff <= 1e-4).mean() > 0.99
    assert abs(np.mean(got) - np.mean(want)) < 2e-3


def _mesh(mod, sky=None):
    """tests/test_megamesh.py's scene: the reference spheres and a
    192-triangle fuzzy-metal torus, built by ``mod``'s package."""
    from opencl_ray_tracer_tpu.io.procgen import make_torus_obj
    if mod is ort:
        from opencl_ray_tracer_tpu.io.obj import parse_obj
    else:
        from opencl_ray_tracer_tpu_torch.io import parse_obj
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    return mod.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)


@pytest.mark.parametrize("policy", ["zero", "running_sum"])
def test_checkpointed_resume_matches_jax(tmp_path, policy):
    cfg = dict(SIZE, spp=6, nan_policy=policy)
    want = jpar.render_checkpointed(ort.readme_scene(),
                                    ort.RenderConfig(**cfg),
                                    str(tmp_path / "jax.npz"), seed=1,
                                    chunk_spp=2)
    tcfg = ot.RenderConfig(**cfg)
    path = str(tmp_path / "port.npz")
    # interrupted after 4 samples, then resumed
    part = tpar.render_checkpointed(ot.readme_scene(), tcfg.replace(spp=4),
                                    path, seed=1, chunk_spp=2, device="cpu")
    assert tpar.load_state(path)[1] == 4
    got = tpar.render_checkpointed(ot.readme_scene(), tcfg, path, seed=1,
                                   chunk_spp=2, device="cpu")
    assert_golden_close(got, want)
    assert torch.equal(got, ot.render(ot.readme_scene(), tcfg, seed=1,
                                      device="cpu"))
    assert torch.equal(part, ot.render(ot.readme_scene(),
                                       tcfg.replace(spp=4), seed=1,
                                       device="cpu"))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A 4-sample checkpoint of either package resumed to 8 in the other,
    against the JAX package's uninterrupted checkpointed render."""
    cfg = dict(SIZE, spp=8, nan_policy="zero")
    want = jpar.render_checkpointed(ort.readme_scene(),
                                    ort.RenderConfig(**cfg),
                                    str(tmp_path / "full.npz"), seed=1,
                                    chunk_spp=2)
    path = str(tmp_path / "shared.npz")
    if writer == "jax":
        jpar.render_checkpointed(ort.readme_scene(),
                                 ort.RenderConfig(**{**cfg, "spp": 4}), path,
                                 seed=1, chunk_spp=2)
        got = tpar.render_checkpointed(ot.readme_scene(),
                                       ot.RenderConfig(**cfg), path, seed=1,
                                       chunk_spp=2, device="cpu")
    else:
        tpar.render_checkpointed(ot.readme_scene(),
                                 ot.RenderConfig(**{**cfg, "spp": 4}), path,
                                 seed=1, chunk_spp=2, device="cpu")
        got = jpar.render_checkpointed(ort.readme_scene(),
                                       ort.RenderConfig(**cfg), path, seed=1,
                                       chunk_spp=2)
    assert_golden_close(got, want)
    with np.load(path) as z:
        assert int(z["n_samples"]) == 8


def test_checkpoint_file_and_checks(tmp_path):
    """The JAX package's keys and dtypes, no temporary file left behind,
    and a checkpoint of another size or seed refused."""
    cfg = ot.RenderConfig(width=8, height=4, spp=2, max_depth=2)
    path = str(tmp_path / "c.npz")
    seen = []
    img = tpar.render_checkpointed(ot.readme_scene(), cfg, path, seed=3,
                                   chunk_spp=1, device="cpu",
                                   progress=lambda d, t, m: seen.append(
                                       (d, t, m.clone())))
    with np.load(path) as z:
        assert sorted(z.files) == ["acc", "n_samples", "seed"]
        assert z["acc"].dtype == np.float32 and z["acc"].shape == (4, 8, 3)
        assert z["n_samples"].dtype == np.int64 and int(z["n_samples"]) == 2
        assert z["seed"].dtype == np.uint32 and int(z["seed"]) == 3
        np.testing.assert_array_equal(z["acc"] / np.float32(2), img.numpy())
    assert os.listdir(tmp_path) == ["c.npz"]
    assert [(d, t) for d, t, _ in seen] == [(1, 2), (2, 2)]
    assert torch.equal(seen[-1][2], img)
    with pytest.raises(ValueError, match="seed"):
        tpar.render_checkpointed(ot.readme_scene(), cfg, path, seed=4,
                                 device="cpu")
    with pytest.raises(ValueError, match="not"):
        tpar.render_checkpointed(ot.readme_scene(),
                                 cfg.replace(width=16), path, seed=3,
                                 device="cpu")


def _sphere_twin(scene, cfg, seed, sample_base=0, acc0=None, mean=True):
    n_pix = cfg.width * cfg.height
    out = mk.render_spheres(mk.camera_table(scene), mk.sphere_table(scene),
                            scene.spheres.count, cfg, scene.sky.kind,
                            mk.specialize_flags(scene), seed, n_pix,
                            sample_base=sample_base,
                            acc0=mk.acc0_planes(acc0, n_pix, "cpu"),
                            mean=mean)
    return torch.stack(out, -1).reshape(cfg.height, cfg.width, 3)


def _mesh_twin(scene, cfg, seed, sample_base=0, acc0=None, mean=True):
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    n_pix = cfg.width * cfg.height
    out = mm.render_mesh(cam, sph, n, tab, cfg, scene.sky.kind, flags, seed,
                         n_pix, sample_base=sample_base, sky_image=image,
                         acc0=mk.acc0_planes(acc0, n_pix, "cpu"), mean=mean)
    return torch.stack(out, -1).reshape(cfg.height, cfg.width, 3)


def test_sphere_window_twin_matches_pallas_interpret():
    """One raw-sum window from the sums of the samples before it."""
    cfg = dict(SIZE, spp=2, nan_policy="running_sum")
    jcfg = ort.RenderConfig(**cfg)
    zeros = jnp.zeros((16, 32, 3), jnp.float32)   # one compile for both
    acc0 = np.asarray(render_pallas(ort.readme_scene(), jcfg, seed=3,
                                    interpret=True, mean=False, acc0=zeros))
    want = np.asarray(render_pallas(ort.readme_scene(), jcfg, seed=3,
                                    interpret=True, sample_offset=2,
                                    mean=False, acc0=jnp.asarray(acc0)))
    got = _sphere_twin(ot.readme_scene(), ot.RenderConfig(**cfg), 3,
                       sample_base=2, acc0=acc0, mean=False)
    assert_kernel_close(got.numpy() / 4, want / 4)


def test_mesh_window_twin_matches_jax_tracer():
    cfg = dict(SIZE, spp=2, nan_policy="zero")
    jcfg = ort.RenderConfig(**cfg)
    scene = _mesh(ort)
    acc0 = np.asarray(_render_rows_jit(jcfg, 16, scene=scene,
                                       row_start=jnp.int32(0),
                                       seed=jnp.uint32(3),
                                       sample_offset=jnp.int32(0), mean=False,
                                       acc0=jnp.zeros((16, 32, 3))))
    want = np.asarray(_render_rows_jit(jcfg, 16, scene=scene,
                                       row_start=jnp.int32(0),
                                       seed=jnp.uint32(3),
                                       sample_offset=jnp.int32(2),
                                       mean=False, acc0=jnp.asarray(acc0)))
    got = _mesh_twin(_mesh(ot), ot.RenderConfig(**cfg), 3, sample_base=2,
                     acc0=acc0, mean=False)
    assert_kernel_close(got.numpy() / 4, want / 4)


def _hdr():
    from opencl_ray_tracer_tpu_torch.io.hdr import tone_map
    from opencl_ray_tracer_tpu_torch.io.procgen import make_sky_image
    return _mesh(ot, sky=ot.Sky.hdr(tone_map(make_sky_image(64, 32))))


@pytest.mark.parametrize("case", ["sphere", "mesh", "hdr"])
@pytest.mark.parametrize("policy", ["zero", "running_sum"])
def test_window_twins_sum_to_one_shot(case, policy):
    """The kernels' plain versions in window mode: windows that tile
    [0, 6) sum to the one-shot sum, and its mean is the one-shot mean, bit
    for bit."""
    scene, twin = {"sphere": (ot.readme_scene(), _sphere_twin),
                   "mesh": (_mesh(ot), _mesh_twin),
                   "hdr": (_hdr(), _mesh_twin)}[case]
    cfg = ot.RenderConfig(width=16, height=8, max_depth=4, spp=6,
                          nan_policy=policy)
    acc = None
    for s0, n in WINDOWS:
        acc = twin(scene, cfg.replace(spp=n), 2, sample_base=s0, acc0=acc,
                   mean=False)
    assert torch.equal(acc, twin(scene, cfg, 2, mean=False))
    mean = twin(scene, cfg, 2)
    assert torch.equal(acc / torch.tensor(6.0), mean)
    if case == "sphere":
        assert torch.equal(mean, ot.render(scene, cfg, seed=2, device="cpu"))


@pytest.mark.parametrize("case", ["readme", "hdr"])
def test_progressive_render_matches_render(case):
    scene = ot.readme_scene() if case == "readme" else _hdr()
    cfg = ot.RenderConfig(width=24, height=12, spp=2, max_depth=3)
    calls = []
    got = ot.render(scene, cfg, seed=4, device="cpu", progress_blocks=5,
                    progress=lambda done, total, img: calls.append(
                        (done, total, img.shape, img.device.type)))
    assert torch.equal(got, ot.render(scene, cfg, seed=4, device="cpu"))
    assert [c[0] for c in calls] == [3, 6, 9, 12]
    assert all(c[1:] == (12, (12, 24, 3), "cpu") for c in calls)


def _fit_case(mod):
    """tests/test_inverse.py:167: the README scene's second albedo moved,
    a target from the true scene, 32x16, 2 spp, depth 3."""
    true = mod.readme_scene()
    cfg = mod.RenderConfig(width=32, height=16, spp=2, max_depth=3)
    if mod is ort:
        bad = true.spheres.albedo.at[1].set(jnp.array([0.3, 0.8, 0.5]))
        target = ort.render(true, cfg.replace(early_stop=False), seed=2)
    else:
        bad = true.spheres.albedo.clone()
        bad[1] = torch.tensor([0.3, 0.8, 0.5])
        target = ot.render(true, cfg.replace(early_stop=False), seed=2,
                           device="cpu")
    init = dataclasses.replace(true, spheres=dataclasses.replace(
        true.spheres, albedo=bad))
    return target, init, cfg


def test_fit_checkpoint_resume(tmp_path):
    kw = dict(param_paths=("spheres.albedo",), learning_rate=1e-2, seed=5,
              sample_new_noise=True)
    target, init, cfg = _fit_case(ot)
    full, losses_full = ot.fit_scene(target, init, cfg, steps=3,
                                     device="cpu", **kw)
    path = str(tmp_path / "fit.pt")
    ot.fit_scene(target, init, cfg, steps=1, checkpoint_path=path,
                 checkpoint_every=1, device="cpu", **kw)
    resumed, losses = ot.fit_scene(target, init, cfg, steps=3,
                                   checkpoint_path=path, checkpoint_every=5,
                                   device="cpu", **kw)
    assert losses == losses_full
    assert torch.equal(resumed.spheres.albedo, full.spheres.albedo)
    assert os.listdir(tmp_path) == ["fit.pt"]
    with pytest.raises(ValueError, match="parameters"):
        ot.fit_scene(target, init, cfg, steps=4, checkpoint_path=path,
                     device="cpu", **{**kw, "param_paths": ("spheres.fuzz",)})

    jtarget, jinit, jcfg = _fit_case(ort)
    jpath = str(tmp_path / "jfit.npz")
    jax_fit_scene(jtarget, jinit, jcfg, steps=1, checkpoint_path=jpath,
                  checkpoint_every=1, grad_backend="jnp", **kw)
    jfit, jlosses = jax_fit_scene(jtarget, jinit, jcfg, steps=3,
                                  checkpoint_path=jpath, checkpoint_every=1,
                                  grad_backend="jnp", **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(resumed.spheres.albedo.numpy(),
                               np.asarray(jfit.spheres.albedo), atol=1e-4)


def test_entry_points_need_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render_checkpointed(ot.readme_scene(), cfg,
                               str(tmp_path / "c.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.render(ot.readme_scene(), cfg, progress=lambda *a: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ot.fit_scene(torch.zeros((4, 8, 3)), ot.readme_scene(), cfg,
                     checkpoint_path=str(tmp_path / "f.pt"))
    assert os.listdir(tmp_path) == []
