"""The port's ``parallel/`` (``torch.distributed``, one process a device)
against the JAX package's ``parallel/`` on the CPU.

- ``shard_triangles`` against JAX's, leaf for leaf.
- A single process (no process group): ``make_mesh`` gives the 1x1 mesh,
  ``describe`` lists it, ``render_sharded`` and ``render_grad_sharded``
  equal ``render`` and ``render_grad_sampled``, the entry points raise
  without a card unless asked for the CPU, and ``init_distributed`` reads
  its arguments or torchrun's environment.
- Two worlds of four ranks (tests/torch_parallel_worker.py, which imports
  the port and not JAX), one test each: gloo through a file in tmp_path
  (no port to collide on between xdist workers), a gloo timeout of 60 s,
  and 120 s for the whole world, after which every rank is killed.
  Every rank's results must equal rank 0's.  The JAX oracles that take
  seconds are recorded with their inputs in
  tests/goldens/torch_grad_refs.npz by ``tools/make_port_refs.py``
  (``jax_references`` below; ``port_refs.load`` checks the inputs).
  - Render world: the README scene at 32x16x8/d4 (early_stop off) on a
    4x1 mesh, bit for bit ``render(device="cpu")``, and within the image
    tolerance (at most 0.2% of values off by more than 1e-4, means within
    1e-4, tests/test_golden.py) of JAX's ``render_sharded`` on 4 of
    conftest's 8 virtual devices; on a 2x2 mesh within 1e-5 of
    ``render`` (tests/test_sharding.py:42-49).  ``ring_hit_fn`` and
    ``ring_hit_fn_mm`` over 4 shards (the last all padding) of
    tests/test_sharding.py's three-triangle scene, against JAX's
    ``closest_hit`` on 64 rays: hit and material equal, t within 1e-6
    relative for the direct form and 1e-5 for the matmul form (its t
    differs by rounding, tests/test_sharding.py:173-174).  The geometry
    ring's render on a 2x2 mesh at 32x16x4/d4 against JAX's matmul-route
    render under tests/test_sharding.py:210-212's tolerance.
  - Gradient world, 4x1: ``render_grad_sharded`` against JAX's
    ``render_grad_sampled(grad_backend="jnp")``: the reference scene's
    spheres at 32x16x3/d5 (5e-3 per leaf, tests/test_torch_grad.py), the
    gradient-sky mesh case of tests/test_torch_mesh_grad.py and the HDR
    mesh case of tests/test_torch_hdr_grad.py, each under its file's
    tolerances and from its recorded reference; and ``make_train_step``'s
    "plain" and "kernel" routes, one SGD step at lr 0 (the loss, and no
    move) and at lr 1 (the move is the albedo gradient, 5e-3 against the
    sphere case's), as tests/test_sharding.py:214-247; and the "kernel"
    route's lr-1 step on the mesh and HDR cases' sphere albedo against
    their JAX gradients (5e-4 and 5e-3, each case's albedo tolerance);
    and the "plain" route's lr-1 step on a 2x2 grid (the sample mean's
    transpose) at 32x16x4/d5, its loss within 1e-4 and its move within
    5e-3 of JAX's albedo gradient there.
- ``examples/multichip_render_torch.py`` at world 1 on the CPU.
"""

import datetime
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
import test_torch_grad
import test_torch_hdr_grad
import test_torch_mesh_grad
from opencl_ray_tracer_tpu import parallel as jpar
from opencl_ray_tracer_tpu.scene import BoundingBoxes as JBoxes
from opencl_ray_tracer_tpu.scene import Triangles as JTriangles
from opencl_ray_tracer_tpu.tracer.intersect import closest_hit
from opencl_ray_tracer_tpu.tracer.mesh_accel import make_mm_hit_fn
from opencl_ray_tracer_tpu.tracer.render import render_grad_sampled
from opencl_ray_tracer_tpu.tracer.render import render_rows as jax_rows
from opencl_ray_tracer_tpu_torch import parallel as par
from opencl_ray_tracer_tpu_torch.scene import (materials, replace_leaves,
                                               scene_from_numpy,
                                               scene_to_numpy)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
RANKS = 4
WORLD_TIMEOUT_S = 120
RENDER_CFG = dict(width=32, height=16, spp=8, max_depth=4, early_stop=False)
RING_CFG = dict(width=32, height=16, spp=4, max_depth=4, early_stop=False)
SPHERE_CFG = dict(width=32, height=16, spp=3, max_depth=5, nan_policy="zero")
SPHERE_SEED = 7
# the plain train step on the 2x2 grid: the sample axis cuts spp
GRID_STEP_CFG = dict(SPHERE_CFG, spp=4)


def _mesh_scene():
    """tests/test_sharding.py's scene: the README spheres and three metal
    triangles in one box."""
    tv = np.array([
        [[-1.5, -0.2, -1.6], [-0.5, -0.2, -1.6], [-1.0, 0.8, -1.6]],
        [[0.5, -0.2, -1.4], [1.5, -0.2, -1.4], [1.0, 0.8, -1.4]],
        [[-0.5, -0.4, -0.9], [0.5, -0.4, -0.9], [0.0, 0.4, -0.9]],
    ], np.float32)
    tris = JTriangles.from_vertices(tv, albedo=(0.8, 0.6, 0.2), fuzz=0.2,
                                    ior=0.0, mat_type=materials.METAL,
                                    box_id=0)
    boxes = JBoxes.single((-1.6, -0.5, -1.7), (1.6, 0.9, -0.8))
    return ort.Scene(ort.readme_scene().camera, ort.readme_scene().spheres,
                     tris, boxes, ort.readme_scene().sky)


def _rays():
    rng = np.random.default_rng(0)
    r = 64
    o = np.zeros((r, 3), np.float32)
    d = np.stack([rng.uniform(-1.5, 1.5, r), rng.uniform(-0.5, 1, r),
                  -np.ones(r)], axis=1).astype(np.float32)
    return o, d


def _to_port(jscene):
    return scene_from_numpy(scene_to_numpy(jscene), jscene.sky.kind)


def _grad_cases():
    """name: (JAX scene, configuration fields, seed, golden prefix)."""
    mesh_make, mesh_seed, _ = test_torch_mesh_grad.CASES["gradient_sky"]
    hdr = test_torch_hdr_grad
    return {
        "sphere": (ort.reference_scene(), SPHERE_CFG, SPHERE_SEED,
                   "parallel/sphere"),
        "mesh": (mesh_make(), test_torch_mesh_grad.CFG, mesh_seed,
                 "mesh_grad/gradient_sky"),
        "hdr": (hdr._scene(ort, "mesh"),
                dict(width=32, height=16, spp=hdr.CASES["mesh"], max_depth=4,
                     nan_policy="zero"), 0, "hdr_grad/mesh"),
    }


def jax_references() -> dict:
    """JAX's render_sharded image on 4 devices, its matmul-route render of
    the ring's scene, render_grad_sampled(grad_backend="jnp") of the
    sphere case, and the loss and albedo gradient of the same at
    GRID_STEP_CFG, with their inputs (``tools/make_port_refs.py`` records
    them)."""
    cfg = ort.RenderConfig(**RENDER_CFG)
    mesh = jpar.make_mesh(n_tile=RANKS, devices=jax.devices()[:RANKS])
    refs = port_refs.record(
        "parallel/tile_4x1", ort.readme_scene(), cfg, 0,
        img=jpar.render_sharded_jit(ort.readme_scene(), cfg, mesh, seed=0),
        inputs={"devices": RANKS})
    scene, rcfg = _mesh_scene(), ort.RenderConfig(**RING_CFG)
    img = jax_rows(scene, rcfg, jnp.int32(0), rcfg.height, jnp.uint32(0),
                   hit_fn=make_mm_hit_fn(scene))
    refs.update(port_refs.record("parallel/ring_mm_render", scene, rcfg, 0,
                                 img=img))
    jscene, jcfg = ort.reference_scene(), ort.RenderConfig(**SPHERE_CFG)
    loss, img, g = render_grad_sampled(jscene, jcfg,
                                       test_torch_grad.jax_loss,
                                       seed=SPHERE_SEED, grad_backend="jnp")
    refs.update(port_refs.record("parallel/sphere", jscene, jcfg,
                                 SPHERE_SEED, loss, img, g))
    jcfg = ort.RenderConfig(**GRID_STEP_CFG)
    loss, _, g = render_grad_sampled(jscene, jcfg, test_torch_grad.jax_loss,
                                     seed=SPHERE_SEED, grad_backend="jnp")
    refs.update(port_refs.record(
        "parallel/sphere_grid_step", jscene, jcfg, SPHERE_SEED, loss,
        outputs={"spheres.albedo": g.spheres.albedo}))
    return refs


def _put(inputs, name, jscene, cfg=None, seed=None):
    inputs.update({f"{name}/{k}": v
                   for k, v in scene_to_numpy(jscene).items()})
    inputs[f"{name}_sky_kind"] = np.asarray(int(jscene.sky.kind))
    if cfg is not None:
        inputs[f"{name}_cfg"] = np.asarray(json.dumps(cfg))
    if seed is not None:
        inputs[f"{name}_seed"] = np.asarray(seed)


def _run_world(name, tmp_path, inputs):
    """Run the world's four ranks and return each one's outputs; kills
    every rank at WORLD_TIMEOUT_S."""
    np.savez(tmp_path / "inputs.npz", **inputs)
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, name, str(r), str(RANKS), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(RANKS)]
    deadline = datetime.datetime.now() + datetime.timedelta(
        seconds=WORLD_TIMEOUT_S)
    logs = []
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            logs.append(p.communicate(timeout=max(left, 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    outs = [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(RANKS)]
    for r in range(1, RANKS):
        for k, v in outs[0].items():
            if k != "describe":
                np.testing.assert_array_equal(outs[r][k], v, err_msg=k)
    return outs[0]


def _image_close(got, want):
    diff = np.abs(got - want)
    assert (diff > 1e-4).mean() < 0.002, diff.max()
    assert abs(got.mean() - want.mean()) < 1e-4


def test_shard_triangles_matches_jax():
    jscene = _mesh_scene()
    for n in (2, 4, 8):
        want = jpar.shard_triangles(jscene.triangles, n)
        got = par.shard_triangles(_to_port(jscene).triangles, n)
        for f in ("p0", "p1", "p2", "albedo", "fuzz", "ior", "mat_type",
                  "box_id"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_single_process_mesh_and_routes():
    """World 1 without a process group: the 1x1 mesh, and the sharded
    calls equal the single-device ones bit for bit."""
    assert not dist.is_initialized()
    mesh = par.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.world) == (
        {"tile": 1, "sample": 1}, 0, None)
    text = par.describe(mesh)
    assert "'tile': 1" in text and "rank 0" in text and "cpu" in text
    assert not par.is_multi_host()
    with pytest.raises(ValueError, match="1x1"):
        par.make_mesh(n_tile=2, device="cpu")
    scene = ot.readme_scene()
    cfg = ot.RenderConfig(width=16, height=8, spp=2, max_depth=4,
                          nan_policy="zero")
    img = par.render_sharded(scene, cfg, mesh, seed=3)
    assert torch.equal(img, ot.render(scene, cfg, seed=3, device="cpu"))

    def loss_fn(im):
        return torch.mean(im ** 2)

    loss, img, g = par.render_grad_sharded(scene, cfg, loss_fn, mesh,
                                           seed=3)
    l2, i2, g2 = ot.render_grad_sampled(scene, cfg, loss_fn, seed=3,
                                        grad_backend="kernel", device="cpu")
    assert float(loss) == float(l2) and torch.equal(img, i2)
    for k, v in scene_to_numpy(g2).items():
        np.testing.assert_array_equal(scene_to_numpy(g)[k], v, err_msg=k)


def test_argument_checks_and_devices(monkeypatch):
    mesh = par.make_mesh(device="cpu")
    scene = ot.readme_scene()
    with pytest.raises(ValueError, match="geometry_ring needs triangles"):
        par.render_sharded(scene, ot.RenderConfig(width=8, height=4, spp=1),
                           mesh, geometry_ring=True)
    with pytest.raises(ValueError, match="own intersection path"):
        par.render_sharded(scene, ot.RenderConfig(width=8, height=4, spp=1),
                           mesh, geometry_ring=True,
                           hit_fn_factory=lambda s: None)
    grid = par.Mesh(2, 2, 0, torch.device("cpu"), ())
    with pytest.raises(ValueError, match="height 5"):
        par.render_sharded(scene, ot.RenderConfig(width=8, height=5, spp=2),
                           grid)
    with pytest.raises(ValueError, match="spp 3"):
        par.render_sharded(scene, ot.RenderConfig(width=8, height=4, spp=3),
                           grid)
    with pytest.raises(ValueError, match="sample axis of 1"):
        par.render_grad_sharded(scene, ot.RenderConfig(width=8, height=4,
                                                       spp=2),
                                lambda im: im.sum(), grid)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.0)
    with pytest.raises(ValueError, match="template_scene"):
        par.make_train_step(ot.RenderConfig(width=8, height=4, spp=1), mesh,
                            opt, None, None, grad_backend="kernel")
    cover = scene_to_numpy(ot.book_cover_scene())    # 100 spheres
    many = scene_from_numpy({k: np.concatenate([v, v])
                             if k.startswith("spheres.") else v
                             for k, v in cover.items()},
                            ot.book_cover_scene().sky.kind)
    with pytest.raises(NotImplementedError, match="128"):
        par.make_train_step(ot.RenderConfig(width=8, height=4, spp=1), mesh,
                            opt, None, None, grad_backend="kernel",
                            template_scene=many)
    # on a mesh the kernel step fits vertices only
    torus = _to_port(test_torch_mesh_grad.CASES["gradient_sky"][0]())
    params = {"triangles.albedo": torus.triangles.albedo.clone()
              .requires_grad_()}
    step = par.make_train_step(
        ot.RenderConfig(width=8, height=4, spp=1), mesh,
        torch.optim.SGD(list(params.values()), lr=1.0),
        lambda im, t: im.mean(), lambda p: replace_leaves(torus, p),
        grad_backend="kernel", template_scene=torus)
    with pytest.raises(NotImplementedError, match="vertices only"):
        step(params, None, 0)
    # without a card, the card is what None means, and it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.init_distributed("tcp://localhost:1", 1, 0)


def test_init_distributed_arguments_and_environment(monkeypatch):
    """The init method, world size, rank, backend and timeout that
    init_distributed passes, from its arguments or torchrun's
    environment; False with neither (nothing initialised)."""
    calls = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert par.init_distributed() is False and not calls
    timeout = datetime.timedelta(seconds=7)
    assert par.init_distributed("localhost:1234", 2, 1, device="cpu",
                                timeout=timeout)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert par.init_distributed(device="cpu", backend="gloo")
    assert calls == [
        (("gloo",), dict(init_method="tcp://localhost:1234", world_size=2,
                         rank=1, timeout=timeout)),
        (("gloo",), dict(init_method="tcp://127.0.0.1:29555", world_size=4,
                         rank=3))]
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="this process's id"):
        par.init_distributed(device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert par.init_distributed() is True and len(calls) == 2


def test_render_world_matches_jax(tmp_path):
    jreadme, jmesh = ort.readme_scene(), _mesh_scene()
    inputs = {"render_cfg": np.asarray(json.dumps(RENDER_CFG)),
              "ring_cfg": np.asarray(json.dumps(RING_CFG))}
    _put(inputs, "readme", jreadme)
    _put(inputs, "mesh", jmesh)
    inputs["rays_o"], inputs["rays_d"] = _rays()
    out = _run_world("render", tmp_path, inputs)
    assert int(out["world"]) == RANKS
    text = str(out["describe"])
    assert "'tile': 4" in text and all(f"rank {r} (tile {r}" in text
                                       for r in range(RANKS))

    cfg = ot.RenderConfig(**RENDER_CFG)
    single = ot.render(_to_port(jreadme), cfg, seed=0, device="cpu").numpy()
    np.testing.assert_array_equal(out["tile_4x1"], single)
    _, jimg, _ = port_refs.load("parallel/tile_4x1", jreadme,
                                ort.RenderConfig(**RENDER_CFG), 0,
                                {"devices": RANKS})
    _image_close(out["tile_4x1"], jimg)
    np.testing.assert_allclose(out["tile_2x2"], single, atol=1e-5)

    o, d = _rays()
    want = jax.jit(lambda o, d: closest_hit(jmesh, o, d, 1e-3))(o, d)
    hit = np.asarray(want.hit)
    assert 0 < hit.sum() < hit.size
    for name, rtol in (("ring", 1e-6), ("ring_mm", 1e-5)):
        np.testing.assert_array_equal(out[f"{name}/hit"], hit)
        np.testing.assert_allclose(out[f"{name}/t"][hit],
                                   np.asarray(want.t)[hit], rtol=rtol)
        np.testing.assert_array_equal(out[f"{name}/mat_type"],
                                      np.asarray(want.mat_type))
        np.testing.assert_allclose(out[f"{name}/albedo"][hit],
                                   np.asarray(want.albedo)[hit], rtol=1e-6)

    _, want_img, _ = port_refs.load("parallel/ring_mm_render", jmesh,
                                    ort.RenderConfig(**RING_CFG), 0)
    diff = np.abs(out["ring_render"] - want_img)
    assert (diff > 1e-3).mean() < 0.01, (diff > 1e-3).mean()
    assert abs(out["ring_render"].mean() - want_img.mean()) < 2e-3


def test_grad_world_matches_jax(tmp_path):
    cases = _grad_cases()
    inputs = {"grid_step_cfg": np.asarray(json.dumps(GRID_STEP_CFG))}
    for name, (jscene, cfg, seed, _) in cases.items():
        _put(inputs, name, jscene, cfg, seed)
    out = _run_world("grad", tmp_path, inputs)
    refs = {name: port_refs.load(prefix, jscene, ort.RenderConfig(**cfg),
                                 seed)
            for name, (jscene, cfg, seed, prefix) in cases.items()}

    def grads(name):
        p = f"{name}/grad/"
        return {k[len(p):]: v for k, v in out.items() if k.startswith(p)}

    jloss, jimg, want = refs["sphere"]
    assert float(out["sphere/loss"]) == pytest.approx(jloss, rel=1e-4)
    diff = np.abs(out["sphere/img"] - jimg)
    assert (diff > 1e-4).mean() < 0.005 and diff.mean() < 1e-4
    test_torch_grad.assert_grads_close(grads("sphere"), want, 5e-3)

    jloss, jimg, want = refs["mesh"]
    assert abs(float(out["mesh/loss"]) - jloss) < 1e-6
    _image_close(out["mesh/img"], jimg)
    tol = test_torch_mesh_grad.CASES["gradient_sky"][2]
    errs = {k: float(np.abs(grads("mesh")[k] - want[k]).max())
            / max(float(np.abs(want[k]).max()), 1e-9) for k in tol}
    assert all(errs[k] < tol[k] for k in tol), errs
    assert np.abs(grads("mesh")["triangles.p0"]).max() > 0

    jloss, jimg, want = refs["hdr"]
    assert abs(float(out["hdr/loss"]) - jloss) < 1e-4
    assert (np.abs(out["hdr/img"] - jimg) > 1e-3).mean() < 0.01
    hdr = test_torch_hdr_grad
    hdr._check_leaves(scene_from_numpy(
        {**scene_to_numpy(_to_port(cases["hdr"][0])), **grads("hdr")},
        cases["hdr"][0].sky.kind), want, 5e-3, hdr.TEXELS_WITHIN["mesh"])

    # the kernel step on the mesh and HDR cases: its loss and its albedo
    # gradient against JAX's, under each case's albedo tolerance
    for name, tol in (("mesh", tol["spheres.albedo"]), ("hdr", 5e-3)):
        jloss, _, want = refs[name]
        assert float(out[f"step/{name}/loss"]) == pytest.approx(
            jloss, rel=1e-4), name
        move, g = out[f"step/{name}/move"], want["spheres.albedo"]
        err = float(np.abs(move - g).max()) / float(np.abs(g).max())
        assert err < tol, (name, err)

    jloss, _, want = refs["sphere"]
    for route in ("plain", "kernel"):
        assert float(out[f"step/{route}/0.0/loss"]) == pytest.approx(
            jloss, rel=1e-4), route
        assert not out[f"step/{route}/0.0/move"].any(), route
        move, g = out[f"step/{route}/1.0/move"], want["spheres.albedo"]
        err = float(np.abs(move - g).max()) / float(np.abs(g).max())
        assert err < 5e-3, (route, err)

    # the plain step on the 2x2 grid, at an spp the sample axis cuts
    jloss, _, want = port_refs.load(
        "parallel/sphere_grid_step", cases["sphere"][0],
        ort.RenderConfig(**GRID_STEP_CFG), SPHERE_SEED)
    assert float(out["step_2x2/loss"]) == pytest.approx(jloss, rel=1e-4)
    g = want["spheres.albedo"]
    err = float(np.abs(out["step_2x2/move"] - g).max()) / float(
        np.abs(g).max())
    assert err < 5e-3, err


def test_multichip_example_at_world_1(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import multichip_render_torch as example
    finally:
        sys.path.pop(0)
    out = tmp_path / "mc.png"
    example.main(["--cpu", "--width", "32", "--height", "16", "--spp", "2",
                  "--out", str(out)])
    text = capsys.readouterr().out
    assert out.exists() and "'tile': 1" in text and "samples/s" in text
