"""The port's ``fit_scene`` (optimize.py) against the JAX package's.

Two Adam steps on the README scene's albedo, from albedo + 0.1 towards a
target rendered from the true scene, on the plain route: the losses agree
to 1e-4 relative, and the albedos to 1e-4.  Adam's first step moves every
parameter by the learning rate times the sign of its gradient, so the
comparison holds when the two gradients agree in sign and roughly in size,
which the albedo's (smooth, all of one sign here) do.  JAX's two steps
(the target JAX renders, its losses and the fitted albedo) are recorded
with their inputs in tests/goldens/torch_grad_refs.npz (``python
tools/make_port_refs.py optimize``, ``jax_references`` below).
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
import port_refs
from opencl_ray_tracer_tpu.optimize import fit_scene as jax_fit_scene
from opencl_ray_tracer_tpu_torch.optimize import (extract_params,
                                                  insert_params)
from opencl_ray_tracer_tpu_torch.scene import scene_from_numpy, scene_to_numpy

torch.set_num_threads(1)

CFG = dict(width=24, height=14, spp=2, max_depth=4)


def _problem():
    true = ort.readme_scene()
    target = np.asarray(ort.render(true, ort.RenderConfig(**CFG), seed=11))
    init = dataclasses.replace(true, spheres=dataclasses.replace(
        true.spheres, albedo=true.spheres.albedo + 0.1))
    return target, init


def jax_references() -> dict:
    """JAX fit_scene's two steps from ``_problem()`` (its losses and the
    fitted albedo) with their inputs, keyed "optimize/two_steps/<name>"
    (``tools/make_port_refs.py`` records them)."""
    target, jinit = _problem()
    jscene, jlosses = jax_fit_scene(
        jnp.asarray(target), jinit, ort.RenderConfig(**CFG),
        param_paths=("spheres.albedo",), steps=2, learning_rate=1e-2,
        seed=4, grad_backend="jnp")
    return port_refs.record(
        "optimize/two_steps", jinit, ort.RenderConfig(**CFG), 4,
        outputs={"target": target,
                 "losses": np.asarray(jlosses, np.float64),
                 "albedo": jscene.spheres.albedo},
        inputs={"learning_rate": 1e-2, "steps": 2})


def test_two_steps_match_jax():
    true = ort.readme_scene()
    jinit = dataclasses.replace(true, spheres=dataclasses.replace(
        true.spheres, albedo=true.spheres.albedo + 0.1))
    _, _, refs = port_refs.load(
        "optimize/two_steps", jinit, ort.RenderConfig(**CFG), 4,
        inputs={"learning_rate": 1e-2, "steps": 2})
    target, jlosses, jalbedo = refs["target"], refs["losses"], refs["albedo"]
    seen = []
    tscene, tlosses = ot.fit_scene(
        torch.tensor(target), scene_from_numpy(scene_to_numpy(jinit),
                                               jinit.sky.kind),
        ot.RenderConfig(**CFG), param_paths=("spheres.albedo",), steps=2,
        learning_rate=1e-2, seed=4,
        callback=lambda i, loss, s: seen.append((i, loss)), device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert [i for i, _ in seen] == [0, 1] and seen[1][1] == tlosses[1]
    np.testing.assert_allclose(tscene.spheres.albedo.numpy(), jalbedo,
                               atol=1e-4)
    # everything else is untouched
    np.testing.assert_array_equal(tscene.spheres.center.numpy(),
                                  np.asarray(jinit.spheres.center))


def test_param_mask_and_fixed_noise():
    target, jinit = _problem()
    init = scene_from_numpy(scene_to_numpy(jinit), jinit.sky.kind)
    mask = torch.ones((5, 3))
    mask[0] = 0.0
    cfg = ot.RenderConfig(**CFG)
    fitted, losses = ot.fit_scene(
        torch.tensor(target), init, cfg, param_paths=("spheres.albedo",),
        steps=2, sample_new_noise=False, param_mask={"spheres.albedo": mask},
        device="cpu")
    assert torch.equal(fitted.spheres.albedo[0], init.spheres.albedo[0])
    assert not torch.equal(fitted.spheres.albedo[1], init.spheres.albedo[1])
    # a fixed seed makes step 0's loss the loss of the initial scene
    img = ot.render(init, cfg.replace(early_stop=False), seed=0,
                    device="cpu")
    assert losses[0] == pytest.approx(
        float(torch.mean((img - torch.tensor(target)) ** 2)), rel=1e-6)


def test_extract_insert_round_trip():
    scene = ot.reference_scene()
    paths = ("spheres.center", "camera.look_at", "sky.const_colour")
    params = extract_params(scene, paths)
    assert list(params) == list(paths)
    assert params["spheres.center"] is scene.spheres.center
    moved = insert_params(scene, {k: v + 1.0 for k, v in params.items()})
    back = extract_params(moved, paths)
    for k in paths:
        torch.testing.assert_close(back[k], params[k] + 1.0)
    # the scene passed in is not changed
    assert torch.equal(extract_params(scene, paths)["camera.look_at"],
                       params["camera.look_at"])
    assert moved.spheres.radius is scene.spheres.radius


def test_unported_options_raise():
    cfg = ot.RenderConfig(**CFG)
    target = torch.zeros((14, 24, 3))
    # soft fits (tests/test_torch_soft.py) and checkpointed fits
    # (tests/test_torch_checkpoint.py) are ported; a checkpoint interval
    # below one step and an unknown backend are refused
    with pytest.raises(ValueError, match="checkpoint_every"):
        ot.fit_scene(target, ot.readme_scene(), cfg,
                     checkpoint_path="fit.npz", checkpoint_every=0,
                     device="cpu")
    with pytest.raises(ValueError, match="grad_backend"):
        ot.fit_scene(target, ot.readme_scene(), cfg, grad_backend="pallas",
                     device="cpu")


def test_inverse_rendering_example_runs(tmp_path, capsys):
    """examples/inverse_rendering_torch.py in process at a tiny size: both
    stages run, the masked spheres' centres stay where they were, and the
    three images are written."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    try:
        import inverse_rendering_torch as example
    finally:
        sys.path.pop(0)
    out = str(tmp_path / "demo")
    run = example.main(["--cpu", "--steps", "1", "--size", "16", "--out",
                        out])
    for key in ("stage1_losses", "stage2_losses"):
        assert len(run[key]) == 1 and np.isfinite(run[key][0])
    start = run["init"].spheres.center
    fitted = run["fitted"].spheres.center
    others = [0, 2, 3, 4]
    assert torch.equal(fitted[others], start[others])
    assert fitted[1, 0] != start[1, 0]
    assert float(start[1, 0] - run["true"].spheres.center[1, 0]) == \
        pytest.approx(0.15)
    for part in ("target", "init", "fitted"):
        assert os.path.getsize(f"{out}_{part}.png") > 0
    assert "stage 2: center (soft visibility)" in capsys.readouterr().out
