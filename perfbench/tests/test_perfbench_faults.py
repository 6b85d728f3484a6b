"""The check's control and faults at a size a test can hold: a whole run
on the CPU (the card's check skipped), with the timed path broken, reads
``correct`` false; the sound run reads it true.

The control is the reference computed in bfloat16 put in the program's
place.  The faults: the state left unchanged (a render that returns an
untouched canvas; a fit step that does not update), half of the batch
left out with the mean taken over the rest (half the samples of an image;
half the image's rows in a step's gradient, the rest counted double), and
an answer altered where it is produced (the image offset; the image
scaled inside the step)."""

import pytest
import torch

from perfbench.reference import tracer as ref
from perfbench.tests.tiny import run, tiny_copy

RENDER_CELLS = ["readme.render", "flagship.render"]
FIT_CELLS = ["flagship.fit"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def _bf16_image(scene, cfg, seed, param_paths=()):
    """The reference's image of a port scene in bfloat16, differentiable
    in the leaves ``param_paths``."""
    from opencl_ray_tracer_tpu_torch.scene import get_leaf, scene_to_numpy
    leaves = scene_to_numpy(scene)
    params = {p: get_leaf(scene, p).to(torch.bfloat16) for p in param_paths}
    rs = ref.RenderSettings(cfg.width, cfg.height, cfg.spp, cfg.max_depth,
                            nan_policy="zero" if param_paths else
                            cfg.nan_policy)
    s = ref.Scene(leaves, scene.sky.kind, "cpu", torch.bfloat16, params)
    img = ref.render_pixels(s, rs, torch.arange(cfg.width * cfg.height),
                            seed)
    return img.float().reshape(cfg.height, cfg.width, 3)


@pytest.mark.parametrize("cell", RENDER_CELLS + FIT_CELLS)
def test_sound_run_is_correct(root, cell):
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1


RENDER_FAULTS = {
    "control_bf16": lambda render: (
        lambda scene, cfg, seed=0, device=None: _bf16_image(scene, cfg,
                                                            seed)),
    "state_unchanged": lambda render: (
        lambda scene, cfg, seed=0, device=None: torch.zeros(
            (cfg.height, cfg.width, 3))),
    "half_samples": lambda render: (
        lambda scene, cfg, seed=0, device=None: render(
            scene, cfg.replace(spp=cfg.spp // 2), seed, device)),
    "answer_altered": lambda render: (
        lambda scene, cfg, seed=0, device=None: render(
            scene, cfg, seed, device) + torch.tensor([0.05, 0.0, 0.0])),
}


@pytest.mark.parametrize("fault", sorted(RENDER_FAULTS))
@pytest.mark.parametrize("cell", RENDER_CELLS)
def test_render_fault_is_not_correct(root, cell, fault, monkeypatch):
    import opencl_ray_tracer_tpu_torch as ot
    monkeypatch.setattr(ot, "render", RENDER_FAULTS[fault](ot.render))
    result = run(root, cell)
    assert not result["correct"], result["checks"]


def _broken_renderer(step_renderer, fault):
    def renderer(init_scene, cfg, param_paths, *args):
        render_fn, scene0 = step_renderer(init_scene, cfg, param_paths,
                                          *args)

        def broken(scene, step_seed):
            if fault == "control_bf16":
                return _bf16_image(scene, cfg, step_seed, param_paths)
            img = render_fn(scene, step_seed)
            if fault == "answer_altered":
                return img * 1.1
            # half of the batch: the lower rows carry no gradient, the
            # upper count double
            keep = torch.zeros_like(img)
            keep[img.shape[0] // 2:] = 2.0
            return img.detach() + keep * (img - img.detach())
        return broken, scene0
    return renderer


@pytest.mark.parametrize("fault", ["control_bf16", "state_unchanged",
                                   "half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_fault_is_not_correct(root, cell, fault, monkeypatch):
    from opencl_ray_tracer_tpu_torch import optimize
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    else:
        monkeypatch.setattr(optimize, "_step_renderer", _broken_renderer(
            optimize._step_renderer, fault))
    result = run(root, cell)
    assert not result["correct"], result["checks"]
