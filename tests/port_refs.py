"""The JAX package's references that the port's tests hold it against,
where computing them would take most of a test's time, read from
tests/goldens/torch_grad_refs.npz.

``tools/make_port_refs.py`` writes the file from the tests'
``jax_references()``, which compute JAX's results (``render_grad_sampled``,
sharded and matmul-route images, soft-visibility losses, images and
gradients, a soft fit's history) and pass them to ``record`` with the
inputs they were computed from: the JAX scene's leaves and sky kind, the
configuration's fields, the seed and any other input the case names
(``inputs``).  ``load`` returns a case's loss, image and other arrays only
after checking that they were recorded from the inputs the test passes
it, so that a test whose case changed fails with a message to record the
file again rather than as a mismatch of the port.
"""

import dataclasses
import os

import numpy as np

from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

PATH = os.path.join(os.path.dirname(__file__), "goldens",
                    "torch_grad_refs.npz")


def _inputs(scene, cfg, seed: int, extra: dict | None = None) -> dict:
    leaves = scene_to_numpy(scene)
    return {**{f"input/scene/{k}": v for k, v in leaves.items()},
            "input/sky_kind": np.asarray(int(scene.sky.kind)),
            "input/cfg": np.asarray(
                repr(sorted(dataclasses.asdict(cfg).items()))),
            "input/seed": np.asarray(int(seed)),
            **{f"input/{k}": np.asarray(v) for k, v in (extra or {}).items()}}


def record(prefix: str, scene, cfg, seed: int, loss=None, img=None,
           grads=None, outputs: dict | None = None,
           inputs: dict | None = None) -> dict:
    """The arrays of one case under ``prefix``: JAX's loss, image,
    gradient leaves (a gradient Scene) and other ``outputs`` by name, each
    where given, and the inputs they came from (``inputs``: those besides
    the scene, configuration and seed)."""
    arrays = _inputs(scene, cfg, seed, inputs)
    if loss is not None:
        arrays["loss"] = np.float32(loss)
    if img is not None:
        arrays["img"] = np.asarray(img)
    if grads is not None:
        arrays.update(scene_to_numpy(grads))
    arrays.update({k: np.asarray(v) for k, v in (outputs or {}).items()})
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def load(prefix: str, scene, cfg, seed: int, inputs: dict | None = None):
    """(loss, image, the other arrays) recorded under ``prefix`` (None for
    a loss or image not recorded), after asserting that they were
    recorded from ``scene``, ``cfg``, ``seed`` (the JAX package's scene
    and configuration) and ``inputs``."""
    with np.load(PATH) as z:
        got = {k[len(prefix) + 1:]: z[k] for k in z.files
               if k.startswith(prefix + "/")}
    want = _inputs(scene, cfg, seed, inputs)
    keys = set(want) | {k for k in got if k.startswith("input/")}
    stale = sorted(k for k in keys if k not in got or k not in want
                   or got[k].shape != want[k].shape
                   or not np.array_equal(got[k], want[k]))
    assert not stale, (
        f"{PATH} holds the references of {prefix} for other inputs "
        f"({', '.join(stale)}): record them again with "
        "python tools/make_port_refs.py")
    refs = {k: v for k, v in got.items() if not k.startswith("input/")}
    loss = refs.pop("loss", None)
    loss = None if loss is None else float(loss)
    return loss, refs.pop("img", None), refs
