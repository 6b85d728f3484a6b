"""The JAX package's gradient references that the port's tests hold it
against, read from tests/goldens/torch_grad_refs.npz.

``tools/make_port_refs.py`` writes the file from the tests'
``jax_references()``, which compute JAX's ``render_grad_sampled`` and pass
it to ``record`` with the inputs it was computed from: the JAX scene's
leaves and sky kind, the configuration's fields and the seed.  ``load``
returns a case's loss, image and gradient leaves only after checking that
they were recorded from the inputs the test passes it, so that a test whose
case changed fails with a message to record the file again rather than as
a mismatch of the port.
"""

import dataclasses
import os

import numpy as np

from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

PATH = os.path.join(os.path.dirname(__file__), "goldens",
                    "torch_grad_refs.npz")


def _inputs(scene, cfg, seed: int) -> dict:
    leaves = scene_to_numpy(scene)
    return {**{f"input/scene/{k}": v for k, v in leaves.items()},
            "input/sky_kind": np.asarray(int(scene.sky.kind)),
            "input/cfg": np.asarray(
                repr(sorted(dataclasses.asdict(cfg).items()))),
            "input/seed": np.asarray(int(seed))}


def record(prefix: str, scene, cfg, seed: int, loss, img, grads) -> dict:
    """The arrays of one case under ``prefix``: JAX's loss, image and
    gradient leaves, and the inputs they came from."""
    arrays = {"loss": np.float32(loss), "img": np.asarray(img),
              **scene_to_numpy(grads), **_inputs(scene, cfg, seed)}
    return {f"{prefix}/{k}": v for k, v in arrays.items()}


def load(prefix: str, scene, cfg, seed: int):
    """(loss, image, gradient leaves) recorded under ``prefix``, after
    asserting that they were recorded from ``scene``, ``cfg`` and
    ``seed`` (the JAX package's scene and configuration)."""
    with np.load(PATH) as z:
        got = {k[len(prefix) + 1:]: z[k] for k in z.files
               if k.startswith(prefix + "/")}
    want = _inputs(scene, cfg, seed)
    keys = set(want) | {k for k in got if k.startswith("input/")}
    stale = sorted(k for k in keys if k not in got or k not in want
                   or got[k].shape != want[k].shape
                   or not np.array_equal(got[k], want[k]))
    assert not stale, (
        f"{PATH} holds the references of {prefix} for other inputs "
        f"({', '.join(stale)}): record them again with "
        "python tools/make_port_refs.py")
    refs = {k: v for k, v in got.items() if not k.startswith("input/")}
    return float(refs.pop("loss")), refs.pop("img"), refs
