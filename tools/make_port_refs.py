#!/usr/bin/env python3
"""Record the JAX package's references that the port's tests hold it
against, where computing them takes most of a test's time:

    python tools/make_port_refs.py [NAME ...]

writes tests/goldens/torch_grad_refs.npz from the ``jax_references()``
of tests/test_torch_mesh_grad.py
(``render_grad_sampled(grad_backend="jnp")`` of three mesh scenes),
tests/test_torch_hdr_grad.py (the same of two HDR-sky scenes, and a
two-step sky-image fit and its target), tests/test_torch_grad.py (the
same of the reference scene, and ``render_and_grad`` of five sphere
scenes), tests/test_torch_soft.py (soft-visibility losses, images and
gradients of two scenes at two betas, and a soft fit's two steps),
tests/test_torch_parallel.py (a sharded image on four devices, a
matmul-route render, gradients of the reference scene at two sample
counts), tests/test_torch_megakernel.py (the Pallas sphere megakernel's
images in interpret mode), tests/test_torch_mesh_render.py (a mesh
scene's render), tests/test_torch_optimize.py (a two-step albedo fit and
its target) and tests/test_torch_examples.py (step 0 of the vertex and
sky-gain fit examples through their Pallas route in interpret mode, and
the sky fit's jnp route): each case's results, computed on the CPU with
the test suite's settings (tests/conftest.py), and the inputs they came
from (the scene's leaves and sky kind, the configuration, the seed and
the case's other inputs; tests/port_refs.py).  With NAMEs
(``mesh_grad``, ``examples``, ...), only those files' cases are recorded
again and the file's other arrays are kept.  A few minutes for all.  The
JAX package is the port's fixed reference, so the file changes only when
a case's inputs do: a test then fails, naming the inputs that differ,
and this records the file again.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

# the test files (tests/test_torch_<name>.py) whose jax_references() the
# file holds; each names its cases "<name>/..."
MODULES = ("mesh_grad", "hdr_grad", "grad", "soft", "parallel",
           "megakernel", "mesh_render", "optimize", "examples")


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import importlib
    names = sys.argv[1:] or list(MODULES)
    refs = {}
    for name in names:
        module = importlib.import_module(f"test_torch_{name}")
        refs.update(module.jax_references())
    path = os.path.join(ROOT, "tests", "goldens", "torch_grad_refs.npz")
    if sys.argv[1:]:
        with np.load(path) as old:
            kept = {k: old[k] for k in old.files
                    if k.split("/")[0] not in names}
        refs = {**kept, **refs}
    np.savez_compressed(path, **refs)
    print(f"wrote {len(refs)} arrays to {path}")


if __name__ == "__main__":
    main()
