#!/usr/bin/env python3
"""Record the JAX package's gradient references that the port's tests
hold it against, where computing them takes most of a test's time:

    python tools/make_port_refs.py

writes tests/goldens/torch_grad_refs.npz from the ``jax_references()`` of
tests/test_torch_mesh_grad.py (``render_grad_sampled(grad_backend="jnp")``
of three mesh scenes), tests/test_torch_hdr_grad.py (the same of two
HDR-sky scenes) and tests/test_torch_grad.py (the same of the reference
scene): each case's loss, image and gradient leaves, computed on
the CPU with the test suite's settings (tests/conftest.py), and the inputs
they came from (the scene's leaves and sky kind, the configuration, the
seed; tests/port_refs.py).  The JAX package is the port's fixed reference,
so the file changes only when a case's scene, configuration or seed does:
a test then fails, naming the inputs that differ, and this records the
file again.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_grad
    import test_torch_hdr_grad
    import test_torch_mesh_grad
    refs = {**test_torch_mesh_grad.jax_references(),
            **test_torch_hdr_grad.jax_references(),
            **test_torch_grad.jax_references()}
    path = os.path.join(ROOT, "tests", "goldens", "torch_grad_refs.npz")
    np.savez_compressed(path, **refs)
    print(f"wrote {len(refs)} arrays to {path}")


if __name__ == "__main__":
    main()
