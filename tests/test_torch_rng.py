"""The port's counter RNG against the JAX package's: the hashes and uniforms
bit-equal, the samplers within 1e-6 (f32 sin/cos/sqrt differ by a few ulp
between XLA and ATen)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opencl_ray_tracer_tpu import rng as jrng
from opencl_ray_tracer_tpu_torch import rng as trng

torch.set_num_threads(1)

EDGES = [0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**31 + 1,
         0xFFFFFFFE, 0xFFFFFFFF]


def _counters():
    grid = np.array(list(itertools.product(EDGES, repeat=4)), np.uint64)
    rand = np.random.default_rng(0).integers(0, 2**32, size=(4096, 4),
                                             dtype=np.uint64)
    return np.concatenate([grid, rand]).T  # (4, N)


def test_pcg4d_bit_equal():
    cnt = _counters()
    want = jrng.pcg4d(*(jnp.asarray(c, jnp.uint32) for c in cnt))
    got = trng.pcg4d(*(torch.tensor(c.astype(np.int64)) for c in cnt))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


def test_uniform4_bit_equal():
    seed, pix, smp, slot = _counters()
    want = jrng.uniform4(jnp.asarray(seed, jnp.uint32),
                         jnp.asarray(pix, jnp.uint32),
                         jnp.asarray(smp, jnp.uint32),
                         jnp.asarray(slot, jnp.uint32))
    got = trng.uniform4(*(torch.tensor(c.astype(np.int64))
                          for c in (seed, pix, smp, slot)))
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["unit_vector", "in_unit_sphere",
                                  "in_unit_disk"])
def test_samplers_match(name):
    u = np.random.default_rng(1).uniform(size=(3, 5000)).astype(np.float32)
    n_args = 3 if name == "in_unit_sphere" else 2
    want = getattr(jrng, f"{name}_from_uniforms")(
        *(jnp.asarray(x) for x in u[:n_args]))
    got = getattr(trng, f"{name}_from_uniforms")(
        *(torch.tensor(x) for x in u[:n_args]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
