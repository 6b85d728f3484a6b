"""The port's tracer modules against the JAX package's on the same numpy
inputs, the JAX side compiled with jit as the package runs it.  Tolerance
atol 1e-5: f32 sin/cos/sqrt differ by a few ulp between XLA and ATen, and
the values compared are of order 1 to 100."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu_torch.tracer import intersect as tint
from opencl_ray_tracer_tpu_torch.tracer import scatter as tsc
from opencl_ray_tracer_tpu_torch.tracer import estimator as test_

# the tracer packages re-export functions under the module names
jint = importlib.import_module("opencl_ray_tracer_tpu.tracer.intersect")
jsc = importlib.import_module("opencl_ray_tracer_tpu.tracer.scatter")
jest = importlib.import_module("opencl_ray_tracer_tpu.tracer.estimator")

torch.set_num_threads(1)
ATOL = 1e-5


def _close(got, want, what):
    """|got - want| <= ATOL * (1 + |want|) per ray: hits far out on the
    radius-100 ground sphere carry the cancellation of |oc|^2 - r^2 into t,
    so the error scales with the distance."""
    got, want = np.asarray(got), np.asarray(want)
    if got.ndim == 1:
        got, want = got[:, None], want[:, None]
    err = np.abs(got - want).max(axis=1)
    bound = ATOL * (1.0 + np.abs(want).max(axis=1))
    assert (err <= bound).all(), (what, float((err / bound).max()))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, size=(n, 3)).astype(np.float32)
    o[:, 2] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("name", ["readme_scene", "reference_scene"])
def test_closest_hit_matches(name):
    jscene, tscene = getattr(ort, name)(), getattr(ot, name)()
    o, d = _rays(4000, 5)
    want = jax.jit(lambda s, o, d: jint.closest_hit(s, o, d, 1e-3))(
        jscene, jnp.asarray(o), jnp.asarray(d))
    got = tint.closest_hit(tscene, torch.tensor(o), torch.tensor(d), 1e-3)
    hit = np.asarray(want.hit)
    assert 0.2 < hit.mean() < 0.95
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.mat_type.numpy(),
                                  np.asarray(want.mat_type))
    for field in ("t", "point", "normal", "albedo", "fuzz", "ior"):
        _close(getattr(got, field).numpy()[hit],
               np.asarray(getattr(want, field))[hit], field)
    ts = tint.hit_spheres(torch.tensor(o), torch.tensor(d),
                          tscene.spheres.center, tscene.spheres.radius, 1e-3)
    js = jax.jit(lambda *a: jint.hit_spheres(*a, 1e-3))(
        jnp.asarray(o), jnp.asarray(d), jscene.spheres.center,
        jscene.spheres.radius)
    _close(ts.numpy(), np.asarray(js), "hit_spheres t")


def test_closest_hit_refuses_triangles():
    """A triangle is tested only inside its gating box
    (gpu_kernel.cl:374-391): without a box, no ray hits it."""
    import dataclasses
    tv = torch.tensor([[[-1.0, -1.0, -2.0], [1.0, -1.0, -2.0],
                        [0.0, 1.0, -2.0]]])
    tris = ot.Triangles.from_vertices(tv, (0.5, 0.5, 0.5), 0.0, 0.0, 0)
    scene = dataclasses.replace(ot.readme_scene(), spheres=ot.Spheres.empty(),
                                triangles=tris)
    o = torch.zeros((2, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [0.1, 0.0, -1.0]])
    assert not tint.closest_hit(scene, o, d, 1e-3).hit.any()
    boxed = dataclasses.replace(scene, boxes=ot.BoundingBoxes.single(
        (-1.0, -1.0, -2.1), (1.0, 1.0, -1.9)))
    h = tint.closest_hit(boxed, o, d, 1e-3)
    assert h.hit.all()
    torch.testing.assert_close(h.t[0], torch.tensor(2.0))


def test_scatter_matches():
    rng = np.random.default_rng(6)
    n = 6000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    front = rng.uniform(size=n) < 0.5
    albedo = rng.uniform(size=(n, 3)).astype(np.float32)
    fuzz = rng.uniform(0, 0.5, size=n).astype(np.float32)
    ior = rng.choice([1.33, 1.5], size=n).astype(np.float32)
    mtype = rng.integers(0, 4, size=n).astype(np.int32)
    u = rng.uniform(size=(n, 8)).astype(np.float32)
    args = (d, nrm, front, albedo, fuzz, ior, mtype, u)
    want = jax.jit(jsc.scatter)(*(jnp.asarray(a) for a in args))
    got = tsc.scatter(*(torch.tensor(a) for a in args))
    np.testing.assert_array_equal(got.absorbed.numpy(),
                                  np.asarray(want.absorbed))
    np.testing.assert_array_equal(got.emitted.numpy(),
                                  np.asarray(want.emitted))
    np.testing.assert_allclose(got.direction.numpy(),
                               np.asarray(want.direction), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got.attenuation.numpy(),
                               np.asarray(want.attenuation), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("nan_policy", ["running_sum", "zero"])
@pytest.mark.parametrize("clamp", [True, False])
def test_accumulate_sample_matches(nan_policy, clamp):
    rng = np.random.default_rng(7)
    acc = rng.uniform(0, 5, size=(500, 3)).astype(np.float32)
    colour = rng.uniform(-0.5, 1.5, size=(500, 3)).astype(np.float32)
    colour[rng.uniform(size=(500, 3)) < 0.2] = np.nan
    want = jax.jit(lambda a, c: jest.accumulate_sample(a, c, nan_policy,
                                                       clamp))(
        jnp.asarray(acc), jnp.asarray(colour))
    got = test_.accumulate_sample(torch.tensor(acc), torch.tensor(colour),
                                  nan_policy, clamp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert not np.isnan(got.numpy()).any()


def test_trace_matches():
    """One sample's bounce loop (the per-sample estimator form)."""
    jscene, tscene = ort.reference_scene(), ot.reference_scene()
    o, d = _rays(3000, 8)
    pix = np.arange(3000, dtype=np.int32)
    want = jax.jit(lambda s, o, d, p: jest.trace(s, o, d, p, 3,
                                                 jnp.uint32(9), 6))(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(pix))
    got = test_.trace(tscene, torch.tensor(o), torch.tensor(d),
                      torch.tensor(pix.astype(np.int64)), 3, 9, 6)
    diff = np.abs(got.numpy() - np.asarray(want))
    # a path that crosses a discrete event (hit/miss, absorb) under an ulp
    # of difference diverges; nearly every path agrees to fp noise
    assert (diff > ATOL).any(axis=1).mean() < 0.005
