"""The port's winner-only differentiable hit (tracer/diffhit.py).

- Against the JAX package's ``winner_hitinfo`` on random rays: the same
  hit records, and the same gradients of a weighted sum of the record
  with respect to the spheres and the rays (relative 1e-5).
- Against autograd through the whole closest-hit fold of the port: the
  interior-derivative convention makes them equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as ort
import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu.tracer import diffhit as jdh
from opencl_ray_tracer_tpu.tracer.intersect import closest_fold as jfold
from opencl_ray_tracer_tpu_torch.scene import replace_leaves
from opencl_ray_tracer_tpu_torch.tracer import diffhit as tdh
from opencl_ray_tracer_tpu_torch.tracer.intersect import BIG, closest_hit

torch.set_num_threads(1)

T_MIN = 1e-3
SPHERE_LEAVES = ("center", "radius", "albedo", "fuzz", "ior")


def _rays(n=256, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[:, 2] += 1.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.5
    w = rng.normal(size=(n, 16)).astype(np.float32)
    return o, d, w


def _weighted(h, w, hit, lib):
    """A scalar that reads every float field of the hit record on hit
    lanes."""
    fields = (h.t[:, None], h.point, h.normal, h.albedo, h.fuzz[:, None],
              h.ior[:, None])
    cat = lib.concatenate if lib is jnp else torch.cat
    v = cat(fields, -1) * w[:, :12]
    return (v.sum(-1) * hit).sum()


@pytest.fixture(scope="module")
def jax_result():
    o, d, w = _rays()
    js = ort.reference_scene()

    def f(leaves, o, d):
        sph = dataclasses.replace(js.spheres, **leaves)
        scene = dataclasses.replace(js, spheres=sph)
        best_t, kind, idx = jfold(jax.lax.stop_gradient(scene), o, d, T_MIN)
        hit = best_t < BIG
        h = jdh.winner_hitinfo(scene, o, d, kind, idx, hit, T_MIN)
        return _weighted(h, w, hit.astype(jnp.float32), jnp), (h, hit)

    (val, (h, hit)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(
            {k: getattr(js.spheres, k) for k in SPHERE_LEAVES},
            jnp.asarray(o), jnp.asarray(d))
    return (o, d, w), np.asarray(val), h, np.asarray(hit), grads


def _port(o, d, w, hit_fn_factory):
    scene = ot.reference_scene()
    leaves = {f"spheres.{k}": getattr(scene.spheres, k).clone()
              .requires_grad_() for k in SPHERE_LEAVES}
    scene = replace_leaves(scene, leaves)
    to = torch.tensor(o, requires_grad=True)
    td = torch.tensor(d, requires_grad=True)
    h = hit_fn_factory(scene)(to, td)
    val = _weighted(h, torch.tensor(w), h.hit.float(), torch)
    grads = torch.autograd.grad(val, [*leaves.values(), to, td])
    return val, h, dict(zip([*SPHERE_LEAVES, "o", "d"], grads))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_winner_hitinfo_matches_jax(jax_result):
    (o, d, w), jval, jh, jhit, (jsph, jo, jd) = jax_result
    val, h, grads = _port(o, d, w, lambda s: tdh.make_grad_hit_fn(s, T_MIN))
    assert 0.3 < jhit.mean() < 1.0      # both hits and misses
    np.testing.assert_array_equal(h.hit.numpy(), jhit)
    m = jhit
    for name in ("t", "point", "normal", "albedo", "fuzz", "ior"):
        np.testing.assert_allclose(getattr(h, name).detach().numpy()[m],
                                   np.asarray(getattr(jh, name))[m],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(h.front_face.numpy()[m],
                                  np.asarray(jh.front_face)[m])
    assert _rel(val.detach(), jval) < 1e-5
    for k in SPHERE_LEAVES:
        assert _rel(grads[k], jsph[k]) < 1e-5, k
    assert _rel(grads["o"], jo) < 1e-5
    assert _rel(grads["d"], jd) < 1e-5


def test_winner_hitinfo_matches_whole_fold_autograd():
    """Winner-only recompute against autograd through the whole fold."""
    o, d, w = _rays(seed=1)
    val, h, grads = _port(o, d, w, lambda s: tdh.make_grad_hit_fn(s, T_MIN))
    bval, bh, bgrads = _port(
        o, d, w, lambda s: (lambda o_, d_: closest_hit(s, o_, d_, T_MIN)))
    assert torch.equal(h.hit, bh.hit)
    assert torch.equal(h.t[h.hit], bh.t[bh.hit])
    assert torch.equal(h.normal[h.hit], bh.normal[bh.hit])
    for k, g in grads.items():
        torch.testing.assert_close(g, bgrads[k], rtol=1e-5, atol=1e-7)


def test_grad_hit_fn_refuses_what_later_slices_port():
    """Since slice 3b the triangle branch and the kernel winner search are
    ported (tests/test_torch_mesh_grad.py); what stays refused is a winner
    search the port does not have.  A sphere scene under "pallas" takes
    the plain fold, as the JAX package's does."""
    scene = ot.reference_scene()
    with pytest.raises(ValueError, match="winner_backend"):
        tdh.make_grad_hit_fn(scene, T_MIN, winner_backend="jnp")
    o, d, _ = _rays(16)
    o, d = torch.tensor(o), torch.tensor(d)
    plain = tdh.make_grad_hit_fn(scene, T_MIN)(o, d)
    kernel = tdh.make_grad_hit_fn(scene, T_MIN, winner_backend="pallas")(o, d)
    assert torch.equal(plain.t, kernel.t) and torch.equal(plain.hit,
                                                          kernel.hit)
    tri = ot.Triangles(*(torch.zeros((1, 3)) for _ in range(4)),
                       torch.zeros(1), torch.ones(1),
                       torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.int32))
    mesh = dataclasses.replace(scene, triangles=tri)
    # a degenerate triangle outside any gating box: the spheres' record
    h = tdh.make_grad_hit_fn(mesh, T_MIN)(o, d)
    assert torch.equal(h.t[h.hit], plain.t[plain.hit])
