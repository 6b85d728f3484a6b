"""Which samples of an HDR render reach another texel in the port than in
the JAX package, and why: on the CPU.

    python tests/hdr_texel_flips.py [--seeds 0 1] [--spp 10]

Takes the mesh case of ``tests/test_torch_hdr_grad.py`` (the reference
scene with a 192-triangle torus under a tone-mapped 64x32 procedural sky,
32x16, depth 4, the "zero" NaN policy) and records each iteration's ray
directions in three wavefronts of the same samples:

- the port's plain HDR emit pass (``hdr_emit_plain``, what the port's
  fused route runs on CPU tensors), with its samples and misses;
- in the JAX package's ``render_grad_sampled(grad_backend="jnp")``, the
  test's oracle: the forward sweep of its differentiable scan, whose
  misses its sky-image gradient sums, and the while form of the same
  wavefront that probes the scan's length (both under ``jax.jit``, read
  through ``jax.debug.callback`` in the sky lookup).

The wavefronts take the same iterations lane by lane, so the directions
are compared ray by ray: the port's against the scan's and the while
form's, and the while form's against the scan's.  Prints one JSON line per seed and pair: the
misses whose texel differs, how many of them lie on another path
altogether, and how far the directions drift apart at each depth (the
share of rays that differ at all, the largest max|a - b| / |b|); then one
line per such miss: its pixel, sample and depth, both directions, their
u*W and v*H (a texel's edges are the integers), both texels and the
drift at each depth of its path.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import opencl_ray_tracer_tpu as ort  # noqa: E402
import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu.io.hdr import tone_map  # noqa: E402
from opencl_ray_tracer_tpu.io.obj import parse_obj  # noqa: E402
from opencl_ray_tracer_tpu.io.procgen import (make_sky_image,  # noqa: E402
                                              make_torus_obj)
from opencl_ray_tracer_tpu.scene.sky import direction_to_uv  # noqa: E402
from opencl_ray_tracer_tpu.tracer import wavefront as jwave  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene.sky import direction_to_uv as port_uv  # noqa: E402,E501

W, H, DEPTH = 32, 16, 4
SKY = tone_map(make_sky_image(64, 32))
# the module, which the package shadows with its function of the same name
jrender = importlib.import_module("opencl_ray_tracer_tpu.tracer.render")
REC: dict = {}           # form -> each iteration's directions


def scene(mod):
    tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    return mod.reference_scene(mesh_tris=tris, mesh_aabb=aabb,
                               sky=mod.Sky.hdr(SKY))


def jax_directions(spp: int, seed: int) -> tuple:
    """Each iteration's (W*H, 3) ray directions in the JAX package's
    ``render_grad_sampled(grad_backend="jnp")``: in its differentiable
    scan (the forward sweep, whose misses its sky-image gradient sums) and
    in the while form that probes the scan's length."""
    cfg = ort.RenderConfig(width=W, height=H, spp=spp, max_depth=DEPTH,
                           nan_policy="zero")
    REC.clear()
    REC.update(scan=[], while_=[])
    form = ["while_"]
    orig_sky, orig_scan = jwave.sky_colour, jwave.render_rows_wavefront_scan

    def recording(sky, d):
        # the form is fixed when the body is traced, the list looked up
        # when it runs: jax.jit keeps the traced body across seeds
        jax.debug.callback(
            lambda x, f=form[0]: REC[f].append(np.array(x)), d)
        return orig_sky(sky, d)

    def scan(*args, **kw):
        form[0] = "scan"
        try:
            return orig_scan(*args, **kw)
        finally:
            form[0] = "while_"

    # probe the scan's length anew, as the first call of a process does
    jrender._ITER_HIGH_WATER.clear()
    jwave.sky_colour, jwave.render_rows_wavefront_scan = recording, scan
    try:
        jrender.render_grad_sampled(scene(ort), cfg,
                                    lambda im: jnp.mean(im ** 2), seed=seed,
                                    grad_backend="jnp")
    finally:
        jwave.sky_colour, jwave.render_rows_wavefront_scan = (orig_sky,
                                                              orig_scan)
    # the while form runs twice (the image's render, the probe), the scan
    # forward then again in the backward sweep's recomputation
    n = len(REC["while_"]) // 2
    return REC["scan"][:len(REC["scan"]) // 2], REC["while_"][n:]


def port_directions(spp: int, seed: int) -> list:
    """Each iteration's (directions, sample ids, misses) in the port's
    plain HDR emit pass."""
    s = scene(ot)
    cfg = ot.RenderConfig(width=W, height=H, spp=spp, max_depth=DEPTH,
                          nan_policy="zero")
    rec = []
    orig = mg.render_rows_wavefront

    def recording(*args, miss_fn, **kw):
        def hook(d, sample, throughput, miss):
            rec.append((d.clone().numpy(), sample.clone().numpy(),
                        miss.clone().numpy()))
            return miss_fn(d, sample, throughput, miss)
        return orig(*args, miss_fn=hook, **kw)

    cam, sph, n, tab, flags, _ = mm.mesh_inputs(s, "cpu")
    mg.render_rows_wavefront = recording
    try:
        mg.hdr_emit_plain(cam, sph, n, tab, cfg, flags, seed, W * H)
    finally:
        mg.render_rows_wavefront = orig
    return rec


def rel_diff(a, b):
    """max over components of |a - b| / |b|, per ray."""
    return np.abs(a - b).max(-1) / np.linalg.norm(b, axis=-1)


def texels(u, v):
    x = np.clip((u * SKY.shape[1]).astype(np.int32), 0, SKY.shape[1] - 1)
    y = np.clip((v * SKY.shape[0]).astype(np.int32), 0, SKY.shape[0] - 1)
    return y, x


def texel_flips(rec_a, rec_b, prec, uv_a, uv_b, spp):
    """Walk the iterations of two recordings of the same wavefront (lists
    of (W*H, 3) directions) with the port's sample ids and misses; return
    the misses whose texels differ, and the directions' drift by depth."""
    depth = np.zeros(W * H, np.int64)
    last_sample = np.zeros(W * H, np.int64)
    drift = {}           # depth -> [rays, rays differing, max rel. diff]
    path = {}            # (pixel, sample) -> rel. diff at each depth
    flips = []
    split = np.full((W * H, 3), -1)     # iteration, sample, depth
    for k, (_, sample, miss) in enumerate(prec):
        da, db = rec_a[k], rec_b[k]
        depth = np.where(sample != last_sample, 0, depth)
        last_sample = sample
        active = sample < spp
        rel = rel_diff(da, db)
        first = active & (rel > 1e-2) & (split[:, 0] < 0)
        split[first] = np.stack([np.full(int(first.sum()), k),
                                 sample[first], depth[first]], -1)
        for dep in np.unique(depth[active]):
            m = active & (depth == dep)
            row = drift.setdefault(int(dep), [0, 0, 0.0])
            row[0] += int(m.sum())
            row[1] += int((rel[m] > 0).sum())
            row[2] = max(row[2], float(rel[m].max()))
        for p in np.nonzero(active)[0]:
            path.setdefault((int(p), int(sample[p])), []).append(
                float(rel[p]))
        if not miss.any():
            continue
        idx = np.nonzero(miss)[0]
        ua, va = uv_a(da[miss])
        ub, vb = uv_b(db[miss])
        ta, tb = texels(ua, va), texels(ub, vb)
        for i in np.nonzero((ta[0] != tb[0]) | (ta[1] != tb[1]))[0]:
            p = int(idx[i])
            flips.append(dict(
                pixel=[p // W, p % W], sample=int(sample[p]),
                # a direction that differs by more than a percent is
                # another path: one form took another branch (a hit for a
                # miss, another sample's ray), not a rounding of the same
                diverged=bool(rel[p] > 1e-2),
                # where the lane's paths first parted: iteration, sample
                # and depth in the first recording's count
                lane_split_at=split[p].tolist(),
                depth=int(depth[p]), iteration=k,
                directions=[da[p].tolist(), db[p].tolist()],
                uW_vH=[[float(ua[i]) * SKY.shape[1],
                        float(va[i]) * SKY.shape[0]],
                       [float(ub[i]) * SKY.shape[1],
                        float(vb[i]) * SKY.shape[0]]],
                texels=[[int(ta[0][i]), int(ta[1][i])],
                        [int(tb[0][i]), int(tb[1][i])]],
                rel_diff_by_depth=path[(p, int(sample[p]))]))
        depth = depth + 1
    return flips, {d: dict(rays=r[0], rays_differing=r[1],
                           share=r[1] / r[0], max_rel_diff=r[2])
                   for d, r in sorted(drift.items())}


def compare(spp: int, seed: int) -> None:
    scan, while_ = jax_directions(spp, seed)
    prec = port_directions(spp, seed)
    if min(len(scan), len(while_)) < len(prec):
        raise SystemExit(f"the JAX wavefront took {len(scan)} and "
                         f"{len(while_)} iterations, the port's {len(prec)}")
    juv_jit = jax.jit(direction_to_uv)

    def juv(d):
        return tuple(np.asarray(a) for a in juv_jit(jnp.asarray(d)))

    def puv(d):
        return tuple(a.numpy() for a in port_uv(torch.tensor(d)))

    port = [r[0] for r in prec]
    misses = int(sum(r[2].sum() for r in prec))
    pairs = {"port_vs_jax_scan": texel_flips(port, scan, prec, puv, juv,
                                             spp),
             "port_vs_jax_while": texel_flips(port, while_, prec, puv, juv,
                                              spp),
             "jax_while_vs_jax_scan": texel_flips(while_, scan, prec, juv,
                                                  juv, spp)}
    print(json.dumps({
        "seed": seed, "spp": spp, "size": f"{W}x{H}/d{DEPTH}",
        "iterations": len(prec), "miss_samples": misses,
        **{name: dict(texel_differs=len(flips),
                      paths_diverged=sum(f["diverged"] for f in flips),
                      drift_by_depth=drift)
           for name, (flips, drift) in pairs.items()}}))
    for name, (flips, _) in pairs.items():
        for f in flips:
            print(json.dumps({"seed": seed, "pair": name, **f}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--spp", type=int, default=10)
    args = ap.parse_args()
    torch.set_num_threads(1)
    for seed in args.seeds:
        compare(args.spp, seed)


if __name__ == "__main__":
    main()
