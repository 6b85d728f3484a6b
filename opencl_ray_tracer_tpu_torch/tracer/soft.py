"""Soft-visibility rendering, for geometry gradients.

Hard visibility (the closest hit) gives interior gradients only: a sphere's
or a triangle's silhouette crossing a pixel is a step that autograd never
sees, so fits of centres and vertices get gradients near zero or of the
wrong sign.  Here the primary visibility is soft: every candidate (each
sphere, then each triangle) covers a ray with

    alpha_i = sigmoid(beta * m_i)

where m_i is a smooth signed silhouette margin, (r^2 - d_perp^2) / r^2 for
a sphere (d_perp: the ray's closest approach to its centre) and the least
barycentric coordinate of the plane point for a triangle.  Candidates are
composited front to back in the order of a smooth depth t,

    w_i = alpha_i * prod_{j before i} (1 - alpha_j),
    w_sky = prod_j (1 - alpha_j)

and each candidate's radiance is one scatter at its primary point followed
by a hard path-traced continuation (``estimator.trace`` with the full
closest-hit fold).  As beta grows this tends to the hard render.  The
forward costs O(n_spheres + n_triangles) times a hard render: it is meant
for fits at small sizes, not for production renders.  Gradients come from
autograd.  There is no kernel on this path: it is a chain of torch ops,
on the card or on the CPU.

The arithmetic follows the JAX package's XLA:CPU rounding where it can
(fma chains for the dot products and the ray points, as the plain tracer).
"""

from __future__ import annotations

import torch

from .._fp import clip01, dot3, fma, sqrt
from ..config import RenderConfig
from ..rng import SLOT_PIXEL_U, uniform4
from ..scene import Scene, camera_frame, rays_from_frame, sky_colour
from .estimator import bounce_uniforms, trace
from .intersect import cross
from .render import resolve_device
from .scatter import scatter


def _primary_candidates(scene: Scene, o, d, beta, t_min):
    """Per (ray, sphere): coverage alpha (R,S), smooth depth t (R,S),
    point (R,S,3) and outward normal (R,S,3)."""
    c = scene.spheres.center                      # (S,3)
    r = scene.spheres.radius                      # (S,)
    oc = c[None, :, :] - o[:, None, :]            # (R,S,3)
    dlen2 = dot3(d, d)[:, None]
    proj = dot3(oc, d[:, None, :]) / dlen2        # t of closest approach
    closest = fma(proj[..., None], d[:, None, :], o[:, None, :])
    diff = closest - c[None]
    d_perp2 = dot3(diff, diff)
    r2 = (r * r)[None, :]
    margin = (r2 - d_perp2) / r2                  # smooth, signed
    alpha = torch.sigmoid(beta * margin) * (proj > t_min)
    # the near root where the ray enters, the closest approach outside
    inside = sqrt(torch.clamp(r2 - d_perp2, min=1e-12) / dlen2)
    t = proj - inside * (margin > 0)
    point = fma(t[..., None], d[:, None, :], o[:, None, :])
    # ((point - c) / r) / max(|(point - c) / r|, 1e-8) with the two
    # divisions merged into one, as XLA rewrites a / b / c
    pc = point - c[None]
    rn = r[None, :, None]
    nn = sqrt(dot3(pc / rn, pc / rn))
    normal = pc / (rn * torch.clamp(nn, min=1e-8)[..., None])
    return alpha, t, point, normal


def _tri_candidates(scene: Scene, o, d, beta, t_min):
    """Per (ray, triangle): coverage alpha (R,T), plane depth t (R,T),
    plane point (R,T,3) and unit normal (R,T,3)."""
    tris = scene.triangles
    p0 = tris.p0
    e0 = tris.p1 - p0
    e1 = tris.p2 - p0
    n = cross(e0, e1)                             # (T,3)
    denom = dot3(d[:, None, :], n[None])          # (R,T)
    # a parallel ray: t goes behind the camera, so alpha is 0
    small = torch.where(denom < 0, -1e-8, 1e-8).to(denom.dtype)
    safe = torch.where(torch.abs(denom) < 1e-8, small, denom)
    num = dot3(p0, n)[None, :] - dot3(o[:, None, :], n[None])
    t = num / safe
    point = fma(t[..., None], d[:, None, :], o[:, None, :])
    s = point - p0[None]
    d00 = dot3(e0, e0)
    d01 = dot3(e0, e1)
    d11 = dot3(e1, e1)
    det = torch.clamp(fma(d00, d11, -(d01 * d01)), min=1e-20)
    s0 = dot3(s, e0[None])
    s1 = dot3(s, e1[None])
    u = fma(d11, s0, -(d01 * s1)) / det
    v = fma(d00, s1, -(d01 * s0)) / det
    margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    alpha = torch.sigmoid(beta * margin) * (t > t_min)
    normal = (n / torch.clamp(sqrt(dot3(n, n)), min=1e-20)[:, None]
              ).expand(point.shape)
    return alpha, t, point, normal


# Rays shaded in one batch: every candidate of every sample of a group
# (``render_soft``) goes through one scatter and one continuation, so that
# a step costs a few thousand launches on the card instead of a few
# thousand per candidate and sample.  The bound caps one batch's tensors;
# the graph that a step's backward needs holds every batch.  On an H100
# (``chip_smoke.py`` phase 27d) a soft forward and backward of the README
# scene at 64x36, depth 4, peaks 0.70 GiB above what was allocated before
# it at one full batch (22 spp, 253,440 candidate rays) and 1.14 GiB at
# two (44 spp).
SHADE_BATCH = 1 << 18


def _shade(scene: Scene, d, point, normal, albedo, fuzz, ior, mat_type,
           pixel_ids, sample_id, seed, max_depth, t_min):
    """Radiance of primary hits at ``point`` with the given materials: one
    scatter with bounce 0's draws, then the hard continuation from bounce
    1's slots with the scatter's attenuation as its throughput."""
    front_face = dot3(d, normal) < 0.0
    n_faced = torch.where(front_face[:, None], normal, -normal)
    sc = scatter(d, n_faced, front_face, albedo, fuzz, ior, mat_type,
                 bounce_uniforms(seed, pixel_ids, sample_id, 0))
    cont = trace(scene, point, sc.direction, pixel_ids, sample_id, seed,
                 max_depth - 1, t_min=t_min, first_bounce=1,
                 throughput=sc.attenuation)
    live = ~(sc.absorbed | sc.emitted)
    out = torch.where(live[:, None], cont, torch.zeros_like(cont))
    return torch.where(sc.emitted[:, None], albedo, out)


def render_soft_rays(scene: Scene, o, d, pixel_ids, sample_id, seed,
                     max_depth, t_min=1e-3, beta=80.0):
    """Soft-primary radiance of a ray batch, (R,3); sample_id is an int or
    an (R,) tensor.  The candidates are every sphere and every triangle,
    composited front to back by their smooth depth (a stable sort: the two
    triangles of a quad share a plane), and shaded in one batch."""
    groups = [(g, f) for g, f in ((scene.spheres, _primary_candidates),
                                  (scene.triangles, _tri_candidates))
              if g.count > 0]
    parts = [f(scene, o, d, beta, t_min) for _, f in groups]
    alpha, t, point, normal = (torch.cat([p[k] for p in parts], dim=1)
                               for k in range(4))
    order = torch.argsort(t, dim=1, stable=True)
    alpha_sorted = alpha.gather(1, order)
    trans = torch.cumprod(1.0 - alpha_sorted + 1e-12, dim=1)
    trans_before = torch.cat([torch.ones_like(trans[:, :1]),
                              trans[:, :-1]], dim=1)
    # each candidate's weight back in candidate order
    w_sorted = alpha_sorted * trans_before
    w = torch.zeros_like(w_sorted).scatter(1, order, w_sorted)
    out = trans[:, -1:] * sky_colour(scene.sky, d)

    # every candidate's rays, candidate-major, with its material
    r, n = alpha.shape

    def per_ray(field):
        return torch.cat([getattr(g, field) for g, _ in groups]
                         ).repeat_interleave(r, dim=0)

    sample_id = torch.as_tensor(sample_id, device=o.device).expand(r)
    li = _shade(scene, d.repeat(n, 1), point.transpose(0, 1).reshape(-1, 3),
                normal.transpose(0, 1).reshape(-1, 3), per_ray("albedo"),
                per_ray("fuzz"), per_ray("ior"), per_ray("mat_type"),
                pixel_ids.repeat(n), sample_id.repeat(n), seed, max_depth,
                t_min).reshape(n, r, 3)
    for i in range(n):
        out = out + w[:, i:i + 1] * li[i]
    return out


def render_soft(scene: Scene, cfg: RenderConfig, seed: int = 0,
                beta: float = 80.0, device=None):
    """Soft render of the full image, (H, W, 3) on ``device`` (None: the
    card, and raises without one), row 0 the image bottom, with the sample
    draws of ``render``.  Each sample is clamped to [0, 1] and a NaN
    channel counts 0, whatever cfg's NaN policy and clamp; the samples are
    added in order and the mean is taken at the end.  Samples go through
    ``render_soft_rays`` in groups of at most ``SHADE_BATCH`` candidate
    rays.  The viewport coordinates and the mean multiply by the
    reciprocal of the width, height and sample count, as XLA compiles the
    JAX package's divisions by them."""
    device = resolve_device(device)
    scene = scene.to(device)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    rows = torch.arange(h, device=device)[:, None].expand(h, w).reshape(-1)
    cols = torch.arange(w, device=device).repeat(h)
    pixel_ids = rows * w + cols
    frame = camera_frame(scene.camera)

    def inverse(x):
        return torch.tensor(1.0 / x, dtype=torch.float32, device=device)

    n_cand = scene.spheres.count + scene.triangles.count
    group = max(1, min(cfg.spp, SHADE_BATCH // max(1, n_pix * n_cand)))
    acc = torch.zeros((n_pix, 3), device=device)
    for s0 in range(0, cfg.spp, group):
        g = min(group, cfg.spp - s0)
        sample_id = torch.arange(s0, s0 + g, device=device
                                 ).repeat_interleave(n_pix)
        pix = pixel_ids.repeat(g)
        u0, u1, u2, u3 = uniform4(seed, pix, sample_id, SLOT_PIXEL_U)
        uu = (cols.repeat(g).to(torch.float32) + u0) * inverse(w)
        vv = (rows.repeat(g).to(torch.float32) + u1) * inverse(h)
        o, d = rays_from_frame(frame, uu, vv, u2, u3)
        colour = clip01(render_soft_rays(scene, o, d, pix, sample_id, seed,
                                         cfg.max_depth, t_min=cfg.t_min,
                                         beta=beta))
        colour = torch.where(torch.isnan(colour), torch.zeros_like(colour),
                             colour).reshape(g, n_pix, 3)
        for k in range(g):
            acc = acc + colour[k]
    return (acc * inverse(cfg.spp)).reshape(h, w, 3)
