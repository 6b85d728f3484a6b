"""The plain reference path tracer: PyTorch operations only, no kernel,
no cache, nothing of the program.

It computes what the program's ``render`` and fit steps compute, for the
same scene leaves and seeds: the reference executable's estimator
(WillBurland/OpenCL-Ray-Tracer ``gpu_kernel.cl``: the closest hit over
spheres and box-gated triangles, Lambertian, fuzzy-metal, dielectric and
emissive scattering, a gradient or equirectangular HDR sky, a black path
at the depth limit, each sample clamped to [0, 1] before the average, a
NaN sample replaced by the running sum or by 0), with the path tracer's
counter-based draws.  The arithmetic is a frozen copy of the program's
plain version (fused multiply-adds, the triangle test in table form), so
that the two agree to rounding; the loop is its own: each sample's paths
are traced bounce by bounce with the finished rays dropped, many samples
at once, and the samples are then summed in order.

Gradients follow the interior-derivative convention: the winning
primitive of each ray segment is searched without autograd, and its hit
is then recomputed differentiably, so a gradient reaches a leaf through
the winners' hit points, normals, materials and sky texels only.

``dtype`` sets the working precision: float32 is the reference, and
bfloat16 the control that the correctness limits were set against.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .fp import atan2, clip01, cross, div, dot3, fma, sqrt, tan
from .rng import (SLOT_PIXEL_U, bounce_uniforms, in_unit_disk,
                  in_unit_sphere, uniform4, unit_vector)

BIG = 3.38e38           # no hit; finite in float32 and bfloat16
TRI_EPS = 1e-5           # the reference's parallel cull
NEAR_ZERO = 1e-8         # Vec3NearZero
TRI_CHUNK = 2048         # triangles per step of the closest-triangle fold
PAIR_BUDGET = 2**24      # (rays x triangles) elements per fold step

LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 0, 1, 2, 3
SKY_GRADIENT, SKY_HDR, SKY_CONST = 0, 1, 2

# the reference's pi literal
_DEG = float(3.141592654 / 180.0)
INV_TWO_PI = float(np.float32(1.0 / (2.0 * np.pi)))
INV_PI = float(np.float32(1.0 / np.pi))

# rows of the triangle table (one column a triangle): the determinant's
# column, u's and v's six rows each, the plane's normal and offset, and
# the unit normal
T_A, T_U, T_V, T_T, T_N = 0, 3, 9, 15, 19


@dataclasses.dataclass
class RenderSettings:
    width: int
    height: int
    spp: int
    max_depth: int
    t_min: float = 1e-3
    nan_policy: str = "running_sum"


class Scene:
    """The scene's leaves ("group.field" -> array) on ``device`` in
    ``dtype``; ``params`` ("group.field" -> tensor) replace leaves, and
    gradients reach them.  The triangle table is built here from the
    corners, differentiably."""

    def __init__(self, leaves: dict, sky_kind: int, device,
                 dtype=torch.float32, params: dict | None = None):
        params = params or {}
        self.dtype = dtype
        self.device = torch.device(device)

        def leaf(path, integer=False):
            if path in params:
                return params[path]
            value = torch.as_tensor(np.asarray(leaves[path]))
            return value.to(device=self.device,
                            dtype=torch.int64 if integer else dtype)

        self.center = leaf("spheres.center")
        self.radius = leaf("spheres.radius")
        self.albedo = leaf("spheres.albedo")
        self.fuzz = leaf("spheres.fuzz")
        self.ior = leaf("spheres.ior")
        self.mat = leaf("spheres.mat_type", True)
        self.n_tris = int(np.asarray(leaves["triangles.p0"]).shape[0])
        if self.n_tris:
            self.tab = triangle_table(leaf("triangles.p0"),
                                      leaf("triangles.p1"),
                                      leaf("triangles.p2"))
            self.t_albedo = leaf("triangles.albedo")
            self.t_fuzz = leaf("triangles.fuzz")
            self.t_ior = leaf("triangles.ior")
            self.t_mat = leaf("triangles.mat_type", True)
            self.box_id = leaf("triangles.box_id", True)
            self.box_min = leaf("boxes.box_min")
            self.box_max = leaf("boxes.box_max")
        self.sky_kind = int(sky_kind)
        self.sky_image = leaf("sky.image")
        self.sky_const = leaf("sky.const_colour")
        self.frame = camera_frame({k.split(".")[1]: leaf(k) for k in leaves
                                   if k.startswith("camera.")})


def triangle_table(p0, p1, p2):
    """(19 + 3, T): the test's columns in table form and the unit normal."""
    e0 = p1 - p0
    e1 = p2 - p0
    n = cross(e0, e1)
    nn = n / torch.clamp(torch.sqrt(dot3(n, n))[:, None], min=1e-20)
    return torch.cat([cross(e1, e0).T, (-cross(e1, p0)).T, e1.T,
                      (-cross(p0, e0)).T, (-e0).T, n.T,
                      (-dot3(p0, n))[None], nn.T], dim=0)


def _unit3(v):
    return v / torch.sqrt(dot3(v, v))


def camera_frame(cam: dict) -> dict:
    """CalculateCamera (``cl_camera.cpp:3-44``): the aperture in degrees."""
    aperture = cam["aperture_deg"] * _DEG
    h = tan(cam["vfov_deg"] * _DEG / 2.0)
    viewport_h = 2.0 * h * cam["focus_dist"]
    viewport_w = cam["aspect_ratio"] * viewport_h
    w = _unit3(cam["look_from"] - cam["look_at"])
    u = _unit3(cross(cam["vup"], w))
    v = cross(w, u)
    horizontal = u * viewport_w
    vertical = v * viewport_h
    lower_left = fma(-w, cam["focus_dist"],
                     cam["look_from"] - horizontal / 2.0 - vertical / 2.0)
    radius = cam["focus_dist"] * tan(aperture / 2.0)
    return dict(origin=cam["look_from"], horizontal=horizontal,
                vertical=vertical, lower_left=lower_left,
                disc_u=u * radius, disc_v=v * radius, aperture=aperture)


def camera_rays(scene: Scene, cfg: RenderSettings, pix, sample, seed):
    """GetRay (``gpu_kernel.cl:559-578``) for pixel ids and sample ids."""
    f = scene.frame
    ft = scene.dtype
    u0, u1, u2, u3 = uniform4(seed, pix, sample, SLOT_PIXEL_U, ft)
    uu = div((pix % cfg.width).to(ft) + u0, cfg.width)
    vv = div((pix // cfg.width).to(ft) + u1, cfg.height)
    p = in_unit_disk(u2, u3)
    offset = fma(f["disc_v"], p[..., 1:2], f["disc_u"] * p[..., 0:1])
    origin = torch.where(f["aperture"] > 0.0, f["origin"] + offset,
                         f["origin"].expand(offset.shape))
    target = fma(f["vertical"], vv[..., None],
                 fma(f["horizontal"], uu[..., None], f["lower_left"]))
    return origin, target - origin


# ---- intersection ----

def _sphere_ts(o, d, center, radius, t_min):
    """(R, S) t of each ray against each sphere, BIG for none."""
    oc = o[:, None, :] - center[None, :, :]
    a = dot3(d, d)[:, None]
    half_b = dot3(oc, d[:, None, :])
    c = dot3(oc, oc) - (radius * radius)[None, :]
    disc = fma(half_b, half_b, -(a * c))
    sqrtd = torch.sqrt(torch.clamp(disc, min=1e-30))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    ok0 = (disc >= 0.0) & (root0 >= t_min)
    ok1 = (disc >= 0.0) & (root1 >= t_min)
    return torch.where(ok0, root0, torch.where(ok1, root1,
                                               torch.full_like(root0, BIG)))


def _box_hits(o, d, box_min, box_max):
    """(R, B) slab tests; fmin and fmax ignore the NaN of 0 * inf."""
    inv_d = 1.0 / d
    t1 = (box_min[None] - o[:, None]) * inv_d[:, None]
    t2 = (box_max[None] - o[:, None]) * inv_d[:, None]
    tmin = torch.fmin(t1, t2).amax(dim=-1)
    tmax = torch.fmax(t1, t2).amin(dim=-1)
    return tmax > torch.maximum(tmin, torch.zeros_like(tmin))


def _chain(fs, ws):
    acc = fs[0] * ws[0]
    for f, w in zip(fs[1:], ws[1:]):
        acc = fma(f, w, acc)
    return acc


def _tri_ts(o, d, tab, t_min, gate):
    """(R, C) t of R rays against the table's C triangles, BIG for none."""
    m = cross(o, d)
    f_d = [d[:, k:k + 1] for k in range(3)]
    f_m = [m[:, k:k + 1] for k in range(3)]
    f_o = [o[:, k:k + 1] for k in range(3)]
    w = [tab[k:k + 1] for k in range(T_N)]
    a = _chain(f_d, w[T_A:T_A + 3])
    u_num = _chain(f_d + f_m, w[T_U:T_U + 6])
    v_num = _chain(f_d + f_m, w[T_V:T_V + 6])
    t_num = _chain(f_o, w[T_T:T_T + 3]) + w[T_T + 3]
    parallel = torch.abs(a) < TRI_EPS
    inv_a = 1.0 / torch.where(parallel, torch.ones_like(a), a)
    u = u_num * inv_a
    v = v_num * inv_a
    t = t_num * inv_a
    ok = (~parallel & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > t_min) & gate)
    return torch.where(ok, t, torch.full_like(t, BIG))


def _closest_tri(scene: Scene, o, d, t_min, counts):
    """(t, index) of each ray's closest box-gated triangle: the first
    index of the smallest t over the triangles in order, BIG for none.
    Only the rays that hit a box are tested."""
    r = o.shape[0]
    best_t = torch.full((r,), BIG, dtype=o.dtype, device=o.device)
    best_i = torch.zeros((r,), dtype=torch.long, device=o.device)
    box_hit = _box_hits(o, d, scene.box_min, scene.box_max)
    rows = torch.nonzero(box_hit.any(dim=1))[:, 0]
    if counts is not None:
        counts["box_segments"] += int(rows.numel())
    if rows.numel() == 0:
        return best_t, best_i
    tab = scene.tab.detach()
    box_id = scene.box_id
    n = scene.n_tris
    chunk = min(TRI_CHUNK, n)
    ray_chunk = max(1, PAIR_BUDGET // chunk)
    for r0 in range(0, rows.numel(), ray_chunk):
        sel = rows[r0:r0 + ray_chunk]
        os_, ds_, bh = o[sel], d[sel], box_hit[sel]
        bt = torch.full((sel.numel(),), BIG, dtype=o.dtype, device=o.device)
        bi = torch.zeros((sel.numel(),), dtype=torch.long, device=o.device)
        for c0 in range(0, n, chunk):
            ids = box_id[c0:c0 + chunk]
            gate = bh[:, ids.clamp(min=0)] & (ids >= 0)[None, :]
            tt = _tri_ts(os_, ds_, tab[:, c0:c0 + chunk], t_min, gate)
            ci = torch.argmin(tt, dim=1)
            ct = tt.gather(1, ci[:, None])[:, 0]
            upd = ct < bt
            bt = torch.where(upd, ct, bt)
            bi = torch.where(upd, c0 + ci, bi)
        best_t[sel] = bt
        best_i[sel] = bi
    return best_t, best_i


class Hit(NamedTuple):
    hit: torch.Tensor
    point: torch.Tensor
    normal: torch.Tensor
    front_face: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ior: torch.Tensor
    mat: torch.Tensor
    is_tri: torch.Tensor


def closest_hit(scene: Scene, o, d, t_min, counts=None) -> Hit:
    """The closest hit (``HitAnything``, ``gpu_kernel.cl:358-394``): the
    winner is searched without autograd, spheres first, so a sphere wins a
    tie; its hit is then recomputed with the search's own expressions,
    differentiably in the scene's leaves."""
    r = o.shape[0]
    with torch.no_grad():
        od, dd = o.detach(), d.detach()
        ts = _sphere_ts(od, dd, scene.center.detach(),
                        scene.radius.detach(), t_min)
        idx = torch.argmin(ts, dim=1)
        best_t = ts.gather(1, idx[:, None])[:, 0]
        is_tri = torch.zeros((r,), dtype=torch.bool, device=o.device)
        if scene.n_tris:
            tri_t, tri_i = _closest_tri(scene, od, dd, t_min, counts)
            is_tri = tri_t < best_t
            best_t = torch.where(is_tri, tri_t, best_t)
            idx = torch.where(is_tri, tri_i, idx)
        hit = best_t < BIG
    zero_i = torch.zeros_like(idx)
    ones = torch.ones((r,), dtype=o.dtype, device=o.device)

    sidx = torch.where(hit & ~is_tri, idx, zero_i)
    c = scene.center[sidx]
    rad = scene.radius[sidx]
    oc = o - c
    a = dot3(d, d)
    half_b = dot3(oc, d)
    cc = dot3(oc, oc) - rad * rad
    disc = fma(half_b, half_b, -(a * cc))
    sqrtd = torch.sqrt(torch.clamp(disc, min=1e-30))
    root0 = (-half_b - sqrtd) / a
    root1 = (-half_b + sqrtd) / a
    t = torch.where((disc >= 0.0) & (root0 >= t_min), root0, root1)
    albedo, fuzz = scene.albedo[sidx], scene.fuzz[sidx]
    ior, mat = scene.ior[sidx], scene.mat[sidx]

    if scene.n_tris:
        tidx = torch.where(hit & is_tri, idx, zero_i)
        w = scene.tab[:, tidx]
        f_d = [d[:, k] for k in range(3)]
        f_o = [o[:, k] for k in range(3)]
        a_t = _chain(f_d, [w[T_A + k] for k in range(3)])
        parallel = torch.abs(a_t) < TRI_EPS
        inv_a = 1.0 / torch.where(parallel, ones, a_t)
        t_t = (_chain(f_o, [w[T_T + k] for k in range(3)])
               + w[T_T + 3]) * inv_a
        t = torch.where(is_tri, t_t, t)
        it = is_tri[:, None]
        albedo = torch.where(it, scene.t_albedo[tidx], albedo)
        fuzz = torch.where(is_tri, scene.t_fuzz[tidx], fuzz)
        ior = torch.where(is_tri, scene.t_ior[tidx], ior)
        mat = torch.where(is_tri, scene.t_mat[tidx], mat)

    t = torch.where(hit, t, ones)
    point = fma(t[:, None], d, o)
    outward = (point - c) / rad[:, None]
    if scene.n_tris:
        outward = torch.where(is_tri[:, None], w[T_N:T_N + 3].T, outward)
    outward = torch.where(hit[:, None], outward, torch.tensor(
        [0.0, 0.0, 1.0], dtype=o.dtype, device=o.device))
    front_face = dot3(d, outward) < 0.0
    normal = torch.where(front_face[:, None], outward, -outward)
    return Hit(hit, point, normal, front_face, albedo, fuzz, ior, mat,
               is_tri & hit)


# ---- scattering and the sky ----

def _unit(v):
    return v / torch.sqrt(dot3(v, v))[..., None]


def _reflect(v, n):
    return fma(-n, (2.0 * dot3(v, n))[..., None], v)


def _refract(uv, n, ratio):
    cos_theta = torch.minimum(dot3(-uv, n), torch.ones_like(uv[..., 0]))
    r_perp = fma(n, cos_theta[..., None], uv) * ratio[..., None]
    r_par = -n * torch.sqrt(torch.clamp(
        torch.abs(1.0 - dot3(r_perp, r_perp)), min=1e-20))[..., None]
    return r_perp + r_par


def _reflectance(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    x = 1.0 - cosine
    x2 = x * x
    return fma(1.0 - r0, x * (x2 * x2), r0)


def scatter(d, h: Hit, u):
    """(direction, attenuation, absorbed, emitted) of every material,
    selected by the hit's material; u: (R, 8) uniforms of the bounce."""
    normal = h.normal
    lam = normal + unit_vector(u[:, 0], u[:, 1])
    near_zero = torch.all(torch.abs(lam) < NEAR_ZERO, dim=-1)
    lam = torch.where(near_zero[:, None], normal, lam)

    unit_d = _unit(d)
    reflected = _reflect(unit_d, normal)
    metal = fma(in_unit_sphere(u[:, 2], u[:, 3], u[:, 4]),
                h.fuzz[:, None], reflected)
    absorbed = dot3(metal, normal) <= 0.0

    ratio = torch.where(h.front_face, 1.0 / torch.clamp(h.ior, min=1e-8),
                        h.ior)
    cos_theta = torch.minimum(dot3(-unit_d, normal), torch.ones_like(h.ior))
    sin_theta = torch.sqrt(torch.clamp(fma(-cos_theta, cos_theta, 1.0),
                                       min=1e-20))
    reflect = ((ratio * sin_theta > 1.0)
               | (_reflectance(cos_theta, ratio) > u[:, 5]))
    diel = torch.where(reflect[:, None], reflected,
                       _refract(unit_d, normal, ratio))

    is_metal = h.mat == METAL
    is_diel = h.mat == DIELECTRIC
    direction = torch.where(is_diel[:, None], diel,
                            torch.where(is_metal[:, None], metal, lam))
    attenuation = torch.where(is_diel[:, None], torch.ones_like(h.albedo),
                              h.albedo)
    return direction, attenuation, is_metal & absorbed, h.mat == EMISSIVE


def sky_colour(scene: Scene, d):
    """The sky's radiance for miss directions d (R, 3)."""
    if scene.sky_kind == SKY_GRADIENT:
        t = 0.5 * (_unit(d)[..., 1] + 1.0)
        blue = torch.tensor([0.5, 0.7, 1.0], dtype=d.dtype, device=d.device)
        return fma(t[..., None], blue, (1.0 - t)[..., None])
    if scene.sky_kind == SKY_CONST:
        return scene.sky_const.expand(d.shape[:-1] + (3,))
    image = scene.sky_image
    h, w = image.shape[0], image.shape[1]
    with torch.no_grad():
        n = d / sqrt(dot3(d, d))[..., None]
        u = fma(atan2(n[..., 2], n[..., 0]), INV_TWO_PI, 0.5)
        y = torch.clamp(n[..., 1], -1.0, 1.0)
        v = fma(2.0 * atan2(y, 1.0 + sqrt((1.0 - y) * (1.0 + y))),
                -INV_PI, 0.5)
        x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
        y = torch.clamp((v * h).to(torch.int32), 0, h - 1).long()
    return image[y, x]


# ---- paths and pixels ----

def trace(scene: Scene, cfg: RenderSettings, o, d, pix, sample, seed,
          counts=None):
    """Each ray's path to its end (``RayColour``, ``gpu_kernel.cl:266-348``):
    (R, 3) radiance, black where the path is absorbed or reaches the
    depth limit."""
    r = o.shape[0]
    alive = torch.arange(r, device=o.device)
    thr = torch.ones((r, 3), dtype=o.dtype, device=o.device)
    ends, values = [], []
    for depth in range(cfg.max_depth):
        if alive.numel() == 0:
            break
        h = closest_hit(scene, o, d, cfg.t_min, counts)
        u = bounce_uniforms(seed, pix[alive], sample[alive], depth,
                            scene.dtype)
        direction, atten, absorbed, emitted = scatter(d, h, u)
        miss = torch.nonzero(~h.hit)[:, 0]
        emit = torch.nonzero(h.hit & emitted)[:, 0]
        keep = torch.nonzero(h.hit & ~emitted & ~absorbed)[:, 0]
        if counts is not None:
            counts["segments"] += int(alive.numel())
            n_tri = int(h.is_tri.sum())
            counts["tri_hits"] += n_tri
            counts["sphere_hits"] += int(h.hit.sum()) - n_tri
        ends += [alive[miss], alive[emit]]
        values += [thr[miss] * sky_colour(scene, d[miss]),
                   thr[emit] * h.albedo[emit]]
        alive = alive[keep]
        o = h.point[keep]
        d = direction[keep]
        thr = thr[keep] * atten[keep]
    out = torch.zeros((r, 3), dtype=o.dtype, device=o.device)
    if ends:
        out = out.index_put((torch.cat(ends),), torch.cat(values))
    return out


def radiance_sum(scene: Scene, cfg: RenderSettings, pix, seed,
                 sample_offset: int, n_samples: int, acc0=None,
                 counts=None):
    """The sum over samples [sample_offset, sample_offset + n_samples) of
    each pixel's clamped samples, added in sample order under
    ``cfg.nan_policy`` from the running sums acc0: (P, 3)."""
    p = pix.shape[0]
    samples = torch.arange(sample_offset, sample_offset + n_samples,
                           device=pix.device)
    pix_all = pix.repeat(n_samples)
    smp_all = samples.repeat_interleave(p)
    o, d = camera_rays(scene, cfg, pix_all, smp_all, seed)
    if counts is not None:
        counts["camera_rays"] += int(pix_all.numel())
    colour = trace(scene, cfg, o, d, pix_all, smp_all, seed, counts)
    colour = colour.reshape(n_samples, p, 3)
    acc = (torch.zeros((p, 3), dtype=scene.dtype, device=pix.device)
           if acc0 is None else acc0)
    zero = torch.zeros((), dtype=scene.dtype, device=pix.device)
    for s in range(n_samples):
        c = clip01(colour[s])
        if cfg.nan_policy == "running_sum":
            c = torch.where(torch.isnan(c), acc, c)
        elif cfg.nan_policy == "zero":
            c = torch.where(torch.isnan(c), zero, c)
        else:
            raise ValueError(f"unknown nan_policy: {cfg.nan_policy}")
        acc = acc + c
    return acc


def samples_per_call(n_pixels: int, spp: int, rays: int = 2**23) -> int:
    """Samples traced together for n_pixels pixels: about ``rays`` rays."""
    return max(1, min(spp, rays // max(n_pixels, 1)))


def render_pixels(scene: Scene, cfg: RenderSettings, pix, seed: int,
                  counts=None, rays: int = 2**21):
    """The mean radiance of the pixels ``pix`` (global ids, row-major from
    the image's bottom row), (P, 3)."""
    spc = samples_per_call(pix.shape[0], cfg.spp, rays)
    acc = None
    for s0 in range(0, cfg.spp, spc):
        acc = radiance_sum(scene, cfg, pix, seed, s0,
                           min(spc, cfg.spp - s0), acc, counts)
    return div(acc, cfg.spp)


def new_counts() -> dict:
    """The path segments the reference counts while it traces."""
    return dict(camera_rays=0, segments=0, sphere_hits=0, tri_hits=0,
                box_segments=0)
