"""Scene inputs from a configuration file: the "group.field" leaves that
both the program (``scene_from_numpy``) and the reference take.

The generators are frozen copies of the path tracer's procedural assets
(the torus mesh that stands in for the reference's F1 car, the
equirectangular sky that stands in for its skybox, and the reference's
tone map), so that the inputs do not change when the program does.
"""

from __future__ import annotations

import numpy as np

SKY_KINDS = {"gradient": 0, "hdr": 1, "constant": 2}
MATERIALS = {"lambertian": 0, "metal": 1, "dielectric": 2, "emissive": 3}


def torus_vertices(n_major: int, n_minor: int, r_major: float,
                   r_minor: float):
    """(vertices (V, 3) f64, faces (F, 3) int, 0-based): 2 n_major n_minor
    triangles, the vertices rounded to 6 decimals as in an OBJ file."""
    u = 2 * np.pi * np.arange(n_major) / n_major
    v = 2 * np.pi * np.arange(n_minor) / n_minor
    ring = np.broadcast_to(r_major + r_minor * np.cos(v)[None, :],
                           (n_major, n_minor))
    verts = np.stack([ring * np.cos(u)[:, None],
                      np.broadcast_to(r_minor * np.sin(v)[None, :],
                                      ring.shape),
                      ring * np.sin(u)[:, None]], axis=-1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(n_major), np.arange(n_minor),
                       indexing="ij")
    i, j = i.ravel(), j.ravel()

    def vid(a, b):
        return (a % n_major) * n_minor + (b % n_minor)

    a, b = vid(i, j), vid(i + 1, j)
    c, d = vid(i, j + 1), vid(i + 1, j + 1)
    faces = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                     axis=1).reshape(-1, 3)
    return np.round(verts, 6), faces


def sky_image(width: int, height: int, sun_dir, sun_power: float,
              sun_sharpness: float) -> np.ndarray:
    """Procedural HDR sky: a gradient and a sun disc, (H, W, 3) f32."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    theta = (0.5 - v) * np.pi
    phi = (u - 0.5) * 2 * np.pi
    y = np.sin(theta)[:, None]
    x = np.cos(theta)[:, None] * np.cos(phi)[None, :]
    z = np.cos(theta)[:, None] * np.sin(phi)[None, :]
    cos_sun = x * sun[0] + y * sun[1] + z * sun[2]
    t = 0.5 * (y + 1.0)
    base = ((1 - t)[..., None] * np.array([1.0, 1.0, 1.0])
            + t[..., None] * np.array([0.35, 0.55, 0.95]))
    sun_term = (np.exp(sun_sharpness * (cos_sun - 1.0))[..., None]
                * np.array([1.0, 0.92, 0.8]) * sun_power)
    ground = y < -0.02
    base[np.broadcast_to(ground[..., None], base.shape)] *= 0.35
    return (base + sun_term).astype(np.float32)


def tone_map(img: np.ndarray, exposure: int) -> np.ndarray:
    """The reference's exposure curve (``utility.cpp:180-186``)."""
    e = exposure * 2 + 1
    img = np.asarray(img, np.float32)
    return (1.0 + 1.0 / ((-1.0 - img) ** e)).astype(np.float32)


def _f32(x):
    return np.asarray(x, np.float32)


def scene_leaves(config: dict, perturb: dict | None = None, seed: int = 0):
    """(leaves, sky kind) of the configuration's scene.  ``perturb`` moves
    it by draws from ``seed``: "sphere_center" (a normal shift of that
    scale), "sphere_albedo" (a relative one), "vertices" (each mesh
    vertex, before the transform), "sky_gain" (a gain a channel)."""
    perturb = perturb or {}
    rng = np.random.default_rng(seed)
    cam = config["camera"]
    leaves = {f"camera.{k}": _f32(cam[k]) for k in
              ("look_from", "look_at", "vup", "vfov_deg", "focus_dist",
               "aperture_deg")}
    r = config["render"]
    leaves["camera.aspect_ratio"] = _f32(r["width"] / r["height"])

    sph = config["spheres"]
    center = np.array([s["center"] for s in sph], np.float64)
    albedo = np.array([s["albedo"] for s in sph], np.float64)
    if "sphere_center" in perturb:
        center = center + rng.normal(0.0, perturb["sphere_center"],
                                     center.shape)
    if "sphere_albedo" in perturb:
        albedo = np.clip(albedo * (1.0 + rng.normal(
            0.0, perturb["sphere_albedo"], albedo.shape)), 0.0, 1.0)
    leaves.update({
        "spheres.center": _f32(center),
        "spheres.radius": _f32([s["radius"] for s in sph]),
        "spheres.albedo": _f32(albedo),
        "spheres.fuzz": _f32([s.get("fuzz", 0.0) for s in sph]),
        "spheres.ior": _f32([s.get("ior", 0.0) for s in sph]),
        "spheres.mat_type": np.array([MATERIALS[s["material"]] for s in sph],
                                     np.int32)})

    mesh = config.get("mesh")
    if mesh is None:
        tris = np.zeros((0, 3, 3), np.float32)
        box = (np.zeros((0, 3), np.float32),) * 2
        mat = dict(albedo=(0.0, 0.0, 0.0), fuzz=0.0, ior=0.0,
                   material="lambertian")
    else:
        verts, faces = torus_vertices(**mesh["torus"])
        if "vertices" in perturb:
            verts = verts + rng.normal(0.0, perturb["vertices"], verts.shape)
        verts = (_f32(verts) * _f32(mesh["scale"]) + _f32(mesh["translate"]))
        tris = verts[faces]
        box = (verts.min(axis=0)[None], verts.max(axis=0)[None])
        mat = mesh["material"]
    t = tris.shape[0]
    leaves.update({
        "triangles.p0": np.ascontiguousarray(tris[:, 0]),
        "triangles.p1": np.ascontiguousarray(tris[:, 1]),
        "triangles.p2": np.ascontiguousarray(tris[:, 2]),
        "triangles.albedo": np.tile(_f32(mat["albedo"]), (t, 1)),
        "triangles.fuzz": np.full((t,), mat["fuzz"], np.float32),
        "triangles.ior": np.full((t,), mat["ior"], np.float32),
        "triangles.mat_type": np.full((t,), MATERIALS[mat["material"]],
                                      np.int32),
        "triangles.box_id": np.zeros((t,), np.int32),
        "boxes.box_min": _f32(box[0]),
        "boxes.box_max": _f32(box[1])})

    sky = config["sky"]
    kind = SKY_KINDS[sky["kind"]]
    image = np.zeros((1, 1, 3), np.float32)
    if kind == SKY_KINDS["hdr"]:
        image = sky_image(**sky["procedural"])
        if "sky_gain" in perturb:
            image = image * _f32(1.0 + rng.normal(0.0, perturb["sky_gain"],
                                                  3))
        image = tone_map(image, sky["tone_map_exposure"])
    leaves["sky.image"] = image
    leaves["sky.const_colour"] = _f32(sky.get("const_colour", (0, 0, 0)))
    return leaves, kind
