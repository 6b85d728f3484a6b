"""Procedural test assets, text for text those of the JAX package.

Watertight triangle meshes as OBJ text for the mesh pipeline, and an
equirectangular HDR sky image, so that tests and demos need no asset from
the reference checkout (its F1 car is not bundled); ``write_test_assets``
writes them as files.
"""

from __future__ import annotations

import numpy as np


def make_uv_sphere_obj(n_lat: int = 12, n_lon: int = 18,
                       radius: float = 1.0) -> str:
    """UV-sphere OBJ text (triangulated, 'v'/'f' records only)."""
    verts = [(0.0, radius, 0.0)]
    for i in range(1, n_lat):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            verts.append((radius * np.sin(theta) * np.cos(phi),
                          radius * np.cos(theta),
                          radius * np.sin(theta) * np.sin(phi)))
    verts.append((0.0, -radius, 0.0))
    top, bottom = 1, len(verts)

    def ring(i, j):  # 1-indexed vertex id of ring i (1..n_lat-1), lon j
        return 2 + (i - 1) * n_lon + (j % n_lon)

    faces = []
    for j in range(n_lon):
        faces.append((top, ring(1, j + 1), ring(1, j)))
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j), ring(i + 1, j + 1)
            faces.append((a, b, d))
            faces.append((a, d, c))
    for j in range(n_lon):
        faces.append((bottom, ring(n_lat - 1, j), ring(n_lat - 1, j + 1)))

    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a} {b} {c}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def make_torus_obj(n_major: int = 24, n_minor: int = 12, r_major: float = 1.0,
                   r_minor: float = 0.35) -> str:
    """Torus OBJ text in the 9-token ``f a/a/a`` face form (the loader's
    slash path); 2 * n_major * n_minor triangles."""
    verts = []
    for i in range(n_major):
        u = 2 * np.pi * i / n_major
        for j in range(n_minor):
            v = 2 * np.pi * j / n_minor
            x = (r_major + r_minor * np.cos(v)) * np.cos(u)
            z = (r_major + r_minor * np.cos(v)) * np.sin(u)
            y = r_minor * np.sin(v)
            verts.append((x, y, z))

    def vid(i, j):
        return (i % n_major) * n_minor + (j % n_minor) + 1

    faces = []
    for i in range(n_major):
        for j in range(n_minor):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i, j + 1), vid(i + 1, j + 1)
            faces.append((a, b, d))
            faces.append((a, d, c))
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}" for a, b, c in faces]
    return "\n".join(lines) + "\n"


def make_sky_image(width: int = 256, height: int = 128,
                   sun_dir=(0.5, 0.6, -0.6), sun_power: float = 40.0,
                   sun_sharpness: float = 200.0) -> np.ndarray:
    """Procedural HDR sky: gradient + sun disc, (H,W,3) f32 linear radiance
    (values above 1)."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    # inverse of Vec3ToUV (gpu_kernel.cl:234-241)
    theta = (0.5 - v) * np.pi            # asin(y)
    phi = (u - 0.5) * 2 * np.pi          # atan2(z, x)
    y = np.sin(theta)[:, None]
    x = np.cos(theta)[:, None] * np.cos(phi)[None, :]
    z = np.cos(theta)[:, None] * np.sin(phi)[None, :]
    cos_sun = x * sun[0] + y * sun[1] + z * sun[2]
    t = 0.5 * (y + 1.0)
    base = ((1 - t)[..., None] * np.array([1.0, 1.0, 1.0])
            + t[..., None] * np.array([0.35, 0.55, 0.95]))
    sun_term = np.exp(sun_sharpness * (cos_sun - 1.0))[..., None] \
        * np.array([1.0, 0.92, 0.8]) * sun_power
    ground = y < -0.02
    base[np.broadcast_to(ground[..., None], base.shape)] *= 0.35
    return (base + sun_term).astype(np.float32)


def write_test_assets(directory: str) -> dict:
    """Write the standard asset set (``uv_sphere.obj``, ``torus.obj``,
    ``sky.hdr``) into ``directory``; returns their paths by name."""
    import os

    from .hdr import encode_hdr

    os.makedirs(directory, exist_ok=True)
    paths = {}
    p = os.path.join(directory, "uv_sphere.obj")
    with open(p, "w") as f:
        f.write(make_uv_sphere_obj())
    paths["uv_sphere"] = p
    p = os.path.join(directory, "torus.obj")
    with open(p, "w") as f:
        f.write(make_torus_obj())
    paths["torus"] = p
    p = os.path.join(directory, "sky.hdr")
    with open(p, "wb") as f:
        f.write(encode_hdr(make_sky_image()))
    paths["sky"] = p
    return paths
