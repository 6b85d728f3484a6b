"""K7, the HDR backward's consume pass (``megagrad.cu::mesh_megagrad``
with ``kSkyConsume``): one fit step's walk back under the HDR sky.  It
replays every segment (the sphere tests, and at least one triangle test
for each segment that hits a triangle) and walks back every segment that
hit; it reads the image's cotangent, each sample's sky value and the
triangles' corners, and writes the triangles' cotangents (10 a
triangle)."""

from perfbench.work import constants as c

KERNEL = r"\bmesh_megagrad<2\b"


def work(w: dict):
    if "segments" not in w:
        return None
    flops = (w["segments"] * w["n_spheres"] * c.SPHERE_TEST
             + w["tri_hits"] * c.TRI_TEST
             + w["sphere_hits"] * c.SPHERE_REVERSE
             + w["tri_hits"] * c.TRI_REVERSE
             + w["camera_rays"] * c.CAMERA_RAY)
    io = (3 * w["n_pix"] + 3 * w["n_pix"] * w["spp"]
          + 19 * w["n_tris"]) * c.FLOAT
    return flops, io
