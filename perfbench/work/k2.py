"""K2, the mesh megakernel's HDR body (``kernels/csrc/megamesh.cu``): one
image under the HDR sky.  Every sphere tested on every segment, at least
one triangle test for each segment that hits a triangle, a scatter on
every segment that hits, a camera ray a sample; it reads the triangles'
corners and the sky image and writes the image."""

from perfbench.work import constants as c

KERNEL = r"\bmesh_megakernel\b"


def work(w: dict):
    if "segments" not in w:
        return None
    flops = (w["segments"] * w["n_spheres"] * c.SPHERE_TEST
             + w["tri_hits"] * c.TRI_TEST
             + (w["sphere_hits"] + w["tri_hits"]) * c.SPHERE_HIT
             + w["camera_rays"] * c.CAMERA_RAY)
    io = (9 * w["n_tris"] + 3 * w["sky_texels"] + 3 * w["n_pix"]) * c.FLOAT
    return flops, io
