"""K1, the sphere megakernel (``kernels/csrc/megakernel.cu``): one image.
Every sphere tested on every segment, a scatter on every segment that
hits, a camera ray a sample; it reads the camera and sphere tables and
writes the image."""

from perfbench.work import constants as c

KERNEL = r"\bsphere_megakernel\b(?!_earlier)"


def work(w: dict):
    if "segments" not in w:
        return None
    flops = (w["segments"] * w["n_spheres"] * c.SPHERE_TEST
             + w["sphere_hits"] * c.SPHERE_HIT
             + w["camera_rays"] * c.CAMERA_RAY)
    io = (w["n_spheres"] * 16 + 128 + 3 * w["n_pix"]) * c.FLOAT
    return flops, io
