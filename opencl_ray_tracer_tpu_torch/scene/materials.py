"""Material codes (the reference's ``Material.type``, ``gpu_kernel.cl:15-21``,
dispatched in ``RayColour``'s switch, ``:282-330``)."""

from __future__ import annotations

LAMBERTIAN = 0   # gpu_kernel.cl:398-413
METAL = 1        # gpu_kernel.cl:415-423
DIELECTRIC = 2   # gpu_kernel.cl:425-451
EMISSIVE = 3     # gpu_kernel.cl:326-329
