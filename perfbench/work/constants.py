"""FP32 operations of one step of the path tracer's work, counted from
the arithmetic of the CUDA kernels (an add, multiply, divide, square root,
min or max as 1 and an fma as 2; compares, selects and sign flips not
counted), so that the bounds built on them are least times.  The work of
a launch applies them to the path segments that the reference counts for
the run's inputs, never to a kernel's own counts."""

# one ray-sphere test: oc 3, half_b 5, c 6, the discriminant 3
SPHERE_TEST = 17
# a hit's scatter besides the tests: hit point 6, normal 6, front face 5,
# the draw's floats 4, zu 2, phi 1, radius 4, cosf and sinf 2, the
# direction 5, the throughput 3
SPHERE_HIT = 38
# a camera ray without aperture: the draw's floats 2, u and v 4, the
# direction 15
CAMERA_RAY = 21
# a ray-triangle test in table form: a 5, u_num 11, v_num 11, t_num 6,
# 1/a 1, u, v and t 3, u + v 1
TRI_TEST = 38
# one sphere bounce walked back, the cheapest kind (Lambertian): the hit's
# recompute 43, throughput 9, normal 18, hit point 11, root 13 + 33, the
# sphere cotangents 5
SPHERE_REVERSE = 132
# one triangle bounce walked back (Lambertian): |d|^2 5, front face 5,
# throughput 9, |n| 6, the normal's adjoint 14, hit point 11, plane t 10,
# its adjoint 24, differences 5
TRI_REVERSE = 89
FLOAT = 4
