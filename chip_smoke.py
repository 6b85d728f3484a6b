#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines on standard output:

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compile every kernel of the main paths from the sources in this
   checkout (nvcc, sm_90a, one process per source, all at once) and report
   the compiler's register counts and spills.
3. forward parity: the sphere megakernel against its plain PyTorch version
   on the same tables, at 160x90, 8 spp, depth 8 for the README scene, the
   spheres of the reference scene (all four materials and an aperture), a
   constant sky, the "zero" NaN policy without the clamp, and the book
   cover; then at the main path's full size, where the kernel as built
   (cbrtf for the fuzz radius) and its variant with the backward's
   powf(u, 1/3) are also timed against each other.  Tolerance: at most
   0.5% of pixels differ by more than 1e-3, more than 99% within 1e-4,
   means within 2e-3.
4. forward main path: ``render(readme_scene(16/9), RenderConfig(1280, 720,
   spp=250, max_depth=50))`` and the 100-sphere book cover at the same
   configuration, one warm-up and the minimum of 3 timed runs each, with
   the kernels' launch counts set to 0 just before and read just after.
5. backward parity: the backward megakernel against its plain version
   (autograd of the plain tracer) on the same tables, at 160x90, 4 spp,
   depth 6, compared on the scene's leaves (``render_grad_scene``), for the
   README scene, the reference spheres, a constant sky, an emissive sphere
   whose albedo clamps, 40 random spheres and the book cover; and on the
   table rows both read for 200 random spheres (the backward takes 256).
   Tolerance per leaf, max|a - b| / max|b|: those of tests/test_megagrad.py,
   and for the book cover, fuzzy metal like the README scene, the README's
   (8e-2 and a cosine above 0.9999).
6. gradient main path: ``render_grad_sampled`` of the README scene and the
   book cover at the main path's configuration with loss mean(img^2), one
   warm-up and the minimum of 3, counts set to 0 just before and read just
   after; then the backward kernel (K4) alone by CUDA events with its
   share of bound and the compiler's register line, and the plain gradient
   against it at depth 50 on 320x180 at 16 spp and on the main path's
   1280x720 at 2 spp (the plain gradient at 250 spp would take hours),
   where each kernel thread takes several work items (pixel samples), and
   two launches give equal camera cotangents.  6d: K4's split at the main
   path's size on both scenes, the median of 5 CUDA-event times after a
   warm-up, in turns: K1, K4, K4's earlier design (a pixel per thread) and
   its timing cuts (the replay alone, the replay with its record writes,
   plain adds instead of the shared atomics), K4's own cuts (the replay
   alone, plain adds), each cut at the thread count of the kernel it is
   cut from, and the SIMT efficiency of replay and walk back; every
   instance that is not a cut agrees with K4 within 2e-3 (K4_AGREE) and
   counts the same bounces.  6e: K1's split at the main path's size on
   both scenes, from the measurement build ORT_K1_VARIANTS (K1_VARIANTS):
   the median of 5 CUDA-event times after a warm-up, in turns, of K1, the
   earlier design (a pixel per thread, each branch drawing on its own),
   the earlier design with one section run twice (the sphere tests, the
   sky, the Lambertian draw, the whole scatter, the camera ray), and K1
   with one pixel per thread, each cut at the earlier design's threads and
   blocks an SM; every instance gives K1's image bit for bit and its
   bounces; the SIMT efficiency of each section of both designs and their
   idle share; the registers and spills of each instance.  6f: K2's walk
   split at REFERENCE_DEFAULTS with 576 and 15,360 triangles under the
   gradient and the HDR sky, from the measurement builds ORT_K2_VARIANTS
   and ORT_FLAT_WALK (the earlier K2, K5, K6 and K7): per bounce the
   gating-box, group, chunk and sub-box slabs, the runs entered, the
   triangle tests and the bounce steps of the earlier walk (every chunk)
   and the grouped walk, the SIMT efficiency at each, the walk's time and
   its triangle tests' time (each run twice, less its kernel), K2 without
   its triangle-major table, without its persistent lanes and without
   both, and K2 (both bodies), K5, K6 and K7 against their earlier
   designs, medians of 5 in turns; every instance gives K2's image bit for
   bit, its bounces and its triangle tests, K6 equal records, and K5's and
   K7's cotangents within 1e-4 of the earlier walk's.  6g: K5's and K7's
   split at REFERENCE_DEFAULTS with 576 and 15,360 triangles (K5 under
   the gradient sky, K7 under the flagship's HDR sky), from the
   measurement build ORT_K5_VARIANTS (K5_VARIANTS): the median of 5
   CUDA-event times after a warm-up, in turns, of K5 or K7, the earlier
   design (a pixel per thread, the megagrad template's mesh instance) and
   its timing cuts (the replay alone, the replay with its record writes,
   plain adds instead of the shared sphere atomics, plain adds instead of
   the global triangle atomics) and K5's own cuts, each cut at the
   threads and blocks an SM of the kernel it is cut from; the SIMT
   efficiency of replay and walk back of both designs; every instance
   that is not a cut counts K5's (K7's) bounces, triangle tests and
   triangle bounces and agrees with it within 1e-4, and two launches of
   K5 (K7) give equal camera cotangents.  6h: K6's split at
   REFERENCE_DEFAULTS on both flagship scenes, from the measurement build
   ORT_K6_VARIANTS (K6_VARIANTS): the median of 5 CUDA-event times after a
   warm-up, in turns, of K6, the earlier design (a thread per pixel, the
   megagrad template's emit instance) and its timing cuts (the replay
   alone, the replay with its emit rows) and K6's replay alone; K6's
   second pass (the sums in sample order) as the difference of K6's
   counting instance with and without it; the SIMT
   efficiency of both designs' replay; every instance
   that is not a cut gives K6's records and non-sky sums bit for bit and
   its bounces and triangle tests, and two launches of K6 give equal ones.
7. fit: 5 Adam steps of ``fit_scene`` on the README scene's albedo at the
   main path's configuration, after one throwaway Adam step that takes
   torch's one-time optimizer set-up; the loss must fall.
8. mesh parity: the mesh megakernel against its plain version on the same
   tables, at 160x90, 8 spp, depth 8, for the tests/test_megamesh.py scene
   (the reference spheres and a 192-triangle fuzzy-metal torus), the same
   under a constant sky, as a dielectric, as an emitter, with the mesh
   behind the camera, and split over 40 gating boxes; the forward
   tolerance above.  Then the closest-triangle kernel against its plain
   version on 2^20 rays aimed into the box of the 15,360-triangle torus,
   and on 2^16 rays into a 2,304-triangle torus split over 40 boxes:
   t and indices equal to the plain version's bit for bit (both take the
   same fma chains; so also indices equal on at least 99.99% of the rays
   and t within 1e-6 relative), and t, indices and triangle tests equal to
   the earlier design's (the measurement build ORT_K3_VARIANTS).
9. the mesh main path: ``render(reference_scene(16/9, mesh_tris=tris,
   mesh_aabb=aabb), REFERENCE_DEFAULTS)`` (1280x720, 5 spp, depth 32) with
   the bundled 576-triangle torus and with the 15,360-triangle procedural
   torus (the F1 car's count), loaded as the reference loads its mesh:
   the kernel alone by CUDA events with its bounce and triangle-test counts
   and the plain version against it (at full size for 576 triangles, at
   320x180 for 15,360), then through ``render()``, one warm-up and the
   minimum of 3, counts set to 0 just before and read just after, the image
   bit-identical to the kernel's; and the render's host time, part by part
   (the route, the kernel's inputs on a cache hit, their build on a miss).
10. the plain tracer on the card: ``render()`` with backend "jnp" on the
   15,360-triangle scene at the same configuration, whose triangle hit is
   the closest-triangle kernel (counted, each launch timed by CUDA
   events); its image against the mesh megakernel's under the forward
   tolerance.  Then the closest-triangle kernel against its plain version
   on the ray batch of that path that ran the most triangle tests, under
   the tolerance of phase 8.  10b: K3's split on that batch and the two
   of phase 8, from the measurement build ORT_K3_VARIANTS (K3_VARIANTS):
   the median of 5 CUDA-event times after a warm-up, in turns, of K3, the
   earlier design (a block-wide vote per chunk, the chunks staged in
   shared memory) and its cuts (no staging; no vote and no staging; the
   chunk gates twice; the triangle tests twice) and K3 with its tests
   twice, and the launches of the plain route and of phase 16's plain
   gradient route, each launch timed with K3 and with the earlier design
   (route_launch_ms); the SIMT
   efficiency of both designs' slabs and runs; every instance gives the
   earlier design's t and indices bit for bit and its triangle tests.
12. mesh gradient parity: the mesh backward kernel (K5) against its plain
   version (autograd of the plain wavefront with the winner hit in plane
   form) on the same tables and image cotangent, at 160x90, 4 spp, depth
   6, for the 576-triangle torus of phase 9 as a Lambertian mesh, a metal
   torus under a constant sky, the Lambertian torus without spheres, and
   the tests/test_megamesh.py torus over 40 gating boxes; per table block
   and per scene leaf after tri_grads_to_scene, max|a - b| / max|b|
   against tests/test_megagrad.py's mesh tolerances (5e-4; 5e-3 for the
   metal case; focus_dist as in phase 5, 5e-3).
13. the same at 320x180, 5 spp, depth 32 for both meshes of phase 9.
14. the mesh gradient main path: ``render_grad_sampled`` of both meshes'
   scenes at ``REFERENCE_DEFAULTS``, one warm-up and the minimum of 3,
   counts set to 0 just before and read just after (the mesh megakernel
   and K5, nothing else); K5 alone by CUDA events, its counts and bound.
15. the mesh fit: 5 Adam steps of ``fit_scene`` on the vertices at
   ``REFERENCE_DEFAULTS`` through the mesh kernels, the plan built once per
   fit: the 576-triangle scene towards a target rendered from its mesh with
   every p0 moved (its losses reported: with hard visibility they rise,
   see PERF.md), and the vertex fit of tests/test_megagrad.py (its
   48-triangle torus near the camera, every p0 moved by 0.02), here of all
   three vertices at rate 1e-3, whose loss must fall.
16. the plain mesh gradient route on the card: ``render_grad_sampled(
   grad_backend="plain")`` on the 15,360-triangle scene at 160x90, 2 spp,
   depth 8, whose winner search is the closest-triangle kernel; its loss
   and leaves against the kernel route's.
17. hdr_lookup: the texel the kernels' HDR lookup picks
   (``csrc/common.cuh::hdr_texel``) against the plain version's
   (``scene/sky.py::texel_index``) on 2^20 random directions and a
   1024x512 image: all equal.
18. hdr_parity: the mesh megakernel's HDR body against its plain version
   at 160x90, 8 spp, depth 8, on the README spheres under the flagship's
   sky (no triangles) and on both flagship scenes (``flagship_scene``:
   the reference scene with the 576-triangle torus, and with the
   15,360-triangle procedural torus as its obj_path, under the
   tone-mapped procedural 1024x512 sky); then at the main path's size
   and seed (``REFERENCE_DEFAULTS``, 1280x720x5/d32) with 576 triangles;
   the forward tolerance of phase 8.
19. hdr_grad_parity: the HDR emit pass (K6) against its plain version
   (directions and throughputs within 1e-6 on at least 99.99% of the
   samples, non-sky sums within 1e-6), and the fused gradient through K6
   and K7 against the same steps through their plain versions, per leaf
   (max|a - b| / max|b|: albedo 5e-3, vertices 5e-4, sky image 5e-3 with
   more than 99.9% of texels within 1e-6), at 160x90, 4 spp, depth 6, on
   the scenes of phase 18, and at the main path's depth and samples on
   320x180 (5 spp, depth 32) on both flagship scenes; then each pass and
   its plain version timed alone there on the 576-triangle scene.
20. hdr_main_path: ``render()`` and ``render_grad_sampled()`` of both
   flagship scenes at ``REFERENCE_DEFAULTS``, one warm-up and the minimum
   of 3 each, counts set to 0 just before and read just after (the
   forward runs K2 alone, the gradient K6 and K7 alone); the image of
   render() bit-identical to K2's, the fused route's image within the
   forward tolerance of it; two launches of K6 give equal records and
   non-sky sums; K2, K6 and K7 alone by CUDA events, with their counts
   and bounds, and the fwd+bwd's host remainder; then a
   5-step ``fit_scene`` of ``sky.image`` from a sky scaled by 0.85
   towards the true sky's image, whose loss must fall.
21. hdr_scene_json: ``scene_from_json`` with ``assets/sky.hdr`` rendered
   through K2.
22. checkpoint_windows, the sphere megakernel's sample windows (raw sums
   from the sums before them, acc0): ``render_checkpointed(chunk_spp=16)``
   of the README scene at ``README_BENCH`` against ``render()`` under the
   "running_sum" and "zero" NaN policies, and a render interrupted at 100
   spp and resumed, each equal bit for bit, counts set to 0 just before
   and read just after (16 launches); then a 16-spp window alone by CUDA
   events with its acc0 and raw sum against the same window in mean mode
   without acc0, in turns, with its bounces and bound; and a window from
   sample 16 against its plain version at 160x90, the forward tolerance.
23. the same for the mesh megakernel's windows at ``REFERENCE_DEFAULTS``
   with ``chunk_spp=2`` (3 launches), on the mesh scene of phase 9 (576
   triangles, gradient sky) and on ``flagship_scene()`` (HDR body), the
   interrupted render resumed from 2 spp; and ``save_state`` alone at
   1280x720 (an 11 MB npz).
24. progressive: ``render(progress=..., progress_blocks=8)`` of the README
   scene at ``README_BENCH`` and of the flagship at
   ``REFERENCE_DEFAULTS``, counts set to 0 just before and read just after
   (8 launches), equal to ``render()`` bit for bit, both timed.
25. fit_resume: phase 7's fit interrupted after 3 steps
   (``checkpoint_path=``) and resumed to 5, against phase 7's 5 steps: the
   losses within 1e-5 relative (K4's atomics add in another order from
   run to run).
26. cli: ``python -m opencl_ray_tracer_tpu_torch.cli render --scene
   reference --checkpoint ... --chunk-spp 2 --progress-image p.bmp -o
   out.bmp`` at the CLI's defaults (the reference executable's
   1280x720x5/d32) in a subprocess on the card; ``read_bmp`` of its output
   equal to ``tonemap_u8(render())`` of the same scene.
27. soft visibility (``tracer/soft.py``, torch ops, no kernel of its
   own): a. ``render_soft`` of the README scene at 64x36, 4 spp, depth 4
   and beta 40 on the card against the same call on the CPU (the forward
   tolerance above), and at beta 50000 against ``render()`` (K1) as
   tests/test_soft.py holds soft against hard (isclose at atol 5e-2 on
   more than 93% of values, means within 0.01).  b. at 48x27x4/d4, sphere
   1 moved 0.1 in x: the centres' gradient of mean((img - target)^2) on
   the card against the CPU's (tests/test_megagrad.py's README tolerance:
   8e-2 and a cosine above 0.9999) and its sign (tests/test_soft.py); the
   one-triangle scene's apex gradient against central differences of the
   soft forward (|fd - ad| < 2e-3 + 0.05 |fd|, ad < 0).
   c. ``examples/inverse_rendering_torch.py`` at its size, 60 steps a
   stage, counts set to 0 just before and read just after: stage 1 (the
   albedo, hard) launches K1 and K4 once a step, stage 2 (the masked soft
   centre fit, beta 40) brings sphere 1's x within 0.4 x 0.15 of the true
   one and leaves the other spheres where they were; seconds a step.
   Stage 1 takes sphere 1's albedo at least halfway to the true one.
   d. one soft fit step under ``utils.profiling.device_trace``: the trace
   file read back, its kernels' device time, host syncs and ten costliest
   ops; the example's first stage-1 step through ``fit_scene``'s kernel
   route (K1 and K4, one launch each) traced the same way, and held
   against the same step on its plain route (the image under the forward
   tolerance, the albedo gradient under 6c's); the peak card memory of a
   soft step whose samples fill one and two groups of ``SHADE_BATCH``
   candidate rays.
28. the kernels line, whose K1 and K2 entries carry phases 22 to 26's
   window-mode keys and K3's to K7's the earlier design's time, and
   the result line.  Each of phases 12 to 16, 21 to 23 and 27 prints its
   seconds.

Any failure ends the run with a nonzero exit and no result line.  The
script needs a CUDA device and the package beside it; it starts no process
other than nvidia-smi, nvcc and the CLI of phase 26, all waited for.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# FP32 operations counted from the code, an add, multiply, divide, square
# root, min or max as 1 and an fma as 2 (compares, selects and sign flips
# not counted), so that the bounds below are least times.
# One ray-sphere test (csrc/common.cuh::closest_sphere): oc 3, half_b 5,
# c 6, the discriminant 3 = 17 for every test; a test that hits adds 4 to 6
# (the root), which is not counted.
FLOPS_PER_SPHERE_TEST = 17
# What every sphere hit takes besides the tests (csrc/megakernel.cu, the
# Lambertian scatter that every hit draws or, in the earlier design, runs
# first): the hit point 6 (3 fma), the normal 6 (3 subtractions, 3
# divisions), the front face 5 (a dot product), the draw's floats 4 (a
# multiply each; the pcg4d hash is integer work), zu 2, phi 1, the radius
# 4 (an fma, a max, a square root), cosf and sinf 2 (one each), the
# direction 5 (2 multiplies, 3 adds), the throughput 3 = 38.  K1 counts at
# least bounces - samples hits (a sample's last bounce may miss).
FLOPS_PER_SPHERE_HIT = 38
# One camera ray (common.cuh::camera_ray, no aperture): the two floats of
# the draw it reads 2, u and v 4 (an add and a division each), the
# direction 15 (2 fma and a subtraction a component) = 21, once a sample.
FLOPS_PER_CAMERA_RAY = 21
# One bounce walked back (csrc/megagrad.cu::bounce_adjoint), the cheapest
# kind, a Lambertian one: the recompute of the winner's hit 43, the
# throughput 9, the normal 18, the hit point 11, the root 13 + 33, the
# sphere cotangents 5 = 132.  A fuzzy-metal bounce adds 72 (reflect, the
# unit direction, the fuzz draw), a dielectric one more; not counted.
FLOPS_PER_REVERSE_BOUNCE = 132
# One triangle bounce walked back (csrc/megagrad.cu::tri_adjoint), the
# cheapest kind, a Lambertian one: |d|^2 5, the front face 5, the
# throughput 9, |n| 6, the normal's adjoint 14, the hit point 11, the plane
# t 10, its adjoint 24, the differences 5 = 89.
FLOPS_PER_TRI_REVERSE_BOUNCE = 89
# One ray-triangle test (csrc/mesh.cuh::tri_candidate, computed whole for
# every test): a 5, u_num 11, v_num 11, t_num 6, 1/a 1, u, v and t 3,
# u + v 1 = 38.  The slab tests that cull (23 each) are not counted.
FLOPS_PER_TRI_TEST = 38
TOL_FLIP, TOL_BULK, TOL_MEAN = 0.005, 0.99, 2e-3
# The mesh fits (phase 15): the 576-triangle target's mesh has every p0
# moved by FIT_SHIFT; Adam's learning rate of both fits
# (tools/mesh_fit_sweep.py measured the rates).
FIT_SHIFT = 0.01
FIT_LR = 1e-3
# Libraries built at the start: label -> (source, macros).  All but the
# first four are measurement builds, not on any path: the forward kernel
# with the backward's fuzz cube root (powf instead of cbrtf;
# csrc/common.cuh), the backward with the instances of K4's split
# (K4_VARIANTS), the sphere forward with the earlier K1 design, its cuts
# and options (K1_VARIANTS), the mesh forward with the walk's counting and
# timing instances (K2_VARIANTS), and the mesh forward and the backward
# with the earlier walk over every chunk (ORT_FLAT_WALK: K2, K5, K6 and K7
# with the walk as it was before the grouped walk), the backward with the
# instances of K5's and K7's split (K5_VARIANTS) and of K6's (K6_VARIANTS),
# and the closest-triangle kernel with the instances of K3's (K3_VARIANTS).
KERNELS = {"megakernel": ("megakernel", ()),
           "megagrad": ("megagrad", ()),
           "megamesh": ("megamesh", ()),
           "intersect_mm": ("intersect_mm", ()),
           "megakernel_powf": ("megakernel", ("ORT_FUZZ_POWF",)),
           "megagrad_k4_variants": ("megagrad", ("ORT_K4_VARIANTS",)),
           "megakernel_k1_variants": ("megakernel", ("ORT_K1_VARIANTS",)),
           "megamesh_k2_variants": ("megamesh", ("ORT_K2_VARIANTS",)),
           "megamesh_flat_walk": ("megamesh", ("ORT_FLAT_WALK",)),
           "megagrad_flat_walk": ("megagrad", ("ORT_FLAT_WALK",)),
           "megagrad_k5_variants": ("megagrad", ("ORT_K5_VARIANTS",)),
           "megagrad_k6_variants": ("megagrad", ("ORT_K6_VARIANTS",)),
           "intersect_mm_k3_variants": ("intersect_mm",
                                        ("ORT_K3_VARIANTS",))}
# The instances of K1's measurement build (csrc/megakernel.cu kVariants),
# in order: the earlier design (a pixel per thread, each branch drawing on
# its own), its SIMT-counting instance and its timing cuts (each runs one
# section twice, from the same inputs, so no path changes: the sphere
# tests, the sky, the bounce's Lambertian draw, the whole scatter, the
# camera ray), K1 with one pixel per thread (no work counter), and K1's
# SIMT-counting instance.  Each cut runs at the earlier design's threads
# and blocks an SM (dynamic shared memory holds a cut that needs fewer
# registers to them).  Every instance gives K1's image bit for bit and its
# bounces (K1_SECTIONS names the counted sections).
K1_VARIANTS = ("earlier", "earlier_simt", "earlier_twice_sphere",
               "earlier_twice_sky", "earlier_twice_lambert",
               "earlier_twice_scatter", "earlier_twice_camera",
               "k1_pixel_per_thread", "k1_simt")
K1_SECTIONS = ("sphere_tests", "sky", "lambert", "metal", "dielectric",
               "camera", "merged_draw")
# The instances of K2's measurement build (csrc/megamesh.cu kVariants), in
# order: the earlier walk and the grouped walk counting their slabs, runs,
# triangle tests and bounce steps and the warp passes at each
# (K2_WALK_KINDS); each walk run twice (the second time from the same rays,
# its result kept alive), so that the difference from the row-major,
# one-pixel-per-thread kernel is the walk's time; the grouped walk with
# each run's triangle tests twice (their time); and K2 without both of its
# options (the grouped walk alone), without the triangle-major table, and
# without persistent lanes.
K2_VARIANTS = ("count_flat", "count_grouped", "twice_flat", "twice_grouped",
               "twice_runs", "grouped_only", "without_major",
               "without_persistent")
K2_WALK_KINDS = ("box_slabs", "group_slabs", "chunk_slabs", "sub_slabs",
                 "runs", "bounce_steps")
# The instances of the measurement build of csrc/megagrad.cu, in the order
# of its kVariants: K4's earlier design (a pixel per thread, the megagrad
# template's sphere instance) and its timing cuts, then K4's timing cuts.
# Each cut is launched with the threads of the kernel it is cut from, so
# that it differs from it in work and not in occupancy.  The cuts' results
# are wrong on purpose (K4_CUTS); the rest must agree with K4 within
# K4_AGREE.  The SIMT instances are launched once, for their counts, and
# not timed.
K4_VARIANTS = ("earlier", "earlier_replay_only", "earlier_replay_records",
               "earlier_no_atomics", "earlier_simt", "k4_no_atomics",
               "k4_replay_only", "k4_simt")
K4_CUTS = ("earlier_replay_only", "earlier_replay_records",
           "earlier_no_atomics", "k4_no_atomics", "k4_replay_only")
# The instances of the measurement build of K5 and K7 (csrc/megagrad.cu
# kMeshVariants), in order: the earlier design (a pixel per thread, the
# megagrad template's mesh instances), K5's then K7's, each with its timing
# cuts (the replay alone, the replay with its record writes, plain adds
# instead of the shared sphere atomics, plain adds instead of the global
# triangle atomics) and its SIMT-counting instance; then the instances of
# mesh_megagrad (K5 and K7 as launched): their SIMT counts and K5's timing
# cuts (plain adds instead of the sphere atomics, instead of the triangle
# atomics, the replay alone).  Each cut runs at the threads and blocks an
# SM of the kernel it is cut from.  The cuts' results are wrong on purpose
# (K5_CUTS); every other instance must count K5's (K7's) bounces and
# triangle tests and agree with it within K5_AGREE.
K5_VARIANTS = (
    "earlier_k5", "earlier_k5_replay_only", "earlier_k5_replay_records",
    "earlier_k5_no_atomics", "earlier_k5_no_tri_atomics", "earlier_k5_simt",
    "earlier_k7", "earlier_k7_replay_only", "earlier_k7_replay_records",
    "earlier_k7_no_atomics", "earlier_k7_no_tri_atomics", "earlier_k7_simt",
    "k5_simt", "k7_simt", "k5_no_atomics", "k5_no_tri_atomics",
    "k5_replay_only")
K5_CUTS = tuple(v for v in K5_VARIANTS if "replay" in v or "no_" in v)
# max|a - b| / max|b| per block (camera, sphere and triangle cotangents)
# against K5's or K7's: the atomics add in another order from run to run
# (the two walks' K5 and K7 agreed within 2.7e-7 of each other).
K5_AGREE = 1e-4
# The instances of K6's measurement build (csrc/megagrad.cu
# kEmitVariants), in order: the earlier design (a thread per pixel, the
# megagrad template's emit instance, each pixel's non-sky sum its own), its
# timing cuts (the replay alone, the replay with its emit rows written)
# and its SIMT counts; K6's SIMT counts and its replay alone.  Each cut
# runs at the threads and blocks an SM of the kernel it is cut from; the
# cuts write no sums (K6_CUTS).  Every other instance gives K6's records
# and sums bit for bit and counts its bounces and triangle tests.
K6_VARIANTS = ("earlier_k6", "earlier_k6_replay_only",
               "earlier_k6_replay_emit", "earlier_k6_simt", "k6_simt",
               "k6_replay_only")
K6_CUTS = ("earlier_k6_replay_only", "earlier_k6_replay_emit",
           "k6_replay_only")
# The instances of K3's measurement build (csrc/intersect_mm.cu
# kVariants), in order: the earlier design (a thread per ray over every
# chunk, a block-wide vote per chunk, the chunks some ray of the block
# needs staged in shared memory) and its cuts (the runs read from device
# memory, no vote and no staging, the chunk gates twice, the triangle
# tests twice) and counts; then K3's walk counts and K3 with its triangle
# tests twice.
# Every instance gives the earlier design's t and index bit for bit and its
# triangle tests (the "twice" cuts repeat them from the same ray and keep
# the result apart).
K3_VARIANTS = ("earlier_k3", "earlier_k3_no_stage", "earlier_k3_no_vote",
               "earlier_k3_twice_gates", "earlier_k3_twice_tests",
               "earlier_k3_count", "k3_count", "k3_twice_tests")
# max|a - b| / max|b| of the sphere-table and camera cotangents against
# K4's: the earlier design adds each lane's values straight into a block's
# shared cell, 10^5 to 10^6 terms a cell in float32, and parts from K4 by
# up to 6.6e-4 on the book cover; the SIMT instance of K4 agrees with it
# within 3e-6.
K4_AGREE = 2e-3
GRAD_LEAVES = ("spheres.center", "spheres.radius", "spheres.albedo",
               "spheres.fuzz", "spheres.ior", "camera.look_from",
               "camera.look_at", "camera.vfov_deg", "camera.aperture_deg",
               "camera.focus_dist", "sky.const_colour")
TRI_LEAVES = ("triangles.p0", "triangles.p1", "triangles.p2",
              "triangles.albedo", "triangles.fuzz", "triangles.ior")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = (got - want).abs()
    return dict(max_abs_diff=float(diff.max()),
                flipped=float((diff > 1e-3).float().mean()),
                within_1e4=float((diff <= 1e-4).float().mean()),
                mean_diff=float((got.mean() - want.mean()).abs()))


def check_close(name: str, stats: dict) -> None:
    if not (stats["flipped"] < TOL_FLIP and stats["within_1e4"] > TOL_BULK
            and stats["mean_diff"] < TOL_MEAN):
        fail(f"{name}: kernel and plain version disagree: {stats}")


def timed(fn, reps: int = 3):
    """Minimum host seconds of reps calls, each ended by a synchronize."""
    best = float("inf")
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def kernel_ms(fn, reps: int = 3) -> float:
    """Minimum device milliseconds of reps calls, from CUDA events."""
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def build_all():
    """Build every kernel library at once, one nvcc each: name -> (path,
    seconds, the compiler's register and spill lines, each after its entry
    function's mangled name)."""
    from opencl_ray_tracer_tpu_torch.kernels import _build

    def one(label):
        t0 = time.perf_counter()
        lib = _build.build(*KERNELS[label])
        secs = time.perf_counter() - t0
        log = lib.with_suffix(".log")
        ptxas, entry = [], ""
        for ln in log.read_text().splitlines() if log.exists() else []:
            if "entry function" in ln:
                entry = ln.split("'")[1]
            elif "registers" in ln or "spill" in ln:
                ptxas.append(f"{entry}: {ln.split(':', 1)[-1].strip()}")
        return label, (lib, secs, ptxas)

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(pool.map(one, KERNELS))


def cube_root_variants(launch, plain_img, reps: int = 5) -> dict:
    """The forward kernel as built (cbrtf for the fuzz radius) and its
    variant with the backward's powf(u, 1/3), launched alternately: each
    one's minimum of reps CUDA-event times and its agreement with the plain
    version's image."""
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    built = mk._library
    src, defines = KERNELS["megakernel_powf"]
    libs = {"cbrtf": built(), "powf": _build.load(src, mk._SYMBOLS, defines)}
    out = {k: {"ms": float("inf")} for k in libs}
    try:
        for _ in range(reps):
            for k, lib in libs.items():
                mk._library = lambda lib=lib: lib
                out[k]["ms"] = min(out[k]["ms"], kernel_ms(launch, reps=1))
        for k, lib in libs.items():
            mk._library = lambda lib=lib: lib
            img = torch.stack(launch(), -1).reshape(plain_img.shape)
            out[k].update(compare(img, plain_img))
    finally:
        mk._library = built
    return out


def random_spheres(base, n: int, seed: int = 42):
    """n random Lambertian and metal spheres with base's camera and sky
    (tests/test_megagrad.py::test_large_sphere_count)."""
    import numpy as np
    import opencl_ray_tracer_tpu_torch as ot
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    return dataclasses.replace(base, spheres=ot.Spheres(
        center=f32(np.stack([rng.uniform(-3, 3, n), rng.uniform(0.3, 0.8, n),
                             rng.uniform(-3, 3, n)], 1)),
        radius=f32(rng.uniform(0.2, 0.45, n)),
        albedo=f32(rng.uniform(0.1, 0.9, (n, 3))),
        fuzz=f32(rng.uniform(0.0, 0.3, n)), ior=f32(np.full(n, 1.5)),
        mat_type=torch.tensor(rng.integers(0, 2, n), dtype=torch.int32)))


def leaf_errors(got, want) -> dict:
    """Per scene leaf: max|a - b| / max|b| (scale floor 1e-6) and
    max|a - b|; and the cosine of the stacked centre, albedo and radius
    gradients."""
    import numpy as np
    from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    rel = {k: float(np.abs(a[k] - b[k]).max())
           / max(float(np.abs(b[k]).max()), 1e-6) for k in GRAD_LEAVES}
    absd = max(float(np.abs(a[k] - b[k]).max()) for k in GRAD_LEAVES)
    keys = ("spheres.center", "spheres.albedo", "spheres.radius")
    va = np.concatenate([a[k].ravel() for k in keys]).astype(np.float64)
    vb = np.concatenate([b[k].ravel() for k in keys]).astype(np.float64)
    cos = float(va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)))
    return rel, absd, cos


def torus_scene(n_major: int | None = None, n_minor: int | None = None,
                translate=None, sky=None, **material):
    """The reference scene with a torus mesh: the bundled assets/torus.obj
    (n_major None) or the procedural make_torus_obj(n_major, n_minor), under
    the reference executable's mesh transform (scale 0.15, translate (0,
    -0.5, -1)) or, with ``translate``, tests/test_megamesh.py's (scale 0.5);
    ``material`` overrides the triangles' fields."""
    import os
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import load_obj, parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    if translate is None:
        xform = ((0.15, 0.15, 0.15), (0.0, -0.5, -1.0))
    else:
        xform = ((0.5, 0.5, 0.5), translate)
    if n_major is None:
        here = os.path.dirname(os.path.abspath(__file__))
        tris, aabb = load_obj(os.path.join(here, "assets", "torus.obj"),
                              *xform)
    else:
        tris, aabb = parse_obj(make_torus_obj(n_major, n_minor), *xform)
    scene = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb,
                               sky=sky)
    t = scene.triangles
    fields = {k: (torch.tensor(v).expand(t.count, 3).clone() if k == "albedo"
                  else torch.full_like(getattr(t, k), v))
              for k, v in material.items()}
    return dataclasses.replace(scene,
                               triangles=dataclasses.replace(t, **fields))


def split_boxes(scene, n_boxes: int = 40):
    """The scene with triangle i in gating box i % n_boxes, each box the
    bounds of its triangles and every third moved 50 units away (its
    triangles are never drawn): more boxes than a 32-bit mask holds."""
    import opencl_ray_tracer_tpu_torch as ot
    t = scene.triangles
    bid = torch.arange(t.count, dtype=torch.int32) % n_boxes
    pts = torch.stack([t.p0, t.p1, t.p2], 1)
    lo = torch.stack([pts[bid == b].reshape(-1, 3).amin(0)
                      for b in range(n_boxes)])
    hi = torch.stack([pts[bid == b].reshape(-1, 3).amax(0)
                      for b in range(n_boxes)])
    away = (torch.arange(n_boxes) % 3 == 0)[:, None] * 50.0
    return dataclasses.replace(
        scene, triangles=dataclasses.replace(t, box_id=bid),
        boxes=ot.BoundingBoxes(lo + away, hi + away))


def walk_table_bytes(tab, major: bool = False) -> int:
    """The bytes of the mesh tables a walk reads: the triangle table (the
    row-major one, or with major the triangle-major copy and the row-major
    normals), the chunks' AABBs, sub-boxes and gating boxes, the gating
    boxes and the groups."""
    tri = (tab.tri_major.numel() + 3 * tab.tri.shape[1] if major
           else tab.tri.numel())
    return 4 * (tri + tab.cluster.numel() + tab.sub.numel()
                + tab.boxes.numel() + tab.chunk_box.numel()
                + tab.group.numel() + tab.group_end.numel())


def bound_of(flops: float, io_bytes: float) -> dict:
    """The least time for flops and bytes, and which of the two sets it."""
    ms = 1e3 * max(flops / PEAK_FP32_FLOPS, io_bytes / PEAK_HBM_BYTES)
    return dict(flops=flops, bytes=io_bytes, bound_ms=ms,
                bound_by=("operations" if flops / PEAK_FP32_FLOPS
                          >= io_bytes / PEAK_HBM_BYTES else "bytes"))


def median_ms(fns: dict, reps: int = 5) -> dict:
    """Each function's median device milliseconds (CUDA events) over reps
    calls, the functions called in turns (warm them up first)."""
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: sorted(v)[len(v) // 2] for k, v in times.items()}


def rel_blocks(a, b) -> float:
    """The largest max|x - y| / max|y| over the blocks of two results."""
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def k4_variant(lib, v: int, cam, sph, n: int, cfg, sky_kind: int, flags,
               g, seed: int):
    """A launcher of instance v of the measurement build (K4_VARIANTS) on
    the image cotangent g (3, n_pix): counts (5 int64) or None ->
    (gcam (22,), gsph).  Built as kernels/megagrad.py's wrapper builds
    K4's launch."""
    import ctypes
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    n_pix = g.shape[1]
    for name, argtypes in (
            ("sphere_megagrad_variant_threads", [ctypes.c_int] * 4),
            ("sphere_megagrad_variant_launch",
             [ctypes.c_int, *mg._SYMBOLS["sphere_megagrad_launch"][0]])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    threads = lib.sphere_megagrad_variant_threads(v, n_pix, cfg.spp, n)
    if threads <= 0:
        fail(f"K4 variant {K4_VARIANTS[v]}: occupancy query failed")
    rec = torch.empty(threads * cfg.max_depth * 12, dtype=torch.float32,
                      device=cam.device)
    cam_part = torch.zeros((threads // 128, 22), dtype=torch.float32,
                           device=cam.device)
    gsph = torch.zeros_like(sph)
    bits = mk._flag_bits(cfg, sky_kind, flags)

    def launch(counts=None):
        gsph.zero_()
        rc = lib.sphere_megagrad_variant_launch(
            v, cam.data_ptr(), sph.data_ptr(), sph.shape[1], n,
            g[0].data_ptr(), g[1].data_ptr(), g[2].data_ptr(),
            cam_part.data_ptr(), gsph.data_ptr(), rec.data_ptr(), threads,
            counts.data_ptr() if counts is not None else None, n_pix, 0,
            seed, 0, cfg.spp, cfg.width, cfg.height, cfg.max_depth,
            cfg.t_min, bits, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"K4 variant {K4_VARIANTS[v]}: CUDA error {rc}")
        return cam_part.sum(0), gsph

    return launch, threads


def k4_split(dev) -> dict:
    """K4's split at the main path's size, README and book cover: K1, K4
    and every instance of the measurement build, the median of 5 CUDA-event
    times after a warm-up (the launch that reads the counts), in turns in
    one process; the counts of each (K4's must equal the earlier design's:
    the same paths replayed and walked back), the SIMT efficiency of
    replay and walk back (lane steps over warp iterations x 32), and each
    result against K4's."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    lib = _build.load(*KERNELS["megagrad_k4_variants"][:1], {},
                      KERNELS["megagrad_k4_variants"][1])
    bench = ot.README_BENCH
    n_pix = bench.width * bench.height
    out = {}
    for case, scene in (("readme", ot.readme_scene(16 / 9)),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        scene = scene.to(dev)
        cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
        n, sky_kind = scene.spheres.count, scene.sky.kind
        flags = mk.specialize_flags(scene)
        img = torch.stack(mk.render_spheres(cam, sph, n, bench, sky_kind,
                                            flags, 0, n_pix), -1)
        g = ((2.0 / img.numel() / bench.spp) * img).T.contiguous()
        fns = {"K1": lambda: mk.render_spheres(cam, sph, n, bench, sky_kind,
                                               flags, 0, n_pix),
               "K4": lambda c=None: mg.render_grad_tables(
                   cam, sph, n, bench, sky_kind, flags, g[0], g[1], g[2], 0,
                   n_pix, counts=c)}
        threads = {}
        for name in K4_VARIANTS:
            fns[name], threads[name] = k4_variant(
                lib, K4_VARIANTS.index(name), cam, sph, n, bench, sky_kind,
                flags, g, 0)
        # counts and results, one launch each, the warm-up
        fns["K1"]()
        counts, results = {}, {}
        for name in ("K4", *K4_VARIANTS):
            c = torch.zeros(5, dtype=torch.int64, device=dev)
            res = fns[name](c[:2] if name == "K4" else c)
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            results[name] = (res[0][:22].clone() if name != "K4"
                             else res[0][0, :22].clone(), res[1].clone())
        rows = list(mg.DIFF_FIELDS)
        agree = {}
        for name in K4_VARIANTS:
            if name in K4_CUTS:
                continue
            a, b = results[name], results["K4"]
            agree[name] = {
                "gsph_rel": float((a[1][rows, :n] - b[1][rows, :n]).abs()
                                  .max() / b[1][rows, :n].abs().max()),
                "gcam_rel": float((a[0] - b[0]).abs().max()
                                  / b[0].abs().max())}
            same = counts[name][:2] == counts["K4"][:2]
            if not same or max(agree[name].values()) >= K4_AGREE:
                fail(f"K4 split {case}: {name} disagrees with K4: "
                     f"{agree[name]}, counts {counts[name][:2]} against "
                     f"{counts['K4'][:2]}")
        ms = median_ms({k: f for k, f in fns.items()
                        if not k.endswith("simt")})
        replay, reverse = counts["K4"][:2]
        flops = (replay * n * FLOPS_PER_SPHERE_TEST
                 + reverse * FLOPS_PER_REVERSE_BOUNCE)
        bound = bound_of(flops, (2 * (cam.numel() + sph.numel())
                                 + 3 * n_pix) * 4)
        simt = {}
        for name in ("earlier_simt", "k4_simt"):
            c = counts[name]
            simt[name] = {"replay": c[0] / (32 * c[2]),
                          "walk_back": c[3] / (32 * c[4]),
                          "replay_warp_iterations": c[2],
                          "walk_back_lane_steps": c[3],
                          "walk_back_warp_iterations": c[4]}
        e = ms["earlier"]
        split = {"records_ms": ms["earlier_replay_records"]
                 - ms["earlier_replay_only"],
                 "walk_back_ms": e - ms["earlier_replay_records"],
                 "atomics_ms": e - ms["earlier_no_atomics"],
                 "k4_replay_share": ms["k4_replay_only"] / ms["K4"],
                 "k4_atomics_ms": ms["K4"] - ms["k4_no_atomics"],
                 "k4_speedup": e / ms["K4"],
                 "k4_share_of_bound": bound["bound_ms"] / ms["K4"]}
        out[case] = dict(ms=ms, split=split, simt=simt, bound=bound,
                         counts=counts, threads=threads, agree=agree)
        emit({"phase": "k4_split", "case": case, "size": "1280x720x250/d50",
              **out[case]})
    return out


def k1_flops(bounces: int, samples: int, n_spheres: int) -> float:
    """K1's FP32 work for a run's bounces and samples: every sphere tested
    on every bounce, at least bounces - samples hits, a camera ray a
    sample (the constants above)."""
    return (bounces * n_spheres * FLOPS_PER_SPHERE_TEST
            + max(bounces - samples, 0) * FLOPS_PER_SPHERE_HIT
            + samples * FLOPS_PER_CAMERA_RAY)


def ptxas_of(built, label: str) -> list:
    """The compiler's register and spill lines of one library."""
    return list(built[label][2]) if built and label in built else []


def simt_of(c: list, names) -> dict:
    """Per counted section: SIMT efficiency (lane steps over warp passes x
    32) and the lane steps, from counts c[1 + 2s] and c[2 + 2s]."""
    return {name: {"simt": (c[1 + 2 * i] / (32 * c[2 + 2 * i])
                            if c[2 + 2 * i] else None),
                   "lane_steps": c[1 + 2 * i]}
            for i, name in enumerate(names)}


def k1_variant(lib, v: int, cam, sph, n: int, cfg, sky_kind: int, flags,
               seed: int = 0):
    """A launcher of instance v of K1's measurement build (K1_VARIANTS):
    counts (the library's count of int64) or None -> (3, n_pix) planes.
    Its work counter is zeroed by each launch, as the wrapper's."""
    import ctypes
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    fn = lib.sphere_megakernel_variant_launch
    fn.argtypes = [i_, p_, p_, i_, i_, p_, p_, p_, p_, p_, i_,
                   ctypes.c_uint32, i_, i_, i_, i_, ctypes.c_float, i_, p_]
    fn.restype = i_
    n_pix = cfg.width * cfg.height
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    bits = mk._flag_bits(cfg, sky_kind, flags)

    def launch(counts=None):
        work = torch.zeros(1, dtype=torch.int32, device=cam.device)
        rc = fn(v, cam.data_ptr(), sph.data_ptr(), sph.shape[1], n,
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                counts.data_ptr() if counts is not None else None,
                work.data_ptr(), n_pix, seed, cfg.width, cfg.height, cfg.spp,
                cfg.max_depth, cfg.t_min, bits,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"K1 variant {K1_VARIANTS[v]}: CUDA error {rc}")
        return out

    return launch


def k1_split(dev, built=None, time_new: bool = True) -> dict:
    """K1's split at the main path's size, README and book cover: K1 and
    every instance of its measurement build, the median of 5 CUDA-event
    times after a warm-up (the launch that reads the counts), in turns in
    one process.  Every instance must give K1's image bit for bit and its
    bounces.  A section's time is its doubled cut less the earlier design;
    the metal and dielectric branches are the whole scatter's less the
    Lambertian draw's; SIMT efficiency per section, and the idle share (1 -
    the sphere tests' efficiency: lanes whose pixel has ended).  With
    time_new False only the earlier design's instances are timed."""
    import ctypes
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    lib = _build.load(*KERNELS["megakernel_k1_variants"][:1], {},
                      KERNELS["megakernel_k1_variants"][1])
    lib.sphere_megakernel_variant_counts.restype = ctypes.c_int
    n_counts = lib.sphere_megakernel_variant_counts()
    bench = ot.README_BENCH
    n_pix = bench.width * bench.height
    samples = n_pix * bench.spp
    out = {}
    for case, scene in (("readme", ot.readme_scene(16 / 9)),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        scene = scene.to(dev)
        cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
        n, sky_kind = scene.spheres.count, scene.sky.kind
        flags = mk.specialize_flags(scene)
        fns = {"K1": lambda: mk.render_spheres(cam, sph, n, bench, sky_kind,
                                               flags, 0, n_pix)}
        for i, name in enumerate(K1_VARIANTS):
            fns[name] = k1_variant(lib, i, cam, sph, n, bench, sky_kind,
                                   flags)
        b = torch.zeros(1, dtype=torch.int64, device=dev)
        k1 = torch.stack(mk.render_spheres(cam, sph, n, bench, sky_kind,
                                           flags, 0, n_pix, bounces=b))
        torch.cuda.synchronize()
        counts = {"K1": b.tolist()}
        for name in K1_VARIANTS:
            c = torch.zeros(n_counts, dtype=torch.int64, device=dev)
            same = torch.equal(fns[name](c), k1)
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            if not same or counts[name][0] != counts["K1"][0]:
                fail(f"K1 split {case}: {name} differs from K1 (image equal "
                     f"{same}, bounces {counts[name][0]} against "
                     f"{counts['K1'][0]})")
        ms = median_ms({k: f for k, f in fns.items()
                        if not k.endswith("simt")
                        and (time_new or k.startswith("earlier"))})
        e = ms["earlier"]
        split = {f"{sec}_ms": ms[f"earlier_twice_{sec}"] - e
                 for sec in ("sphere", "sky", "lambert", "scatter", "camera")}
        split["metal_dielectric_ms"] = (split["scatter_ms"]
                                        - split["lambert_ms"])
        split["rest_ms"] = e - sum(split[f"{sec}_ms"] for sec in
                                   ("sphere", "sky", "scatter", "camera"))
        simt = {name: simt_of(counts[name], K1_SECTIONS)
                for name in ("earlier_simt", "k1_simt")}
        idle = {name: 1.0 - simt[name]["sphere_tests"]["simt"]
                for name in simt}
        bounces = counts["K1"][0]
        bound = bound_of(k1_flops(bounces, samples, n),
                         (cam.numel() + sph.numel() + 3 * n_pix) * 4)
        bound_tests_only = bound_of(bounces * n * FLOPS_PER_SPHERE_TEST,
                                    (cam.numel() + sph.numel()
                                     + 3 * n_pix) * 4)
        k1_ms = ms.get("K1", float("nan"))
        out[case] = dict(ms=ms, split=split, simt=simt, idle_share=idle,
                         bounces=bounces, speedup=e / k1_ms,
                         bound=bound, bound_tests_only=bound_tests_only,
                         share_of_bound=bound["bound_ms"] / k1_ms)
        emit({"phase": "k1_split", "case": case, "size": "1280x720x250/d50",
              **out[case], "counts": counts,
              "ptxas": ptxas_of(built, "megakernel_k1_variants")})
    return out


def k2_split(dev, built=None, time_new: bool = True) -> dict:
    """K2's walk split at REFERENCE_DEFAULTS (1280x720x5/d32) with 576 and
    15,360 triangles, under the gradient sky and the HDR sky: K2 with the
    grouped walk and as it was (the earlier walk over every chunk, the
    ORT_FLAT_WALK build), the walk's counts per bounce for both walks
    (gating-box, group, chunk and sub-box slabs, runs entered, triangle
    tests, and the SIMT efficiency at each), the walk's time (each walk
    run a second time, less its kernel), and the backward kernels that
    replay the walk (K5 under the gradient sky, K6 and K7 under the HDR
    sky) with both walks; medians of 5 CUDA-event times in turns after a
    warm-up.  Both walks must find the same winners: equal images, bounce
    and triangle-test counts, equal K6 records, equal K5 and K7 counts
    and their cotangents within 1e-4 of each other's scale (atomics add
    in another order).  With time_new False only the earlier walk's
    instances are timed."""
    import ctypes
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.kernels.intersect_mm import table_args
    var = _build.load(*KERNELS["megamesh_k2_variants"][:1], {},
                      KERNELS["megamesh_k2_variants"][1])
    var.mesh_megakernel_variant_launch.argtypes = [
        ctypes.c_int, *mm._SYMBOLS["mesh_megakernel_launch"][0]]
    var.mesh_megakernel_variant_launch.restype = ctypes.c_int
    flat = {mm: _build.load("megamesh", mm._SYMBOLS,
                            KERNELS["megamesh_flat_walk"][1]),
            mg: _build.load("megagrad", mg._SYMBOLS,
                            KERNELS["megagrad_flat_walk"][1])}
    built_libs = {mm: mm._library, mg: mg._library}

    def flat_walk(fn):
        """fn run with the ORT_FLAT_WALK libraries in place."""
        def run(*a, **k):
            for mod, lib in flat.items():
                mod._library = lambda lib=lib: lib
            try:
                return fn(*a, **k)
            finally:
                for mod, lib in built_libs.items():
                    mod._library = lib
        return run

    cfg = ot.REFERENCE_DEFAULTS
    n_pix = cfg.width * cfg.height
    n_walk = len(K2_WALK_KINDS)
    flagship = flagship_scenes()
    scenes = {"mesh_576": torus_scene(), "mesh_15360": torus_scene(128, 60),
              "hdr_576": flagship["torus_576"],
              "hdr_15360": flagship["torus_15360"]}
    out = {}
    for case, scene in scenes.items():
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
        hdr = image is not None
        kind = scene.sky.kind
        bits = mk._flag_bits(cfg, kind, flags[:5])
        sky = mm.sky_args(image)

        def k2(counts=None):
            return torch.stack(mm.render_mesh(cam, sph, n, tab, cfg, kind,
                                              flags, 0, n_pix, counts=counts,
                                              sky_image=image))

        def variant(v):
            res = torch.empty((3, n_pix), dtype=torch.float32, device=dev)

            def launch(counts=None):
                work = torch.zeros(1, dtype=torch.int32, device=dev)
                rc = var.mesh_megakernel_variant_launch(
                    v, cam.data_ptr(), sph.data_ptr(), sph.shape[1], n,
                    *table_args(tab), int(flags[5]),
                    res[0].data_ptr(), res[1].data_ptr(), res[2].data_ptr(),
                    None, counts.data_ptr() if counts is not None else None,
                    work.data_ptr(), n_pix, 0, 0, 0, cfg.width, cfg.height,
                    cfg.spp, cfg.max_depth, cfg.t_min, bits, *sky,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    fail(f"K2 variant {K2_VARIANTS[v]}: CUDA error {rc}")
                return res
            return launch

        fns = {"K2": k2, "K2_flat_walk": flat_walk(k2)}
        for i, name in enumerate(K2_VARIANTS):
            fns[name] = variant(i)
        counts = {}
        img = None
        for name in ("K2", "K2_flat_walk", *K2_VARIANTS):
            c = torch.zeros(2 + 2 * n_walk + 1, dtype=torch.int64,
                            device=dev)
            got = fns[name](c if name in K2_VARIANTS else c[:2])
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            img = got.clone() if img is None else img
            if (not torch.equal(got, img)
                    or counts[name][:2] != counts["K2"][:2]):
                fail(f"K2 split {case}: {name} differs from K2 (bounces, "
                     f"tests {counts[name][:2]} against "
                     f"{counts['K2'][:2]})")
        # the backward kernels that replay the walk, with both walks
        g = ((2.0 / (3 * n_pix) / cfg.spp) * img).contiguous()
        if hdr:
            emit_, _ = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 0, n_pix)
            sky_rows, _ = mg.hdr_lookup(image, emit_)
            grads = {
                "K6": lambda c=None: mg.hdr_emit(cam, sph, n, tab, cfg,
                                                 flags, 0, n_pix, counts=c),
                "K7": lambda c=None: mg.hdr_consume(
                    cam, sph, n, tab, cfg, flags, g[0], g[1], g[2],
                    sky_rows, 0, n_pix, counts=c)}
        else:
            grads = {"K5": lambda c=None: mg.render_grad_mesh_tables(
                cam, sph, n, tab, cfg, kind, flags, g[0], g[1], g[2], 0,
                n_pix, counts=c)}
        agree = {}
        for name, fn in list(grads.items()):
            grads[f"{name}_flat_walk"] = flat_walk(fn)
            res = {}
            for key in (name, f"{name}_flat_walk"):
                c = torch.zeros(4 if name != "K6" else 2, dtype=torch.int64,
                                device=dev)
                res[key] = grads[key](c)
                torch.cuda.synchronize()
                counts[key] = c.tolist()
            a, b = res[name], res[f"{name}_flat_walk"]
            if name == "K6":
                agree[name] = bool(torch.equal(a[0], b[0])
                                   and torch.equal(a[1], b[1]))
            else:
                agree[name] = rel_blocks(a, b)
            if (counts[name] != counts[f"{name}_flat_walk"]
                    or agree[name] is False
                    or (agree[name] is not True and agree[name] > 1e-4)):
                fail(f"K2 split {case}: {name} with the two walks disagrees: "
                     f"{agree[name]}, counts {counts[name]} against "
                     f"{counts[name + '_flat_walk']}")
        fns.update(grads)
        earlier = ("K2_flat_walk", "twice_flat", "K5_flat_walk",
                   "K6_flat_walk", "K7_flat_walk")
        ms = median_ms({k: f for k, f in fns.items()
                        if not k.startswith("count")
                        and (time_new or k in earlier)})
        bounces = counts["K2"][0]
        walk = {}
        for w in ("flat", "grouped"):
            c = counts[f"count_{w}"]
            walk[w] = {
                "per_bounce": {k: c[2 + i] / bounces
                               for i, k in enumerate(K2_WALK_KINDS)},
                "simt": {k: (c[2 + i] / (32 * c[2 + n_walk + i])
                             if c[2 + n_walk + i] else None)
                         for i, k in enumerate(K2_WALK_KINDS)},
                "slab_simt": (sum(c[2:2 + 4]) / (32 * sum(
                    c[2 + n_walk:2 + n_walk + 4])) if sum(
                        c[2 + n_walk:2 + n_walk + 4]) else None),
                "tests_per_bounce": c[1] / bounces}
        walk["flat"]["walk_ms"] = ms["twice_flat"] - ms["K2_flat_walk"]
        if time_new:
            walk["grouped"]["walk_ms"] = (ms["twice_grouped"]
                                          - ms["grouped_only"])
            walk["grouped"]["tests_ms"] = (ms["twice_runs"]
                                           - ms["grouped_only"])
        out[case] = dict(ms=ms, walk=walk, bounces=bounces,
                         tests=counts["K2"][1], agree=agree,
                         n_chunks=tab.chunk_box.shape[0],
                         n_groups=tab.group_end.shape[0])
        emit({"phase": "k2_split", "case": case, "size": "1280x720x5/d32",
              **out[case], "counts": counts,
              "ptxas": ptxas_of(built, "megamesh_k2_variants")
              + ptxas_of(built, "megamesh_flat_walk")
              + ptxas_of(built, "megagrad_flat_walk")})
    return out


def k5_variant(lib, v: int, cam, sph, n: int, tab, cfg, sky_kind: int, flags,
               g, seed: int, sky_rows=None):
    """A launcher of instance v of K5's measurement build (K5_VARIANTS) on
    the image cotangent g (3, n_pix), with sky_rows for K7's instances:
    counts (7 int64) or None -> (gcam (1, 128), gsph, gtri), as
    kernels/megagrad.py's wrappers return them; and its threads."""
    import ctypes
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels.intersect_mm import table_args
    from opencl_ray_tracer_tpu_torch.scene.sky import KIND_HDR
    for name, argtypes in (
            ("mesh_megagrad_variant_threads", [ctypes.c_int] * 4),
            ("mesh_megagrad_variant_launch",
             [ctypes.c_int, *mg._SYMBOLS["hdr_consume_launch"][0]])):
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    n_pix = g.shape[1]
    threads = lib.mesh_megagrad_variant_threads(v, n_pix, cfg.spp, n)
    if threads <= 0:
        fail(f"K5 variant {K5_VARIANTS[v]}: occupancy query failed")
    rec = torch.empty(threads * cfg.max_depth * 12, dtype=torch.float32,
                      device=cam.device)
    cam_part = torch.zeros((threads // 128, 22), dtype=torch.float32,
                           device=cam.device)
    gsph = torch.zeros_like(sph)
    gtri = torch.zeros((10, tab.tri.shape[1]), dtype=torch.float32,
                       device=cam.device)
    bits = mk._flag_bits(cfg.replace(nan_policy="zero")
                         if sky_kind == KIND_HDR else cfg, sky_kind,
                         flags[:5])

    def launch(counts=None):
        gsph.zero_()
        gtri.zero_()
        rc = lib.mesh_megagrad_variant_launch(
            v, cam.data_ptr(), sph.data_ptr(), sph.shape[1], n,
            *table_args(tab), int(flags[5]), g[0].data_ptr(),
            g[1].data_ptr(), g[2].data_ptr(),
            sky_rows.data_ptr() if sky_rows is not None else None,
            cam_part.data_ptr(), gsph.data_ptr(), gtri.data_ptr(),
            rec.data_ptr(), threads,
            counts.data_ptr() if counts is not None else None, n_pix, 0,
            seed, 0, cfg.spp, cfg.width, cfg.height, cfg.max_depth,
            cfg.t_min, bits, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"K5 variant {K5_VARIANTS[v]}: CUDA error {rc}")
        gcam = torch.zeros_like(cam)
        gcam[0, :22] = cam_part.sum(0)
        return gcam, gsph, gtri

    return launch, threads


def k5_split(dev, built=None, time_new: bool = True) -> dict:
    """K5's and K7's split at REFERENCE_DEFAULTS (1280x720x5/d32) with 576
    and 15,360 triangles, K5 under the gradient sky and K7 under the
    flagship's HDR sky: K5 or K7 as launched and every instance of the
    measurement build of its sky (K5_VARIANTS), the median of 5 CUDA-event
    times after a warm-up (the launch that reads the counts), in turns in
    one process.  The earlier design's time by part (the replay, the record
    writes, the walk back, the sphere and the triangle atomics), the SIMT
    efficiency of replay and walk back of both designs (lane steps over
    warp iterations x 32), each kernel's bound, and each result against
    K5's (K7's): every instance that is not a cut counts its bounces and
    triangle tests and agrees within K5_AGREE; two launches of K5 (K7)
    give equal camera cotangents.  With time_new False only the earlier
    design's instances are timed."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    lib = _build.load(*KERNELS["megagrad_k5_variants"][:1], {},
                      KERNELS["megagrad_k5_variants"][1])
    cfg = ot.REFERENCE_DEFAULTS
    n_pix = cfg.width * cfg.height
    flagship = flagship_scenes()
    scenes = {"mesh_576": torus_scene(), "mesh_15360": torus_scene(128, 60),
              "hdr_576": flagship["torus_576"],
              "hdr_15360": flagship["torus_15360"]}
    out = {}
    for case, scene in scenes.items():
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
        kind = scene.sky.kind
        k = "k7" if image is not None else "k5"
        img = torch.stack(mm.render_mesh(cam, sph, n, tab, cfg, kind, flags,
                                         0, n_pix, sky_image=image))
        g = ((2.0 / (3 * n_pix) / cfg.spp) * img).contiguous()
        sky_rows = None
        if image is not None:
            emit_, _ = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 0, n_pix)
            sky_rows, _ = mg.hdr_lookup(image, emit_)
            del emit_

            def kernel(c=None):
                return mg.hdr_consume(cam, sph, n, tab, cfg, flags, g[0],
                                      g[1], g[2], sky_rows, 0, n_pix,
                                      counts=c)
        else:
            def kernel(c=None):
                return mg.render_grad_mesh_tables(
                    cam, sph, n, tab, cfg, kind, flags, g[0], g[1], g[2], 0,
                    n_pix, counts=c)
        names = [v for v in K5_VARIANTS
                 if v.startswith(f"earlier_{k}") or v.startswith(f"{k}_")]
        fns, threads = {k.upper(): kernel}, {}
        for name in names:
            fns[name], threads[name] = k5_variant(
                lib, K5_VARIANTS.index(name), cam, sph, n, tab, cfg, kind,
                flags, g, 0, sky_rows)
        # counts and results, one launch each, the warm-up
        counts, results = {}, {}
        for name, fn in fns.items():
            c = torch.zeros(7, dtype=torch.int64, device=dev)
            res = fn(c[:4] if name == k.upper() else c)
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            results[name] = tuple(x.clone() for x in res)
        base = results[k.upper()]
        repeat = fns[k.upper()]()
        torch.cuda.synchronize()
        if not torch.equal(repeat[0], base[0]):
            fail(f"K5 split {case}: two launches of {k.upper()} give other "
                 "camera cotangents")
        agree = {}
        for name in names:
            if name in K5_CUTS:
                continue
            agree[name] = rel_blocks(results[name], base)
            if (counts[name][:4] != counts[k.upper()][:4]
                    or agree[name] >= K5_AGREE):
                fail(f"K5 split {case}: {name} disagrees with {k.upper()}: "
                     f"{agree[name]}, counts {counts[name][:4]} against "
                     f"{counts[k.upper()][:4]}")
        ms = median_ms({key: f for key, f in fns.items()
                        if not key.endswith("simt")
                        and (time_new or key.startswith("earlier"))})
        e = f"earlier_{k}"
        split = {"replay_ms": ms[f"{e}_replay_only"],
                 "records_ms": ms[f"{e}_replay_records"]
                 - ms[f"{e}_replay_only"],
                 "walk_back_ms": ms[e] - ms[f"{e}_replay_records"],
                 "sphere_atomics_ms": ms[e] - ms[f"{e}_no_atomics"],
                 "tri_atomics_ms": ms[e] - ms[f"{e}_no_tri_atomics"]}
        if time_new:
            split["speedup"] = ms[e] / ms[k.upper()]
            if k == "k5":
                split.update(
                    new_replay_ms=ms["k5_replay_only"],
                    new_sphere_atomics_ms=ms["K5"] - ms["k5_no_atomics"],
                    new_tri_atomics_ms=ms["K5"] - ms["k5_no_tri_atomics"])
        simt = {}
        for name in (f"{e}_simt", f"{k}_simt"):
            c = counts[name]
            simt[name] = {"replay": c[0] / (32 * c[4]) if c[4] else None,
                          "walk_back": c[5] / (32 * c[6]) if c[6] else None,
                          "replay_warp_iterations": c[4],
                          "walk_back_lane_steps": c[5],
                          "walk_back_warp_iterations": c[6]}
        replay, reverse, tests, reverse_tri = counts[k.upper()][:4]
        flops = (replay * n * FLOPS_PER_SPHERE_TEST
                 + tests * FLOPS_PER_TRI_TEST
                 + (reverse - reverse_tri) * FLOPS_PER_REVERSE_BOUNCE
                 + reverse_tri * FLOPS_PER_TRI_REVERSE_BOUNCE)
        io_bytes = ((2 * (cam.numel() + sph.numel()) + 3 * n_pix
                     + 10 * tab.tri.shape[1]
                     + (sky_rows.numel() if sky_rows is not None else 0)) * 4
                    + walk_table_bytes(tab))
        bound = bound_of(flops, io_bytes)
        if time_new:
            bound["share_of_bound"] = bound["bound_ms"] / ms[k.upper()]
        out[case] = dict(ms=ms, split=split, simt=simt, bound=bound,
                         agree=agree, threads=threads)
        emit({"phase": "k5_split", "case": case, "size": "1280x720x5/d32",
              **out[case], "counts": counts,
              "ptxas": [ln for ln in ptxas_of(built, "megagrad")
                        if "mesh_megagrad" in ln]
              + ptxas_of(built, "megagrad_k5_variants")})
        del results, base, repeat, sky_rows
    return out


def k6_variant(lib, v: int, cam, sph, n: int, tab, cfg, flags,
               seed: int = 0, sums: bool = True):
    """A launcher of instance v of K6's measurement build (K6_VARIANTS):
    counts (3 int64) or None -> (emit, emis), as kernels/megagrad.py's
    hdr_emit returns them (K6's instances' per-sample rows summed by its
    second pass; with sums False, and for the cuts, that pass is not
    launched and emis holds the rows)."""
    import ctypes
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels.intersect_mm import table_args
    from opencl_ray_tracer_tpu_torch.scene.sky import KIND_HDR
    lib.hdr_emit_variant_launch.argtypes = [
        ctypes.c_int, *mg._SYMBOLS["hdr_emit_launch"][0]]
    lib.hdr_emit_variant_launch.restype = ctypes.c_int
    n_pix = cfg.width * cfg.height
    rows = not K6_VARIANTS[v].startswith("earlier")
    sums = sums and rows and K6_VARIANTS[v] not in K6_CUTS
    emit = torch.empty((mg.EMIT_ROWS, cfg.spp, n_pix), dtype=torch.float32,
                       device=cam.device)
    emis = torch.empty((3, cfg.spp, n_pix) if rows else (3, n_pix),
                       dtype=torch.float32, device=cam.device)
    out = torch.empty((3, n_pix), dtype=torch.float32, device=cam.device)
    bits = mk._flag_bits(cfg.replace(nan_policy="zero"), KIND_HDR, flags[:5])

    def launch(counts=None):
        rc = lib.hdr_emit_variant_launch(
            v, cam.data_ptr(), sph.data_ptr(), sph.shape[1], n,
            *table_args(tab), int(flags[5]), emit.data_ptr(),
            emis.data_ptr(), out.data_ptr() if sums else None,
            counts.data_ptr() if counts is not None else None, n_pix, 0,
            seed, 0, cfg.spp, cfg.width, cfg.height, cfg.max_depth,
            cfg.t_min, bits, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"K6 variant {K6_VARIANTS[v]}: CUDA error {rc}")
        return emit, (out if sums else emis)

    return launch


def k6_split(dev, built=None, time_new: bool = True) -> dict:
    """K6's split at REFERENCE_DEFAULTS (1280x720x5/d32) on both flagship
    scenes (576 and 15,360 triangles under the tone-mapped HDR sky): K6 as
    launched and every instance of its measurement build (K6_VARIANTS),
    the median of 5 CUDA-event times after a warm-up (the launch that reads
    the counts), in turns in one process.  The earlier design's time by
    part (the replay, the emit rows, the non-sky sums), the SIMT efficiency
    of both designs' replay (lane steps over warp iterations x 32), the
    bound, and every instance that is not a cut against K6: equal records
    and sums bit for bit, equal bounces and triangle tests; two launches of
    K6 give equal records and sums.  With time_new False only the earlier
    design's instances are timed."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    lib = _build.load(*KERNELS["megagrad_k6_variants"][:1], {},
                      KERNELS["megagrad_k6_variants"][1])
    cfg = ot.REFERENCE_DEFAULTS
    n_pix = cfg.width * cfg.height
    flagship = flagship_scenes()
    out = {}
    for case, key in (("hdr_576", "torus_576"), ("hdr_15360", "torus_15360")):
        cam, sph, n, tab, flags, _ = mm.mesh_inputs(flagship[key], dev)

        def kernel(c=None):
            return mg.hdr_emit(cam, sph, n, tab, cfg, flags, 0, n_pix,
                               counts=c)

        fns = {"K6": kernel}
        for i, name in enumerate(K6_VARIANTS):
            fns[name] = k6_variant(lib, i, cam, sph, n, tab, cfg, flags)
        counts, results = {}, {}
        for name, fn in fns.items():
            c = torch.zeros(3, dtype=torch.int64, device=dev)
            res = fn(c[:2] if name == "K6" else c)
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            if name not in K6_CUTS:
                results[name] = tuple(x.clone() for x in res)
        base = results["K6"]
        repeat = kernel()
        torch.cuda.synchronize()
        if not (torch.equal(repeat[0], base[0])
                and torch.equal(repeat[1], base[1])):
            fail(f"K6 split {case}: two launches of K6 differ")
        for name in K6_VARIANTS:
            if name in K6_CUTS:
                continue
            a = results[name]
            if (not torch.equal(a[0], base[0])
                    or not torch.equal(a[1], base[1])
                    or counts[name][:2] != counts["K6"][:2]):
                fail(f"K6 split {case}: {name} differs from K6 (counts "
                     f"{counts[name][:2]} against {counts['K6'][:2]}, "
                     f"largest sum difference "
                     f"{float((a[1] - base[1]).abs().max())})")
        ms = median_ms({k: f for k, f in fns.items()
                        if not k.endswith("simt")
                        and (time_new or k.startswith("earlier"))})
        split = {"replay_ms": ms["earlier_k6_replay_only"],
                 "emit_rows_ms": ms["earlier_k6_replay_emit"]
                 - ms["earlier_k6_replay_only"],
                 "nonsky_sums_ms": ms["earlier_k6"]
                 - ms["earlier_k6_replay_emit"]}
        if time_new:
            # the second pass: K6's counting instance with and without it
            v = K6_VARIANTS.index("k6_simt")
            passes = median_ms({
                s: k6_variant(lib, v, cam, sph, n, tab, cfg, flags, sums=s)
                for s in (True, False)})
            split.update(speedup=ms["earlier_k6"] / ms["K6"],
                         new_replay_ms=ms["k6_replay_only"],
                         new_outputs_ms=ms["K6"] - ms["k6_replay_only"],
                         sample_sums_ms=passes[True] - passes[False])
        simt = {}
        for name in ("earlier_k6_simt", "k6_simt"):
            c = counts[name]
            simt[name] = {"replay": c[0] / (32 * c[2]) if c[2] else None,
                          "replay_lane_steps": c[0],
                          "replay_warp_iterations": c[2]}
        replay, tests = counts["K6"][:2]
        bound = bound_of(replay * n * FLOPS_PER_SPHERE_TEST
                         + tests * FLOPS_PER_TRI_TEST,
                         (cam.numel() + sph.numel()
                          + base[0].numel() + base[1].numel()) * 4
                         + walk_table_bytes(tab))
        if time_new:
            bound["share_of_bound"] = bound["bound_ms"] / ms["K6"]
        out[case] = dict(ms=ms, split=split, simt=simt, bound=bound)
        emit({"phase": "k6_split", "case": case, "size": "1280x720x5/d32",
              **out[case], "counts": counts,
              "ptxas": [ln for ln in ptxas_of(built, "megagrad")
                        if "mesh_megagrad" in ln]
              + ptxas_of(built, "megagrad_k6_variants")})
        del results, base, repeat
    return out


def k3_random_batches(dev) -> dict:
    """The closest-triangle kernel's random batches, (tables, o, d): 2^20
    rays from around the camera into the box of the 15,360-triangle torus,
    and 2^16 into the kept boxes of a 2,304-triangle torus split over 40
    gating boxes (split_boxes)."""
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    big = torus_scene(128, 60).to(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    lo, hi = big.boxes.box_min[0], big.boxes.box_max[0]
    target = lo + (hi - lo) * torch.rand((2**20, 3), generator=gen,
                                         device=dev)
    o = (big.camera.look_from + 0.5 * torch.randn(
        (2**20, 3), generator=gen, device=dev)).contiguous()
    out = {"random_2^20": (im.mesh_tables(big), o,
                           (target - o).contiguous())}
    boxed = split_boxes(torus_scene(48, 24, (0.3, 0.0, -1.6))).to(dev)
    kept = torch.arange(40, device=dev) % 3 != 0
    lo = boxed.boxes.box_min[kept].amin(0)
    hi = boxed.boxes.box_max[kept].amax(0)
    target = lo + (hi - lo) * torch.rand((2**16, 3), generator=gen,
                                         device=dev)
    o = (boxed.camera.look_from + 0.5 * torch.randn(
        (2**16, 3), generator=gen, device=dev)).contiguous()
    out["40_boxes_2^16"] = (im.mesh_tables(boxed), o,
                            (target - o).contiguous())
    return out


def k3_calls(dev, fn) -> tuple:
    """fn() with each closest-triangle launch timed by CUDA events and
    counting its triangle tests, the launch counts set to 0 just before and
    read just after: (seconds, fn's result, the closest-triangle launches,
    the mesh megakernel launches, and each launch's (start event, end
    event, triangle tests, tables, o, d))."""
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    launch_k3 = im.closest_tri
    calls = []

    def closest_tri_timed(tab_, o, d, t_min, tests=None):
        n_tests = torch.zeros(1, dtype=torch.int64, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch_k3(tab_, o, d, t_min, n_tests)
        end.record()
        if tests is not None:
            tests += n_tests
        calls.append((start, end, n_tests, tab_, o.clone(), d.clone()))
        return out

    im.closest_tri = closest_tri_timed
    try:
        im.LAUNCHES = mm.LAUNCHES = 0
        secs, out = timed(fn, reps=1)
        return secs, out, im.LAUNCHES, mm.LAUNCHES, calls
    finally:
        im.closest_tri = launch_k3


def plain_route_k3_calls(dev, scene, cfg) -> tuple:
    """k3_calls of ``render()`` of scene with backend "jnp" (the plain
    tracer on the card, whose triangle hit is the closest-triangle
    kernel), seed 0."""
    import opencl_ray_tracer_tpu_torch as ot
    return k3_calls(dev, lambda: ot.render(
        scene, cfg.replace(backend="jnp"), seed=0))


def plain_grad_k3_calls(dev, scene, cfg) -> tuple:
    """k3_calls of ``render_grad_sampled(grad_backend="plain")`` of scene
    (autograd of the plain wavefront, whose winner search is the
    closest-triangle kernel, as in the plain fits), loss mean(img^2),
    seed 0: phase 16's route."""
    import opencl_ray_tracer_tpu_torch as ot
    return k3_calls(dev, lambda: ot.render_grad_sampled(
        scene, cfg, lambda img: torch.mean(img ** 2), seed=0,
        grad_backend="plain"))


def k3_variant(lib, v: int, tab, o, d, t_min: float = 1e-3):
    """A launcher of instance v of K3's measurement build (K3_VARIANTS) on
    the rays (o, d): counts (15 int64: the triangle tests first) or None ->
    (t, index int32)."""
    import ctypes
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels.intersect_mm import table_args
    lib.closest_tri_variant_launch.argtypes = [
        ctypes.c_int, *im._SYMBOLS["closest_tri_launch"][0]]
    lib.closest_tri_variant_launch.restype = ctypes.c_int
    r = o.shape[0]
    out_t = torch.empty((r,), dtype=torch.float32, device=o.device)
    out_i = torch.empty((r,), dtype=torch.int32, device=o.device)
    persistent = not K3_VARIANTS[v].startswith("earlier")

    def launch(counts=None):
        work = (torch.zeros(1, dtype=torch.int32, device=o.device)
                if persistent else None)
        rc = lib.closest_tri_variant_launch(
            v, *table_args(tab), o.data_ptr(), d.data_ptr(), r, t_min,
            out_t.data_ptr(), out_i.data_ptr(),
            counts.data_ptr() if counts is not None else None,
            work.data_ptr() if work is not None else None,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            fail(f"K3 variant {K3_VARIANTS[v]}: CUDA error {rc}")
        return out_t, out_i

    return launch


def k3_split(dev, built=None, time_new: bool = True, calls=None) -> dict:
    """K3's split on three batches: the 2^20 random rays into the
    15,360-triangle torus, the plain route's busiest batch (the plain
    tracer's render of that scene at REFERENCE_DEFAULTS, the launch that
    ran the most triangle tests; ``calls``: that render's launches, as
    plain_route_k3_calls gives them, when the caller has them) and the
    2^16 rays into the 40-box torus; and each design's time of all that
    render's launches and of all the launches of phase 16's plain gradient
    route (route_launch_ms).  K3 as launched and
    every instance of its measurement build (K3_VARIANTS), the median of 5
    CUDA-event times after a warm-up, in turns: the earlier design's time
    by part (the votes with their staging, the staging alone, the chunk
    gates, the triangle tests), the SIMT efficiency of the walk's slabs and
    runs in both designs, the earlier design's staged chunks and the warps
    idle in them, the bound; every instance gives the earlier design's t
    and index bit for bit and its triangle tests.  With time_new False only
    the earlier design's instances are timed."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    lib = _build.load(*KERNELS["intersect_mm_k3_variants"][:1], {},
                      KERNELS["intersect_mm_k3_variants"][1])
    batches = k3_random_batches(dev)
    if calls is None:
        *_, calls = plain_route_k3_calls(dev, torus_scene(128, 60),
                                         ot.REFERENCE_DEFAULTS)
    batches = {"random_2^20": batches["random_2^20"],
               "plain_route_busiest": max(
                   calls, key=lambda c: int(c[2].item()))[3:],
               "40_boxes_2^16": batches["40_boxes_2^16"]}
    n_kinds = len(K2_WALK_KINDS)
    out = {}
    for case, (tab, o, d) in batches.items():
        fns = {"K3": lambda c=None, tab=tab, o=o, d=d: im.closest_tri(
            tab, o, d, 1e-3, tests=c)}
        for i, name in enumerate(K3_VARIANTS):
            fns[name] = k3_variant(lib, i, tab, o, d)
        counts, results = {}, {}
        for name, fn in fns.items():
            c = torch.zeros(15, dtype=torch.int64, device=dev)
            t, idx = fn(c[:1] if name == "K3" else c)
            torch.cuda.synchronize()
            counts[name] = c.tolist()
            results[name] = (t.clone(), idx.int().clone())
        base = results["earlier_k3"]
        for name, (t, idx) in results.items():
            if (not torch.equal(t, base[0]) or not torch.equal(idx, base[1])
                    or counts[name][0] != counts["earlier_k3"][0]):
                fail(f"K3 split {case}: {name} differs from the earlier "
                     f"design (tests {counts[name][0]} against "
                     f"{counts['earlier_k3'][0]}, indices equal on "
                     f"{float((idx == base[1]).float().mean())})")
        ms = median_ms({k: f for k, f in fns.items()
                        if not k.endswith("count")
                        and (time_new or k.startswith("earlier"))})
        e = "earlier_k3"
        split = {"votes_and_staging_ms": ms[e] - ms[f"{e}_no_vote"],
                 "staging_ms": ms[e] - ms[f"{e}_no_stage"],
                 "gates_ms": ms[f"{e}_twice_gates"] - ms[e],
                 "tests_ms": ms[f"{e}_twice_tests"] - ms[e]}
        if time_new:
            split.update(speedup=ms[e] / ms["K3"],
                         new_tests_ms=ms["k3_twice_tests"] - ms["K3"])
        simt = {}
        for name in (f"{e}_count", "k3_count"):
            c = counts[name]
            simt[name] = {
                k: (c[1 + i] / (32 * c[1 + n_kinds + i])
                    if c[1 + n_kinds + i] else None)
                for i, k in enumerate(K2_WALK_KINDS[:5])}
            simt[name]["per_ray"] = {k: c[1 + i] / o.shape[0]
                                     for i, k in enumerate(K2_WALK_KINDS[:5])}
        c = counts[f"{e}_count"]
        blocks = (o.shape[0] + 127) // 128
        staged = c[1 + 2 * n_kinds]
        simt[f"{e}_count"].update(
            chunks_staged=staged,
            staged_share=staged / (blocks * tab.chunk_box.shape[0]),
            idle_warp_share_in_staged=(
                1 - c[2 + 2 * n_kinds] / (4 * staged) if staged else None))
        tests = counts["K3"][0]
        bound = bound_of(tests * FLOPS_PER_TRI_TEST,
                         walk_table_bytes(tab) + 8 * 4 * o.shape[0])
        if time_new:
            bound["share_of_bound"] = bound["bound_ms"] / ms["K3"]
        out[case] = dict(ms=ms, split=split, simt=simt, bound=bound,
                         n_rays=o.shape[0], tri_tests=tests,
                         n_triangles=tab.plan.n_tris)
        emit({"phase": "k3_split", "case": case, **out[case],
              "counts": counts,
              "ptxas": ptxas_of(built, "intersect_mm")
              + ptxas_of(built, "intersect_mm_k3_variants")})
        del results, base
    # the two routes' launches, each design over all of them as its wrapper
    # launched it (the earlier design's with the indices' conversion to
    # int64, K3's with its work counter's zeroing too)
    def earlier(tab, o, d):
        fn = k3_variant(lib, K3_VARIANTS.index("earlier_k3"), tab, o, d)
        return lambda: fn()[1].long()

    designs = {"earlier_k3": earlier}
    if time_new:
        designs["K3"] = lambda tab, o, d: (
            lambda: im.closest_tri(tab, o, d, 1e-3))
    grad_cfg = ot.RenderConfig(width=160, height=90, spp=2, max_depth=8)
    *_, grad_calls = plain_grad_k3_calls(dev, torus_scene(128, 60),
                                         grad_cfg)
    for case, route_calls in (("plain_route_launches", calls),
                              ("plain_grad_route_launches", grad_calls)):
        out[case] = route_launch_ms(designs, route_calls)
        emit({"phase": "k3_split", "case": case, **out[case]})
    return out


def route_launch_ms(designs: dict, calls) -> dict:
    """Each design's CUDA-event time of each of a route's closest-triangle
    launches (calls, as k3_calls records them), the launches queued behind
    a sleep on the card so that no host time falls between their events:
    per launch its rays and the median of 3 times, and each design's sum
    of those medians."""
    launchers = {k: [make(*c[3:]) for c in calls]
                 for k, make in designs.items()}
    times = {k: [[] for _ in calls] for k in launchers}
    for _ in range(3):
        for k, fns in launchers.items():
            events = []
            torch.cuda._sleep(100_000_000)
            for fn in fns:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(events):
                times[k][i].append(a.elapsed_time(b))
    per_launch = {k: [sorted(v)[1] for v in t] for k, t in times.items()}
    return {"launches": len(calls),
            "rays": sum(c[4].shape[0] for c in calls),
            "ms": {k: sum(v) for k, v in per_launch.items()},
            "per_launch_rays": [c[4].shape[0] for c in calls],
            "per_launch_ms": per_launch}


def split_only(*splits, time_new: bool = True) -> None:
    """The device line, the build and the splits alone (K1's, K2's walk,
    K4's, K5's and K7's, K6's and K3's, or those named: "k1", "k2", "k4",
    "k5", "k6", "k3"), with time_new False timing only the earlier designs:
    python3 -c 'import chip_smoke; chip_smoke.split_only("k6", "k3")'."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"library": lib.name, "seconds": secs,
                             "ptxas": ptxas}
                      for name, (lib, secs, ptxas) in built.items()}})
    dev = torch.device("cuda")
    for name in splits or ("k1", "k2", "k4", "k5", "k6", "k3"):
        {"k1": lambda: k1_split(dev, built, time_new),
         "k2": lambda: k2_split(dev, built, time_new),
         "k4": lambda: k4_split(dev),
         "k5": lambda: k5_split(dev, built, time_new),
         "k6": lambda: k6_split(dev, built, time_new),
         "k3": lambda: k3_split(dev, built, time_new)}[name]()


def mesh_phases(dev, built) -> tuple:
    """Phases 8 to 10b (see the module docstring): the kernels-line
    entries of the mesh megakernel and the closest-triangle kernel."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.scene import materials as mat
    from opencl_ray_tracer_tpu_torch.tracer import clusters
    from opencl_ray_tracer_tpu_torch.tracer.render import kernel_route

    def mesh_tables(scene):
        scene = scene.to(dev)
        return (mm.mesh_camera_table(scene), mk.sphere_table(scene),
                scene.spheres.count, mm.mesh_tables(scene), scene.sky.kind,
                mm.specialize_mesh_flags(scene))

    def pair(scene, cfg, seed, plain=True):
        """Kernel and (if plain) plain version on the same tables: images,
        counts, the plain version's seconds and the kernel's launch."""
        tables = mesh_tables(scene)
        args = (*tables[:4], cfg, *tables[4:])
        n_pix = cfg.width * cfg.height
        kc = torch.zeros(2, dtype=torch.int64, device=dev)

        def launch(counts=None):
            return torch.stack(mm.render_mesh(*args, seed, n_pix,
                                              counts=counts), -1)

        k = launch(kc)
        torch.cuda.synchronize()
        if not plain:
            return k, None, kc.tolist(), None, None, launch, args
        pc = torch.zeros(2, dtype=torch.int64, device=dev)
        t_plain, p = timed(lambda: torch.stack(mm.render_mesh_plain(
            *args, seed, n_pix, counts=pc), -1), reps=1)
        return k, p, kc.tolist(), pc.tolist(), t_plain, launch, args

    # ---- 8. mesh parity, small ----
    small = ot.RenderConfig(width=160, height=90, spp=8, max_depth=8)
    near = (0.3, 0.0, -1.6)
    cases = {
        "mesh": torus_scene(12, 8, near),
        "mesh_const_sky": torus_scene(12, 8, near,
                                      sky=ot.Sky.constant((0.2, 0.4, 0.6))),
        "mesh_dielectric": torus_scene(12, 8, near, mat_type=mat.DIELECTRIC,
                                       ior=1.5),
        "mesh_emissive": torus_scene(12, 8, near, mat_type=mat.EMISSIVE,
                                     albedo=(2.0, 1.5, 1.0)),
        "mesh_behind_camera": torus_scene(12, 8, (-3.0, 0.2, 4.0)),
        "mesh_40_boxes": split_boxes(torus_scene(12, 8, near)),
    }
    mesh_parity_max = 0.0
    for name, scene in cases.items():
        k, p, kc, pc, t_plain, _, _ = pair(scene, small, seed=7)
        if not torch.isfinite(k).all():
            fail(f"{name}: mesh kernel output is not finite")
        stats = compare(k, p)
        emit({"phase": "mesh_parity", "case": name, "size": "160x90x8/d8",
              **stats, "kernel_bounces": kc[0], "plain_bounces": pc[0],
              "kernel_tri_tests": kc[1], "plain_tri_tests": pc[1],
              "plain_s": t_plain})
        check_close(name, stats)
        mesh_parity_max = max(mesh_parity_max, stats["max_abs_diff"])

    k3_var = _build.load(*KERNELS["intersect_mm_k3_variants"][:1], {},
                         KERNELS["intersect_mm_k3_variants"][1])

    def k3_check(name, tab, o, d):
        """The closest-triangle kernel against its plain version and its
        earlier design on the rays (o, d): agreement (t and index bit for
        bit with both, equal triangle tests with the earlier design),
        CUDA-event and plain times, the tests run and the bound."""
        tests = torch.zeros(1, dtype=torch.int64, device=dev)
        t_k, i_k = im.closest_tri(tab, o, d, 1e-3, tests=tests)
        e_tests = torch.zeros(15, dtype=torch.int64, device=dev)
        t_e, i_e = k3_variant(k3_var, K3_VARIANTS.index("earlier_k3"), tab,
                              o, d)(e_tests)
        torch.cuda.synchronize()
        earlier_equal = (torch.equal(t_k, t_e)
                         and torch.equal(i_k, i_e.long())
                         and tests.item() == e_tests[0].item())
        k_ms = kernel_ms(lambda: im.closest_tri(tab, o, d, 1e-3))
        t_plain, (t_p, i_p) = timed(
            lambda: im.closest_tri_plain(tab, o, d, 1e-3), reps=1)
        same = i_k == i_p
        hit = t_p < 1e38
        rel = ((t_k - t_p).abs() / t_p.abs().clamp(min=1e-30))[same & hit]
        n = o.shape[0]
        out = dict(n_rays=n, hit_share=float(hit.float().mean()),
                   index_agree=float(same.float().mean()),
                   bit_equal_plain=float(((t_k == t_p) & same)
                                         .float().mean()),
                   earlier_design_equal=earlier_equal,
                   max_rel_t=float(rel.max()) if rel.numel() else 0.0,
                   max_abs_t=float((t_k - t_p)[same & hit].abs().max())
                   if rel.numel() else 0.0,
                   kernel_ms=k_ms, plain_ms=1e3 * t_plain,
                   tri_tests=tests.item(),
                   **bound_of(tests.item() * FLOPS_PER_TRI_TEST,
                              walk_table_bytes(tab) + 8 * 4 * n))
        emit({"phase": "closest_tri_parity", "case": name, **out})
        if (out["index_agree"] < 0.9999 or out["max_rel_t"] > 1e-6
                or out["bit_equal_plain"] < 1.0 or not earlier_equal):
            fail(f"{name}: closest-triangle kernel and plain version "
                 f"disagree: {out}")
        return out

    # the closest-triangle kernel on 2^20 rays into the 15,360-triangle box
    # and on 2^16 rays into the 40 boxes of a split torus
    batches = k3_random_batches(dev)
    k3_random = k3_check("torus_15360_random_2^20",
                         *batches["random_2^20"])
    if k3_random["hit_share"] < 0.1:
        fail(f"the random rays miss the mesh: {k3_random}")
    k3_boxes = k3_check("torus_2304_40_boxes_2^16",
                        *batches["40_boxes_2^16"])
    if k3_boxes["hit_share"] < 0.01:
        fail(f"the random rays miss the split mesh: {k3_boxes}")
    del batches

    # ---- 9. the mesh main path ----
    ref = ot.REFERENCE_DEFAULTS
    n_pix = ref.width * ref.height
    meshes = {"torus_576": torus_scene(), "torus_15360": torus_scene(128, 60)}
    full = {}
    for name, scene in meshes.items():
        k, _, kc, _, _, launch, args = pair(scene, ref, seed=0, plain=False)
        ms = kernel_ms(launch)
        cam, sph, n, tab = args[:4]
        flops = (kc[0] * n * FLOPS_PER_SPHERE_TEST
                 + kc[1] * FLOPS_PER_TRI_TEST)
        io_bytes = ((cam.numel() + sph.numel() + 3 * n_pix) * 4
                    + walk_table_bytes(tab, major=True))
        entry = dict(kernel_ms=ms, bounces=kc[0],
                     bounces_per_sample=kc[0] / (n_pix * ref.spp),
                     tri_tests=kc[1], tri_tests_per_bounce=kc[1] / kc[0],
                     n_triangles=scene.triangles.count, n_spheres=n,
                     **bound_of(flops, io_bytes),
                     image=k.reshape(ref.height, ref.width, 3))
        # the plain version: at full size for 576 triangles, at 320x180
        # for 15,360 (its fold over every chunk a ray enters)
        check_cfg = ref if name == "torus_576" else ref.replace(width=320,
                                                                height=180)
        size = f"{check_cfg.width}x{check_cfg.height}x5/d32"
        ck, cp, ckc, cpc, t_plain, claunch, _ = pair(scene, check_cfg, 0)
        stats = compare(ck, cp)
        check_close(f"{name} at {size}", stats)
        entry.update(check_size=size, plain_ms=1e3 * t_plain,
                     check_kernel_ms=kernel_ms(claunch),
                     check_bounces=(ckc[0], cpc[0]), **stats)
        full[name] = entry
        emit({"phase": "mesh_full_size_kernel", "case": name,
              "size": "1280x720x5/d32",
              **{k_: v for k_, v in entry.items() if k_ != "image"}})
        del ck, cp

    mm.LAUNCHES = im.LAUNCHES = mk.LAUNCHES = 0
    runs = {}
    for name, scene in meshes.items():
        ot.render(scene, ref, seed=0)  # warm-up
        runs[name] = timed(lambda: ot.render(scene, ref, seed=0))
    mesh_launches = mm.LAUNCHES
    if mesh_launches < 1 or im.LAUNCHES or mk.LAUNCHES:
        fail(f"the mesh main path did not run the mesh megakernel alone: "
             f"{mesh_launches}, {im.LAUNCHES}, {mk.LAUNCHES}")
    # the render's host time, part by part: the route (the mesh material's
    # check), the inputs on a cache hit (the scene read to the host and
    # hashed), and, on a miss, the plan and the rest of the inputs' build
    host = {}
    for name, scene in meshes.items():
        def build():
            mm._INPUTS.clear()
            im._TABLES.clear()
            clusters._PLAN_CACHE.clear()
            return mm.mesh_inputs(scene, dev)

        def plan():
            clusters._PLAN_CACHE.clear()
            return clusters.plan_for_scene(scene, im.MESH_CHUNK)

        host[name] = {
            "route_ms": 1e3 * timed(lambda: kernel_route(scene, ref))[0],
            "inputs_hit_ms": 1e3 * timed(
                lambda: mm.mesh_inputs(scene, dev))[0],
            "inputs_build_ms": 1e3 * timed(build)[0],
            "plan_build_ms": 1e3 * timed(plan)[0]}
        host[name]["render_less_kernel_ms"] = (
            1e3 * runs[name][0] - full[name]["kernel_ms"])
    for name, (secs, img) in runs.items():
        mean = float(img.mean())
        if not (img.shape == (ref.height, ref.width, 3)
                and bool(torch.isfinite(img).all()) and mean > 0.05):
            fail(f"mesh main path {name}: shape {tuple(img.shape)}, "
                 f"mean {mean}")
        if not torch.equal(img, full[name]["image"]):
            fail(f"mesh main path {name}: render() differs from the kernel")
        emit({"phase": "mesh_main_path", "case": name,
              "size": "1280x720x5/d32", "seconds": secs, "ms": 1e3 * secs,
              "camera_samples_per_s": n_pix * ref.spp / secs,
              "image_mean": mean, "launches_so_far": mesh_launches,
              "host": host[name]})

    # ---- 10. the plain tracer on the card, with the closest-triangle
    # kernel as its triangle hit; each of its launches timed by CUDA events
    # and counting its triangle tests, and each ray batch kept for the
    # kernel's check at the shapes this path gives it ----
    secs, img, k3_launches, k2_after, calls = plain_route_k3_calls(
        dev, meshes["torus_15360"], ref)
    k3_in_route_ms = sum(c[0].elapsed_time(c[1]) for c in calls)
    call_tests = [int(c[2].item()) for c in calls]
    stats = compare(img, full["torus_15360"]["image"])
    emit({"phase": "plain_route", "case": "torus_15360",
          "size": "1280x720x5/d32", "seconds": secs, "ms": 1e3 * secs,
          "closest_tri_launches": k3_launches,
          "closest_tri_ms_in_route": k3_in_route_ms,
          "closest_tri_tests_in_route": sum(call_tests),
          "rays_through_closest_tri": sum(c[4].shape[0] for c in calls),
          "mesh_kernel_launches": k2_after, "against_mesh_kernel": stats})
    if k3_launches < 1 or k2_after:
        fail(f"the plain route launched {k3_launches} closest-triangle and "
             f"{k2_after} mesh kernels")
    check_close("plain route against the mesh kernel", stats)
    # the kernel against its plain version on the batch of that path that
    # ran the most triangle tests
    busiest = calls[max(range(len(calls)), key=call_tests.__getitem__)]
    k3 = k3_check("torus_15360_plain_route_busiest_batch", *busiest[3:])
    if k3["tri_tests"] < 1:
        fail(f"the plain route's busiest batch ran no triangle test: {k3}")
    del busiest

    # ---- 10b. K3's split on the three batches, and the route's launches
    # with each design ----
    k3s = k3_split(dev, built, calls=calls)
    del calls

    r = full["torus_576"]
    f = full["torus_15360"]
    return ({
        "name": "mesh_megakernel",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megamesh.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megamesh.py:258 "
                    "_make_kernel (mesh body, gradient and constant skies; "
                    "windows: render_pallas_mesh :1028-1031, acc0 "
                    ":1112-1114)",
        "launches": mesh_launches,
        "max_abs_err": r["max_abs_diff"],
        "parity_max_abs_diff": mesh_parity_max,
        "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "torus_15360_ms": f["kernel_ms"],
        "torus_15360_bound_ms": f["bound_ms"],
        "torus_15360_plain_ms": f["plain_ms"],
        "torus_15360_plain_size": f["check_size"],
        "torus_15360_max_abs_err": f["max_abs_diff"],
        "render_ms": {k_: 1e3 * v[0] for k_, v in runs.items()},
        "render_host_ms": host,
    }, {
        "name": "closest_tri",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/intersect_mm.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/intersect_mm.py:73 "
                    "_make_kernel",
        "launches": k3_launches,
        "max_abs_err": k3["max_abs_t"],
        "index_agree": k3["index_agree"],
        "ms": k3["kernel_ms"],
        "plain_ms": k3["plain_ms"],
        "size": f"{k3['n_rays']} rays (the plain route's busiest batch), "
                "15,360 triangles",
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,
        "ms_in_plain_route": k3_in_route_ms,
        "plain_route_render_ms": 1e3 * secs,
        "random_2^20_ms": k3_random["kernel_ms"],
        "random_2^20_plain_ms": k3_random["plain_ms"],
        "random_2^20_bound_ms": k3_random["bound_ms"],
        "random_2^20_index_agree": k3_random["index_agree"],
        "40_boxes_2^16_index_agree": k3_boxes["index_agree"],
        "40_boxes_2^16_ms": k3_boxes["kernel_ms"],
        "redesign_median_ms": {c: k3s[c]["ms"]["K3"] for c in k3s},
        "earlier_design_median_ms": {c: k3s[c]["ms"]["earlier_k3"]
                                     for c in k3s},
    })


def mesh_leaf_errors(got, want, leaves=GRAD_LEAVES + TRI_LEAVES) -> dict:
    """Per scene leaf with entries: max|a - b| / max|b| (scale floor
    1e-6)."""
    import numpy as np
    from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    return {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-6)
            for k in leaves if b[k].size}


def mesh_grad_phases(dev, k2) -> dict:
    """Phases 12 to 16 (see the module docstring): the kernels-line entry
    of the mesh backward kernel.  k2: the mesh megakernel's entry, whose
    main-path times these phases report beside K5's."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.scene import materials as mat
    from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy
    from opencl_ray_tracer_tpu_torch.tracer import clusters

    def loss_fn(img):
        return torch.mean(img ** 2)

    def grad_pair(scene, cfg, seed, plain=True):
        """K5 and (if plain) its plain version on the same tables and image
        cotangent (loss mean(img^2) of the mesh megakernel's image): table
        cotangents, counts, the plain version's seconds, the scene on the
        card, the tables and K5's launch."""
        scene = scene.to(dev)
        cam, sph = mm.mesh_camera_table(scene), mk.sphere_table(scene)
        n, tab = scene.spheres.count, mm.mesh_tables(scene)
        flags = mm.specialize_mesh_flags(scene)
        n_pix = cfg.width * cfg.height
        img = torch.stack(mm.render_mesh(cam, sph, n, tab, cfg,
                                         scene.sky.kind, flags, seed,
                                         n_pix), -1)
        g = (2.0 / img.numel() / cfg.spp) * img.T.contiguous()
        args = (cam, sph, n, tab, cfg, scene.sky.kind, flags, g[0], g[1],
                g[2], seed, n_pix)

        def launch(counts=None):
            return mg.render_grad_mesh_tables(*args, counts=counts)

        kc = torch.zeros(4, dtype=torch.int64, device=dev)
        k = launch(kc)
        torch.cuda.synchronize()
        if not plain:
            return k, None, kc.tolist(), None, None, scene, tab, launch
        pc = torch.zeros(4, dtype=torch.int64, device=dev)
        t_plain, p = timed(lambda: mg.render_grad_mesh_tables_plain(
            *args, counts=pc), reps=1)
        return k, p, kc.tolist(), pc.tolist(), t_plain, scene, tab, launch

    def block_errors(k, p, tab):
        """max|a - b| / max|b| per table block, on what both versions
        write: the camera slots, the sphere rows of both (centres, albedo,
        fuzz), gtri rows 0-3, and rows 4-9 with the 1/ior row folded into
        the ior row as tri_cotangents folds it (the plain version's row 8
        holds the whole ior cotangent)."""
        def rel(a, b):
            scale = float(b.abs().max())
            return float((a - b).abs().max()) / max(scale, 1e-30)

        rows = [mk.F_CX, mk.F_CY, mk.F_CZ, mk.F_ALR, mk.F_ALG, mk.F_ALB,
                mk.F_FUZZ]
        slots = list(mg.CAM_SLOTS)
        ior = tab.feats.ior.clamp(min=1e-8)
        folded = k[2].clone()
        folded[8] = k[2][8] - k[2][9] / (ior * ior)
        folded[9] = 0.0
        out = {"gcam": rel(k[0][0, slots], p[0][0, slots]),
               "gtri_0_3": rel(folded[:4], p[2][:4]),
               "gtri_4_9": rel(folded[4:], p[2][4:])}
        if float(p[1][rows].abs().max()) > 0:
            out["gsph"] = rel(k[1][rows], p[1][rows])
        return out

    # ---- 12. mesh_grad_parity: K5 against its plain version, small ----
    t_phase = time.perf_counter()
    cfg = ot.RenderConfig(width=160, height=90, spp=4, max_depth=6,
                          nan_policy="zero")
    near = (0.3, 0.0, -1.6)
    lamb = dict(mat_type=mat.LAMBERTIAN, albedo=(0.7, 0.6, 0.5), fuzz=0.0)
    tol = {k: 5e-4 for k in GRAD_LEAVES + TRI_LEAVES}
    # focus_dist, a near-cancelling sum, at the reference scene's tolerance
    # of the sphere backward's phase 5
    tol["camera.focus_dist"] = 5e-3
    cases = {
        "torus_576_lambertian": (torus_scene(**lamb), tol),
        "metal_const_sky": (torus_scene(
            12, 8, near, sky=ot.Sky.constant((0.3, 0.5, 0.8)),
            albedo=(0.8, 0.7, 0.3), fuzz=0.2, ior=0.0, mat_type=mat.METAL),
            {k: 5e-3 for k in tol}),
        "mesh_only": (dataclasses.replace(torus_scene(**lamb),
                                          spheres=ot.Spheres.empty()), tol),
        "40_boxes": (split_boxes(torus_scene(12, 8, near)), tol),
    }
    parity_max = 0.0
    for name, (scene, case_tol) in cases.items():
        k, p, kc, pc, t_plain, scene, tab, _ = grad_pair(scene, cfg, seed=7)
        if not all(bool(torch.isfinite(x).all()) for x in k):
            fail(f"mesh grad {name}: kernel output is not finite")
        got = mg.tri_grads_to_scene(scene, tab.plan, k[2],
                                    mg.table_grads_to_scene(scene, *k[:2]))
        want = mg.tri_grads_to_scene(scene, tab.plan, p[2],
                                     mg.table_grads_to_scene(scene, *p[:2]))
        rel = mesh_leaf_errors(got, want, tuple(case_tol))
        emit({"phase": "mesh_grad_parity", "case": name,
              "size": "160x90x4/d6", "blocks": block_errors(k, p, tab),
              "rel_err": rel, "max_rel_err": max(rel.values()),
              "tolerance": case_tol,
              "kernel_replay_bounces": kc[0], "kernel_reverse_bounces": kc[1],
              "kernel_tri_tests": kc[2], "kernel_reverse_tri_bounces": kc[3],
              "plain_bounces": pc[0], "plain_s": t_plain})
        bad = {k_: v for k_, v in rel.items() if not v < case_tol[k_]}
        if bad:
            fail(f"mesh grad {name}: kernel and plain version disagree: "
                 f"{bad}")
        if not float(p[2][:4].abs().max()) > 0 and name != "metal_const_sky":
            fail(f"mesh grad {name}: no vertex cotangent")
        parity_max = max(parity_max, max(rel.values()))
    emit({"phase": "mesh_grad_parity_done",
          "seconds": time.perf_counter() - t_phase})

    # ---- 13. mesh_grad_full_size_kernel: K5 against its plain version at
    # 320x180x5/d32, both meshes ----
    t_phase = time.perf_counter()
    ref = ot.REFERENCE_DEFAULTS
    meshes = {"torus_576": torus_scene(), "torus_15360": torus_scene(128, 60)}
    check_cfg = ref.replace(width=320, height=180, nan_policy="zero")
    checks = {}
    for name, scene in meshes.items():
        k, p, kc, pc, t_plain, scene_d, tab, launch = grad_pair(
            scene, check_cfg, seed=0)
        got = mg.tri_grads_to_scene(scene_d, tab.plan, k[2],
                                    mg.table_grads_to_scene(scene_d, *k[:2]))
        want = mg.tri_grads_to_scene(scene_d, tab.plan, p[2],
                                     mg.table_grads_to_scene(scene_d, *p[:2]))
        rel = mesh_leaf_errors(got, want)
        a = torch.cat([getattr(got.triangles, f).reshape(-1)
                       for f in ("p0", "p1", "p2")]).double()
        b = torch.cat([getattr(want.triangles, f).reshape(-1)
                       for f in ("p0", "p1", "p2")]).double()
        cos = float(a @ b / (a.norm() * b.norm()))
        a_np, b_np = scene_to_numpy(got), scene_to_numpy(want)
        checks[name] = dict(rel=rel, plain_ms=1e3 * t_plain,
                            kernel_ms=kernel_ms(launch),
                            max_abs_err=max(
                                float(abs(a_np[k_] - b_np[k_]).max())
                                for k_ in rel))
        emit({"phase": "mesh_grad_full_size_kernel", "case": name,
              "size": "320x180x5/d32", "blocks": block_errors(k, p, tab),
              "rel_err": rel, "max_rel_err": max(rel.values()),
              "vertex_cosine": cos, "plain_s": t_plain,
              "kernel_ms": checks[name]["kernel_ms"],
              "kernel_counts": kc, "plain_bounces": pc[0]})
        if max(rel.values()) >= 5e-2 or cos <= 0.999:
            fail(f"mesh grad {name} at 320x180x5/d32: kernel and plain "
                 f"version disagree: {rel}, vertex cosine {cos}")
        del k, p
    emit({"phase": "mesh_grad_full_size_done",
          "seconds": time.perf_counter() - t_phase})

    # ---- 14. mesh_grad_main_path: render_grad_sampled at
    # REFERENCE_DEFAULTS, counts set to 0 just before, read just after ----
    t_phase = time.perf_counter()
    mm.LAUNCHES = mg.MESH_LAUNCHES = mg.LAUNCHES = 0
    mk.LAUNCHES = im.LAUNCHES = 0
    runs = {}
    for name, scene in meshes.items():
        ot.render_grad_sampled(scene, ref, loss_fn, seed=0)  # warm-up
        runs[name] = timed(lambda: ot.render_grad_sampled(scene, ref,
                                                          loss_fn, seed=0))
    launches = {"mesh_megakernel": mm.LAUNCHES,
                "mesh_megagrad": mg.MESH_LAUNCHES,
                "sphere_megakernel": mk.LAUNCHES,
                "sphere_megagrad": mg.LAUNCHES, "closest_tri": im.LAUNCHES}
    if (launches["mesh_megakernel"] < 1 or launches["mesh_megagrad"] < 1
            or launches["sphere_megakernel"] or launches["sphere_megagrad"]
            or launches["closest_tri"]):
        fail(f"the mesh gradient main path ran other kernels: {launches}")
    main = {}
    n_pix = ref.width * ref.height
    for name, (secs, (loss, img, grads)) in runs.items():
        finite = all(bool(torch.isfinite(getattr(grads.triangles, f)).all())
                     for f in ("p0", "p1", "p2", "albedo", "fuzz"))
        if not (finite and torch.isfinite(loss)
                and img.shape == (ref.height, ref.width, 3)
                and float(grads.triangles.p0.abs().max()) > 0):
            fail(f"mesh gradient main path {name}: loss {float(loss)}, "
                 f"finite {finite}")
        # K5 alone by CUDA events on this image's cotangent, its counts and
        # its bound
        scene = meshes[name].to(dev)
        cam, sph = mm.mesh_camera_table(scene), mk.sphere_table(scene)
        n, tab = scene.spheres.count, mm.mesh_tables(scene)
        flags = mm.specialize_mesh_flags(scene)
        g = (2.0 / img.numel() / ref.spp) * img.reshape(-1, 3).T.contiguous()
        counts = torch.zeros(4, dtype=torch.int64, device=dev)

        def launch(c=None):
            return mg.render_grad_mesh_tables(cam, sph, n, tab, ref,
                                              scene.sky.kind, flags, g[0],
                                              g[1], g[2], 0, n_pix, counts=c)

        launch(counts)
        torch.cuda.synchronize()
        k5_ms = kernel_ms(launch)
        replay, reverse, tests, reverse_tri = counts.tolist()
        flops = (replay * n * FLOPS_PER_SPHERE_TEST
                 + tests * FLOPS_PER_TRI_TEST
                 + (reverse - reverse_tri) * FLOPS_PER_REVERSE_BOUNCE
                 + reverse_tri * FLOPS_PER_TRI_REVERSE_BOUNCE)
        io_bytes = ((2 * (cam.numel() + sph.numel()) + 3 * n_pix
                     + 10 * tab.tri.shape[1]) * 4 + walk_table_bytes(tab))
        k2_ms = k2["ms"] if name == "torus_576" else k2["torus_15360_ms"]
        main[name] = dict(fwd_bwd_ms=1e3 * secs, k5_ms=k5_ms, k2_ms=k2_ms,
                          loss=float(loss), replay_bounces=replay,
                          reverse_bounces=reverse, replay_tri_tests=tests,
                          reverse_tri_bounces=reverse_tri,
                          **bound_of(flops, io_bytes))
        main[name]["share_of_bound"] = main[name]["bound_ms"] / k5_ms
        emit({"phase": "mesh_grad_main_path", "case": name,
              "size": "1280x720x5/d32", **main[name],
              "launches_so_far": launches})
    emit({"phase": "mesh_grad_main_path_done",
          "seconds": time.perf_counter() - t_phase})

    # ---- 15. mesh_fit: 5 Adam steps on the vertices, through the mesh
    # kernels, with the plan built once per fit: the 576-triangle scene
    # towards a target from its mesh with every p0 moved (reported), and
    # tests/test_megagrad.py's vertex fit, whose loss must fall ----
    t_phase = time.perf_counter()
    true = meshes["torus_576"]
    t = true.triangles
    displaced = dataclasses.replace(true, triangles=dataclasses.replace(
        t, p0=t.p0 + FIT_SHIFT))
    jax_true = torus_scene(6, 4, near)
    jt = jax_true.triangles
    jax_init = dataclasses.replace(jax_true, triangles=dataclasses.replace(
        jt, p0=jt.p0 + 0.02))
    fits = {
        "torus_576": (ot.render(displaced, ref, seed=0), true,
                      ("triangles.p0", "triangles.p1", "triangles.p2"),
                      FIT_LR, 0),
        "jax_test_torus_48": (ot.render(jax_true, ref, seed=7), jax_init,
                              ("triangles.p0", "triangles.p1",
                               "triangles.p2"), FIT_LR, 7),
    }
    build_plan = clusters.build_mesh_plan
    fit = {}
    for name, (target, init, paths, lr, seed) in fits.items():
        built = []

        def counted_build(*args, **kwargs):
            built.append(1)
            return build_plan(*args, **kwargs)

        clusters.build_mesh_plan = counted_build
        clusters._PLAN_CACHE.clear()
        stamps = [time.perf_counter()]

        def on_step(i, loss, scene):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        mm.LAUNCHES = mg.MESH_LAUNCHES = 0
        try:
            _, losses = ot.fit_scene(target, init, ref, param_paths=paths,
                                     steps=5, learning_rate=lr, seed=seed,
                                     sample_new_noise=False,
                                     callback=on_step)
        finally:
            clusters.build_mesh_plan = build_plan
        fit[name] = dict(
            losses=losses, params=paths, learning_rate=lr,
            seconds_per_step=[b - a for a, b in zip(stamps, stamps[1:])],
            plans_built=len(built),
            launches={"mesh_megakernel": mm.LAUNCHES,
                      "mesh_megagrad": mg.MESH_LAUNCHES})
        emit({"phase": "mesh_fit", "case": name, "size": "1280x720x5/d32",
              **fit[name]})
        if (not all(x == x for x in losses) or mg.MESH_LAUNCHES != 5
                or mm.LAUNCHES != 5 or len(built) != 1):
            fail(f"mesh fit {name}: the kernels were skipped or the plan "
                 f"was built more than once: {fit[name]}")
    if not (fit["jax_test_torus_48"]["losses"][-1]
            < fit["jax_test_torus_48"]["losses"][0]):
        fail(f"mesh fit: the loss did not fall: {fit}")
    emit({"phase": "mesh_fit_done", "seconds": time.perf_counter() - t_phase})

    # ---- 16. mesh_grad_plain_route: autograd of the plain wavefront on
    # the card, K3 as its winner search ----
    t_phase = time.perf_counter()
    small = ot.RenderConfig(width=160, height=90, spp=2, max_depth=8)
    scene = meshes["torus_15360"]
    im.LAUNCHES = mg.MESH_LAUNCHES = 0
    secs, (ploss, _, pgrads) = timed(lambda: ot.render_grad_sampled(
        scene, small, loss_fn, seed=0, grad_backend="plain"), reps=1)
    k3_launches, k5_launches = im.LAUNCHES, mg.MESH_LAUNCHES
    kloss, _, kgrads = ot.render_grad_sampled(scene, small, loss_fn, seed=0)
    rel = mesh_leaf_errors(pgrads, kgrads)
    a = torch.cat([getattr(pgrads.triangles, f).reshape(-1)
                   for f in ("p0", "p1", "p2")]).double()
    b = torch.cat([getattr(kgrads.triangles, f).reshape(-1)
                   for f in ("p0", "p1", "p2")]).double()
    cos = float(a @ b / (a.norm() * b.norm()))
    emit({"phase": "mesh_grad_plain_route", "case": "torus_15360",
          "size": "160x90x2/d8", "seconds": secs,
          "closest_tri_launches": k3_launches,
          "mesh_megagrad_launches": k5_launches, "loss": float(ploss),
          "kernel_route_loss": float(kloss), "rel_err_vs_kernel": rel,
          "vertex_cosine_vs_kernel": cos,
          "phase_seconds": time.perf_counter() - t_phase})
    if (k3_launches < 1 or k5_launches or not torch.isfinite(ploss)
            or abs(float(ploss) - float(kloss)) > 1e-6 * float(kloss)
            or not all(bool(torch.isfinite(getattr(pgrads.triangles,
                                                   f)).all())
                       for f in ("p0", "p1", "p2"))):
        fail(f"mesh grad plain route: K3 launches {k3_launches}, K5 "
             f"launches {k5_launches}, loss {float(ploss)} against "
             f"{float(kloss)}")

    c, m = checks["torus_576"], main["torus_576"]
    c2, m2 = checks["torus_15360"], main["torus_15360"]
    return {
        "name": "mesh_megagrad",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megagrad.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megagrad.py:187 "
                    "_make_grad_kernel (mesh variant; pallas_call at :2004, "
                    ":2044 in _grad_tables_mesh_inner)",
        "launches": launches["mesh_megagrad"],
        "max_abs_err": c["max_abs_err"],
        "max_rel_err": max(c["rel"].values()),
        "parity_max_rel_err": parity_max,
        "ms": m["k5_ms"],
        "plain_ms": c["plain_ms"],
        "plain_size": "320x180x5/d32 (kernel there: %.3f ms)"
                      % c["kernel_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": None,
        "fwd_bwd_ms": m["fwd_bwd_ms"],
        "torus_15360_ms": m2["k5_ms"],
        "torus_15360_bound_ms": m2["bound_ms"],
        "torus_15360_plain_ms": c2["plain_ms"],
        "torus_15360_fwd_bwd_ms": m2["fwd_bwd_ms"],
        "fit_seconds_per_step": fit["torus_576"]["seconds_per_step"],
        "closest_tri_launches_in_plain_grad_route": k3_launches,
    }


def flagship_scenes() -> dict:
    """The reference executable's default scene (``flagship_scene``) with
    the bundled 576-triangle torus and with the 15,360-triangle procedural
    torus (the F1 car's count) passed as its obj_path."""
    import os
    import tempfile
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "torus_15360.obj")
        with open(path, "w") as f:
            f.write(make_torus_obj(128, 60))
        big = ot.flagship_scene(16 / 9, obj_path=path)
    return {"torus_576": ot.flagship_scene(16 / 9), "torus_15360": big}


def hdr_phases(dev) -> list:
    """Phases 17 to 21 (see the module docstring): the kernels-line
    entries of K2's HDR body, K6 and K7."""
    import numpy as np
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy
    from opencl_ray_tracer_tpu_torch.scene.sky import texel_index

    def loss_fn(img):
        return torch.mean(img ** 2)

    def zero_counts():
        mm.LAUNCHES = mk.LAUNCHES = im.LAUNCHES = 0
        mg.LAUNCHES = mg.MESH_LAUNCHES = 0
        mg.EMIT_LAUNCHES = mg.CONSUME_LAUNCHES = 0

    def counts():
        return {"mesh_megakernel": mm.LAUNCHES, "hdr_emit": mg.EMIT_LAUNCHES,
                "hdr_consume": mg.CONSUME_LAUNCHES,
                "sphere_megakernel": mk.LAUNCHES,
                "sphere_megagrad": mg.LAUNCHES,
                "mesh_megagrad": mg.MESH_LAUNCHES, "closest_tri": im.LAUNCHES}

    def table_bytes(cam, sph, tab, major=False):
        return (cam.numel() + sph.numel()) * 4 + walk_table_bytes(tab, major)

    # ---- 17. hdr_lookup: the kernels' texel against the plain version's
    # on 2^20 directions ----
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    d = torch.randn((2**20, 3), generator=gen, device=dev)
    y, x = texel_index(torch.zeros((512, 1024, 3), device=dev), d)
    k_texel = mm.hdr_texels(d, 1024, 512)
    texel_agree = float((k_texel == y * 1024 + x).float().mean())
    emit({"phase": "hdr_lookup", "directions": d.shape[0],
          "image": "1024x512", "texels_equal": texel_agree})
    if texel_agree != 1.0:
        fail(f"hdr_lookup: the kernels' texels differ from the plain "
             f"version's on {1 - texel_agree:.2e} of the directions")
    del d, y, x, k_texel

    # ---- 18. hdr_parity: K2's HDR body against render_mesh_plain ----
    flagship = flagship_scenes()
    readme_hdr = dataclasses.replace(ot.readme_scene(16 / 9),
                                     sky=flagship["torus_576"].sky)
    small = ot.RenderConfig(width=160, height=90, spp=8, max_depth=8)
    k2_parity = {}
    for name, scene in (("readme_hdr_0_triangles", readme_hdr),
                        *flagship.items()):
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
        args = (cam, sph, n, tab, small, scene.sky.kind, flags, 7,
                small.width * small.height)
        k = torch.stack(mm.render_mesh(*args, sky_image=image), -1)
        torch.cuda.synchronize()
        k_ms = kernel_ms(lambda: mm.render_mesh(*args, sky_image=image))
        t_plain, p = timed(lambda: torch.stack(mm.render_mesh_plain(
            *args, sky_image=image), -1), reps=1)
        stats = compare(k, p)
        k2_parity[name] = dict(stats, kernel_ms=k_ms, plain_ms=1e3 * t_plain)
        emit({"phase": "hdr_parity", "case": name, "size": "160x90x8/d8",
              **k2_parity[name]})
        if not torch.isfinite(k).all():
            fail(f"hdr_parity {name}: kernel output is not finite")
        check_close(f"hdr_parity {name}", stats)
    # at the main path's size and seed, on the 576-triangle scene (the
    # plain version's fold over 15,360 triangles would take minutes there)
    ref = ot.REFERENCE_DEFAULTS
    scene = flagship["torus_576"]
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
    args = (cam, sph, n, tab, ref, scene.sky.kind, flags, 0,
            ref.width * ref.height)
    k = torch.stack(mm.render_mesh(*args, sky_image=image), -1)
    t_plain, p = timed(lambda: torch.stack(mm.render_mesh_plain(
        *args, sky_image=image), -1), reps=1)
    stats = compare(k, p)
    k2_full = dict(stats, plain_ms=1e3 * t_plain)
    emit({"phase": "hdr_parity", "case": "torus_576",
          "size": "1280x720x5/d32", **k2_full})
    if not torch.isfinite(k).all():
        fail("hdr_parity torus_576 at 1280x720x5/d32: kernel output is not "
             "finite")
    check_close("hdr_parity torus_576 at 1280x720x5/d32", stats)
    del k, p

    # ---- 19. hdr_grad_parity: K6 against hdr_emit_plain, and the fused
    # route through K6 and K7 against the same route through their plain
    # versions, per leaf ----
    gcfg = ot.RenderConfig(width=160, height=90, spp=4, max_depth=6,
                           nan_policy="zero")

    def fused(scene, cfg, emit_fn, consume_fn, seed=7):
        """The fused route's leaves (HdrRenderFn's steps) with the given
        passes: the gradient Scene, the image, the emit pass's outputs and
        the consume pass's inputs (the cotangent planes, the sky
        values)."""
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
        n_pix = cfg.width * cfg.height
        emit_, emis = emit_fn(cam, sph, n, tab, cfg, flags, seed, n_pix)
        sky, flat = mg.hdr_lookup(image, emit_)
        img = mg.hdr_image(emit_, emis, sky, cfg).T.reshape(
            cfg.height, cfg.width, 3)
        img_ = img.detach().requires_grad_()
        (g_img,) = torch.autograd.grad(loss_fn(img_), img_)
        planes = mg._planes(g_img, cfg.spp)
        g_sky = mg.hdr_sky_cot(image, emit_, sky, flat, *planes)
        gcam, gsph, gtri = consume_fn(cam, sph, n, tab, cfg, flags, *planes,
                                      sky, seed, n_pix)
        s = scene.to(dev)
        grads = mg.table_grads_to_scene(s, gcam, gsph)
        if tab.plan is not None:
            grads = mg.tri_grads_to_scene(s, tab.plan, gtri, grads)
        grads = dataclasses.replace(grads, sky=dataclasses.replace(
            grads.sky, image=g_sky))
        return grads, img, (emit_, emis), (planes, sky)

    grad_tol = {"spheres.albedo": 5e-3, "triangles.p0": 5e-4,
                "triangles.p1": 5e-4, "triangles.p2": 5e-4,
                "triangles.albedo": 5e-3, "sky.image": 5e-3}

    def grad_parity(name, scene, cfg, size):
        """K6 against its plain version, and the fused route through K6
        and K7 against the same route through their plain versions, per
        leaf, under the tolerances above; fails on a disagreement."""
        kg, kimg, (kemit, kemis), _ = fused(scene, cfg, mg.hdr_emit,
                                            mg.hdr_consume)
        torch.cuda.synchronize()
        t_plain, (pg, pimg, (pemit, pemis), _) = timed(
            lambda: fused(scene, cfg, mg.hdr_emit_plain,
                          mg.hdr_consume_plain), reps=1)
        dev_ = (kemit - pemit).abs().amax(0)
        samples_equal = float((dev_ <= 1e-6).float().mean())
        emis_err = float((kemis - pemis).abs().max())
        a, b = scene_to_numpy(kg), scene_to_numpy(pg)
        rel = {k: float(np.abs(a[k] - b[k]).max())
               / max(float(np.abs(b[k]).max()), 1e-9)
               for k in grad_tol if b[k].size and np.abs(b[k]).max() > 0}
        sky_within = float((np.abs(a["sky.image"] - b["sky.image"])
                            <= 1e-6).mean())
        out = dict(
            samples_equal=samples_equal, emis_max_abs_err=emis_err,
            rel_err=rel, sky_texels_within_1e6=sky_within,
            image=compare(kimg, pimg), fused_plain_ms=1e3 * t_plain,
            max_abs_err=max(float(np.abs(a[k] - b[k]).max())
                            for k in grad_tol if b[k].size))
        emit({"phase": "hdr_grad_parity", "case": name, "size": size,
              **out, "tolerance": grad_tol})
        bad = {k: v for k, v in rel.items() if not v < grad_tol[k]}
        if (samples_equal < 0.9999 or emis_err > 1e-6 or bad
                or sky_within <= 0.999
                or not float(np.abs(b["sky.image"]).max()) > 0):
            fail(f"hdr_grad_parity {name} at {size}: kernels and plain "
                 f"versions disagree: {out}")
        return out

    for name, scene in (("readme_hdr_0_triangles", readme_hdr),
                        *flagship.items()):
        grad_parity(name, scene, gcfg, "160x90x4/d6")
    # the main path's depth and samples on a quarter of its width and height
    deep = ot.REFERENCE_DEFAULTS.replace(width=320, height=180,
                                         nan_policy="zero")
    k67_deep = {name: grad_parity(name, scene, deep, "320x180x5/d32")
                for name, scene in flagship.items()}
    # each pass and its plain version alone, on the same inputs
    cam, sph, n, tab, flags, image = mm.mesh_inputs(flagship["torus_576"],
                                                    dev)
    args = (cam, sph, n, tab, deep, flags)
    n_pix = deep.width * deep.height
    _, _, _, (planes, sky) = fused(flagship["torus_576"], deep, mg.hdr_emit,
                                   mg.hdr_consume)
    passes = dict(
        k6_ms=kernel_ms(lambda: mg.hdr_emit(*args, 7, n_pix)),
        k6_plain_ms=1e3 * timed(lambda: mg.hdr_emit_plain(
            *args, 7, n_pix), reps=1)[0],
        k7_ms=kernel_ms(lambda: mg.hdr_consume(
            *args, *planes, sky, 7, n_pix)),
        k7_plain_ms=1e3 * timed(lambda: mg.hdr_consume_plain(
            *args, *planes, sky, 7, n_pix), reps=1)[0])
    emit({"phase": "hdr_pass_times", "case": "torus_576",
          "size": "320x180x5/d32", **passes})
    del planes, sky

    # ---- 20. hdr_main_path: render() and render_grad_sampled() of both
    # flagship scenes at REFERENCE_DEFAULTS, counts set to 0 just before
    # and read just after; each kernel alone by CUDA events; a sky fit ----
    ref = ot.REFERENCE_DEFAULTS
    n_pix = ref.width * ref.height
    zero_counts()
    renders = {}
    for name, scene in flagship.items():
        ot.render(scene, ref, seed=0)  # warm-up
        renders[name] = timed(lambda: ot.render(scene, ref, seed=0))
    fwd_launches = counts()
    if fwd_launches["mesh_megakernel"] < 1 or any(
            v for k, v in fwd_launches.items() if k != "mesh_megakernel"):
        fail(f"the HDR forward main path ran other kernels: {fwd_launches}")
    zero_counts()
    grads_runs = {}
    for name, scene in flagship.items():
        ot.render_grad_sampled(scene, ref, loss_fn, seed=0)  # warm-up
        grads_runs[name] = timed(lambda: ot.render_grad_sampled(
            scene, ref, loss_fn, seed=0))
    bwd_launches = counts()
    if (bwd_launches["hdr_emit"] < 1 or bwd_launches["hdr_consume"] < 1
            or any(v for k, v in bwd_launches.items()
                   if k not in ("hdr_emit", "hdr_consume"))):
        fail(f"the HDR gradient main path ran other kernels: {bwd_launches}")
    main = {}
    for name, scene in flagship.items():
        secs, img = renders[name]
        gsecs, (loss, gimg, grads) = grads_runs[name]
        mean = float(img.mean())
        flips = compare(gimg, img)
        if not (img.shape == (ref.height, ref.width, 3)
                and bool(torch.isfinite(img).all()) and mean > 0.05
                and torch.isfinite(loss)
                and float(grads.sky.image.abs().max()) > 0
                and bool(torch.isfinite(grads.sky.image).all())):
            fail(f"HDR main path {name}: mean {mean}, loss {float(loss)}")
        check_close(f"HDR fused image {name} against render()", flips)
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
        c2 = torch.zeros(2, dtype=torch.int64, device=dev)
        k2_img = torch.stack(mm.render_mesh(
            cam, sph, n, tab, ref, scene.sky.kind, flags, 0, n_pix,
            counts=c2, sky_image=image), -1).reshape(img.shape)
        if not torch.equal(k2_img, img):
            fail(f"HDR main path {name}: render() differs from K2")
        k2_ms = kernel_ms(lambda: mm.render_mesh(
            cam, sph, n, tab, ref, scene.sky.kind, flags, 0, n_pix,
            sky_image=image))
        c6 = torch.zeros(2, dtype=torch.int64, device=dev)
        emit_, emis = mg.hdr_emit(cam, sph, n, tab, ref, flags, 0, n_pix,
                                  counts=c6)
        # the non-sky sums keep one order: two launches give them equal
        emit2, emis2 = mg.hdr_emit(cam, sph, n, tab, ref, flags, 0, n_pix)
        if not (torch.equal(emis, emis2) and torch.equal(emit_, emit2)):
            fail(f"HDR main path {name}: two launches of K6 differ")
        del emit2, emis2
        k6_ms = kernel_ms(lambda: mg.hdr_emit(cam, sph, n, tab, ref, flags, 0,
                                              n_pix))
        sky, flat = mg.hdr_lookup(image, emit_)
        g = ((2.0 / gimg.numel() / ref.spp)
             * gimg.reshape(-1, 3).T).contiguous()
        c7 = torch.zeros(4, dtype=torch.int64, device=dev)
        mg.hdr_consume(cam, sph, n, tab, ref, flags, g[0], g[1], g[2], sky,
                       0, n_pix, counts=c7)
        k7_ms = kernel_ms(lambda: mg.hdr_consume(
            cam, sph, n, tab, ref, flags, g[0], g[1], g[2], sky, 0, n_pix))
        c2, c6, c7 = c2.tolist(), c6.tolist(), c7.tolist()
        tb = table_bytes(cam, sph, tab)
        k2_bound = bound_of(c2[0] * n * FLOPS_PER_SPHERE_TEST
                            + c2[1] * FLOPS_PER_TRI_TEST,
                            table_bytes(cam, sph, tab, major=True)
                            + image.numel() * 4 + 3 * n_pix * 4)
        k6_bound = bound_of(c6[0] * n * FLOPS_PER_SPHERE_TEST
                            + c6[1] * FLOPS_PER_TRI_TEST,
                            tb + (emit_.numel() + emis.numel()) * 4)
        replay, reverse, tests, reverse_tri = c7
        k7_bound = bound_of(replay * n * FLOPS_PER_SPHERE_TEST
                            + tests * FLOPS_PER_TRI_TEST
                            + (reverse - reverse_tri)
                            * FLOPS_PER_REVERSE_BOUNCE
                            + reverse_tri * FLOPS_PER_TRI_REVERSE_BOUNCE,
                            2 * tb + (3 * n_pix + sky.numel()
                                      + 10 * tab.tri.shape[1]) * 4)
        main[name] = dict(
            render_ms=1e3 * secs, k2_ms=k2_ms, k2_counts=c2,
            k2_bound=k2_bound, fwd_bwd_ms=1e3 * gsecs, k6_ms=k6_ms,
            k6_counts=c6, k6_bound=k6_bound, k7_ms=k7_ms, k7_counts=c7,
            k7_bound=k7_bound,
            fwd_bwd_host_ms=1e3 * gsecs - k6_ms - k7_ms,
            loss=float(loss), image_mean=mean,
            fused_image_against_render=flips,
            sky_grad_max=float(grads.sky.image.abs().max()))
        emit({"phase": "hdr_main_path", "case": name, "size": "1280x720x5/d32",
              **main[name], "forward_launches": fwd_launches,
              "fwd_bwd_launches": bwd_launches})
        del emit_, emis, sky, flat

    # a 5-step fit of the sky image towards a target whose sky is the true
    # one, from a perturbed sky; the loss must fall
    fits = {}
    for name, scene in flagship.items():
        target = ot.render(scene, ref, seed=3)
        init = dataclasses.replace(scene, sky=ot.Sky.hdr(
            scene.sky.image * 0.85))
        stamps = [time.perf_counter()]

        def on_step(i, loss, s):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        zero_counts()
        _, losses = ot.fit_scene(target, init, ref,
                                 param_paths=("sky.image",), steps=5,
                                 seed=3, sample_new_noise=False,
                                 callback=on_step)
        fits[name] = dict(losses=losses, launches=counts(),
                          seconds_per_step=[b - a for a, b in
                                            zip(stamps, stamps[1:])])
        emit({"phase": "hdr_fit", "case": name, "size": "1280x720x5/d32",
              **fits[name]})
        if (not losses[-1] < losses[0] or mg.EMIT_LAUNCHES != 5
                or mg.CONSUME_LAUNCHES != 5 or mm.LAUNCHES):
            fail(f"HDR sky fit {name}: {fits[name]}")

    # ---- 21. scene_from_json with assets/sky.hdr, rendered through K2 ----
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    spec = json.dumps({"meshes": [{"path": "torus.obj",
                                   "scale": [0.15, 0.15, 0.15],
                                   "translate": [0.0, -0.5, -1.0]}],
                       "sky": {"kind": "hdr", "path": "sky.hdr"}})
    jscene = ot.scene_from_json(spec, os.path.join(here, "assets"))
    mm.LAUNCHES = 0
    jimg = ot.render(jscene, small, seed=0)
    emit({"phase": "hdr_scene_json", "sky": list(jscene.sky.image.shape),
          "sky_max": float(jscene.sky.image.max()),
          "mesh_megakernel_launches": mm.LAUNCHES,
          "image_mean": float(jimg.mean()),
          "phase_seconds": time.perf_counter() - t_phase})
    if (mm.LAUNCHES != 1 or not bool(torch.isfinite(jimg).all())
            or tuple(jscene.sky.image.shape) != (128, 256, 3)):
        fail("scene_from_json with an HDR sky did not render through K2")

    m, m2 = main["torus_576"], main["torus_15360"]
    g576 = k67_deep["torus_576"]
    common = dict(route="cuda", library_ms=None)
    return [{
        "name": "mesh_megakernel_hdr",
        **common,
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megamesh.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megamesh.py:258 "
                    "_make_kernel (HDR body: hdr at :277, :293, :405, :801)",
        "launches": fwd_launches["mesh_megakernel"],
        "max_abs_err": k2_full["max_abs_diff"],
        "parity_max_abs_diff": max(v["max_abs_diff"] for v in
                                   (*k2_parity.values(), k2_full)),
        "ms": m["k2_ms"],
        "plain_ms": k2_full["plain_ms"],
        "plain_size": "1280x720x5/d32",
        "bound_ms": m["k2_bound"]["bound_ms"],
        "bound_by": m["k2_bound"]["bound_by"],
        "render_ms": {k: v["render_ms"] for k, v in main.items()},
        "torus_15360_ms": m2["k2_ms"],
        "torus_15360_bound_ms": m2["k2_bound"]["bound_ms"],
        "texels_equal_2^20": texel_agree,
    }, {
        "name": "hdr_emit",
        **common,
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megagrad.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megagrad.py:187 "
                    "_make_grad_kernel (hdr_mode=\"emit\"; pallas_call at "
                    ":2301, :2348 in _hdr_emit_window)",
        "launches": bwd_launches["hdr_emit"],
        "max_abs_err": g576["emis_max_abs_err"],
        "samples_equal": g576["samples_equal"],
        "ms": m["k6_ms"],
        "plain_ms": passes["k6_plain_ms"],
        "plain_size": "320x180x5/d32 (kernel there: %.3f ms)"
                      % passes["k6_ms"],
        "bound_ms": m["k6_bound"]["bound_ms"],
        "bound_by": m["k6_bound"]["bound_by"],
        "torus_15360_ms": m2["k6_ms"],
        "torus_15360_bound_ms": m2["k6_bound"]["bound_ms"],
    }, {
        "name": "hdr_consume",
        **common,
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megagrad.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megagrad.py:187 "
                    "_make_grad_kernel (hdr_mode=\"consume\"; pallas_call at "
                    ":2469, :2527 in _hdr_consume_window)",
        "launches": bwd_launches["hdr_consume"],
        "max_abs_err": g576["max_abs_err"],
        "max_rel_err": max(g576["rel_err"].values()),
        "ms": m["k7_ms"],
        "plain_ms": passes["k7_plain_ms"],
        "plain_size": "320x180x5/d32 (kernel there: %.3f ms)"
                      % passes["k7_ms"],
        "bound_ms": m["k7_bound"]["bound_ms"],
        "bound_by": m["k7_bound"]["bound_by"],
        "fwd_bwd_ms": {k: v["fwd_bwd_ms"] for k, v in main.items()},
        "torus_15360_ms": m2["k7_ms"],
        "torus_15360_bound_ms": m2["k7_bound"]["bound_ms"],
        "fit_seconds_per_step": fits["torus_576"]["seconds_per_step"],
    }]


def window_phases(dev, readme_img, fit) -> dict:
    """Phases 22 to 26 (see the module docstring): the kernels' sample
    windows through ``render_checkpointed``, the progressive render, a
    resumed fit and the CLI; the window-mode keys of the K1 and K2 entries
    of the kernels line, by entry name."""
    import os
    import tempfile
    import numpy as np
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import read_bmp, tonemap_u8
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.parallel import save_state

    tmp = tempfile.TemporaryDirectory()
    bench, ref = ot.README_BENCH, ot.REFERENCE_DEFAULTS
    readme = ot.readme_scene(16 / 9)
    scenes = {"readme": readme, "mesh": torus_scene(),
              "flagship": ot.flagship_scene(16 / 9)}
    kernel_of = {"readme": "sphere_megakernel", "mesh": "mesh_megakernel",
                 "flagship": "mesh_megakernel_hdr"}
    out = {k: {} for k in kernel_of.values()}

    def launches():
        return mk.LAUNCHES + mm.LAUNCHES

    def checkpointed(name, cfg, chunk, resume_at=None):
        """render_checkpointed from scratch (or interrupted at resume_at
        spp and resumed), counts set to 0 just before: (seconds, image,
        launches)."""
        path = os.path.join(tmp.name, f"{name}.npz")
        if os.path.exists(path):
            os.unlink(path)
        if resume_at is not None:
            ot.render_checkpointed(scenes[name], cfg.replace(spp=resume_at),
                                   path, seed=0, chunk_spp=chunk)
        mk.LAUNCHES = mm.LAUNCHES = 0
        secs, img = timed(lambda: ot.render_checkpointed(
            scenes[name], cfg, path, seed=0, chunk_spp=chunk), reps=1)
        return secs, img, launches()

    # ---- 22, 23. K1 and K2 windows through render_checkpointed ----
    t_phase = time.perf_counter()
    for name, cfg, chunk, resume_at in (("readme", bench, 16, 100),
                                        ("mesh", ref, 2, 2),
                                        ("flagship", ref, 2, 2)):
        runs = {}
        for policy in ("running_sum", "zero"):
            pcfg = cfg.replace(nan_policy=policy)
            if name == "readme" and policy == "running_sum":
                mono_s, mono = timed(lambda: ot.render(scenes[name], pcfg))
                if not torch.equal(mono, readme_img):
                    fail("render() of the README scene changed between "
                         "phases")
            else:
                ot.render(scenes[name], pcfg)   # warm-up
                mono_s, mono = timed(lambda: ot.render(scenes[name], pcfg))
            secs, img, n_launch = checkpointed(name, pcfg, chunk)
            windows = -(-cfg.spp // chunk)
            equal = torch.equal(img, mono)
            runs[policy] = dict(monolithic_ms=1e3 * mono_s,
                                checkpointed_ms=1e3 * secs,
                                launches=n_launch, bit_equal=equal,
                                max_abs_diff=float((img - mono).abs().max()))
            if policy == "running_sum":
                r_secs, r_img, r_launch = checkpointed(name, pcfg, chunk,
                                                       resume_at)
                runs["resumed"] = dict(
                    interrupted_at_spp=resume_at,
                    resumed_ms=1e3 * r_secs, launches=r_launch,
                    bit_equal=torch.equal(r_img, mono))
                if not runs["resumed"]["bit_equal"] or r_launch < 1:
                    fail(f"{name}: the resumed render differs from "
                         f"render(): {runs['resumed']}")
            if not equal or n_launch != windows:
                fail(f"{name} under {policy}: checkpointed render against "
                     f"render(): {runs[policy]}, {windows} windows")
        emit({"phase": "checkpoint_windows", "case": name,
              "size": f"{cfg.width}x{cfg.height}x{cfg.spp}/d{cfg.max_depth}",
              "chunk_spp": chunk, **runs})
        out[kernel_of[name]]["checkpoint"] = runs

    # the windowed kernel alone, by CUDA events, against its mean mode
    # without acc0 on the same window, in turns; then one window against
    # its plain version at 160x90 from the kernel's sums before it
    for name, cfg, chunk in (("readme", bench, 16), ("mesh", ref, 2),
                             ("flagship", ref, 2)):
        scene = scenes[name]
        if name == "readme":
            s = scene.to(dev)
            head = (mk.camera_table(s), mk.sphere_table(s), s.spheres.count)
            tail = (s.sky.kind, mk.specialize_flags(s), 0)
            fn, plain_fn, kw = mk.render_spheres, mk.render_spheres_plain, {}
        else:
            cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, dev)
            head, tail = (cam, sph, n, tab), (scene.sky.kind, flags, 0)
            fn, plain_fn = mm.render_mesh, mm.render_mesh_plain
            kw = {"sky_image": image}

        def launch(c, base=0, acc0=None, mean=True, f=fn):
            return torch.stack(f(*head, c, *tail, c.width * c.height,
                                 sample_base=base, acc0=acc0, mean=mean,
                                 **kw))

        wcfg = cfg.replace(spp=chunk)
        acc0 = launch(wcfg, mean=False)
        counts = (torch.zeros(1 if name == "readme" else 2,
                              dtype=torch.int64, device=dev))
        if name == "readme":
            fn(*head, wcfg, *tail, cfg.width * cfg.height,
               sample_base=chunk, acc0=acc0, mean=False, bounces=counts)
        else:
            fn(*head, wcfg, *tail, cfg.width * cfg.height,
               sample_base=chunk, acc0=acc0, mean=False, counts=counts,
               **kw)
        torch.cuda.synchronize()
        raw_ms = mean_ms = float("inf")
        for _ in range(3):
            raw_ms = min(raw_ms, kernel_ms(lambda: launch(
                wcfg, chunk, acc0, False), reps=1))
            mean_ms = min(mean_ms, kernel_ms(lambda: launch(wcfg, chunk),
                                             reps=1))
        n_pix = cfg.width * cfg.height
        c = counts.tolist()
        n_sph = scene.spheres.count
        flops = (c[0] * n_sph * FLOPS_PER_SPHERE_TEST
                 + (c[1] * FLOPS_PER_TRI_TEST if len(c) > 1 else 0))
        if name == "readme":
            flops = k1_flops(c[0], cfg.width * cfg.height * chunk, n_sph)
        table_bytes = sum(t.numel() * t.element_size() for t in head
                          if isinstance(t, torch.Tensor))
        if name != "readme":
            table_bytes += sum(t.numel() * t.element_size()
                               for t in tab if isinstance(t, torch.Tensor))
            if image is not None:
                table_bytes += image.numel() * 4
        bound = bound_of(flops, table_bytes + 2 * 3 * n_pix * 4)
        small = cfg.replace(width=160, height=90, spp=chunk)
        sm_acc0 = launch(small, mean=False)
        k = launch(small, chunk, sm_acc0, False)
        t_plain, p = timed(lambda: launch(small, chunk, sm_acc0, False,
                                          f=plain_fn), reps=1)
        stats = compare(k / (2 * chunk), p / (2 * chunk))
        check_close(f"{name} window at 160x90", stats)
        window = dict(window_spp=chunk, window_ms=raw_ms,
                      mean_mode_ms=mean_ms, acc0_cost_ms=raw_ms - mean_ms,
                      window_bounces=c[0], window_flops=flops,
                      window_bytes=bound["bytes"],
                      window_bound_ms=bound["bound_ms"],
                      window_bound_by=bound["bound_by"],
                      window_max_abs_err=stats["max_abs_diff"],
                      window_parity=stats, window_plain_ms=1e3 * t_plain,
                      window_parity_size=f"160x90x{chunk}/d{cfg.max_depth} "
                                         f"from sample {chunk}")
        emit({"phase": "window_kernel", "case": name,
              "size": f"{cfg.width}x{cfg.height}, samples "
                      f"[{chunk}, {2 * chunk}), d{cfg.max_depth}",
              **window})
        out[kernel_of[name]].update(window)
        del acc0, sm_acc0

    # save_state alone: the npz of one chunk at 1280x720 (11 MB)
    acc = torch.zeros((720, 1280, 3), device=dev)
    save_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        save_state(os.path.join(tmp.name, "save.npz"), acc, i, 0)
        save_ms.append(1e3 * (time.perf_counter() - t0))
    emit({"phase": "save_state", "bytes": os.path.getsize(
        os.path.join(tmp.name, "save.npz")), "ms": save_ms})
    out["sphere_megakernel"]["save_state_ms"] = min(save_ms)
    emit({"phase": "windows_seconds", "seconds":
          time.perf_counter() - t_phase})

    # ---- 24. the progressive render ----
    for name, cfg in (("readme", bench), ("flagship", ref)):
        calls = []
        mk.LAUNCHES = mm.LAUNCHES = 0
        secs, img = timed(lambda: ot.render(
            scenes[name], cfg, progress_blocks=8,
            progress=lambda d, t, im: calls.append(d)), reps=1)
        n_launch = launches()
        mono_s, mono = timed(lambda: ot.render(scenes[name], cfg))
        entry = dict(progressive_ms=1e3 * secs, monolithic_ms=1e3 * mono_s,
                     blocks=len(calls), launches=n_launch,
                     bit_equal=torch.equal(img, mono))
        emit({"phase": "progressive", "case": name, **entry})
        out[kernel_of[name]]["progressive"] = entry
        if not entry["bit_equal"] or n_launch != 8 or len(calls) != 8:
            fail(f"progressive {name}: {entry}")

    # ---- 25. a fit interrupted after 3 steps and resumed to 5 ----
    target, init, full_losses = fit
    path = os.path.join(tmp.name, "fit.pt")
    kw = dict(param_paths=("spheres.albedo",), sample_new_noise=False,
              checkpoint_path=path, checkpoint_every=1)
    mk.LAUNCHES = mg.LAUNCHES = 0
    ot.fit_scene(target, init, bench, steps=3, **kw)
    t0 = time.perf_counter()
    _, losses = ot.fit_scene(target, init, bench, steps=5, **kw)
    resume_s = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, full_losses))
    emit({"phase": "fit_resume", "size": "1280x720x250/d50",
          "losses": losses, "uninterrupted_losses": full_losses,
          "max_rel_diff": rel, "tolerance": 1e-5,
          "resumed_two_steps_s": resume_s,
          "launches": {"sphere_megakernel": mk.LAUNCHES,
                       "sphere_megagrad": mg.LAUNCHES}})
    if rel > 1e-5 or mg.LAUNCHES != 5 or len(losses) != 5:
        fail(f"fit resume: losses {losses} against {full_losses}")

    # ---- 26. the CLI on the card, checkpointed with a progress image ----
    out_bmp = os.path.join(tmp.name, "out.bmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", "render",
         "--scene", "reference", "--checkpoint",
         os.path.join(tmp.name, "cli.npz"), "--chunk-spp", "2",
         "--progress-image", os.path.join(tmp.name, "p.bmp"), "-o",
         out_bmp], capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the CLI failed: {proc.stderr[-2000:]}")
    want = tonemap_u8(ot.render(scenes["flagship"], ref))
    got = read_bmp(out_bmp)
    with np.load(os.path.join(tmp.name, "cli.npz")) as z:
        cli_spp = int(z["n_samples"])
    equal = bool(np.array_equal(got, want))
    rate = [ln for ln in proc.stdout.splitlines() if "samples/s" in ln]
    emit({"phase": "cli", "args": proc.args[3:], "seconds": cli_s,
          "bmp_equal_to_render": equal, "checkpoint_spp": cli_spp,
          "stdout_rate": rate, "progress_lines": proc.stderr.count(
              "Rendered")})
    if not equal or cli_spp != ref.spp:
        fail("the CLI's BMP differs from tonemap_u8(render())")
    out["mesh_megakernel_hdr"]["cli_seconds"] = cli_s
    tmp.cleanup()
    del scenes, readme_img
    torch.cuda.empty_cache()
    return out


def soft_triangle_scene(ot, shift_x: float = 0.0):
    """tests/test_soft.py's one-triangle scene: a Lambertian triangle
    facing the camera in a gating box, under the gradient sky."""
    tv = [[[-0.6 + shift_x, -0.5, -1.5], [0.6 + shift_x, -0.5, -1.5],
           [0.0 + shift_x, 0.6, -1.5]]]
    tris = ot.Triangles.from_vertices(tv, albedo=(0.7, 0.3, 0.2), fuzz=0.0,
                                      ior=0.0,
                                      mat_type=ot.materials.LAMBERTIAN)
    boxes = ot.BoundingBoxes.single((-2.0, -1.0, -1.6), (2.0, 1.0, -1.4))
    cam = ot.Camera.create((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), vfov_deg=70.0,
                           aspect_ratio=48.0 / 27.0, focus_dist=1.0,
                           aperture_deg=0.0)
    return ot.Scene(cam, ot.Spheres.empty(), tris, boxes, ot.Sky.gradient())


def trace_summary(path: str, span: str) -> dict:
    """A ``device_trace`` file read back: the span's host time, the
    kernels' summed device time and count, the host syncs (``aten::item``,
    each waiting for the card), and the ten ops with the largest device
    time (a kernel is charged to the op whose External id it carries, else
    to its own name)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_op: dict = {}
    for k in kernels:
        name = ops.get(k.get("args", {}).get("External id"), k["name"])
        by_op[name] = by_op.get(name, 0.0) + k["dur"]
    span_us = sum(e["dur"] for e in events if e["name"] == span
                  and e.get("cat") == "user_annotation")
    busy_us = sum(k["dur"] for k in kernels)
    items = [e for e in events if e["name"] == "aten::item"]
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    return dict(span_ms=span_us / 1e3, kernel_ms=busy_us / 1e3,
                kernels=len(kernels),
                idle_share=(1.0 - busy_us / span_us) if span_us else None,
                host_syncs=len(items),
                host_sync_ms=sum(e["dur"] for e in items) / 1e3,
                top_ops_cuda_ms=[[n, us / 1e3] for n, us in top])


def soft_phases(dev) -> dict:
    """Phases 27a to 27d (see the module docstring): the soft-visibility
    path, a chain of torch ops that reaches no kernel of its own, on the
    card; the example's stage 1 goes through K1 and K4."""
    import glob
    import os
    import tempfile
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
    from opencl_ray_tracer_tpu_torch.optimize import (_step_renderer,
                                                      insert_params)
    from opencl_ray_tracer_tpu_torch.tracer.soft import SHADE_BATCH
    from opencl_ray_tracer_tpu_torch.utils.profiling import (annotate,
                                                             device_trace)

    t_all = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    out = {}
    readme = ot.readme_scene()
    cfg = ot.RenderConfig(width=64, height=36, spp=4, max_depth=4,
                          early_stop=False)
    small = cfg.replace(width=48, height=27)

    # ---- 27a. soft forward: the card against the CPU at beta 40, and at
    # beta 50000 against render() (K1) ----
    t0 = time.perf_counter()
    soft_s, soft = timed(lambda: ot.render_soft(readme, cfg, 0, 40.0))
    cpu_s, cpu = timed(lambda: ot.render_soft(readme, cfg, 0, 40.0,
                                              device="cpu"), reps=1)
    stats = compare(soft.cpu(), cpu)
    sharp = ot.render_soft(readme, cfg, 0, 50000.0)
    mk.LAUNCHES = 0
    hard = ot.render(readme, cfg, 0)
    k1 = mk.LAUNCHES
    close = float(torch.isclose(sharp, hard, rtol=1e-5, atol=5e-2)
                  .float().mean())
    mean_gap = float((sharp.mean() - hard.mean()).abs())
    out["forward"] = dict(soft_ms=1e3 * soft_s, cpu_ms=1e3 * cpu_s,
                          card_vs_cpu=stats, beta_50000_close=close,
                          beta_50000_mean_gap=mean_gap, k1_launches=k1)
    emit({"phase": "soft_forward", "size": "64x36x4/d4", **out["forward"],
          "seconds": time.perf_counter() - t0})
    check_close("soft forward, card against CPU", stats)
    if close <= 0.93 or mean_gap >= 0.01 or k1 != 1:
        fail(f"soft forward at beta 50000 against render(): {close}, "
             f"{mean_gap}, {k1} launches")

    # ---- 27b. soft gradients: sphere 1 moved 0.1 in x, the centres'
    # gradient on the card against the CPU's and its sign; the triangle's
    # apex against central differences of the soft forward ----
    t0 = time.perf_counter()
    target = ot.render(readme, small, seed=99)
    c0 = readme.spheres.center.clone()
    c0[1, 0] += 0.1

    def center_grad(device):
        c = c0.to(device).requires_grad_()
        img = ot.render_soft(insert_params(readme, {"spheres.center": c}),
                             small, 99, 40.0, device=device)
        torch.mean((img - target.to(device)) ** 2).backward()
        return c.grad.cpu()

    grad_s, g = timed(lambda: center_grad(dev), reps=1)
    g_cpu = center_grad("cpu")
    rel = float((g - g_cpu).abs().max() / g_cpu.abs().max().clamp(min=1e-6))
    cos = float((g * g_cpu).sum() / (g.norm() * g_cpu.norm()))

    tri = soft_triangle_scene(ot)
    tri_target = ot.render(soft_triangle_scene(ot, shift_x=0.15), small,
                           seed=7)
    p_all = torch.cat([tri.triangles.p0, tri.triangles.p1,
                       tri.triangles.p2]).to(dev)

    def loss_of_p(p):
        s = insert_params(tri, {"triangles.p0": p[0:1],
                                "triangles.p1": p[1:2],
                                "triangles.p2": p[2:3]})
        img = ot.render_soft(s, small, 7, 40.0)
        return torch.mean((img - tri_target) ** 2)

    p = p_all.clone().requires_grad_()
    loss_of_p(p).backward()
    eps = 1e-3
    e = torch.zeros_like(p_all)
    e[2, 0] = 1.0
    with torch.no_grad():
        fd = float((loss_of_p(p_all + eps * e) - loss_of_p(p_all - eps * e))
                   / (2 * eps))
    ad = float(p.grad[2, 0])
    out["gradient"] = dict(
        center_grad_ms=1e3 * grad_s, center_rel=rel, center_cos=cos,
        center_g_x=float(g[1, 0]), center_g_y=float(g[1, 1]),
        apex_fd=fd, apex_ad=ad, vertex_grad_finite=bool(
            torch.isfinite(p.grad).all()))
    emit({"phase": "soft_gradient", "size": "48x27x4/d4",
          **out["gradient"], "seconds": time.perf_counter() - t0})
    if rel >= 8e-2 or cos <= 0.9999:
        fail(f"soft centre gradient, card against CPU: {rel}, cos {cos}")
    if not (g[1, 0] > 0 and g[1, 0].abs() > g[1, 1].abs()):
        fail(f"soft centre gradient has the wrong sign: {g[1]}")
    if not (abs(fd - ad) < 2e-3 + 0.05 * abs(fd) and ad < 0.0
            and out["gradient"]["vertex_grad_finite"]):
        fail(f"soft vertex gradient against differences: fd {fd}, ad {ad}")

    # ---- 27c. examples/inverse_rendering_torch.py at its size (64x36x4/d4,
    # 60 steps a stage): stage 1 through K1 and K4, stage 2 soft; counts
    # set to 0 just before and read just after ----
    t0 = time.perf_counter()
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "examples"))
    import inverse_rendering_torch as example
    mk.LAUNCHES = mg.LAUNCHES = 0
    run = example.main(["--out", os.path.join(tmp.name, "demo")])
    launches = {"sphere_megakernel": mk.LAUNCHES,
                "sphere_megagrad": mg.LAUNCHES}
    steps = len(run["stage2_losses"])
    x_err = abs(float(run["fitted"].spheres.center[1, 0])
                - float(run["true"].spheres.center[1, 0]))
    drift = (run["fitted"].spheres.center.cpu()
             - run["init"].spheres.center.cpu()).abs()
    drift[1] = 0.0
    # stage 1 takes sphere 1's albedo at least halfway to the true one
    # (stage 2 fits the centres alone)
    albedo = [run[k].spheres.albedo[1].cpu() for k in ("init", "fitted",
                                                        "true")]
    albedo_err = float((albedo[1] - albedo[2]).norm())
    albedo_err0 = float((albedo[0] - albedo[2]).norm())
    out["example"] = dict(
        steps=steps, x_err=x_err, x_err_limit=0.4 * 0.15,
        masked_drift=float(drift.max()), albedo_fitted=albedo[1].tolist(),
        albedo_err=albedo_err, albedo_err_limit=0.5 * albedo_err0,
        stage1_s_per_step=run["stage1_seconds_per_step"],
        stage2_s_per_step=run["stage2_seconds_per_step"],
        stage1_losses=run["stage1_losses"][::10] + run["stage1_losses"][-1:],
        stage2_losses=run["stage2_losses"][::10] + run["stage2_losses"][-1:],
        launches=launches)
    emit({"phase": "soft_example", "size": "64x36x4/d4", **out["example"],
          "seconds": time.perf_counter() - t0})
    # stage 1: K1 and K4 once a step; the three images: K1
    if launches != {"sphere_megakernel": steps + 3,
                    "sphere_megagrad": steps}:
        fail(f"the example's stage 1 skipped the kernels: {launches}")
    if not (albedo_err < 0.5 * albedo_err0
            and run["stage1_losses"][-1] < run["stage1_losses"][0]):
        fail(f"the example's albedo fit: {albedo[1].tolist()} against "
             f"{albedo[2].tolist()}, losses {run['stage1_losses'][0]} -> "
             f"{run['stage1_losses'][-1]}")
    if x_err >= 0.4 * 0.15 or drift.max() != 0.0:
        fail(f"the example's soft fit: x off by {x_err}, masked spheres "
             f"moved by {float(drift.max())}")

    # ---- 27d. one soft fit step under device_trace ----
    t0 = time.perf_counter()
    trace_dir = os.path.join(tmp.name, "trace")
    mask = torch.zeros((5, 3))
    mask[1] = 1.0
    init = insert_params(readme, {"spheres.center": c0})
    target = ot.render(readme, cfg, seed=123)
    with device_trace(trace_dir):
        with annotate("soft_fit_step"):
            ot.fit_scene(target, init, cfg, param_paths=("spheres.center",),
                         steps=1, learning_rate=4e-3, seed=11, soft=True,
                         beta=40.0, param_mask={"spheres.center": mask})
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        fail(f"device_trace wrote {files}")
    summary = trace_summary(files[0], "soft_fit_step")
    out["trace"] = summary
    emit({"phase": "soft_trace", "size": "64x36x4/d4",
          "trace_bytes": os.path.getsize(files[0]), **summary,
          "seconds": time.perf_counter() - t0})
    if not summary["kernels"]:
        fail("the soft step's trace holds no kernel")

    # the example's first stage-1 step (its init, target and step seed 8)
    # through fit_scene's kernel route (K1 and K4), traced the same way, and
    # the same step on its plain route: the image under the forward
    # tolerance, the albedo's gradient under phase 6c's (target is the
    # example's: the README scene at seed 123)
    def stage1_step(backend):
        render_fn, scene = _step_renderer(run["init"], cfg,
                                          ("spheres.albedo",), False, 80.0,
                                          backend, dev)
        a = scene.spheres.albedo.detach().clone().requires_grad_()
        img = render_fn(insert_params(scene, {"spheres.albedo": a}), 8)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        return float(loss.detach()), img.detach(), a.grad

    hard_dir = os.path.join(tmp.name, "trace_hard")
    mk.LAUNCHES = mg.LAUNCHES = 0
    with device_trace(hard_dir):
        with annotate("hard_fit_step"):
            k_loss, k_img, k_grad = stage1_step("kernel")
            torch.cuda.synchronize()
    launches = {"sphere_megakernel": mk.LAUNCHES,
                "sphere_megagrad": mg.LAUNCHES}
    p_loss, p_img, p_grad = stage1_step("plain")
    stats = compare(k_img, p_img)
    rel = float((k_grad - p_grad).abs().max()
                / p_grad.abs().max().clamp(min=1e-6))
    cos = float((k_grad * p_grad).sum() / (k_grad.norm() * p_grad.norm()))
    files = glob.glob(os.path.join(hard_dir, "*.pt.trace.json"))
    out["hard_trace"] = trace_summary(files[0], "hard_fit_step")
    emit({"phase": "hard_fit_step", "size": "64x36x4/d4",
          "launches": launches, "kernel_loss": k_loss, "plain_loss": p_loss,
          "image": stats, "albedo_grad_rel": rel, "albedo_grad_cos": cos,
          **out["hard_trace"]})
    check_close("the example's stage-1 step, kernel route against plain",
                stats)
    if rel >= 8e-2 or cos <= 0.9999:
        fail(f"the example's stage-1 albedo gradient, kernel route against "
             f"plain: {rel}, cosine {cos}")
    if launches != {"sphere_megakernel": 1, "sphere_megagrad": 1}:
        fail(f"the stage-1 step skipped the kernels: {launches}")

    # peak card memory of a soft step (forward and backward) whose samples
    # fill one group of SHADE_BATCH candidate rays, and two groups
    memory = {}
    n_cand = readme.spheres.count + readme.triangles.count
    full = SHADE_BATCH // (cfg.width * cfg.height * n_cand)
    for spp in (full, 2 * full):
        mcfg = cfg.replace(spp=spp)
        mtarget = ot.render(readme, mcfg, seed=123)
        c = c0.to(dev).requires_grad_()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        img = ot.render_soft(insert_params(readme, {"spheres.center": c}),
                             mcfg, 11, 40.0)
        torch.mean((img - mtarget) ** 2).backward()
        torch.cuda.synchronize()
        memory[spp] = dict(
            rays=spp * cfg.width * cfg.height * n_cand,
            step_s=time.perf_counter() - t1,
            peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
        del img, c
    out["memory"] = memory
    emit({"phase": "soft_step_memory", "size": "64x36xN/d4",
          "shade_batch": SHADE_BATCH, "by_spp": memory})
    tmp.cleanup()
    emit({"phase": "soft_done", "seconds": time.perf_counter() - t_all})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
    from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk

    dev = torch.device("cuda")
    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # ---- 2. build ----
    t0 = time.perf_counter()
    built = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"library": lib.name, "seconds": secs,
                             "ptxas": ptxas}
                      for name, (lib, secs, ptxas) in built.items()}})

    def tables(scene):
        scene = scene.to(dev)
        return (mk.camera_table(scene), mk.sphere_table(scene),
                scene.spheres.count, scene.sky.kind,
                mk.specialize_flags(scene))

    def both(scene, cfg, seed):
        """Kernel and plain version on the same tables: images, bounce
        counts and the plain version's host seconds."""
        cam, sph, n, sky_kind, flags = tables(scene)
        n_pix = cfg.width * cfg.height
        kb = torch.zeros(1, dtype=torch.int64, device=dev)
        pb = torch.zeros(1, dtype=torch.int64, device=dev)
        k = torch.stack(mk.render_spheres(cam, sph, n, cfg, sky_kind, flags,
                                          seed, n_pix, bounces=kb), -1)
        torch.cuda.synchronize()
        t_plain, p = timed(lambda: torch.stack(mk.render_spheres_plain(
            cam, sph, n, cfg, sky_kind, flags, seed, n_pix, bounces=pb), -1),
            reps=1)
        return k, p, int(kb.item()), int(pb.item()), t_plain

    # ---- 3. parity, small ----
    small = ot.RenderConfig(width=160, height=90, spp=8, max_depth=8)
    readme = ot.readme_scene(16 / 9)
    cases = {
        "readme": (readme, small),
        "reference_spheres": (ot.reference_scene(16 / 9), small),
        "const_sky": (ot.Scene(readme.camera, readme.spheres,
                               readme.triangles, readme.boxes,
                               ot.Sky.constant((0.2, 0.4, 0.6))), small),
        "nan_zero_no_clamp": (readme, small.replace(nan_policy="zero",
                                                    clamp_samples=False)),
        "book_cover": (ot.book_cover_scene(aspect_ratio=16 / 9), small),
    }
    parity_max = 0.0
    for name, (scene, cfg) in cases.items():
        k, p, kb, pb, t_plain = both(scene, cfg, seed=7)
        if not torch.isfinite(k).all():
            fail(f"{name}: kernel output is not finite")
        stats = compare(k, p)
        emit({"phase": "parity", "case": name, "size": "160x90x8/d8",
              **stats, "kernel_bounces": kb, "plain_bounces": pb,
              "plain_s": t_plain})
        check_close(name, stats)
        parity_max = max(parity_max, stats["max_abs_diff"])

    # ---- 3b. parity and kernel time at the main path's size ----
    bench = ot.README_BENCH
    n_pix = bench.width * bench.height
    full = {}
    for name, scene in (("readme", readme),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        cam, sph, n, sky_kind, flags = tables(scene)
        bounces = torch.zeros(1, dtype=torch.int64, device=dev)
        launch = lambda b=None: mk.render_spheres(  # noqa: E731
            cam, sph, n, bench, sky_kind, flags, 0, n_pix, bounces=b)
        launch(bounces)
        torch.cuda.synchronize()
        ms = kernel_ms(launch)
        img = torch.stack(launch(), -1).reshape(bench.height, bench.width, 3)
        torch.cuda.synchronize()
        n_bounces = int(bounces.item())
        flops = k1_flops(n_bounces, n_pix * bench.spp, n)
        io_bytes = (cam.numel() + sph.numel() + 3 * n_pix) * 4
        bound_ms = 1e3 * max(flops / PEAK_FP32_FLOPS,
                             io_bytes / PEAK_HBM_BYTES)
        # the bound of the sphere tests alone, without the scatter's work
        tests_bound_ms = bound_of(n_bounces * n * FLOPS_PER_SPHERE_TEST,
                                  io_bytes)["bound_ms"]
        entry = dict(kernel_ms=ms, bounces=n_bounces,
                     tests_only_bound_ms=tests_bound_ms,
                     bounces_per_sample=n_bounces / (n_pix * bench.spp),
                     n_spheres=n, flops=flops, bytes=io_bytes,
                     bound_ms=bound_ms, image=img)
        if name == "readme":
            t_plain, p = timed(lambda: torch.stack(mk.render_spheres_plain(
                cam, sph, n, bench, sky_kind, flags, 0, n_pix),
                -1).reshape(bench.height, bench.width, 3), reps=1)
            stats = compare(img, p)
            check_close("readme at 1280x720x250/d50", stats)
            entry.update(plain_ms=1e3 * t_plain, **stats)
            emit({"phase": "fuzz_cube_root", "case": name,
                  "size": "1280x720x250/d50",
                  **cube_root_variants(launch, p)})
            del p
        full[name] = entry
        emit({"phase": "full_size_kernel", "case": name,
              "size": "1280x720x250/d50",
              **{k: v for k, v in entry.items() if k != "image"}})

    # ---- 4. the forward main path, through render() ----
    mk.LAUNCHES = mg.LAUNCHES = 0
    main_runs = {}
    for name, scene in (("readme", ot.readme_scene(16 / 9)),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        ot.render(scene, bench, seed=0)  # warm-up
        secs, img = timed(lambda: ot.render(scene, bench, seed=0))
        main_runs[name] = (secs, img)
    launches = mk.LAUNCHES

    for name, (secs, img) in main_runs.items():
        mean = float(img.mean())
        ok = (img.shape == (bench.height, bench.width, 3)
              and not bool(torch.isnan(img).any()) and mean > 0.05)
        if not ok:
            fail(f"main path {name}: shape {tuple(img.shape)}, mean {mean}")
        # render() must have gone through the same kernel: same tables,
        # same seed, bit-identical image
        if not torch.equal(img, full[name]["image"]):
            fail(f"main path {name}: render() differs from the kernel run")
        emit({"phase": "main_path", "case": name, "size": "1280x720x250/d50",
              "seconds": secs, "ms": 1e3 * secs,
              "camera_samples_per_s": n_pix * bench.spp / secs,
              "image_mean": mean, "launches_so_far": launches})
    if launches < 1:
        fail("the main path launched no sphere megakernel")

    # ---- 5. backward parity, small ----
    grad_cfg = ot.RenderConfig(width=160, height=90, spp=4, max_depth=6,
                               nan_policy="zero")
    reference = ot.reference_scene(16 / 9)
    alb = reference.spheres.albedo.clone()
    alb[5] = torch.tensor([2.5, 0.9, 2.5])     # the emissive sphere
    grad_cases = {
        "readme": (readme, 8e-2),
        "reference_spheres": (reference, 5e-3),
        "const_sky": (dataclasses.replace(
            reference, sky=ot.Sky.constant((0.6, 0.7, 0.9))), 1e-3),
        "emissive_clamp": (dataclasses.replace(
            reference, spheres=dataclasses.replace(reference.spheres,
                                                   albedo=alb)), 5e-3),
        "random_40": (random_spheres(reference, 40), 2e-2),
        "book_cover": (ot.book_cover_scene(aspect_ratio=16 / 9), 8e-2),
    }


    def grad_pair(scene, cfg, seed):
        """Backward kernel and plain version on the same tables and image
        cotangent (loss mean(img^2)): table cotangents of both, counts,
        the plain version's host seconds, the scene on the card and the
        kernel's launch."""
        scene = scene.to(dev)
        cam, sph, n, sky_kind, flags = tables(scene)
        n_pix = cfg.width * cfg.height
        img = torch.stack(mk.render_spheres(cam, sph, n, cfg, sky_kind,
                                            flags, seed, n_pix), -1)
        g = (2.0 / img.numel() / cfg.spp) * img.T.contiguous()

        def launch(counts=None):
            return mg.render_grad_tables(cam, sph, n, cfg, sky_kind, flags,
                                         g[0], g[1], g[2], seed, n_pix,
                                         counts=counts)

        kc = torch.zeros(2, dtype=torch.int64, device=dev)
        pc = torch.zeros(2, dtype=torch.int64, device=dev)
        k = launch(kc)
        torch.cuda.synchronize()
        t_plain, p = timed(lambda: mg.render_grad_tables_plain(
            cam, sph, n, cfg, sky_kind, flags, g[0], g[1], g[2], seed,
            n_pix, counts=pc), reps=1)
        return k, p, kc.tolist(), pc.tolist(), t_plain, scene, launch

    grad_parity = {}
    for name, (scene, rtol) in grad_cases.items():
        k, p, kc, pc, t_plain, scene, _ = grad_pair(scene, grad_cfg,
                                                    seed=7)
        if not (torch.isfinite(k[0]).all() and torch.isfinite(k[1]).all()):
            fail(f"grad {name}: kernel output is not finite")
        rel, absd, cos = leaf_errors(mg.table_grads_to_scene(scene, *k),
                                     mg.table_grads_to_scene(scene, *p))
        emit({"phase": "grad_parity", "case": name, "size": "160x90x4/d6",
              "rel_err": rel, "max_rel_err": max(rel.values()),
              "max_abs_err": absd, "cosine": cos, "tolerance": rtol,
              "kernel_replay_bounces": kc[0], "kernel_reverse_bounces": kc[1],
              "plain_bounces": pc[0], "plain_s": t_plain})
        fuzzy = name in ("readme", "book_cover")
        if max(rel.values()) >= rtol or (fuzzy and cos <= 0.9999):
            fail(f"grad {name}: kernel and plain version disagree: {rel}, "
                 f"cosine {cos}")
        grad_parity[name] = max(rel.values())

    # 200 spheres: beyond the forward kernel's 128, so tables only, on the
    # rows both versions read (centres, albedo, fuzz; the camera slots)
    scene = random_spheres(reference, 200).to(dev)
    cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
    n_small = grad_cfg.width * grad_cfg.height
    g = torch.full((3, n_small), 1.0 / n_small / grad_cfg.spp, device=dev)
    args = (cam, sph, 200, grad_cfg, scene.sky.kind,
            mk.specialize_flags(scene), g[0], g[1], g[2], 7, n_small)
    kcam, ksph = mg.render_grad_tables(*args)
    pcam, psph = mg.render_grad_tables_plain(*args)
    rows = [mk.F_CX, mk.F_CY, mk.F_CZ, mk.F_ALR, mk.F_ALG, mk.F_ALB,
            mk.F_FUZZ]
    slots = list(mg.CAM_SLOTS[:12])
    rel200 = {"sphere_rows": float((ksph[rows] - psph[rows]).abs().max()
                                   / psph[rows].abs().max()),
              "camera_slots": float((kcam[0, slots] - pcam[0, slots]).abs()
                                    .max() / pcam[0, slots].abs().max())}
    emit({"phase": "grad_parity", "case": "random_200_tables",
          "size": "160x90x4/d6", "rel_err": rel200, "tolerance": 2e-2})
    if max(rel200.values()) >= 2e-2:
        fail(f"grad random_200_tables: kernel and plain disagree: {rel200}")

    # ---- 6. the gradient main path, through render_grad_sampled() ----
    def loss_fn(img):
        return torch.mean(img ** 2)

    mk.LAUNCHES = mg.LAUNCHES = 0
    grad_runs = {}
    for name, scene in (("readme", ot.readme_scene(16 / 9)),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        ot.render_grad_sampled(scene, bench, loss_fn, seed=0)  # warm-up
        secs, out = timed(lambda: ot.render_grad_sampled(scene, bench,
                                                         loss_fn, seed=0))
        grad_runs[name] = (secs, out)
    grad_launches = {"sphere_megakernel": mk.LAUNCHES,
                     "sphere_megagrad": mg.LAUNCHES}
    for name, (secs, (loss, img, grads)) in grad_runs.items():
        finite = all(bool(torch.isfinite(getattr(grads.spheres, f)).all())
                     for f in ("center", "radius", "albedo", "fuzz", "ior"))
        if not (finite and torch.isfinite(loss)
                and torch.equal(img, main_runs[name][1])
                and float(grads.spheres.albedo.abs().max()) > 0):
            fail(f"gradient main path {name}: loss {float(loss)}, finite "
                 f"{finite}, image equal to render(): "
                 f"{torch.equal(img, main_runs[name][1])}")
        emit({"phase": "grad_main_path", "case": name,
              "size": "1280x720x250/d50", "seconds": secs,
              "fwd_bwd_ms": 1e3 * secs, "loss": float(loss),
              "launches_so_far": grad_launches})
    if min(grad_launches.values()) < 1:
        fail(f"the gradient main path skipped a kernel: {grad_launches}")

    # ---- 6b. the backward kernel alone at the main path's size ----
    # K4's lines of the compiler's report
    k4_ptxas = [ln for ln in built["megagrad"][2] if "sphere_megagrad" in ln]
    grad_full = {}
    for name, scene in (("readme", readme),
                        ("book_cover", ot.book_cover_scene(
                            aspect_ratio=16 / 9))):
        cam, sph, n, sky_kind, flags = tables(scene.to(dev))
        img = main_runs[name][1]
        g = (2.0 / img.numel() / bench.spp) * img.reshape(-1, 3).T.contiguous()
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
        launch = lambda c=None: mg.render_grad_tables(  # noqa: E731
            cam, sph, n, bench, sky_kind, flags, g[0], g[1], g[2], 0, n_pix,
            counts=c)
        launch(counts)
        torch.cuda.synchronize()
        ms = kernel_ms(launch)
        replay, reverse = counts.tolist()
        flops = (replay * n * FLOPS_PER_SPHERE_TEST
                 + reverse * FLOPS_PER_REVERSE_BOUNCE)
        io_bytes = (2 * (cam.numel() + sph.numel()) + 3 * n_pix) * 4
        bound_ms = 1e3 * max(flops / PEAK_FP32_FLOPS,
                             io_bytes / PEAK_HBM_BYTES)
        grad_full[name] = dict(
            kernel_ms=ms, ptxas=k4_ptxas, replay_bounces=replay,
            reverse_bounces=reverse,
            replay_bounces_per_sample=replay / (n_pix * bench.spp),
            reverse_bounces_per_sample=reverse / (n_pix * bench.spp),
            n_spheres=n, flops=flops, bytes=io_bytes, bound_ms=bound_ms,
            share_of_bound=bound_ms / ms)
        emit({"phase": "grad_full_size_kernel", "case": name,
              "size": "1280x720x250/d50", **grad_full[name]})

    # ---- 6c. plain gradient against the kernel, README, at depth 50 ----
    # 320x180 at 16 spp, and 1280x720, the main path's grid, at 2 spp (the
    # plain version at 250 spp would take hours).  Both hold more work items
    # (pixel samples) than the kernel's resident threads, so each thread
    # takes several items, of several pixels at 1280x720, reusing its
    # records and carrying its camera cotangents from one to the next
    lib = mg._library()
    grad_check = {}
    for size, cfg in (("320x180x16/d50", ot.RenderConfig(
            width=320, height=180, spp=16, max_depth=50, nan_policy="zero")),
                      ("1280x720x2/d50", bench.replace(spp=2,
                                                       nan_policy="zero"))):
        n_px = cfg.width * cfg.height
        threads = lib.sphere_megagrad_threads(n_px * cfg.spp,
                                              readme.spheres.count)
        k, p, kc, pc, t_plain, scene, launch = grad_pair(readme, cfg, seed=0)
        rel, absd, cos = leaf_errors(mg.table_grads_to_scene(scene, *k),
                                     mg.table_grads_to_scene(scene, *p))
        k_ms = kernel_ms(launch)
        # the kernel sums the camera cotangents in a fixed order
        if not torch.equal(launch()[0], k[0]):
            fail(f"grad readme at {size}: the camera cotangents differ "
                 "between two launches")
        items_per_thread = n_px * cfg.spp / threads
        grad_check[size] = dict(rel=rel, absd=absd, plain_ms=1e3 * t_plain,
                                kernel_ms=k_ms,
                                items_per_thread=items_per_thread)
        emit({"phase": "grad_plain_vs_kernel", "case": "readme",
              "size": size, "n_pix": n_px, "kernel_threads": threads,
              "work_items_per_thread": items_per_thread,
              "pixels_per_thread": n_px / threads, "rel_err": rel,
              "max_rel_err": max(rel.values()), "max_abs_err": absd,
              "cosine": cos, "plain_ms": 1e3 * t_plain, "kernel_ms": k_ms,
              "kernel_replay_bounces": kc[0], "plain_bounces": pc[0]})
        if max(rel.values()) >= 8e-2 or cos <= 0.9999:
            fail(f"grad readme at {size}: kernel and plain disagree: "
                 f"{rel}, cosine {cos}")
        del k, p
    full_check = grad_check["1280x720x2/d50"]
    if not full_check["items_per_thread"] > 1:
        fail("the full-size gradient check left the kernel's stride over "
             "work items untested")

    # ---- 6d. K4's split: the earlier design's time by part, K4 and its
    # options against it, the SIMT efficiencies ----
    split = k4_split(dev)

    # ---- 6e. K1's split: the earlier design's time by section, K1 and its
    # options against it, the SIMT efficiencies and the idle share ----
    k1s = k1_split(dev, built)

    # ---- 6f. K2's walk split: both walks' counts per bounce, their time,
    # and K2, K5, K6 and K7 with each walk ----
    k2s = k2_split(dev, built)

    # ---- 6g. K5's and K7's split: the earlier design's time by part, K5
    # and K7 against it, the SIMT efficiencies ----
    k5s = k5_split(dev, built)

    # ---- 6h. K6's split: the earlier design's time by part, K6 against
    # it, the SIMT efficiencies ----
    k6s = k6_split(dev, built)

    # ---- 7. fit: 5 Adam steps on the README scene's albedo ----
    true = ot.readme_scene(16 / 9)
    target = ot.render(true, bench, seed=0)
    init = dataclasses.replace(true, spheres=dataclasses.replace(
        true.spheres, albedo=true.spheres.albedo + 0.1))
    # the process's first Adam step pays for torch's one-time optimizer
    # set-up; take it on a throwaway parameter so that it stays out of the
    # fit's first step
    t0 = time.perf_counter()
    w = torch.zeros(3, device=dev, requires_grad=True)
    adam = torch.optim.Adam([w])
    w.sum().backward()
    adam.step()
    torch.cuda.synchronize()
    adam_first_step_s = time.perf_counter() - t0
    stamps = [time.perf_counter()]

    def on_step(i, loss, scene):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    mk.LAUNCHES = mg.LAUNCHES = 0
    _, losses = ot.fit_scene(target, init, bench,
                             param_paths=("spheres.albedo",), steps=5,
                             sample_new_noise=False, grad_backend="auto",
                             callback=on_step)
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    emit({"phase": "fit", "size": "1280x720x250/d50", "losses": losses,
          "seconds_per_step": step_s,
          "first_adam_step_of_the_process_s": adam_first_step_s,
          "launches": {"sphere_megakernel": mk.LAUNCHES,
                       "sphere_megagrad": mg.LAUNCHES}})
    if not losses[-1] < losses[0] or mg.LAUNCHES < 5:
        fail(f"fit: loss did not fall or skipped the kernels: {losses}")

    mesh_entries = mesh_phases(dev, built)
    mesh_grad_entry = mesh_grad_phases(dev, mesh_entries[0])
    hdr_entries = hdr_phases(dev)
    windows = window_phases(dev, main_runs["readme"][1],
                            (target, init, losses))
    soft_phases(dev)

    # ---- 28. kernels line, result line ----
    r = full["readme"]
    gr = grad_full["readme"]
    kernels = [{
        "name": "sphere_megakernel",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megakernel.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megakernel.py:277 "
                    "_make_kernel (mean mode, and the raw-sum window mode: "
                    "flags :283, acc0 :300, :368, epilogue :604-612)",
        "launches": launches,
        "max_abs_err": r["max_abs_diff"],
        "parity_max_abs_diff": parity_max,
        "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": ("operations" if r["flops"] / PEAK_FP32_FLOPS
                     >= r["bytes"] / PEAK_HBM_BYTES else "bytes"),
        "library_ms": None,
        "readme_ms": 1e3 * main_runs["readme"][0],
        "book_cover_ms": 1e3 * main_runs["book_cover"][0],
        "launches_in_gradient_path": grad_launches["sphere_megakernel"],
        "tests_only_bound_ms": r["tests_only_bound_ms"],
        "earlier_design_median_ms": {
            case: k1s[case]["ms"]["earlier"] for case in k1s},
        "median_ms": {case: k1s[case]["ms"]["K1"] for case in k1s},
    }, {
        "name": "sphere_megagrad",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megagrad.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megagrad.py:187 "
                    "_make_grad_kernel (sphere variant)",
        "launches": grad_launches["sphere_megagrad"],
        "max_abs_err": full_check["absd"],
        "max_rel_err": max(full_check["rel"].values()),
        "parity_max_rel_err": max(grad_parity.values()),
        "ms": gr["kernel_ms"],
        "plain_ms": full_check["plain_ms"],
        "plain_size": "1280x720x2/d50 (kernel there: %.3f ms)"
                      % full_check["kernel_ms"],
        "bound_ms": gr["bound_ms"],
        "bound_by": ("operations" if gr["flops"] / PEAK_FP32_FLOPS
                     >= gr["bytes"] / PEAK_HBM_BYTES else "bytes"),
        "library_ms": None,
        "readme_fwd_bwd_ms": 1e3 * grad_runs["readme"][0],
        "book_cover_fwd_bwd_ms": 1e3 * grad_runs["book_cover"][0],
        "book_cover_ms": grad_full["book_cover"]["kernel_ms"],
        "earlier_design_median_ms": {
            case: split[case]["ms"]["earlier"] for case in split},
        "median_ms": {case: split[case]["ms"]["K4"] for case in split},
    }, *mesh_entries, mesh_grad_entry, *hdr_entries]
    for entry in kernels:
        entry.update(windows.get(entry["name"], {}))
    # the walk's split: each kernel that walks the mesh, with the earlier
    # walk in the same call
    walk_of = {"mesh_megakernel": ("K2", ("mesh_576", "mesh_15360")),
               "mesh_megakernel_hdr": ("K2", ("hdr_576", "hdr_15360")),
               "mesh_megagrad": ("K5", ("mesh_576", "mesh_15360")),
               "hdr_emit": ("K6", ("hdr_576", "hdr_15360")),
               "hdr_consume": ("K7", ("hdr_576", "hdr_15360"))}
    for entry in kernels:
        if entry["name"] in walk_of:
            k, cases = walk_of[entry["name"]]
            entry["median_ms"] = {c: k2s[c]["ms"][k] for c in cases}
            entry["earlier_walk_median_ms"] = {
                c: k2s[c]["ms"][f"{k}_flat_walk"] for c in cases}
    # K5 and K7 beside their earlier design (a pixel per thread), phase 6g
    for entry in kernels:
        k = {"mesh_megagrad": "k5", "hdr_consume": "k7"}.get(entry["name"])
        if k is not None:
            cases = [c for c in k5s if c.startswith(
                "mesh" if k == "k5" else "hdr")]
            entry["redesign_median_ms"] = {
                c: k5s[c]["ms"][k.upper()] for c in cases}
            entry["earlier_design_median_ms"] = {
                c: k5s[c]["ms"][f"earlier_{k}"] for c in cases}
        if entry["name"] == "hdr_emit":
            entry["redesign_median_ms"] = {c: k6s[c]["ms"]["K6"]
                                           for c in k6s}
            entry["earlier_design_median_ms"] = {
                c: k6s[c]["ms"]["earlier_k6"] for c in k6s}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
