"""The backward kernels' arithmetic against their plain versions, on the CPU.

Compiles ``kernels/csrc/megagrad.cu`` as host C++ with g++: ``__device__``
and the like defined away, ``__shared__`` (and K4's dynamic shared array)
as ``static``, atomics as plain adds, the warp intrinsics as a group of
one lane (sums and shuffles the lane's own value, votes and matches its
own bit), and the launchers cut off.
It then runs the kernel as one thread per block over the pixels of a small
image (K4, K5 and K7, which take work items (pixel, sample) in a flat loop
per lane: a third as many threads as items, so that each takes several),
and holds the cotangents it returns against the plain version's
(``render_grad_mesh_tables_plain`` for the mesh backward, K5;
``render_grad_tables_plain`` for the sphere backward, K4;
``hdr_consume_plain`` for the HDR consume pass, K7), per table block and
per scene leaf after the chain to the scene, as max|a - b| / max|b|; the
HDR emit pass (K6) against ``hdr_emit_plain``, as the share of samples
whose direction and throughput agree to 1e-6 and the largest difference
of the non-sky sums.  No card and no nvcc are needed: this checks the
hand-derived adjoints before a kernel's first run on the card.  The cases
are chip_smoke.py's mesh cases on a 192-triangle torus (the reference
mesh material, a Lambertian mesh, a metal mesh under a constant sky, no
spheres, a dielectric, an emitter, 40 gating boxes), two sphere scenes,
and under an HDR sky the reference mesh, the README spheres and an
emissive sphere.  With --earlier, K5 and K7 run as their earlier design
(the megagrad template's mesh instances, a pixel per thread), which must
count the same bounces and triangle tests.

    python tools/host_megagrad_check.py [--size 48x27x2/d6] [--earlier]
        [case ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch.io import parse_obj  # noqa: E402
from opencl_ray_tracer_tpu_torch.io.hdr import tone_map  # noqa: E402
from opencl_ray_tracer_tpu_torch.io.procgen import (  # noqa: E402
    make_sky_image, make_torus_obj)
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene import materials as mat  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy  # noqa: E402

CSRC = HERE.parent / "opencl_ray_tracer_tpu_torch" / "kernels" / "csrc"
# the HDR cases' sky: tests/test_megamesh.py's tone-mapped procedural sky
SKY = tone_map(make_sky_image(64, 32))
SHIM = r'''
#pragma once
#include <math.h>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
using std::isnan;
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
struct Dim3 { unsigned x; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w}; }
static Dim3 threadIdx{0}, blockIdx{0}, blockDim{1};
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float atomicAdd(float* p, float v) { float o = *p; *p += v; return o; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = *p; *p += v; return o; }
inline float __shfl_down_sync(unsigned, float, int) { return 0.f; }
inline unsigned __reduce_add_sync(unsigned, unsigned v) { return v; }
inline unsigned __activemask() { return 1u; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline bool __any_sync(unsigned, bool p) { return p; }
inline unsigned __ballot_sync(unsigned, bool p) { return p ? 1u : 0u; }
inline unsigned __match_any_sync(unsigned, int) { return 1u; }
inline float __shfl_sync(unsigned, float v, int) { return v; }
inline unsigned __float_as_uint(float x) {
  unsigned u; memcpy(&u, &x, 4); return u; }
inline float __uint_as_float(unsigned u) {
  float x; memcpy(&x, &u, 4); return x; }
'''
# The kernels of the host program (DRIVER below), by mode: K4, K5, K6,
# K7, and K5 and K7 as their earlier design.
MODES = {"k4": 0, "k5": 1, "k6": 2, "k7": 3, "k5_earlier": 4,
         "k7_earlier": 5}
# Reads the tables from the working directory, runs each thread as its own
# block of one (K4: a third as many threads as pixels, so that each takes
# several work items of several pixels; K5 and K7: a third as many as
# items; the rest a thread per pixel), and writes gcam (22), gsph
# (16 x tab_w), gtri (10 x t_pad) and the four counts; in the emit mode
# (K6) the emit rows (6 x spp x n_pix), the non-sky sums (3 x n_pix) and
# the four counts.
DRIVER = r'''
#include <algorithm>
#include <vector>
static std::vector<char> rd(const char* f) {
  FILE* fp = fopen(f, "rb"); fseek(fp, 0, SEEK_END); long n = ftell(fp);
  fseek(fp, 0, SEEK_SET); std::vector<char> b(n);
  if (fread(b.data(), 1, n, fp) != (size_t)n) exit(2);
  fclose(fp); return b; }
int main(int argc, char** argv) {
  if (argc != 17) return 2;
  int a = 1;
  // mesh: the mode (MODES)
  const int mesh = atoi(argv[a++]), ns = atoi(argv[a++]);
  const int tab_w = atoi(argv[a++]), t_pad = atoi(argv[a++]);
  const int n_chunks = atoi(argv[a++]), n_boxes = atoi(argv[a++]);
  const int n_groups = atoi(argv[a++]);
  const int mesh_type = atoi(argv[a++]), n_pix = atoi(argv[a++]);
  const unsigned seed = (unsigned)atoi(argv[a++]);
  const int n_samples = atoi(argv[a++]), width = atoi(argv[a++]);
  const int height = atoi(argv[a++]), max_depth = atoi(argv[a++]);
  const float t_min = (float)atof(argv[a++]);
  const int flags = atoi(argv[a++]);
  auto cam = rd("cam.bin"), sph = rd("sph.bin"), g = rd("g.bin");
  std::vector<char> tri, cl, sub, cb, bx, gr, ge, tm;
  if (mesh && t_pad > 0) {
    tri = rd("tri.bin"); cl = rd("cluster.bin"); sub = rd("sub.bin");
    cb = rd("chunk_box.bin"); bx = rd("boxes.bin"); gr = rd("group.bin");
    ge = rd("group_end.bin"); tm = rd("tri_major.bin"); }
  std::vector<char> sky_rows;
  if (mesh == 3 || mesh == 5) sky_rows = rd("sky_rows.bin");
  std::vector<float> emit((size_t)6 * n_samples * n_pix, -7.f);
  std::vector<float> emis((size_t)3 * n_pix, -7.f);
  const float* gp = (const float*)g.data();
  const long long items = (long long)n_pix * n_samples;
  const int threads = mesh == 0 ? (n_pix + 2) / 3
                      : (mesh == 1 || mesh == 3) ? (int)((items + 2) / 3)
                                                 : n_pix;
  const size_t rows = (size_t)std::max(threads, n_pix);
  std::vector<float> cam_part(rows * 22, 0.f), gsph(16 * tab_w, 0.f);
  std::vector<float> gtri(10 * (t_pad > 0 ? t_pad : 1), 0.f);
  std::vector<float> rec(rows * max_depth * kRecMesh);
  unsigned long long counts[4] = {0, 0, 0, 0};
  Params p{};
  p.cam = (const float*)cam.data(); p.sph = (const float*)sph.data();
  p.g_r = gp; p.g_g = gp + n_pix; p.g_b = gp + 2 * n_pix;
  p.cam_part = cam_part.data(); p.gsph = gsph.data(); p.rec = rec.data();
  p.counts = counts; p.tab_w = tab_w; p.n_spheres = ns; p.n_pix = n_pix;
  p.pix_offset = 0; p.n_threads = threads; p.seed = seed; p.sample_base = 0;
  p.n_samples = n_samples; p.width = width; p.height = height;
  p.max_depth = max_depth; p.t_min = t_min; p.flags = flags;
  if (mesh) {
    p.mt = MeshTables{(const float*)tri.data(), t_pad,
                      (const float*)cl.data(), (const float*)sub.data(),
                      (const int*)cb.data(), n_chunks,
                      (const float*)bx.data(), n_boxes,
                      (const float*)gr.data(), (const int*)ge.data(),
                      n_groups, (const float*)tm.data()};
    p.mesh_type = mesh_type; p.gtri = gtri.data();
  }
  p.emit = emit.data(); p.emis = emis.data();
  p.sky_rows = sky_rows.empty() ? nullptr : (const float*)sky_rows.data();
  for (int b = 0; b < threads; ++b) {
    blockIdx.x = b;
    if (mesh == 0) sphere_megagrad<>(p);
    else if (mesh == 1) mesh_megagrad<kSkyComputed>(p);
    else if (mesh == 2) megagrad<true, kSkyEmit>(p);
    else if (mesh == 3) mesh_megagrad<kSkyConsume>(p);
    else if (mesh == 4) megagrad<true, kSkyComputed>(p);
    else megagrad<true, kSkyConsume>(p);
  }
  if (mesh == 2) {
    FILE* fp = fopen("out.bin", "wb");
    fwrite(emit.data(), 4, emit.size(), fp);
    fwrite(emis.data(), 4, emis.size(), fp); fwrite(counts, 8, 4, fp);
    fclose(fp);
    return 0;
  }
  std::vector<float> gcam(22, 0.f);
  for (size_t b = 0; b < rows; ++b)
    for (int k = 0; k < 22; ++k) gcam[k] += cam_part[b * 22 + k];
  FILE* fp = fopen("out.bin", "wb");
  fwrite(gcam.data(), 4, 22, fp); fwrite(gsph.data(), 4, gsph.size(), fp);
  fwrite(gtri.data(), 4, gtri.size(), fp); fwrite(counts, 8, 4, fp);
  fclose(fp);
  return 0;
}
'''


def build(work: pathlib.Path) -> pathlib.Path:
    """The host program of megagrad.cu, compiled in ``work``."""
    for header in CSRC.glob("*.cuh"):
        (work / header.name).write_text(header.read_text())
    (work / "shim.h").write_text(SHIM)
    src = (CSRC / "megagrad.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "shim.h"').replace(
        "extern __shared__ float smem[];", "static float smem[1 << 16];")
    src = src[:src.index("// Threads to launch for")] + "}  // namespace\n"
    (work / "megagrad_host.cpp").write_text(src + DRIVER)
    exe = work / "megagrad_host"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-o",
                    str(exe), str(work / "megagrad_host.cpp")], check=True)
    return exe


def torus(sky=None, **material):
    tris, aabb = parse_obj(make_torus_obj(12, 8), (0.5, 0.5, 0.5),
                           (0.3, 0.0, -1.6))
    scene = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb,
                               sky=sky)
    t = scene.triangles
    fields = {k: (torch.tensor(v).expand(t.count, 3).clone() if k == "albedo"
                  else torch.full_like(getattr(t, k), v))
              for k, v in material.items()}
    return dataclasses.replace(scene,
                               triangles=dataclasses.replace(t, **fields))


def split_boxes(scene, n_boxes=40):
    """chip_smoke.py's split: triangle i in gating box i % n_boxes."""
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


def cases():
    lamb = dict(mat_type=mat.LAMBERTIAN, albedo=(0.7, 0.6, 0.5), fuzz=0.0)
    return {
        "mesh_reference_material": torus(),
        "mesh_lambertian": torus(**lamb),
        "mesh_metal_const_sky": torus(sky=ot.Sky.constant((0.3, 0.5, 0.8)),
                                      albedo=(0.8, 0.7, 0.3), fuzz=0.2,
                                      ior=0.0, mat_type=mat.METAL),
        "mesh_only": dataclasses.replace(torus(**lamb),
                                         spheres=ot.Spheres.empty()),
        "mesh_dielectric": torus(mat_type=mat.DIELECTRIC, ior=1.5),
        "mesh_emissive": torus(mat_type=mat.EMISSIVE,
                               albedo=(2.0, 1.5, 1.0)),
        "mesh_40_boxes": split_boxes(torus(**lamb)),
        "readme_spheres": ot.readme_scene(),
        "reference_spheres": ot.reference_scene(),
        "hdr_mesh": torus(sky=ot.Sky.hdr(SKY)),
        "hdr_readme_spheres": dataclasses.replace(ot.readme_scene(),
                                                  sky=ot.Sky.hdr(SKY)),
        "hdr_emissive_sphere": dataclasses.replace(ot.reference_scene(),
                                                   sky=ot.Sky.hdr(SKY)),
    }


def _write(work, arrays: dict) -> None:
    for name, arr in arrays.items():
        arr.contiguous().numpy().tofile(work / f"{name}.bin")


def _run(exe, work, mode, n, sph, dims, n_pix, seed, cfg, bits):
    subprocess.run([str(exe), str(mode), str(n), str(sph.shape[1]),
                    *map(str, dims), str(n_pix), str(seed), str(cfg.spp),
                    str(cfg.width), str(cfg.height), str(cfg.max_depth),
                    str(cfg.t_min), str(bits)], check=True, cwd=work)
    return np.fromfile(work / "out.bin", dtype=np.float32)


def check_hdr(exe, work, scene, cfg, seed=7, earlier=False):
    """K6 and K7 (with ``earlier``, K7's earlier design) as host code
    against their plain versions: (emit agreement, per-block errors,
    per-leaf errors, K7's counts)."""
    n, n_pix, spp = scene.spheres.count, cfg.width * cfg.height, cfg.spp
    cam, sph, _, tab, flags, image = mm.mesh_inputs(scene, "cpu")
    arrays = {"cam": cam, "sph": sph}
    if tab.tri.shape[1]:
        arrays.update(tri=tab.tri, cluster=tab.cluster, sub=tab.sub,
                      chunk_box=tab.chunk_box, boxes=tab.boxes,
                      group=tab.group, group_end=tab.group_end,
                      tri_major=tab.tri_major)
    dims = (tab.tri.shape[1], tab.chunk_box.shape[0], tab.boxes.shape[0],
            tab.group_end.shape[0], int(flags[5]))
    bits = mk._flag_bits(cfg, scene.sky.kind, flags[:5])
    # K6
    _write(work, {**arrays, "g": torch.zeros(3, n_pix)})
    out = _run(exe, work, 2, n, sph, dims, n_pix, seed, cfg, bits)
    m = 6 * spp * n_pix
    k_emit = torch.from_numpy(out[:m].reshape(6, spp, n_pix).copy())
    k_emis = torch.from_numpy(out[m:m + 3 * n_pix].reshape(3, n_pix).copy())
    p_emit, p_emis = mg.hdr_emit_plain(cam, sph, n, tab, cfg, flags, seed,
                                       n_pix)
    same = ((k_emit - p_emit).abs().amax(0) <= 1e-6).float().mean()
    dev = (k_emit - p_emit).abs().amax(0)
    emit = {"samples_agree": float(same),
            "within_1e-4": float((dev <= 1e-4).float().mean()),
            "max_dev": float(dev.max()),
            "emis_max_abs": float((k_emis - p_emis).abs().max())}
    # K7 on the plain emit's sky values and the image's cotangent
    sky, _ = mg.hdr_lookup(image, p_emit)
    img = mg.hdr_image(p_emit, p_emis, sky, cfg)
    g = ((2.0 / img.numel() / spp) * img).contiguous()
    _write(work, {**arrays, "g": g, "sky_rows": sky})
    out = _run(exe, work, MODES["k7_earlier" if earlier else "k7"], n, sph,
               dims, n_pix, seed, cfg, bits)
    return emit, *_compare_mesh(out, cam, sph, n, tab, scene, g, sky, cfg,
                                flags, seed, n_pix)


def _compare_mesh(out, cam, sph, n, tab, scene, g, sky, cfg, flags, seed,
                  n_pix):
    w, t_pad = sph.shape[1], max(tab.tri.shape[1], 1)
    kcam = torch.zeros_like(cam)
    kcam[0, :22] = torch.from_numpy(out[:22].copy())
    ksph = torch.from_numpy(out[22:22 + 16 * w].reshape(16, w).copy())
    ktri = torch.from_numpy(out[22 + 16 * w:22 + 16 * w + 10 * t_pad]
                            .reshape(10, t_pad).copy())
    counts = np.frombuffer(out[-8:].tobytes(), dtype=np.uint64).tolist()
    pcam, psph, ptri = mg.hdr_consume_plain(cam, sph, n, tab, cfg, flags,
                                            g[0], g[1], g[2], sky, seed,
                                            n_pix)
    blocks = {"gcam": rel(kcam, pcam)}
    rows = [mk.F_CX, mk.F_CY, mk.F_CZ, mk.F_ALR, mk.F_ALG, mk.F_ALB,
            mk.F_FUZZ]
    if n and float(psph[rows].abs().max()) > 0:
        blocks["gsph"] = rel(ksph[rows], psph[rows])
    got = mg.table_grads_to_scene(scene, kcam, ksph)
    want = mg.table_grads_to_scene(scene, pcam, psph)
    if tab.tri.shape[1]:
        ior = tab.feats.ior.clamp(min=1e-8)
        folded = ktri.clone()
        folded[8] = ktri[8] - ktri[9] / (ior * ior)
        folded[9] = 0.0
        blocks["gtri_4_9"] = rel(folded[4:], ptri[4:])
        got = mg.tri_grads_to_scene(scene, tab.plan, ktri, got)
        want = mg.tri_grads_to_scene(scene, tab.plan, ptri, want)
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    leaves = {k: float(np.abs(a[k] - b[k]).max()
                       / max(np.abs(b[k]).max(), 1e-9))
              for k in b if b[k].size and np.abs(b[k]).max() > 0}
    return blocks, leaves, counts


def rel(a, b) -> float:
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-12))


def check(exe, work, scene, cfg, seed=7, earlier=False):
    """(per-block errors, per-leaf errors, the kernel's counts) of K4 or K5
    (with ``earlier``, K5's earlier design)."""
    mesh = scene.triangles.count > 0
    n, n_pix = scene.spheres.count, cfg.width * cfg.height
    sph = mk.sphere_table(scene)
    if mesh:
        cam, tab = mm.mesh_camera_table(scene), mm.mesh_tables(scene)
        flags = mm.specialize_mesh_flags(scene)
        img = torch.stack(mm.render_mesh(cam, sph, n, tab, cfg,
                                         scene.sky.kind, flags, seed, n_pix),
                          -1)
        arrays = {"tri": tab.tri, "cluster": tab.cluster, "sub": tab.sub,
                  "chunk_box": tab.chunk_box, "boxes": tab.boxes,
                  "group": tab.group, "group_end": tab.group_end,
                  "tri_major": tab.tri_major}
        dims = (tab.tri.shape[1], tab.chunk_box.shape[0],
                tab.boxes.shape[0], tab.group_end.shape[0], int(flags[5]))
    else:
        cam, flags = mk.camera_table(scene), mk.specialize_flags(scene)
        img = torch.stack(mk.render_spheres(cam, sph, n, cfg, scene.sky.kind,
                                            flags, seed, n_pix), -1)
        arrays, dims = {}, (0, 0, 0, 0, 0)
    g = ((2.0 / img.numel() / cfg.spp) * img.T).contiguous()
    for name, arr in {"cam": cam, "sph": sph, "g": g, **arrays}.items():
        arr.contiguous().numpy().tofile(work / f"{name}.bin")
    bits = mk._flag_bits(cfg, scene.sky.kind, flags[:5])
    mode = MODES[("k5_earlier" if earlier else "k5") if mesh else "k4"]
    subprocess.run([str(exe), str(mode), str(n), str(sph.shape[1]),
                    *map(str, dims), str(n_pix), str(seed), str(cfg.spp),
                    str(cfg.width), str(cfg.height), str(cfg.max_depth),
                    str(cfg.t_min), str(bits)], check=True, cwd=work)
    out = np.fromfile(work / "out.bin", dtype=np.float32)
    w, t_pad = sph.shape[1], max(dims[0], 1)
    kcam = torch.zeros_like(cam)
    kcam[0, :22] = torch.from_numpy(out[:22].copy())
    ksph = torch.from_numpy(out[22:22 + 16 * w].reshape(16, w).copy())
    ktri = torch.from_numpy(out[22 + 16 * w:22 + 16 * w + 10 * t_pad]
                            .reshape(10, t_pad).copy())
    counts = np.frombuffer(out[-8:].tobytes(), dtype=np.uint64).tolist()
    args = (cam, sph, n) + ((tab,) if mesh else ()) + (
        cfg, scene.sky.kind, flags, g[0], g[1], g[2], seed, n_pix)
    rows = [mk.F_CX, mk.F_CY, mk.F_CZ, mk.F_ALR, mk.F_ALG, mk.F_ALB,
            mk.F_FUZZ]
    if mesh:
        pcam, psph, ptri = mg.render_grad_mesh_tables_plain(*args)
        ior = tab.feats.ior.clamp(min=1e-8)
        folded = ktri.clone()
        folded[8] = ktri[8] - ktri[9] / (ior * ior)
        folded[9] = 0.0
        blocks = {"gcam": rel(kcam, pcam), "gtri_0_3": rel(folded[:4],
                                                           ptri[:4]),
                  "gtri_4_9": rel(folded[4:], ptri[4:])}
        got = mg.tri_grads_to_scene(scene, tab.plan, ktri,
                                    mg.table_grads_to_scene(scene, kcam,
                                                            ksph))
        want = mg.tri_grads_to_scene(scene, tab.plan, ptri,
                                     mg.table_grads_to_scene(scene, pcam,
                                                             psph))
    else:
        pcam, psph = mg.render_grad_tables_plain(*args)
        blocks = {"gcam": rel(kcam, pcam)}
        got = mg.table_grads_to_scene(scene, kcam, ksph)
        want = mg.table_grads_to_scene(scene, pcam, psph)
    if n and float(psph[rows].abs().max()) > 0:
        blocks["gsph"] = rel(ksph[rows], psph[rows])
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    leaves = {k: float(np.abs(a[k] - b[k]).max()
                       / max(np.abs(b[k]).max(), 1e-9))
              for k in b if b[k].size and np.abs(b[k]).max() > 0}
    return blocks, leaves, counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", default="48x27x2/d6")
    ap.add_argument("--earlier", action="store_true",
                    help="K5 and K7 as their earlier design")
    ap.add_argument("case", nargs="*")
    args = ap.parse_args()
    dims, depth = args.size.split("/d")
    width, height, spp = map(int, dims.split("x"))
    cfg = ot.RenderConfig(width=width, height=height, spp=spp,
                          max_depth=int(depth), nan_policy="zero")
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        exe = build(work)
        for name, scene in cases().items():
            if args.case and name not in args.case:
                continue
            if scene.sky.kind == ot.scene.sky.KIND_HDR:
                emit, blocks, leaves, counts = check_hdr(
                    exe, work, scene, cfg, earlier=args.earlier)
                print(name, "emit", emit)
            else:
                blocks, leaves, counts = check(exe, work, scene, cfg,
                                               earlier=args.earlier)
            print(name, "counts", counts)
            print("  blocks", {k: f"{v:.1e}" for k, v in blocks.items()})
            print("  leaves", {k: f"{v:.1e}" for k, v in leaves.items()})


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    main()
