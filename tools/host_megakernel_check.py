"""The sphere megakernel's instances against each other and against the
plain version, on the CPU.

Compiles ``kernels/csrc/megakernel.cu`` with ``ORT_K1_VARIANTS`` as host
C++ with g++, with tools/host_megagrad_check.py's shims (``__device__``
and the like defined away, ``__shared__`` as ``static``, atomics as plain
adds, the warp intrinsics as a group of one lane) and the launchers cut
off.  The tables are staged whole before the first thread runs, and the
threads of each block run one after another, each to its end: a
persistent lane takes pixels from the work counter until none is left.
Every instance of the measurement build (chip_smoke.py's K1_VARIANTS: the
earlier design, its cuts, the merged draw, the kernel's options) must give
the earlier design's image bit for bit; the earlier design is held against
``render_spheres_plain`` (largest difference; host glibc ``sinf`` and
``cosf`` against ATen's).  No card and no nvcc are needed; the warp counts
are not meaningful here (the lane that sums is the lane itself).

    python tools/host_megakernel_check.py [--size 48x27x6/d8]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import host_megagrad_check as hm  # noqa: E402
import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk  # noqa: E402

SHIM = hm.SHIM.replace(
    "static Dim3 threadIdx{0}, blockIdx{0}, blockDim{1};",
    "static Dim3 threadIdx{0}, blockIdx{0}, blockDim{1}, gridDim{1};") + r'''
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
'''
# Runs instance v (chip_smoke.py's K1_VARIANTS order) over the pixels, its
# blocks' threads one after another (a persistent instance on 3 blocks, so
# that lanes take several pixels), and writes the (3, n_pix) planes.
DRIVER = r'''
#include <vector>
static std::vector<char> rd(const char* f) {
  FILE* fp = fopen(f, "rb"); fseek(fp, 0, SEEK_END); long n = ftell(fp);
  fseek(fp, 0, SEEK_SET); std::vector<char> b(n);
  if (fread(b.data(), 1, n, fp) != (size_t)n) exit(2);
  fclose(fp); return b; }
template <class F> void run(F fn, int block, int blocks) {
  gridDim.x = blocks; blockDim.x = block;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    for (int t = 0; t < block; ++t) { threadIdx.x = t; fn(); } } }
int main(int argc, char** argv) {
  if (argc != 12) return 2;
  int a = 1;
  const int v = atoi(argv[a++]), n = atoi(argv[a++]);
  const int tab_w = atoi(argv[a++]), n_pix = atoi(argv[a++]);
  const unsigned seed = (unsigned)atoi(argv[a++]);
  const int width = atoi(argv[a++]), height = atoi(argv[a++]);
  const int spp = atoi(argv[a++]), max_depth = atoi(argv[a++]);
  const float t_min = (float)atof(argv[a++]);
  const int flags = atoi(argv[a++]);
  auto cam = rd("cam.bin"), sph = rd("sph.bin");
  std::vector<float> out((size_t)3 * n_pix, -7.f);
  unsigned long long counts[kCounts] = {};
  int work = 0;
  Params p;
  if (!sphere_params(p, (const float*)cam.data(), (const float*)sph.data(),
                     tab_w, n, out.data(), out.data() + n_pix,
                     out.data() + 2 * n_pix, nullptr, counts, &work, n_pix,
                     0, seed, 0, width, height, spp, max_depth, t_min, flags))
    return 3;
  const int per = (n_pix + 127) / 128;
  auto earlier = [&](auto fn) { run(fn, 128, per); };
  switch (v) {
    case 0: earlier([&] { sphere_megakernel_earlier<kCutNone>(p); }); break;
    case 1: earlier([&] { sphere_megakernel_earlier<kSimtOld>(p); }); break;
    case 2: earlier([&] { sphere_megakernel_earlier<kTwiceSphere>(p); });
      break;
    case 3: earlier([&] { sphere_megakernel_earlier<kTwiceSky>(p); }); break;
    case 4: earlier([&] { sphere_megakernel_earlier<kTwiceLambert>(p); });
      break;
    case 5: earlier([&] { sphere_megakernel_earlier<kTwiceScatter>(p); });
      break;
    case 6: earlier([&] { sphere_megakernel_earlier<kTwiceCamera>(p); });
      break;
    case 7: earlier([&] { sphere_megakernel<false, false>(p); }); break;
    case 8: run([&] { sphere_megakernel<false, true, true>(p); }, 128, 3);
      break;
    case 9: run([&] { sphere_megakernel<false>(p); }, 128, 3); break;
    default: return 4;
  }
  FILE* fp = fopen("out.bin", "wb");
  fwrite(out.data(), 4, out.size(), fp);
  fclose(fp);
  return 0;
}
'''
# The instances the host program runs: chip_smoke.py's K1_VARIANTS, then
# the kernel as the entry point launches it.
NAMES = ("earlier", "earlier_simt", "earlier_twice_sphere",
         "earlier_twice_sky", "earlier_twice_lambert",
         "earlier_twice_scatter", "earlier_twice_camera",
         "k1_pixel_per_thread", "k1_simt", "k1")


def build(work: pathlib.Path) -> pathlib.Path:
    """The host program of megakernel.cu's measurement build in ``work``."""
    for header in hm.CSRC.glob("*.cuh"):
        (work / header.name).write_text(header.read_text())
    (work / "shim.h").write_text(SHIM)
    src = (hm.CSRC / "megakernel.cu").read_text().replace(
        "#include <cuda_runtime.h>", '#include "shim.h"')
    # cut the launchers, which the host cannot compile
    for start, end in (("// Blocks of a launch of kernel fn",
                        "}  // namespace"),
                       ("// Launches the kernel on `stream`",
                        "#ifdef ORT_K1_VARIANTS"),
                       ("struct VariantFn {", "}  // namespace"),
                       ("// Launches variant v as", "#endif")):
        a = src.index(start)
        src = src[:a] + src[src.index(end, a):]
    # stage the tables whole before the first thread runs
    src = src.replace("k = threadIdx.x; k <", "k = 0; k <").replace(
        "k += blockDim.x)", "k += 1)")
    (work / "megakernel_host.cpp").write_text(src + DRIVER)
    exe = work / "megakernel_host"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-DORT_K1_VARIANTS", "-o", str(exe),
                    str(work / "megakernel_host.cpp")], check=True)
    return exe


def check(exe, work, scene, cfg, seed=7) -> dict:
    """Every instance's image against the earlier design's (equal bit for
    bit or not), and the earlier design's largest difference from the
    plain version."""
    cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
    n, n_pix = scene.spheres.count, cfg.width * cfg.height
    flags = mk.specialize_flags(scene)
    bits = mk._flag_bits(cfg, scene.sky.kind, flags)
    cam.numpy().tofile(work / "cam.bin")
    sph.numpy().tofile(work / "sph.bin")
    imgs = {}
    for v, name in enumerate(NAMES):
        subprocess.run([str(exe), str(v), str(n), str(sph.shape[1]),
                        str(n_pix), str(seed), str(cfg.width),
                        str(cfg.height), str(cfg.spp), str(cfg.max_depth),
                        str(cfg.t_min), str(bits)], check=True, cwd=work)
        imgs[name] = np.fromfile(work / "out.bin", dtype=np.float32)
    plain = torch.stack(mk.render_spheres_plain(
        cam, sph, n, cfg, scene.sky.kind, flags, seed, n_pix)).numpy()
    base = imgs["earlier"]
    return {"bit_equal": {k: bool(np.array_equal(v, base))
                          for k, v in imgs.items() if k != "earlier"},
            "plain_max_abs": float(np.abs(base - plain.ravel()).max())}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", default="48x27x6/d8")
    args = ap.parse_args()
    dims, depth = args.size.split("/d")
    width, height, spp = map(int, dims.split("x"))
    cfg = ot.RenderConfig(width=width, height=height, spp=spp,
                          max_depth=int(depth))
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        exe = build(work)
        for name, scene in (("readme", ot.readme_scene(16 / 9)),
                            ("reference_spheres", ot.reference_scene(16 / 9)),
                            ("book_cover", ot.book_cover_scene(
                                aspect_ratio=16 / 9))):
            res = check(exe, work, scene, cfg)
            print(name, res)
            ok = ok and all(res["bit_equal"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
