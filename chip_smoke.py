#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing JSON lines on standard output:

1. device: the card's name and power limit (nvidia-smi), PyTorch and CUDA.
2. build: compile every kernel of the main path from the sources in this
   checkout (nvcc, sm_90a) and report the compiler's register counts.
3. parity: each kernel against its plain PyTorch version on the same
   tables, at 160x90, 8 spp, depth 8 for the README scene, the spheres of
   the reference scene (all four materials and an aperture), a constant
   sky, the "zero" NaN policy without the clamp, and the book cover; then
   at the main path's full size.  Tolerance: at most 0.5% of pixels differ
   by more than 1e-3, more than 99% within 1e-4, means within 2e-3.
4. main path: ``render(readme_scene(16/9), RenderConfig(1280, 720,
   spp=250, max_depth=50))`` and the 100-sphere book cover at the same
   configuration, one warm-up and the minimum of 3 timed runs each, with
   the kernels' launch counts set to 0 just before and read just after.
5. the kernels line and the result line.

Any failure ends the run with a nonzero exit and no result line.  The
script needs a CUDA device and the package beside it; it starts no process
other than nvidia-smi and nvcc, both waited for.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# One ray-sphere test: the half-b quadratic (two fma-chain dot products,
# the discriminant, a sqrt, two divides and the root selection) is about
# 25 FP32 operations.
FLOPS_PER_SPHERE_TEST = 25
TOL_FLIP, TOL_BULK, TOL_MEAN = 0.005, 0.99, 2e-3


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import opencl_ray_tracer_tpu_torch as ot
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
    lib = mk.build()
    build_s = time.perf_counter() - t0
    log = lib.with_suffix(".log")
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln] if log.exists() else [])
    emit({"phase": "build", "kernel": "sphere_megakernel",
          "seconds": build_s, "library": lib.name, "ptxas": ptxas})

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
        flops = n_bounces * n * FLOPS_PER_SPHERE_TEST
        io_bytes = (cam.numel() + sph.numel() + 3 * n_pix) * 4
        bound_ms = 1e3 * max(flops / PEAK_FP32_FLOPS,
                             io_bytes / PEAK_HBM_BYTES)
        entry = dict(kernel_ms=ms, bounces=n_bounces,
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
            del p
        full[name] = entry
        emit({"phase": "full_size_kernel", "case": name,
              "size": "1280x720x250/d50",
              **{k: v for k, v in entry.items() if k != "image"}})

    # ---- 4. the main path, through render() ----
    mk.LAUNCHES = 0
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

    # ---- 5. kernels line, result line ----
    r = full["readme"]
    emit({"kernels": [{
        "name": "sphere_megakernel",
        "route": "cuda",
        "source": "opencl_ray_tracer_tpu_torch/kernels/csrc/megakernel.cu",
        "replaces": "opencl_ray_tracer_tpu/kernels/megakernel.py:277 "
                    "_make_kernel",
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
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
