"""Command-line interface.

The reference's one entry point is its executable's ``main()``
(``src/cpp/main.cpp:13``), with everything fixed in the source: a device
dump, the scene, a block-by-block render that rewrites ``output.bmp``
after every block, and the BMP.  This CLI runs the same pipeline with its
settings as flags, the JAX package's CLI (``opencl_ray_tracer_tpu.cli``)
flag for flag, on the card unless ``--cpu`` is given:

    python -m opencl_ray_tracer_tpu_torch.cli render --scene reference \\
        -o output.bmp
    python -m opencl_ray_tracer_tpu_torch.cli render --scene readme \\
        --checkpoint state.npz --chunk-spp 16 --progress-image progress.bmp
    python -m opencl_ray_tracer_tpu_torch.cli render --scene scene.json --cpu
    python -m opencl_ray_tracer_tpu_torch.cli info

The defaults are the reference executable's render: 1280x720, 5 samples
per pixel, depth 32.  With ``--checkpoint`` the render runs in windows of
``--chunk-spp`` samples and writes its state after each; run the same
command again to resume an interrupted render.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_scene(name: str):
    from . import (book_cover_scene, flagship_scene, readme_scene,
                   reference_scene, scene_from_json)
    if name == "readme":
        return readme_scene()
    if name == "reference":
        # the reference executable's default render (main.cpp:118-133): a
        # mesh, 8 spheres and a tone-mapped HDR sky
        return flagship_scene()
    if name == "reference-bare":
        return reference_scene()   # the 8 spheres alone
    if name == "cover":
        return book_cover_scene()
    return scene_from_json(name)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="opencl_ray_tracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to an image file")
    pr.add_argument("--scene", default="readme",
                    help="readme | reference (a mesh, 8 spheres and an HDR "
                         "sky, the reference executable's default) | "
                         "reference-bare | cover | path/to/scene.json")
    pr.add_argument("--width", type=int, default=1280)
    pr.add_argument("--height", type=int, default=720)
    pr.add_argument("--spp", type=int, default=5)
    pr.add_argument("--max-depth", type=int, default=32)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("-o", "--output", default="output.bmp",
                    help=".bmp (the reference's format) or .png")
    pr.add_argument("--checkpoint", default=None,
                    help="npz of the accumulated samples, for resuming")
    pr.add_argument("--chunk-spp", type=int, default=16)
    pr.add_argument("--progress-image", default=None,
                    help="image rewritten as the render proceeds (.bmp or "
                         ".png)")
    pr.add_argument("--cpu", action="store_true",
                    help="render with the plain PyTorch tracer on the CPU")

    pi = sub.add_parser("info", help="device dump")
    pi.add_argument("--json", action="store_true")

    args = p.parse_args(argv)

    from .utils import (PhaseTimer, ProgressReporter, device_info,
                        print_device_info, rays_per_second)
    if args.cmd == "info":
        if args.json:
            print(json.dumps(device_info(), indent=2))
        else:
            print_device_info()
        return 0

    from . import RenderConfig, render
    from .io import tonemap_u8, write_bmp, write_png
    from .tracer.render import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    print_device_info()
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth)
    timer = PhaseTimer()
    with timer.phase("scene build"):
        scene = _build_scene(args.scene)

    out = {}
    with timer.phase("render", sync_on=out):
        progress = (ProgressReporter(args.progress_image)
                    if args.checkpoint or args.progress_image else None)
        if args.checkpoint:
            from .parallel import render_checkpointed
            out["img"] = render_checkpointed(
                scene, cfg, args.checkpoint, seed=args.seed,
                chunk_spp=args.chunk_spp, progress=progress, device=device)
        else:
            # with --progress-image, the reference's block-by-block image
            # (main.cpp:263-265): row blocks through the same route
            out["img"] = render(scene, cfg, seed=args.seed, device=device,
                                progress=progress)

    stats = rays_per_second(cfg.width, cfg.height, cfg.spp, timer["render"])
    print(f"{stats['camera_samples_per_s']:.3e} camera samples/s")

    img = out["img"].cpu().numpy()
    if args.output.endswith(".png"):
        write_png(args.output, tonemap_u8(img))
    else:
        write_bmp(args.output, img)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
