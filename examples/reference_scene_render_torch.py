"""Render the reference's default scene end to end on the PyTorch port.

The port's version of ``examples/reference_scene_render.py``.  The scene
hardcoded in the reference's ``main.cpp:80-152``: 8 spheres (all four
materials), a triangle mesh in its gating box, and an equirectangular HDR
skybox (the tone-mapped procedural ``make_sky_image(1024, 512)``: the
reference's ``skybox.hdr`` is a missing LFS blob), at the reference's
default build configuration (1280x720, 5 spp, depth 32;
``globals.hpp:9-14``).  The mesh is the OBJ file given by --obj (the
reference's 15,329-triangle F1 car, ``src/assets/models/f1_car.obj`` of
the reference repository, which this one does not bundle), loaded through
``load_obj`` (the native parser) with the exact scale and translate of
``main.cpp:118-120``; without it, a procedural 576-triangle torus.

On the card the render takes the mesh megakernel's HDR body
(``kernels/csrc/megamesh.cu``); the first render of a process includes
building the kernel library.  On one NVIDIA H100 80GB HBM3 (power limit
700 W) the defaults with a 15,360-triangle mesh rendered in 0.102 s, the
library already built and the mesh's tables built in that call
(``chip_smoke.py`` phase 30d).  With --cpu it runs the plain PyTorch
tracer (slow at full size: pass --small, 320x180, 2 spp, depth 8).

    python examples/reference_scene_render_torch.py [--small] [--obj PATH]
        [--cpu] [-o reference_scene.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def make_scene(obj: str | None = None):
    """The reference scene with the mesh of ``obj`` (None or a missing
    file: the procedural torus) under the tone-mapped 1024x512 sky."""
    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import load_obj, parse_obj, tone_map
    from opencl_ray_tracer_tpu_torch.io.procgen import (make_sky_image,
                                                        make_torus_obj)

    if obj is not None and os.path.exists(obj):
        # the reference's exact mesh transform (main.cpp:118-120)
        tris, aabb = load_obj(obj, scale=(0.15, 0.15, 0.15),
                              translate=(0.0, -0.5, -1.0))
    else:
        if obj is not None:
            print(f"# {obj} not found; using a procedural torus")
        tris, aabb = parse_obj(make_torus_obj(24, 12),
                               scale=(0.5, 0.5, 0.5),
                               translate=(0.3, 0.0, -1.6))
    sky = ot.Sky.hdr(tone_map(make_sky_image(1024, 512)))
    return ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)


def main(argv=None, cfg=None):
    """Render and write the PNG; the scene, configuration, image, seconds
    and samples a second.  ``cfg`` replaces the configuration the
    arguments pick."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--obj", default=None,
                    help="OBJ file of the mesh (default: a procedural "
                         "torus)")
    ap.add_argument("--small", action="store_true",
                    help="320x180x2spp, depth 8 (CPU-friendly)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU with the plain tracer")
    ap.add_argument("-o", "--output", default="reference_scene.png")
    args = ap.parse_args(argv)

    import torch

    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import tonemap_u8, write_png
    from opencl_ray_tracer_tpu_torch.tracer.render import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    scene = make_scene(args.obj)
    if cfg is None:
        cfg = (ot.RenderConfig(width=320, height=180, spp=2, max_depth=8)
               if args.small
               else ot.RenderConfig())  # the reference defaults
    print(f"# device={device.type}  {cfg.width}x{cfg.height} "
          f"spp={cfg.spp} depth={cfg.max_depth} "
          f"tris={scene.triangles.count}")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    img = ot.render(scene, cfg, seed=0, device=device)
    sync()
    dt = time.perf_counter() - t0
    sps = cfg.width * cfg.height * cfg.spp / dt
    print(f"# render: {dt:.3f} s  ({sps:.3e} camera samples/s)")

    write_png(args.output, tonemap_u8(img))
    print(f"wrote {args.output}")
    return dict(scene=scene, cfg=cfg, image=img, seconds=dt,
                samples_per_s=sps)


if __name__ == "__main__":
    main()
