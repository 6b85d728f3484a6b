"""Sharded rendering on the PyTorch port: one process per device.

Renders the README benchmark scene over a (tile x sample) mesh of ranks
(``opencl_ray_tracer_tpu_torch.parallel``); the tile sharding is
bit-identical to a single-device render (counter RNG), and every rank
returns the whole image, which rank 0 writes.

    python examples/multichip_render_torch.py            # one card
    torchrun --nproc-per-node N examples/multichip_render_torch.py
    python examples/multichip_render_torch.py --cpu      # the CPU, gloo

Under torchrun each rank takes the card ``cuda:$LOCAL_RANK`` and NCCL (or
the CPU and gloo with --cpu).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=144)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--sample-axis", type=int, default=1)
    ap.add_argument("--out", default="multichip.png")
    args = ap.parse_args(argv)

    import torch

    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch import parallel as par
    from opencl_ray_tracer_tpu_torch.io import tonemap_u8, write_png

    device = "cpu" if args.cpu else None
    par.init_distributed(device=device)   # False for a single process
    mesh = par.make_mesh(n_sample=args.sample_axis, device=device)
    if mesh.rank == 0:
        print(par.describe(mesh))

    cfg = ot.RenderConfig(width=args.width, height=args.height,
                          spp=args.spp, max_depth=8, early_stop=False)
    scene = ot.readme_scene()

    def run(seed):
        img = par.render_sharded(scene, cfg, mesh, seed=seed)
        if img.is_cuda:
            torch.cuda.synchronize()
        return img

    t0 = time.perf_counter()
    run(0)                                # kernels built, caches warm
    t1 = time.perf_counter()
    img = run(1)
    dt = time.perf_counter() - t1
    if mesh.rank == 0:
        ranks = mesh.n_tile * mesh.n_sample
        print(f"first render {t1 - t0:.2f}s; second {dt:.3f}s "
              f"({cfg.width * cfg.height * cfg.spp / max(dt, 1e-9):.3e} "
              f"samples/s over {ranks} rank(s) on {mesh.device})")
        write_png(args.out, tonemap_u8(img.cpu()))
        print(f"wrote {args.out}")
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
