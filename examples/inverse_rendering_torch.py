"""Inverse rendering demo on the PyTorch port (BASELINE.json config 5).

Recovers a perturbed sphere's albedo and position from a rendered target
image by gradient descent on the pixel MSE: stage 1 fits the albedo under
hard visibility (on the card through the forward and backward sphere
kernels), stage 2 the centre under soft visibility (``render_soft``).

Run on the card, or on the CPU with --cpu:
    python examples/inverse_rendering_torch.py [--steps 60] [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default="inverse_demo")
    args = ap.parse_args(argv)

    import torch

    import opencl_ray_tracer_tpu_torch as ot
    from opencl_ray_tracer_tpu_torch.io import tonemap_u8, write_png
    from opencl_ray_tracer_tpu_torch.optimize import insert_params

    device = "cpu" if args.cpu else None
    w = args.size
    h = int(w * 9 / 16)
    cfg = ot.RenderConfig(width=w, height=h, spp=4, max_depth=4,
                          early_stop=False)

    true_scene = ot.readme_scene()
    target = ot.render(true_scene, cfg, seed=123, device=device)
    write_png(f"{args.out}_target.png", tonemap_u8(target))

    # Perturb: the centre sphere's albedo and x position
    albedo = true_scene.spheres.albedo.clone()
    albedo[1] = torch.tensor([0.2, 0.9, 0.9])
    center = true_scene.spheres.center.clone()
    center[1, 0] += 0.15
    init = insert_params(true_scene, {"spheres.albedo": albedo,
                                      "spheres.center": center})
    write_png(f"{args.out}_init.png",
              tonemap_u8(ot.render(init, cfg, seed=0, device=device)))

    def stage(scene, **kw):
        t0 = time.perf_counter()
        fitted, losses = ot.fit_scene(target, scene, cfg, steps=args.steps,
                                      device=device, **kw)
        secs = (time.perf_counter() - t0) / max(args.steps, 1)
        print(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({secs:.3f} s a step)")
        return fitted, losses, secs

    # Stage 1: materials with hard visibility (smooth gradients).
    print("stage 1: albedo (hard visibility)")
    fitted, losses1, secs1 = stage(init, param_paths=("spheres.albedo",),
                                   learning_rate=5e-2, seed=7)

    # Stage 2: geometry with soft visibility (silhouette gradients).
    print("stage 2: center (soft visibility)")
    mask = torch.zeros_like(init.spheres.center)
    mask[1] = 1.0
    fitted, losses2, secs2 = stage(
        fitted, param_paths=("spheres.center",), learning_rate=4e-3,
        seed=11, soft=True, beta=40.0,
        param_mask={"spheres.center": mask})

    got_albedo = fitted.spheres.albedo[1].cpu().numpy()
    want_albedo = true_scene.spheres.albedo[1].numpy()
    got_x = float(fitted.spheres.center[1, 0])
    want_x = float(true_scene.spheres.center[1, 0])
    print(f"albedo: recovered {got_albedo.round(3)} true {want_albedo}")
    print(f"center.x: recovered {got_x:+.4f} true {want_x:+.4f} "
          f"(init was {want_x + 0.15:+.4f})")
    write_png(f"{args.out}_fitted.png",
              tonemap_u8(ot.render(fitted, cfg, seed=0, device=device)))
    print(f"wrote {args.out}_{{target,init,fitted}}.png")
    return dict(true=true_scene, init=init, fitted=fitted,
                stage1_losses=losses1, stage2_losses=losses2,
                stage1_seconds_per_step=secs1,
                stage2_seconds_per_step=secs2)


if __name__ == "__main__":
    main()
