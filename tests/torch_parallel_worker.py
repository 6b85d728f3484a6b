"""One rank of a CPU world of tests/test_torch_parallel.py: gloo over a
file, the port alone (no JAX).

    python tests/torch_parallel_worker.py {render|grad} RANK WORLD DIR

reads DIR/inputs.npz (the scenes' numpy leaves and sky kinds, rays),
joins the process group through DIR/init, runs its world's calls and
writes what it computed to DIR/out_RANK.npz.  The test holds rank 0's
results against the JAX package and every rank's against rank 0's.
"""

import dataclasses
import datetime
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import opencl_ray_tracer_tpu_torch as ot  # noqa: E402
from opencl_ray_tracer_tpu_torch import parallel as par  # noqa: E402
from opencl_ray_tracer_tpu_torch.scene import (  # noqa: E402
    replace_leaves, scene_from_numpy, scene_to_numpy)

torch.set_num_threads(1)


def scene(inputs, name):
    prefix = f"{name}/"
    leaves = {k[len(prefix):]: v for k, v in inputs.items()
              if k.startswith(prefix)}
    return scene_from_numpy(leaves, int(inputs[f"{name}_sky_kind"]))


def cfg(inputs, name):
    return ot.RenderConfig(**json.loads(str(inputs[f"{name}_cfg"])))


def loss_fn(img, tgt):
    return torch.mean((img - tgt) ** 2)


def albedo_step(s, c, mesh, seed, lr=1.0, **kwargs):
    """(loss, move) of one SGD step at lr on the spheres' albedo through
    ``make_train_step(**kwargs)`` towards a black target: the lr-1 step's
    move is the albedo gradient."""
    params = {"spheres.albedo": s.spheres.albedo.clone().requires_grad_()}
    step = par.make_train_step(
        c, mesh, torch.optim.SGD(list(params.values()), lr=lr), loss_fn,
        lambda p: replace_leaves(s, p), seed=seed, **kwargs)
    loss = step(params, torch.zeros((c.height, c.width, 3)), seed)
    return loss.numpy(), (s.spheres.albedo
                          - params["spheres.albedo"]).detach().numpy()


def render_world(inputs, out):
    readme = scene(inputs, "readme")
    mesh_scene = scene(inputs, "mesh")
    c = cfg(inputs, "render")
    tile = par.make_mesh(n_tile=4, device="cpu")
    out["describe"] = np.asarray(par.describe(tile))
    out["tile_4x1"] = par.render_sharded(readme, c, tile, seed=0).numpy()
    grid = par.make_mesh(n_tile=2, n_sample=2, device="cpu")
    out["tile_2x2"] = par.render_sharded_jit(readme, c, grid, seed=0).numpy()
    # the rings on numpy rays, over the 4x1 mesh: shard 3 is padding alone
    o, d = (torch.tensor(inputs[k]) for k in ("rays_o", "rays_d"))
    padded = par.shard_triangles(mesh_scene.triangles, tile.n_tile)
    local = dataclasses.replace(mesh_scene, triangles=par.ring.local_shard(
        padded, tile))
    for name, fn in (("ring", par.ring_hit_fn),
                     ("ring_mm", par.ring_hit_fn_mm)):
        h = fn(local, tile)(o, d)
        for f in ("hit", "t", "mat_type", "albedo"):
            out[f"{name}/{f}"] = getattr(h, f).numpy()
    rc = cfg(inputs, "ring")
    out["ring_render"] = par.render_sharded(mesh_scene, rc, grid, seed=0,
                                            geometry_ring=True).numpy()


def grad_world(inputs, out):
    tile = par.make_mesh(device="cpu")
    for name in ("sphere", "mesh", "hdr"):
        s, c = scene(inputs, name), cfg(inputs, name)
        loss, img, g = par.render_grad_sharded(
            s, c, lambda im: torch.mean(im ** 2), tile,
            seed=int(inputs[f"{name}_seed"]))
        out[f"{name}/loss"] = loss.numpy()
        out[f"{name}/img"] = img.numpy()
        for k, v in scene_to_numpy(g).items():
            out[f"{name}/grad/{k}"] = v
    # the kernel step's mesh and HDR forwards and backwards: one lr-1 step
    # on the spheres' albedo of each of those cases
    for name in ("mesh", "hdr"):
        t = scene(inputs, name)
        out[f"step/{name}/loss"], out[f"step/{name}/move"] = albedo_step(
            t, cfg(inputs, name), tile, int(inputs[f"{name}_seed"]),
            grad_backend="kernel", template_scene=t)
    # one SGD step at lr 0 and at lr 1 on the sphere scene's albedo, per
    # route: the loss, and the gradient as the lr-1 step's move
    s, seed = scene(inputs, "sphere"), int(inputs["sphere_seed"])
    for route in ("plain", "kernel"):
        for lr in (0.0, 1.0):
            out[f"step/{route}/{lr}/loss"], out[f"step/{route}/{lr}/move"] = (
                albedo_step(s, cfg(inputs, "sphere"), tile, seed, lr,
                            grad_backend=route, template_scene=s))
    # the plain step on a 2x2 grid: the sample mean's transpose
    grid = par.make_mesh(n_tile=2, n_sample=2, device="cpu")
    out["step_2x2/loss"], out["step_2x2/move"] = albedo_step(
        s, cfg(inputs, "grid_step"), grid, seed)


def main():
    world_name, rank, world, tmp = sys.argv[1:5]
    rank, world = int(rank), int(world)
    inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
    par.init_distributed(f"file://{os.path.join(tmp, 'init')}", world, rank,
                         device="cpu",
                         timeout=datetime.timedelta(seconds=60))
    out = {"world": np.asarray(torch.distributed.get_world_size())}
    {"render": render_world, "grad": grad_world}[world_name](inputs, out)
    np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
