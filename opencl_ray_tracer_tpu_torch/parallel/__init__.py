"""Several devices, one process each: the (tile, sample) mesh of ranks,
sharded renders, gradients and training steps, the geometry ring and the
process group's set-up (``torch.distributed``); and long renders: the
sample-accumulation checkpoint and resume."""

from .checkpoint import load_state, render_checkpointed, save_state
from .distributed import init_distributed, is_multi_host
from .mesh import SAMPLE_AXIS, TILE_AXIS, Mesh, describe, make_mesh
from .ring import ring_hit_fn, ring_hit_fn_mm, shard_triangles
from .sharded import (make_train_step, render_grad_sharded, render_sharded,
                      render_sharded_jit)

__all__ = [
    "make_mesh", "describe", "Mesh", "TILE_AXIS", "SAMPLE_AXIS",
    "render_sharded", "render_sharded_jit", "make_train_step",
    "render_grad_sharded",
    "ring_hit_fn", "ring_hit_fn_mm", "shard_triangles",
    "render_checkpointed", "save_state", "load_state",
    "init_distributed", "is_multi_host",
]
