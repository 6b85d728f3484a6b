"""The (tile, sample) grid of ranks and the collectives of ``parallel/``.

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh``:
axis "tile" cuts the image into row blocks rendered at the same time,
axis "sample" cuts each pixel's samples into windows whose means are
averaged.  Here each device is a process (``init_distributed``), and the
mesh is the world's ranks as that grid, rank ``ti * n_sample + si`` at
tile ``ti`` and sample window ``si``, with a process group per row (the
tile group: the ranks of one sample window, which gather rows and pass
the geometry ring) and per column (the sample group: the ranks of one row
block, which average their windows).

``Mesh`` is this module's own record rather than a
``torch.distributed.device_mesh.DeviceMesh``: a DeviceMesh initialises a
default process group when there is none, and a single process (world 1,
a plain ``python`` run) needs none here; its groups are None and every
collective below returns its input.

The collectives (``all_sum``, ``sample_mean``, ``gather_rows``,
``ring_shift``, ``any_over``) are the counterparts of ``psum``,
``pmean``, the row-sharded output's gather and ``ppermute``;
``gather_objects`` exchanges small host objects (the geometry ring's
table shapes, once a render).  NCCL takes
CUDA tensors as they are.  Gloo, the backend of several ranks on one
card (NCCL puts one rank on a card) and of the CPU, takes host tensors:
under gloo each collective copies a CUDA tensor to the host and its result
back, chosen by the group's backend, and adds the bytes it copied to
``STAGED_BYTES``.  No collective changes backend or device on its own.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

from ..tracer.render import resolve_device

TILE_AXIS = "tile"
SAMPLE_AXIS = "sample"

# Bytes the collectives copied between the card and the host under gloo
# (each copy counted once, to the host and back) since the count was last
# set to 0.
STAGED_BYTES = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The world's ranks as an (n_tile, n_sample) grid, seen from one rank.

    device: this rank's device; devices: each rank's (device, its name,
    host, process id), in rank order; tile_group, sample_group and world:
    this rank's process groups (None without a process group)."""
    n_tile: int
    n_sample: int
    rank: int
    device: torch.device
    devices: tuple
    tile_group: object = None
    sample_group: object = None
    world: object = None

    @property
    def shape(self) -> dict:
        return {TILE_AXIS: self.n_tile, SAMPLE_AXIS: self.n_sample}

    @property
    def tile_index(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_index(self) -> int:
        return self.rank % self.n_sample

    def tile_rank(self, ti: int) -> int:
        """The world rank at tile ti in this rank's sample window."""
        return (ti % self.n_tile) * self.n_sample + self.sample_index


def _describe_device(device: torch.device) -> tuple:
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
    return (str(device), name, socket.gethostname(), os.getpid())


def make_mesh(n_tile: int | None = None, n_sample: int = 1,
              device=None) -> Mesh:
    """The (tile, sample) mesh of the world's ranks; by default every rank
    on the tile axis.  device: this rank's device, None meaning the card
    (the current CUDA device), which raises when there is none.  With a
    process group this is a collective: every rank calls it, with the same
    arguments.  Without one it is the 1x1 mesh of this process."""
    if device is None:
        resolve_device(None)        # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if not dist.is_initialized():
        if (n_tile or 1) * n_sample != 1:
            raise ValueError(f"a single process makes a 1x1 mesh, not "
                             f"{n_tile}x{n_sample}")
        return Mesh(1, 1, 0, device, (_describe_device(device),))
    world = dist.get_world_size()
    if n_tile is None:
        if world % n_sample:
            raise ValueError(f"{world} ranks do not divide into sample "
                             f"windows of {n_sample}")
        n_tile = world // n_sample
    if n_tile * n_sample != world:
        raise ValueError(f"a {n_tile}x{n_sample} mesh needs "
                         f"{n_tile * n_sample} ranks, not {world}")
    rank = dist.get_rank()
    devices = [None] * world
    dist.all_gather_object(devices, _describe_device(device))
    tile_group = sample_group = None
    # every rank creates every group, in the same order
    for si in range(n_sample):
        ranks = [ti * n_sample + si for ti in range(n_tile)]
        group = dist.new_group(ranks)
        if rank in ranks:
            tile_group = group
    for ti in range(n_tile):
        ranks = [ti * n_sample + si for si in range(n_sample)]
        group = dist.new_group(ranks)
        if rank in ranks:
            sample_group = group
    return Mesh(n_tile, n_sample, rank, device, tuple(devices), tile_group,
                sample_group, dist.group.WORLD)


def describe(mesh: Mesh) -> str:
    """The mesh's layout and every rank's device: the counterpart of the
    JAX package's device dump (and of the reference's OpenCL device dump,
    ``utility.cpp:3-61``)."""
    lines = [f"mesh axes: {mesh.shape}"]
    for rank, (dev, name, host, pid) in enumerate(mesh.devices):
        ti, si = divmod(rank, mesh.n_sample)
        lines.append(f"  rank {rank} (tile {ti}, sample {si}): {dev} {name} "
                     f"(process {rank}, {host} pid {pid})")
    return "\n".join(lines)


def _staged(group) -> bool:
    return dist.get_backend(group) == dist.Backend.GLOO


def _to_backend(x: torch.Tensor, group) -> torch.Tensor:
    """x where the group's backend takes it: a host copy of a CUDA tensor
    under gloo (counted), else x itself."""
    global STAGED_BYTES
    if x.is_cuda and _staged(group):
        STAGED_BYTES += x.numel() * x.element_size()
        return x.cpu()
    return x


def _from_backend(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The result y back on like's device (counted when it moves)."""
    global STAGED_BYTES
    if y.device != like.device:
        STAGED_BYTES += y.numel() * y.element_size()
        return y.to(like.device)
    return y


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks (psum), on every rank; x itself
    without a group.  x is not changed."""
    if group is None:
        return x
    y = _to_backend(x, group)
    y = y.clone() if y is x else y
    dist.all_reduce(y, group=group)
    return _from_backend(y, x)


def sample_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of x over the rank's sample group (pmean over "sample"):
    each rank holds the mean of an equal window of samples.  A group of
    one rank returns x, with no collective."""
    if mesh.sample_group is None or mesh.n_sample == 1:
        return x
    return all_sum(x, mesh.sample_group) / mesh.n_sample


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The row blocks x of the rank's tile group, concatenated in tile
    order along dim 0, on every rank."""
    if mesh.tile_group is None:
        return x
    y = _to_backend(x.contiguous(), mesh.tile_group)
    parts = [torch.empty_like(y) for _ in range(mesh.n_tile)]
    dist.all_gather(parts, y, group=mesh.tile_group)
    return _from_backend(torch.cat(parts), x)


def gather_objects(obj, mesh: Mesh) -> list:
    """The picklable obj of every rank of the tile group, in tile order,
    on every rank; [obj] without a group."""
    if mesh.tile_group is None:
        return [obj]
    out = [None] * mesh.n_tile
    dist.all_gather_object(out, obj, group=mesh.tile_group)
    return out


def ring_shift(tensors, recv_specs, mesh: Mesh) -> list:
    """One step of the ring over the tile axis (ppermute by +1): sends
    ``tensors`` to tile ti + 1 and returns what tile ti - 1 sent, as
    tensors of ``recv_specs`` ((shape, dtype) each: the sender's, which
    may differ from this rank's in number, shape and dtype) on this rank's
    device.  Empty tensors travel implicitly (their specs are known to
    both ends).  Without a group, or with one tile, returns ``tensors``."""
    if mesh.tile_group is None or mesh.n_tile == 1:
        return list(tensors)
    group = mesh.tile_group
    nxt = mesh.tile_rank(mesh.tile_index + 1)
    prv = mesh.tile_rank(mesh.tile_index - 1)
    sends = [_to_backend(t.contiguous(), group) for t in tensors]
    at = ("cpu" if mesh.device.type == "cuda" and _staged(group)
          else mesh.device)
    recvs = [torch.empty(shape, dtype=dtype, device=at)
             for shape, dtype in recv_specs]
    ops = [dist.P2POp(dist.isend, s, nxt) for s in sends if s.numel()]
    ops += [dist.P2POp(dist.irecv, r, prv) for r in recvs if r.numel()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    like = torch.empty(0, device=mesh.device)
    return [_from_backend(r, like) for r in recvs]


def any_over(flag: bool, mesh: Mesh) -> bool:
    """True when flag is true on any rank of the tile group: the geometry
    ring's loops end together, so that every rank of a ring calls it
    equally often."""
    if mesh.tile_group is None:
        return flag
    dev = ("cpu" if _staged(mesh.tile_group) else mesh.device)
    x = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.tile_group)
    return bool(x.item())
