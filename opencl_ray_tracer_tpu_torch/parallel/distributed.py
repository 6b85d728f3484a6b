"""Process-group initialisation: one process per device.

PyTorch's multi-device idiom is one process a device: rank r owns
``cuda:{LOCAL_RANK}``, and ``torch.distributed`` collectives stand in for
the JAX package's ``shard_map`` collectives.  Call ``init_distributed()``
once per process before ``make_mesh``.  Under ``torchrun`` it reads the
launcher's environment; a plain ``python`` run (no arguments, no
environment) is a single process and needs no process group, so every
entry point of ``parallel/`` works after it unchanged.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..tracer.render import resolve_device


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None,
                     backend: str | None = None,
                     timeout: datetime.timedelta | None = None) -> bool:
    """Join the process group; True when one is active afterwards.

    coordinator_address: an init method (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` means tcp), by default
    ``tcp://$MASTER_ADDR:$MASTER_PORT``; num_processes and process_id by
    default ``$WORLD_SIZE`` and ``$RANK`` (torchrun's environment).  With
    none of them, this is a single process: returns False and initialises
    nothing.  An initialised group returns True as it is.

    device: this rank's device; None means the card ``cuda:$LOCAL_RANK``
    (which it makes the current one) and raises when there is none, as
    ``render`` does.  backend None means NCCL for a CUDA device and gloo
    for the CPU; NCCL puts one rank on a card, so several ranks on one
    card run gloo (the collectives of ``parallel.mesh`` then stage CUDA
    tensors through the host).  timeout is passed to
    ``init_process_group``: a rank that never arrives fails the others
    after it instead of hanging them."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"tcp://{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs a coordinator address, the "
                         "number of processes and this process's id")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if device is None:
        resolve_device(None)        # raises without a card
        device = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    return True


def is_multi_host() -> bool:
    """True when the process group holds more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1
