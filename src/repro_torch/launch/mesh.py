"""Device meshes and the process group (port of `repro.launch.mesh`'s
`make_local_mesh`, `make_production_mesh` and `PROD_TP`, with the
process-group start that `train --mesh local-dp | prod` needs).

A mesh names the dims of a grid of ranks.  Over live ranks (a
`torch.distributed` process group the caller started, one process per
rank) it is a `torch.distributed.device_mesh.DeviceMesh`; the planner reads
only its dim names and sizes, and SPMD execution its coordinates.  With no
process group there is one rank, and the mesh is the plain (name, size)
layout every planner entry point also takes: all sizes 1.

    dist.init_process_group("gloo", init_method="file:///tmp/pg", rank=r,
                            world_size=4)
    mesh = make_local_mesh((4,), ("x",))

`init_distributed` starts the default group for data-parallel training
from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) or a
rendezvous the caller passes, and picks the backend: NCCL when every rank
of the host has a card of its own, gloo otherwise (NCCL refuses two ranks
on one card; gloo stages CUDA tensors through host memory).
"""

from __future__ import annotations

import datetime
import math
import os
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["PROD_TP", "init_distributed", "make_local_mesh", "make_production_mesh"]

PROD_TP = 16  # 'model' axis size on the production meshes


def make_local_mesh(shape, axes):
    """A mesh of `shape` named `axes` over the first prod(shape) ranks of
    the process group (tests, CPU runs, one card's ranks).

    Validated against the live world size up front, with an error that
    names it, where `init_device_mesh` would fail later and opaquely.  The
    DeviceMesh's device type follows the backend: "cuda" under NCCL, "cpu"
    under gloo (which stages CUDA tensors through host memory).
    """
    shape, axes = tuple(int(s) for s in shape), tuple(str(a) for a in axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} must have equal rank")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need > have:
        raise ValueError(
            f"mesh shape {shape} ({'x'.join(map(str, shape))} = {need} ranks) exceeds the"
            f" world size {have}; start {need} ranks with"
            " torch.distributed.init_process_group(rank=..., world_size=...) first"
        )
    if not dist.is_initialized():
        return tuple(zip(axes, shape))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if need == have:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    return DeviceMesh(device_type, torch.arange(need).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh over the process group: 16 x 16 =
    256 ranks ('data', 'model'), or 2 x 16 x 16 = 512 multi-pod ('pod',
    'data', 'model'), a rank per chip.  A group of any other size raises
    ValueError naming the count, where the reference's `jax.make_mesh`
    fails too."""
    shape = (2, 16, PROD_TP) if multi_pod else (16, PROD_TP)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the production mesh {'x'.join(map(str, shape))} needs {need} ranks;"
                         f" the process group has {have}")
    return make_local_mesh(shape, axes)


def init_distributed(device, init_method=None, *, world_size=None, rank=None,
                     timeout_s: float = 600.0):
    """Join the default process group; returns (world size, rank).

    An existing group is used as it is.  Else `init_method` (e.g. a
    `file://` rendezvous, with `world_size` and `rank`), else torchrun's
    environment (`env://`).  With neither there is one rank and no group.
    On a CUDA `device` where the host has a card for each of its ranks
    (LOCAL_WORLD_SIZE, by default the world), the backend is NCCL and this
    process takes card LOCAL_RANK; otherwise gloo.  The choice is logged
    on stderr.  A collective that waits longer than `timeout_s` raises.
    """
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    if init_method is None:
        if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
            return 1, 0
        init_method = "env://"
        world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count() if torch.device(device).type == "cuda" else 0
    backend = "nccl" if cards >= local_world else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    print(f"[dist] rank {rank} of {world_size}: backend {backend} ({cards} card(s) for"
          f" {local_world} rank(s) on this host)", file=sys.stderr, flush=True)
    return world_size, rank
