"""Device meshes for the sharded planner (port of `repro.launch.mesh`'s
`make_local_mesh`).

A mesh names the dims of a grid of ranks.  Over live ranks (a
`torch.distributed` process group the caller started, one process per
rank) it is a `torch.distributed.device_mesh.DeviceMesh`; the planner reads
only its dim names and sizes, and SPMD execution its coordinates.  With no
process group there is one rank, and the mesh is the plain (name, size)
layout every planner entry point also takes: all sizes 1.

    dist.init_process_group("gloo", init_method="file:///tmp/pg", rank=r,
                            world_size=4)
    mesh = make_local_mesh((4,), ("x",))
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_local_mesh"]


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
