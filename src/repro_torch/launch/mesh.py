"""Mesh construction (the port of ``repro.launch.mesh``).

Single pod:  (data=16, model=16)          = 256 ranks (the reference's v5e pod)
Multi-pod:   (pod=2, data=16, model=16)   = 512 ranks

The ``pod`` axis carries data parallelism only (parameters replicated
across pods, gradients summed over pod x data).  A ``DeviceMesh`` needs a
process group of its size; where the world is another size the production
shapes come back as an ``AbstractMesh``, which is enough to derive specs.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False):
    """The pod (or two-pod) mesh: a ``DeviceMesh`` over the current world
    when its size matches, else an ``AbstractMesh`` of the same shape."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return make_host_mesh(shape, axes)
    return AbstractMesh(axes, shape)


def make_host_mesh(shape: tuple[int, ...] = (1, 1),
                   axes: tuple[str, ...] = ("data", "model")):
    """A ``DeviceMesh`` of ``shape`` over the current world, whose size must
    be ``prod(shape)``: on CUDA under NCCL (each rank on its card,
    ``LOCAL_RANK`` or rank modulo the cards), on the CPU otherwise."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))
