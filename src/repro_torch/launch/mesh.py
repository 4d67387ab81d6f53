"""Production meshes and sharding helpers on ``torch.distributed``.

The mesh constructors are functions (never module-level constants), so
importing this module touches no process group.  Each needs an
initialized default process group (``torch.distributed.init_process_group``,
or ``torchrun``) of the mesh's size, and builds a
:class:`~torch.distributed.device_mesh.DeviceMesh` on ``device_type``
(default ``"cuda"``).

Axes:
  pod    -- 2-way across pods (data parallel over the slow boundary)
  data   -- 16-way data parallel / FSDP within a pod
  model  -- 16-way tensor/expert parallel (heads, mlp, experts, vocab)
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models.params import (
    NamedSharding,
    active_rules,
    mesh_axis_sizes,
    param_shardings,
)

__all__ = [
    "make_production_mesh",
    "make_smoke_mesh",
    "batch_shardings",
    "state_shardings",
    "data_axes",
]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``: 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_smoke_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The ``("data", "model")`` mesh of every rank of the process group,
    with the largest model axis of 4, 2 or 1 that divides its size."""
    n = dist.get_world_size()
    model = next(m for m in (4, 2, 1) if n % m == 0 and n >= m)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))


def batch_shardings(input_specs: dict, mesh) -> dict:
    """Shard every input's leading (batch) dim per the active rules, where
    the batch axes' product divides it; replicate it otherwise.
    ``input_specs``: {name: (shape, dtype)}, as ``Model.input_specs``."""
    sizes = mesh_axis_sizes(mesh)
    rule = active_rules().get("batch", "fsdp")
    if rule == "all":
        axes = tuple(sizes)
    elif isinstance(rule, tuple):
        axes = tuple(a for a in rule if a in sizes)
    else:
        axes = data_axes(mesh)
    size = math.prod(sizes[a] for a in axes) if axes else 1
    out = {}
    for name, (shape, _) in input_specs.items():
        if shape and size > 1 and shape[0] % size == 0:
            out[name] = NamedSharding(mesh, (axes,) + (None,) * (len(shape) - 1))
        else:
            out[name] = NamedSharding(mesh, ())
    return out


def state_shardings(specs_tree, mesh):
    """ParamSpec tree -> :class:`NamedSharding` tree (params, optimizer
    state, caches)."""
    return param_shardings(specs_tree, mesh)
