"""The device mesh of the sharded decode step and its axis collectives.

Counterpart of the reference's ``launch/mesh.py`` and of the mesh half of
``runtime/compat.py``.  A mesh is a ``torch.distributed`` ``DeviceMesh``
whose axes are named ``("data", "model")`` or ``("pod", "data",
"model")``: ``model`` carries tensor parallelism (and the K/V arenas'
page slots), the others the batch or, sequence-parallel, the pages.  Each
rank runs its step on its own shards; the reference's ``psum``, ``pmax``
and ``all_gather`` over a named axis become collectives on that axis's
process group.

A mesh of more than one rank needs ``torch.distributed`` initialised by
the caller (rank, world size and a store: nothing here reads a cluster's
environment).  A mesh of one rank without a process group gets a
one-rank gloo group on an in-memory store, so that it is a mesh all the
same; it never stands in for a larger one.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

MODEL_AXIS = "model"

# the all-reduces ``psum`` and ``pmax`` made in this process (one a
# process group) and their bytes; a caller zeroes them around a path
collective_calls = 0
collective_bytes = 0


def make_mesh(shape, names, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over the ranks of
    the default process group (rank-major: the last axis varies
    fastest)."""
    shape, names = tuple(shape), tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a mesh of {n} ranks needs torch.distributed initialised "
                f"first (init_process_group with its rank, world size and "
                f"store)")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cpu") -> DeviceMesh:
    """The (data, model) mesh of the CPU tests."""
    return make_mesh((data, model), ("data", "model"), device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production layout: (16, 16) over (data, model), or
    (2, 16, 16) over (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> tuple[str, ...]:
    """Every axis but ``model``."""
    return tuple(a for a in axis_names(mesh) if a != MODEL_AXIS)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    """Ranks along an axis, or the product over a tuple of axes."""
    names = axis_names(mesh)
    return math.prod(mesh.shape[names.index(a)] for a in _axes(axes))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def dp_linear_index(mesh, axes) -> int:
    """The flattened coordinate over (possibly several) axes, the first
    slowest."""
    out = 0
    for a in _axes(axes):
        out = out * axis_size(mesh, a) + axis_index(mesh, a)
    return out


def _groups(mesh, axes):
    """The process groups one reduction over ``axes`` takes: the whole
    mesh's in one step when ``axes`` are all of its axes, else one group
    an axis (a size-1 axis takes none)."""
    axes = tuple(a for a in _axes(axes) if axis_size(mesh, a) > 1)
    if len(axes) > 1 and axis_size(mesh, axes) == mesh.size() \
            == dist.get_world_size():
        return [dist.group.WORLD]
    return [mesh.get_group(a) for a in axes]


def _all_reduce(x: torch.Tensor, mesh, axes, op) -> torch.Tensor:
    global collective_calls, collective_bytes
    for g in _groups(mesh, axes):
        dist.all_reduce(x, op=op, group=g)
        collective_calls += 1
        collective_bytes += x.numel() * x.element_size()
    return x


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over ``axes`` (a name or a tuple), IN PLACE; returns x."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Maximum over ``axes``, IN PLACE; returns x."""
    return _all_reduce(x, mesh, axes, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """[n, *x.shape]: every rank's x along ``axes`` (a name or a tuple,
    flattened the first slowest), in axis order.  An all-reduce of a
    zero-filled buffer that holds x at this rank's row: exact (a sum of
    one value and zeros; -0.0 comes back as 0.0), and the one collective
    gloo takes on CUDA tensors."""
    n = axis_size(mesh, axes)
    out = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[dp_linear_index(mesh, axes)] = x
    return psum(out, mesh, axes)
