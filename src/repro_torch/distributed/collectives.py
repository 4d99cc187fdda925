"""The collectives of the sharded train step, each an autograd Function.

The reference trains on a mesh as pjit auto-SPMD: XLA inserts the
resharding its sharding annotations imply, forward and backward.  Here
each rank runs the step on its own blocks and its own batch shard, and
every resharding is one of these, with its backward stated:

  * ``copy_to_model``: identity forward; backward an all-reduce over
    ``model``.  It marks where a tensor that every model rank holds whole
    starts feeding per-rank work (its heads, its ffn columns, its
    vocabulary rows): each rank's cotangent then carries only its part,
    and the sum is the whole cotangent.
  * ``reduce_from_model``: forward the sum over ``model`` (in fp32,
    rounded once to the result's dtype); identity backward.  Its result
    feeds work every model rank repeats identically, so each rank's
    cotangent already is the whole one.  Composed as
    ``copy_to_model(reduce_from_model(x))`` it is a sum whose result
    feeds per-rank work again (Mamba-2's gated norm).
  * ``row_parallel``: a row-parallel product, this rank's ``a @ w``
    partial in fp32, summed over ``model`` and rounded once, as one
    device's product rounds it; backward the local products (the
    cotangent is replicated, as for ``reduce_from_model``).
  * ``gather_fsdp``: a leaf's block gathered over ``data`` on its FSDP
    dim before use.  Backward: the gradient is summed over the data axes
    (the batch is split over them) in fp32, rounded once to the leaf's
    dtype, and this rank's block kept: a reduce-scatter.  Every leaf
    passes through it, sharded over ``data`` or not, so every gradient is
    summed over the batch shards exactly once.
  * ``gather_model``: a leaf's block gathered over ``model`` (starcoder2's
    2 KV heads at tp 4: each rank needs the whole KV head its query heads
    read), or an activation whose units the model ranks hold by the plan
    below, unevenly or not (the RG-LRU's gates read every channel of the
    convolved input); backward the fp32 sum over ``model`` of the whole
    gradient, rounded once, this rank's part kept.

The plan of a split dim (``unit_ranges``): a dim of n units (query heads,
d_ff columns, SSD heads, RG-LRU channels) over tp model ranks gives rank r
the units [r n / tp, (r + 1) n / tp) (floors).  ``model_part`` takes a
rank's range of a leaf: the leaf's ``model`` block itself where every
rank's block is its range; else the leaf gathered over ``model`` (its
columns split but not on the plan's bounds) or, replicated over ``model``
(``_fit`` dropped an axis that does not divide), marked by
``copy_to_model``, and narrowed.  Its gradient: the block's own in the
first case; else summed over ``model`` (every rank's range of it) by
``gather_model``'s or ``copy_to_model``'s backward.  The choice reads
every rank's range, so all model ranks make it alike and their
collectives pair.

gloo takes ``all_reduce`` (and ``broadcast``) on CUDA tensors, so a
gather is an all-reduce of a zero-filled buffer (exact) and a
reduce-scatter an all-reduce and a slice.  No Function keeps state
between its forward and its backward beyond ``ctx``, so the unit remat
(which runs a unit's forward again inside the backward, collectives and
all, in the same order on every rank) is safe.
"""

from __future__ import annotations

import torch

from .mesh import MODEL_AXIS, axis_names, axis_size, data_axes, \
    dp_linear_index, psum
from .specs import entry_axes


def mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N] with an fp32 result, the product never rounded to
    a's dtype: on the card one cuBLAS product that writes fp32
    (``out_dtype``), on the CPU in fp32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def _sum32(g: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A new fp32 tensor: ``g`` summed over ``axes``."""
    out = g.to(torch.float32, copy=True)
    return psum(out, mesh, axes)


def _gather_dim(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` put together on ``dim``."""
    n = axis_size(mesh, axes)
    if n == 1:
        return x
    shape = list(x.shape)
    c = shape[dim]
    shape[dim] = c * n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.narrow(dim, dp_linear_index(mesh, axes) * c, c).copy_(x)
    return psum(out, mesh, axes)


def _block_of(g: torch.Tensor, dim: int, mesh, axes, c: int):
    return g.narrow(dim, dp_linear_index(mesh, axes) * c, c)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return _sum32(g, ctx.mesh, MODEL_AXIS).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dtype):
        ctx.dtype = x.dtype
        return _sum32(x, mesh, MODEL_AXIS).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, mesh):
        ctx.save_for_backward(a, w)
        part = mm32(a.reshape(-1, a.shape[-1]), w)
        out = psum(part, mesh, MODEL_AXIS).to(a.dtype)
        return out.reshape(*a.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        da = torch.matmul(g2, w.t()).reshape(a.shape)
        dw = torch.matmul(a.reshape(-1, a.shape[-1]).t(), g2)
        return da, dw, None


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, spec, mesh):
        ctx.mesh, ctx.spec = mesh, spec
        ctx.block_shape, ctx.dtype = tuple(block.shape), block.dtype
        x = block
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in entry_axes(entry) if a != MODEL_AXIS)
            if axes:
                x = _gather_dim(x, dim, mesh, axes)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        g = _sum32(g, mesh, data_axes(mesh)).to(ctx.dtype)
        for dim, entry in enumerate(ctx.spec):
            axes = tuple(a for a in entry_axes(entry) if a != MODEL_AXIS)
            if axes and axis_size(mesh, axes) > 1:
                g = _block_of(g, dim, mesh, axes, ctx.block_shape[dim])
        return g.contiguous(), None, None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ranges, mesh):
        lo, hi = ranges[model_index(mesh)]
        ctx.mesh, ctx.dim, ctx.lo, ctx.n = mesh, dim, lo, hi - lo
        shape = list(x.shape)
        shape[dim] = ranges[-1][1]
        out = torch.zeros(shape, dtype=x.dtype, device=x.device)
        out.narrow(dim, lo, hi - lo).copy_(x)
        return psum(out, mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        g = _sum32(g, ctx.mesh, MODEL_AXIS).to(g.dtype)
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, \
            None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh, dtype=None) -> torch.Tensor:
    """The sum over ``model`` of ``x`` in fp32, rounded to ``dtype``
    (default x's)."""
    return _ReduceFromModel.apply(x, mesh, dtype or x.dtype)


def row_parallel(a: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """``a [.., K/tp] @ w [K/tp, N]`` summed over ``model``, in a's
    dtype."""
    return _RowParallel.apply(a, w, mesh)


def gather_fsdp(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The leaf whole on its data-sharded dims (its model-sharded dims
    stay this rank's); its gradient summed over the data axes."""
    return _GatherFSDP.apply(block, tuple(spec), mesh)


def gather_model(x: torch.Tensor, dim: int, mesh, ranges=None) -> torch.Tensor:
    """``x`` whole on ``dim`` on every model rank, this rank's part being
    elements ``ranges[model_index]`` of it (default equal blocks: the
    leaf's model-sharded ``dim``); its gradient summed over ``model`` and
    this rank's part kept."""
    dim = dim % x.dim()
    if ranges is None:
        c = x.shape[dim]
        ranges = [(i * c, (i + 1) * c) for i in range(model_size(mesh))]
    return _GatherModel.apply(x, dim, tuple(ranges), mesh)


def gather_leaves(tree, specs, mesh):
    """``gather_fsdp`` over every leaf of a tree."""
    if isinstance(tree, dict):
        return {k: gather_leaves(v, specs[k], mesh) for k, v in tree.items()}
    return gather_fsdp(tree, specs, mesh)


def model_index(mesh) -> int:
    return dp_linear_index(mesh, MODEL_AXIS)


def model_size(mesh) -> int:
    return axis_size(mesh, MODEL_AXIS) if mesh is not None else 1


def unit_ranges(n: int, tp: int) -> list[tuple[int, int]]:
    """The plan of a dim of ``n`` units over ``tp`` model ranks: rank r's
    units [r n // tp, (r + 1) n // tp).  Raises where a rank would hold
    none (no split)."""
    if n < tp:
        raise NotImplementedError(f"{n} units do not split over model {tp}: "
                                  f"a rank would hold none")
    return [(r * n // tp, (r + 1) * n // tp) for r in range(tp)]


def model_part(w: torch.Tensor, dim: int, whole: int, ranges, unit: int,
               mesh) -> torch.Tensor:
    """This rank's units ``ranges[model_index]`` (each ``unit`` elements
    wide) of a leaf whose ``dim`` is ``whole`` elements, from its block
    ``w`` (the leaf gathered over ``data``): see the module's docstring
    for the three cases and their gradients."""
    dim = dim % w.dim()
    blk = w.shape[dim]
    lo, hi = ranges[model_index(mesh)]
    if blk < whole:
        if all((a * unit, b * unit) == (i * blk, (i + 1) * blk)
               for i, (a, b) in enumerate(ranges)):
            return w
        full = gather_model(w, dim, mesh)
    else:
        full = copy_to_model(w, mesh)
    return full.narrow(dim, lo * unit, (hi - lo) * unit)


def psum_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """A new tensor: ``x`` (no grad) summed over the whole mesh."""
    return psum(x.detach().clone(), mesh, axis_names(mesh))


def psum_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """A new tensor: ``x`` (no grad) summed over the data axes."""
    return psum(x.detach().clone(), mesh, data_axes(mesh))
