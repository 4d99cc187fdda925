"""Sharding specs of the serving layout, and the trees they cut.

Copies of the reference's ``serving/decode.py`` ``serve_param_specs``,
``mixer_state_specs`` and ``dstate_specs``.  A spec is a plain tuple, the
counterpart of a ``PartitionSpec``: one entry a dim, each ``None``
(replicated), an axis name or a tuple of axis names (sharded over their
flattened index, the first slowest).

``shard_tree`` cuts global tensors into this rank's blocks (the
counterpart of ``device_put`` with a ``NamedSharding``); ``gather_tree``
puts the blocks of every rank back together, on every rank.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from .mesh import MODEL_AXIS, axis_index, axis_names, axis_size, data_axes, \
    dp_linear_index, psum


def param_spec(cfg: ModelConfig, path: str, ndim: int, tp: int) -> tuple:
    """The spec of the weight at ``path`` (``"/units/l0/attn/wq"``: the
    unit-stacked leaves have one leading dim more) with ``ndim`` dims
    under TP degree ``tp`` (model-axis TP only).  Vocab tables whose row
    count does not divide the TP axis are replicated (internvl2: 92553,
    granite-moe: 49155, hubert: 504)."""
    M = MODEL_AXIS
    lead = 1 if path.startswith("/units/") else 0
    pre = (None,) * lead

    def p(*s):
        return pre + s + (None,) * (ndim - lead - len(s))

    last = path.split("/")[-1]
    if "attn" in path:
        if last in ("wq", "wk", "wv", "wo"):
            return p(M, None)
        return p()                            # biases replicated
    if "ffn" in path:
        if last == "router":
            return p()
        if last in ("wi", "wg"):
            return p(M) if ndim - lead == 3 else p(None, M)
        if last == "wo":
            return p(M) if ndim - lead == 3 else p(M, None)
    if "ssd" in path:
        if last in ("in_z", "in_x", "in_dt", "conv_x_w"):
            return p(None, M)
        if last in ("conv_x_b", "A_log", "dt_bias", "D", "norm_w"):
            return p(M)
        if last == "out_proj":
            return p(M, None)
        return p()                            # in_bc / conv_bc_* replicated
    if "rglru" in path:
        if last in ("in_x", "in_g", "conv_w"):
            return p(None, M)
        if last in ("conv_b", "lam"):
            return p(M)
        if last in ("wa", "wx", "out"):
            return p(M, None)
        return p()
    if last in ("embed", "unembed"):
        return (M, None) if cfg.vocab_size % tp == 0 else (None, None)
    return p()                                # norms etc. replicated


def serve_param_specs(cfg: ModelConfig, params, tp: int = 16) -> dict:
    """``param_spec`` of every leaf of ``params`` (any tree of objects
    with a ``shape``): the serving weight layout."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        return param_spec(cfg, path, len(tree.shape), tp)

    return walk(params)


def mixer_state_specs(cfg: ModelConfig, mesh, stacked: bool,
                      batch_sharded: bool) -> dict:
    """Specs of one pattern position's state (optionally unit-stacked).

    With ``batch_sharded`` the batch dim is split over the data axes and
    each data shard keeps its own sequences' pages.  Otherwise (batch <
    dp) the *pages* are split over the data axes -- sequence parallelism
    -- and recurrent states are replicated over dp."""
    dp = data_axes(mesh)
    pre = (None,) if stacked else ()
    M = MODEL_AXIS
    bdp = dp if batch_sharded else None

    def mk(*s):
        return pre + s

    out = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        key = f"l{i}"
        if mixer in ("attn", "local_attn"):
            out[key] = {"k": mk(dp, M, None, None),
                        "v": mk(dp, M, None, None)}
            if cfg.kv_dtype == "int8":
                out[key]["ks"] = mk(dp, M, None)
                out[key]["vs"] = mk(dp, M, None)
        elif mixer == "mamba2":
            out[key] = {"h": mk(bdp, M, None, None),
                        "conv_x": mk(bdp, None, M),
                        "conv_bc": mk(bdp, None, None)}
        elif mixer == "rglru":
            out[key] = {"h": mk(bdp, M), "conv": mk(bdp, None, M)}
    return out


def dstate_specs(cfg: ModelConfig, mesh, batch_sharded: bool = True) -> dict:
    """Specs of the decode state (``serving/decode.py`` ``make_dstate``)."""
    dp = data_axes(mesh)
    if batch_sharded:
        pos_s, bt_s, kvp_s = (dp,), (dp, None), (dp, None, MODEL_AXIS)
    else:  # sequence parallelism: pages over dp, batch replicated
        pos_s, bt_s, kvp_s = (), (None, dp), (None, dp, MODEL_AXIS)
    specs = {"pos": pos_s, "block_table": bt_s, "kv_pos": kvp_s,
             "units": mixer_state_specs(cfg, mesh, True, batch_sharded)}
    tail = {}
    for i, _ in enumerate(cfg.tail_specs):
        sub = mixer_state_specs(cfg, mesh, False, batch_sharded)
        if f"l{i}" in sub:
            tail[f"t{i}"] = sub[f"l{i}"]
    specs["tail"] = tail
    return specs


def entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec``, a new
    contiguous tensor."""
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        n = axis_size(mesh, axes) if axes else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        c = x.shape[dim] // n
        x = x.narrow(dim, dp_linear_index(mesh, axes) * c, c)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh):
    """Global tensors -> this rank's blocks, leaf by leaf (``specs`` a tree
    of the same keys, or with more)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_block(tree, specs, mesh)


def gather_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The global tensor from every rank's block ``x`` under ``spec``, on
    every rank: an all-reduce over the mesh (which spans the process
    group) of a zero-filled global buffer, to which the ranks at
    coordinate 0 of each axis the spec leaves replicated add their block.
    Exact."""
    shape, index = list(x.shape), []
    used = set()
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        used.update(axes)
        n = axis_size(mesh, axes) if axes else 1
        i = dp_linear_index(mesh, axes) if axes else 0
        index.append(slice(i * x.shape[dim], (i + 1) * x.shape[dim]))
        shape[dim] *= n
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if all(axis_index(mesh, a) == 0 for a in axis_names(mesh)
           if a not in used):
        out[tuple(index)] = x
    return psum(out, mesh, axis_names(mesh))


def gather_tree(tree, specs, mesh):
    """``gather_block`` over a tree: every leaf global, on every rank."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, specs[k], mesh) for k, v in tree.items()}
    return gather_block(tree, specs, mesh)
