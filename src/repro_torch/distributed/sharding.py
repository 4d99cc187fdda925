"""Sharding rules of the training layout: 2-D "FSDP x TP".

Copies of the reference's ``distributed/sharding.py`` training rules:

  * the batch over the data axes (every axis but ``model``);
  * weight matrices sharded TP over ``model`` on their head / ffn dim and
    FSDP over ``data`` on the other dim (ZeRO-3: the AdamW moments follow
    their parameters);
  * the embeddings vocab-sharded over ``model`` where it divides.

Every rule is checked against the actual dim: an axis that does not
divide its dim is dropped (internvl2's vocabulary of 92553 stays
unsharded on ``model``).  A spec is a plain tuple, as in ``specs.py``:
one entry a dim, each ``None``, an axis name or a tuple of axis names.

A ``mesh`` here is a ``DeviceMesh``, or anything that maps axis names to
sizes: a dict such as ``{"data": 16, "model": 16}`` stands for a mesh no
process group spans (the production layout, in tests).  Paths take the
reference's form (``units/l0/attn/wq``) or the port's ``init_params``
form with a leading ``/``; both give the same spec.

The reference's two MoE layout switches (environment variables that
replicate the experts over ``data`` or move their FSDP dim) are not
copied: MoE on a mesh is ROADMAP A8b (2).
"""

from __future__ import annotations

from .mesh import MODEL_AXIS

DATA_AXIS = "data"


def axis_sizes(mesh) -> dict:
    """{axis name: ranks} of a ``DeviceMesh`` or of a dict of sizes."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _fit(spec: tuple, shape, mesh) -> tuple:
    """Drop axis names that do not evenly divide their dim."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a]
        out.append(entry if i < len(shape) and shape[i] % size == 0
                   else None)
    return tuple(out)


def train_param_spec(path: str, shape, mesh, dp: str = DATA_AXIS,
                     tp: str = MODEL_AXIS) -> tuple:
    """The spec of the leaf at ``path`` with global ``shape``."""
    last = path.split("/")[-1]
    lead = 1 if path.startswith("units/") or "/units/" in f"/{path}" else 0
    pre = (None,) * lead

    def mk(*s):
        full = pre + s + (None,) * (len(shape) - lead - len(s))
        return _fit(full, shape, mesh)

    if "attn" in path:
        if last in ("wq", "wk", "wv"):
            return mk(dp, tp)
        if last == "wo":
            return mk(tp, dp)
        return mk()                                   # biases
    if "ffn" in path:
        if last == "router":
            return mk(dp, None)
        if len(shape) - lead == 3:                    # moe experts [E, ., .]
            if last in ("wi", "wg"):
                return mk(tp, dp, None)
            return mk(tp, None, dp)
        if last in ("wi", "wg"):
            return mk(dp, tp)
        return mk(tp, dp)                             # wo
    if "ssd" in path:
        if last in ("in_z", "in_x", "in_dt"):
            return mk(dp, tp)
        if last == "in_bc":
            return mk(dp, None)
        if last == "conv_x_w":
            return mk(None, tp)
        if last in ("conv_x_b", "norm_w", "A_log", "dt_bias", "D"):
            return mk(tp)
        if last == "out_proj":
            return mk(tp, dp)
        return mk()
    if "rglru" in path:
        if last in ("in_x", "in_g"):
            return mk(dp, tp)
        if last == "conv_w":
            return mk(None, tp)
        if last in ("conv_b", "lam"):
            return mk(tp)
        if last in ("wa", "wx"):
            return mk(dp, tp)
        if last == "out":
            return mk(tp, dp)
        return mk()
    if last in ("embed", "unembed"):
        return _fit((tp, dp), shape, mesh)
    return mk()                                       # norms etc.


def tree_path_map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a nested dict, paths as ``units/l0/...``."""
    if isinstance(tree, dict):
        return {k: tree_path_map(fn, v, f"{path}/{k}".lstrip("/"))
                for k, v in tree.items()}
    return fn(path, tree)


def train_param_specs(params_shape, mesh) -> dict:
    """The spec of every leaf of ``params_shape`` (any tree of objects
    with a global ``shape``: tensors, meta tensors)."""
    return tree_path_map(
        lambda path, leaf: train_param_spec(path, tuple(leaf.shape), mesh),
        params_shape)


def model_train_specs(cfg, mesh) -> dict:
    """``train_param_specs`` of ``cfg``'s parameter tree on ``mesh``."""
    from ..models.params import param_shapes
    return train_param_specs(param_shapes(cfg), mesh)


def data_axes_of(mesh) -> tuple[str, ...]:
    """Every axis but ``model``, in mesh order."""
    return tuple(a for a in axis_sizes(mesh) if a != MODEL_AXIS)


def batch_spec(mesh) -> tuple:
    """The batch's dim 0 over the data axes."""
    return (data_axes_of(mesh),)


def make_batch_constrainer(mesh, local_batch: int | None = None):
    """f(x) for dim 0 of the activations at every unit boundary.

    The reference pins dim 0 to the data axes with a sharding constraint,
    because XLA's auto-SPMD may otherwise reshard an intermediate from
    batch-parallel to head-parallel.  In eager SPMD nothing reshards: a
    rank's activations are its batch shard by construction.  So here f
    checks that: it raises if dim 0 is not the local batch (a rank fed
    the global batch, or another rank's shard size), rather than passing
    x through unchecked.  Without a mesh it is the identity."""
    if mesh is None or local_batch is None:
        return lambda x: x

    def constrain(x):
        if x.shape[0] != local_batch:
            raise ValueError(f"activations of batch {x.shape[0]} on a rank "
                             f"whose batch shard is {local_batch}")
        return x

    return constrain


def opt_state_specs(params_specs) -> dict:
    """AdamW moments shard exactly like their parameters (ZeRO-3)."""
    return {"m": params_specs, "v": params_specs}
