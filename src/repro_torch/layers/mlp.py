"""Feed-forward variants (forward): ``swiglu``, ``squared_relu``, ``gelu``.

Port of the reference's ``layers/mlp.py`` ``apply_mlp``: SiLU and GELU
(tanh form, ``jax.nn.gelu``'s default) are evaluated in fp32 and cast
back to the activation dtype.  On a mesh whose ``model`` axis has more
than one rank, ``apply_mlp(..., mesh=)`` runs this rank's columns of the
ffn dim by the plan (``unit_ranges``, uneven where d_ff does not divide):
wi / wg column-parallel on the replicated input, ``wo`` its rows,
row-parallel (``distributed/collectives.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_to_model, model_part, \
    model_size, row_parallel, unit_ranges


def mlp_hidden(cfg, p, x):
    """The activation before the output projection ``wo``."""
    h = torch.matmul(x, p["wi"])
    if cfg.mlp == "swiglu":
        g = torch.matmul(x, p["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    elif cfg.mlp == "squared_relu":
        h = torch.square(torch.relu(h))
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h


def apply_mlp(cfg, p, x, mesh=None):
    if mesh is None:
        return torch.matmul(mlp_hidden(cfg, p, x), p["wo"])
    f = cfg.d_ff
    cols = unit_ranges(f, model_size(mesh))
    loc = {w: model_part(p[w], -1, f, cols, 1, mesh)
           for w in ("wi", "wg") if w in p}
    wo = model_part(p["wo"], 0, f, cols, 1, mesh)
    return row_parallel(mlp_hidden(cfg, loc, copy_to_model(x, mesh)), wo,
                        mesh)
