"""Feed-forward variants (forward): ``swiglu``, ``squared_relu``, ``gelu``.

Port of the reference's ``layers/mlp.py`` ``apply_mlp``: SiLU and GELU
(tanh form, ``jax.nn.gelu``'s default) are evaluated in fp32 and cast
back to the activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def apply_mlp(cfg, p, x):
    return torch.matmul(mlp_hidden(cfg, p, x), p["wo"])
