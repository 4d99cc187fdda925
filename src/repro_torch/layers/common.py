"""Norms, embedding and unembedding (forward only).

Ports of the reference's ``layers/common.py`` forward numerics: the norm
statistics come from an fp32 row sum and are cast back to the input
dtype before scaling, as in the reference.
"""

from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    inv = torch.rsqrt((xf * xf).sum(-1) / x.shape[-1] + eps)
    return x * inv[..., None].to(x.dtype) * w.to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1) / d
    ssq = (xf * xf).sum(-1) / d
    inv = torch.rsqrt(ssq - mu * mu + eps)
    xhat = (x - mu[..., None].to(x.dtype)) * inv[..., None].to(x.dtype)
    return xhat * w.to(x.dtype) + b.to(x.dtype)


def apply_norm(kind: str, p: dict, x: torch.Tensor):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def embed(tokens: torch.Tensor, table: torch.Tensor):
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor):
    """Logits against a [V, D] table, returned in fp32.  In fp32 the
    product is fp32 throughout; in bf16 the matmul's output is rounded to
    bf16 before the cast (the reference accumulates into fp32)."""
    return torch.matmul(x, table.t()).float()
