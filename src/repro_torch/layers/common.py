"""Norms, embedding and unembedding, and the depthwise causal convolution
of the recurrent mixers.

Ports of the reference's ``layers/common.py``: the norm statistics come
from an fp32 row sum and are cast back to the input dtype before scaling,
as in the reference.  ``rmsnorm`` and ``layernorm`` are autograd Functions
whose backward is the reference's custom VJP (``_rms_bwd``, ``_ln_bwd``)
op for op, with its casts: every [.., D] tensor in x's dtype, the row
sums and the weight (and bias) gradients summed in fp32 and cast to the
weight's dtype.  ``embed`` takes a mesh for the vocab-parallel
embedding of the sharded train step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import model_index, reduce_from_model


def _f32_rowsum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() * b.float()).sum(-1)


def _f32_colsum(a: torch.Tensor, b: torch.Tensor | None = None):
    """sum over every leading dim of a (* b), fp32: [D]."""
    a = a.float() if b is None else a.float() * b.float()
    return a.reshape(-1, a.shape[-1]).sum(0)


def _rms_inv(x, eps):
    xf = x.float()
    return torch.rsqrt((xf * xf).sum(-1) / x.shape[-1] + eps)


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        inv = _rms_inv(x, eps)
        ctx.save_for_backward(x, w, inv)
        return x * inv[..., None].to(x.dtype) * w.to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, w, inv = ctx.saved_tensors
        d = x.shape[-1]
        t = ct * w.to(x.dtype)
        dot = _f32_rowsum(t, x)
        coef = (inv ** 3 * dot / d)[..., None].to(x.dtype)
        dx = t * inv[..., None].to(x.dtype) - x * coef
        xhat = x * inv[..., None].to(x.dtype)
        dw = _f32_colsum(ct, xhat).to(w.dtype)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    return _RMSNorm.apply(x, w, eps)


def _ln_stats(x, eps):
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1) / d
    ssq = (xf * xf).sum(-1) / d
    inv = torch.rsqrt(ssq - mu * mu + eps)
    xhat = (x - mu[..., None].to(x.dtype)) * inv[..., None].to(x.dtype)
    return xhat, mu, inv


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, eps):
        xhat, mu, inv = _ln_stats(x, eps)
        ctx.save_for_backward(x, w, mu, inv)
        return xhat * w.to(x.dtype) + b.to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        x, w, mu, inv = ctx.saved_tensors
        d = x.shape[-1]
        xhat = (x - mu[..., None].to(x.dtype)) * inv[..., None].to(x.dtype)
        t = ct * w.to(x.dtype)
        m1 = (t.float().sum(-1) / d)[..., None]
        m2 = (_f32_rowsum(t, xhat) / d)[..., None]
        dx = (t - m1.to(x.dtype) - xhat * m2.to(x.dtype)) \
            * inv[..., None].to(x.dtype)
        dw = _f32_colsum(ct, xhat).to(w.dtype)
        db = _f32_colsum(ct).to(w.dtype)
        return dx, dw, db, None


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    return _LayerNorm.apply(x, w, b, eps)


def apply_norm(kind: str, p: dict, x: torch.Tensor):
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def embed(tokens: torch.Tensor, table: torch.Tensor, mesh=None):
    """Rows of ``table`` for ``tokens``.  With ``mesh`` the table is this
    model rank's rows of the vocabulary (vocab-parallel): ids outside
    them give zero rows, and the ranks' rows are summed over ``model``
    (exact: one of them is not zero)."""
    if mesh is None:
        return table[tokens.long()]
    V = table.shape[0]
    local = tokens.long() - model_index(mesh) * V
    ok = (local >= 0) & (local < V)
    rows = table[local.clamp(0, V - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros(
        (), dtype=table.dtype, device=table.device))
    return reduce_from_model(rows, mesh)


def unembed(x: torch.Tensor, table: torch.Tensor):
    """Logits against a [V, D] table, returned in fp32.  In fp32 the
    product is fp32 throughout; in bf16 the matmul's output is rounded to
    bf16 before the cast (the reference accumulates into fp32)."""
    return torch.matmul(x, table.t()).float()


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Depthwise causal conv1d over u [B, S, C] with taps w [W, C], plus
    b: the taps summed one by one in u's dtype, the reference's order of
    rounding (Mamba-2's and RG-LRU's full-sequence convolutions)."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0]
    for k in range(1, W):
        out = out + pad[:, k:k + S] * w[k]
    return out + b


def conv_step(hist: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """One position of the same convolution in decode: hist [B, W, C]
    (fp32, the newest input last) against w, plus b, in fp32."""
    return (hist * w.float()).sum(dim=1) + b.float()
