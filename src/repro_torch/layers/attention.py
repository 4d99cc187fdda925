"""Grouped-query attention over a full sequence (training / prefill).

Ports of the reference's ``layers/attention.py`` full-sequence functions.
The projections stay ``torch.matmul``, as the reference leaves them to
XLA.  On a CUDA tensor the ``"chunked"`` (the reference's default) and
``"pallas"`` implementations both run the ``flash_attention`` autograd
Function -- they compute the same function, and its gradient is the
backward kernel; on a CPU tensor ``"chunked"`` is the reference's
differentiable online-softmax loop over KV chunks and ``"pallas"`` the
Function's plain versions.  ``"naive"`` is the dense path everywhere.  The
one-token decode half lives in ``serving/tp_layers.py``.
"""

from __future__ import annotations

import torch

from ..kernels.flash_attention.kernel import flash_attention
from .rope import apply_rope

NEG_INF = -1e30


def _qkv(cfg, p, x, positions):
    """q [B, S, H, dh], k/v [B, S, K, dh] (RoPE applied)."""
    B, S, _ = x.shape
    h, k, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.matmul(x, p["wq"])
    kk = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, kk, v = q + p["bq"], kk + p["bk"], v + p["bv"]
    q = q.reshape(B, S, h, dh)
    kk = kk.reshape(B, S, k, dh)
    v = v.reshape(B, S, k, dh)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        kk = apply_rope(kk, positions, cfg.rope_theta)
    return q, kk, v


def full_attention(cfg, p, x, positions, *, causal: bool = True,
                   window: int = 0):
    """Dense attention.  Returns (out [B, S, D], (k, v))."""
    B, S, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    q, k, v = _qkv(cfg, p, x, positions)
    qg = q.reshape(B, S, kvh, g, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    scores = scores * (dh ** -0.5)
    ii = positions[:, :, None]
    jj = positions[:, None, :]
    mask = torch.ones((1, S, S), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask & (jj <= ii)
    if window:
        mask = mask & (jj > ii - window)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    out = out.reshape(B, S, h * dh)
    return torch.matmul(out, p["wo"]), (k, v)


def chunked_attention(cfg, p, x, positions, *, causal: bool = True,
                      window: int = 0, kv_chunk: int = 256):
    """Online-softmax attention over KV chunks (never the S x S scores).
    On a CUDA tensor this is the ``flash_attention`` kernel."""
    if x.device.type == "cuda":
        return pallas_attention(cfg, p, x, positions, causal=causal,
                                window=window)
    B, S, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // kvh
    q, k, v = _qkv(cfg, p, x, positions)
    C = min(kv_chunk, S)
    while S % C:
        C -= 1
    qg = (q.reshape(B, S, kvh, g, dh) * (dh ** -0.5)).float()
    m = torch.full((B, S, kvh, g), NEG_INF, dtype=torch.float32,
                   device=x.device)
    l = torch.zeros((B, S, kvh, g), dtype=torch.float32, device=x.device)
    acc = torch.zeros((B, S, kvh, g, dh), dtype=torch.float32,
                      device=x.device)
    for c0 in range(0, S, C):
        kb = k[:, c0:c0 + C].float()
        vb = v[:, c0:c0 + C].float()
        kp = positions[:, c0:c0 + C]
        s = torch.einsum("bskgd,bckd->bskgc", qg, kb)
        valid = torch.ones((B, S, C), dtype=torch.bool, device=x.device)
        if causal:
            valid = valid & (kp[:, None, :] <= positions[:, :, None])
        if window:
            valid = valid & (kp[:, None, :] > positions[:, :, None] - window)
        s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
        m2 = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m2)
        e = torch.exp(s - m2[..., None])
        l = l * corr + e.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bskgc,bckd->bskgd", e, vb)
        m = m2
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).to(x.dtype)
    out = out.reshape(B, S, h * dh)
    return torch.matmul(out, p["wo"]), (k, v)


def pallas_attention(cfg, p, x, positions, *, causal: bool = True,
                     window: int = 0):
    """Attention through the ``flash_attention`` Function (the forward and
    backward kernels on CUDA).  Positions are the sequence index, as the
    kernel assumes."""
    B, S, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x, positions)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=causal,
                          window=window)
    out = out.transpose(1, 2).reshape(B, S, h * dh)
    return torch.matmul(out, p["wo"]), (k, v)


def attention_fwd(cfg, p, x, positions, *, causal: bool = True,
                  window: int = 0):
    """Dispatch on ``cfg.attn_impl``: 'chunked' (default), 'naive',
    'pallas'."""
    impl = getattr(cfg, "attn_impl", "chunked")
    if impl == "naive":
        return full_attention(cfg, p, x, positions, causal=causal,
                              window=window)
    if impl == "pallas":
        return pallas_attention(cfg, p, x, positions, causal=causal,
                                window=window)
    return chunked_attention(cfg, p, x, positions, causal=causal,
                             window=window)
