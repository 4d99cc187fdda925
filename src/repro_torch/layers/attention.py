"""Grouped-query attention over a full sequence (training / prefill).

Ports of the reference's ``layers/attention.py`` full-sequence functions.
The projections stay ``torch.matmul``, as the reference leaves them to
XLA.  On a CUDA tensor the ``"chunked"`` (the reference's default) and
``"pallas"`` implementations both run the ``flash_attention`` autograd
Function -- they compute the same function, and its gradient is the
backward kernel; on a CPU tensor ``"chunked"`` is the reference's
differentiable online-softmax loop over KV chunks and ``"pallas"`` the
Function's plain versions.  ``"naive"`` is the dense path everywhere.  The
one-token decode half lives in ``serving/tp_layers.py``.  On a mesh of
the sharded train step, ``attention_tp`` runs one model rank's heads.
"""

from __future__ import annotations

import dataclasses

import torch

from ..distributed.collectives import copy_to_model, gather_model, \
    model_index, model_size, row_parallel
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
    out, kv = _full_heads(cfg, p, x, positions, causal, window)
    return torch.matmul(out, p["wo"]), kv


def _full_heads(cfg, p, x, positions, causal, window):
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
    return out.reshape(B, S, h * dh), (k, v)


def chunked_attention(cfg, p, x, positions, *, causal: bool = True,
                      window: int = 0, kv_chunk: int = 256):
    """Online-softmax attention over KV chunks (never the S x S scores).
    On a CUDA tensor this is the ``flash_attention`` kernel."""
    out, kv = _chunked_heads(cfg, p, x, positions, causal, window, kv_chunk)
    return torch.matmul(out, p["wo"]), kv


def _chunked_heads(cfg, p, x, positions, causal, window, kv_chunk=256):
    if x.device.type == "cuda":
        return _pallas_heads(cfg, p, x, positions, causal, window)
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
    return out.reshape(B, S, h * dh), (k, v)


def pallas_attention(cfg, p, x, positions, *, causal: bool = True,
                     window: int = 0):
    """Attention through the ``flash_attention`` Function (the forward and
    backward kernels on CUDA).  Positions are the sequence index, as the
    kernel assumes."""
    out, kv = _pallas_heads(cfg, p, x, positions, causal, window)
    return torch.matmul(out, p["wo"]), kv


def _pallas_heads(cfg, p, x, positions, causal, window):
    B, S, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x, positions)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(), causal=causal,
                          window=window)
    return out.transpose(1, 2).reshape(B, S, h * dh), (k, v)


def attention_heads(cfg, p, x, positions, *, causal: bool = True,
                    window: int = 0):
    """The heads' output before ``wo`` [B, S, H * dh] and (k, v), on
    ``cfg.attn_impl``: 'chunked' (default), 'naive', 'pallas'."""
    impl = getattr(cfg, "attn_impl", "chunked")
    if impl == "naive":
        return _full_heads(cfg, p, x, positions, causal, window)
    if impl == "pallas":
        return _pallas_heads(cfg, p, x, positions, causal, window)
    return _chunked_heads(cfg, p, x, positions, causal, window)


def attention_fwd(cfg, p, x, positions, *, causal: bool = True,
                  window: int = 0, mesh=None):
    """Attention on ``cfg.attn_impl``; with ``mesh`` (a model axis of
    more than one rank) this rank's heads of it (``attention_tp``)."""
    if mesh is not None:
        return attention_tp(cfg, p, x, positions, causal=causal,
                            window=window, mesh=mesh)
    out, kv = attention_heads(cfg, p, x, positions, causal=causal,
                              window=window)
    return torch.matmul(out, p["wo"]), kv


def kv_heads_of_rank(H: int, K: int, tp: int, r: int) -> tuple[int, int]:
    """[k0, k1): the KV heads model rank ``r``'s query heads read (query
    head i reads KV head i // (H / K)).  Raises where the rank's query
    heads do not split whole groups or fall inside one."""
    if H % tp:
        raise NotImplementedError(f"{H} query heads do not split over "
                                  f"model {tp}")
    hl, g = H // tp, H // K
    if hl % g and g % hl:
        raise NotImplementedError(f"{hl} query heads a rank straddle "
                                  f"groups of {g}")
    k0 = r * hl // g
    return k0, (r * hl + hl - 1) // g + 1


def attention_tp(cfg, p, x, positions, *, causal: bool = True,
                 window: int = 0, mesh=None):
    """This model rank's heads of the layer (Megatron-style): ``x``
    replicated over ``model``; wq / wk / wv this rank's columns (its
    query heads and the KV heads they read), the replicated biases sliced
    to them, ``wo`` row-parallel (fp32 partials summed over ``model`` and
    rounded once).  Where the KV heads do not split over ``model``
    (starcoder2-3b's 2 at tp 4), wk / wv are gathered over ``model`` and
    each rank takes the KV head its query heads read; the ranks sharing
    it sum its gradient (``gather_model``).  ``p`` is the layer's leaves
    gathered over ``data``; (k, v) come back for this rank's KV heads."""
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp, r = model_size(mesh), model_index(mesh)
    k0, k1 = kv_heads_of_rank(H, K, tp, r)
    hl = H // tp
    q0 = r * hl
    loc = {"wq": _model_cols(p["wq"], H * dh, q0 * dh, hl * dh, mesh)}
    for w in ("wk", "wv"):
        loc[w] = _model_cols(p[w], K * dh, k0 * dh, (k1 - k0) * dh, mesh)
    if cfg.qkv_bias:
        for b, lo, n in (("bq", q0, hl), ("bk", k0, k1 - k0),
                         ("bv", k0, k1 - k0)):
            loc[b] = copy_to_model(p[b], mesh)[..., lo * dh:(lo + n) * dh]
    lcfg = dataclasses.replace(cfg, num_heads=hl, num_kv_heads=k1 - k0)
    out, kv = attention_heads(lcfg, loc, copy_to_model(x, mesh), positions,
                              causal=causal, window=window)
    return row_parallel(out, p["wo"], mesh), kv


def _model_cols(w, whole: int, lo: int, n: int, mesh):
    """Columns [lo, lo + n) of a [D, whole] weight: this rank's block
    itself where the columns split over ``model`` into blocks of ``n``
    and the block is those; else the weight gathered over ``model``
    (replicated: marked so that its gradient is summed over ``model``)
    and sliced."""
    if w.shape[-1] == n and lo == model_index(mesh) * n:
        return w
    full = gather_model(w, w.dim() - 1, mesh) if w.shape[-1] < whole \
        else copy_to_model(w, mesh)
    return full[..., lo:lo + n]
