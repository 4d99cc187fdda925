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

from ..distributed.collectives import copy_to_model, model_index, \
    model_part, model_size, row_parallel, unit_ranges
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
    """[k0, k1): the KV heads model rank ``r``'s query heads (its range of
    ``unit_ranges(H, tp)``) read; query head i reads KV head i // (H / K).
    Raises where a rank would hold no query head."""
    q0, q1 = unit_ranges(H, tp)[r]
    g = H // K
    return q0 // g, (q1 - 1) // g + 1


def kv_map_of_rank(H: int, K: int, tp: int, r: int):
    """None where rank ``r``'s query heads read their KV heads as the flash
    kernels take them (local head j reads j // (hl / kl)); else each local
    query head's local KV head, by which ``attention_tp`` repeats wk /
    wv's columns (unequal parts of groups: 10 heads on 2 KV heads at tp 3,
    rank 1's heads 3, 4 read KV head 0, head 5 KV head 1)."""
    q0, q1 = unit_ranges(H, tp)[r]
    k0, k1 = kv_heads_of_rank(H, K, tp, r)
    hl, kl, g = q1 - q0, k1 - k0, H // K
    idx = [(q0 + j) // g - k0 for j in range(hl)]
    if hl % kl == 0 and idx == [j // (hl // kl) for j in range(hl)]:
        return None
    return idx


def attention_tp(cfg, p, x, positions, *, causal: bool = True,
                 window: int = 0, mesh=None):
    """This model rank's heads of the layer (Megatron-style): ``x``
    replicated over ``model``; the rank's query heads by the plan
    (``unit_ranges``), wq / wk / wv its columns of them and of the KV
    heads they read, the replicated biases sliced alike (``model_part``:
    the rank's block, or the leaf gathered over ``model`` --
    starcoder2-3b's 2 KV heads at tp 4, qwen2.5-32b's 40 heads at tp 16
    -- or replicated, and sliced; the ranks sharing a leaf sum its
    gradient); ``wo`` its rows of the heads, row-parallel (fp32 partials
    summed over ``model`` and rounded once).  Where the rank's heads
    read unequal parts of groups, wk / wv (and bk / bv) take one column
    block a query head (``kv_map_of_rank``; the index_select's backward
    sums the blocks' gradients) and the attention runs as MHA on the
    rank's heads: one flash launch a layer all the same.  ``p`` is the
    layer's leaves gathered over ``data``; (k, v) come back for this
    rank's KV heads, one a query head where repeated."""
    H, K, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tp, r = model_size(mesh), model_index(mesh)
    qr = unit_ranges(H, tp)
    kr = [kv_heads_of_rank(H, K, tp, i) for i in range(tp)]
    (q0, q1), (k0, k1) = qr[r], kr[r]
    loc = {"wq": model_part(p["wq"], -1, H * dh, qr, dh, mesh)}
    for w in ("wk", "wv"):
        loc[w] = model_part(p[w], -1, K * dh, kr, dh, mesh)
    if cfg.qkv_bias:
        loc["bq"] = model_part(p["bq"], -1, H * dh, qr, dh, mesh)
        for b in ("bk", "bv"):
            loc[b] = model_part(p[b], -1, K * dh, kr, dh, mesh)
    wo = model_part(p["wo"], 0, H * dh, qr, dh, mesh)
    kl = k1 - k0
    idx = kv_map_of_rank(H, K, tp, r)
    if idx is not None:
        idx = torch.tensor(idx, dtype=torch.long, device=x.device)
        for w in ("wk", "wv", "bk", "bv"):
            if w in loc:
                loc[w] = loc[w].unflatten(-1, (kl, dh)).index_select(
                    -2, idx).flatten(-2)
        kl = q1 - q0
    lcfg = dataclasses.replace(cfg, num_heads=q1 - q0, num_kv_heads=kl)
    out, kv = attention_heads(lcfg, loc, copy_to_model(x, mesh), positions,
                              causal=causal, window=window)
    return row_parallel(out, wo, mesh), kv
