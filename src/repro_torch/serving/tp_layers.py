"""Decode layers on one device (the reference's ``serving/tp_layers.py``
at tensor-parallel degree 1, where every ``psum`` / ``pmax`` is the
identity).

Between its QKV matmuls and its paged attention the decode layer makes
one call, ``rope_kv_append`` (bias, RoPE, page/slot lookup and the K/V
write), then ``paged_attention``: the CUDA kernels on a CUDA tensor,
their plain versions on a CPU tensor.  The projections stay
``torch.matmul``, as the reference leaves them to XLA outside any Pallas
kernel.  The MoE feed-forward (``moe_decode_tp``) and the recurrent
mixers (``mamba2_decode_tp``, ``rglru_decode_tp``) are plain PyTorch, as
the reference writes them in ``jnp``.  The mixers round as the
reference's ``_tp`` versions do, which differ from its layer functions,
and update the lane states IN PLACE, as the arenas are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.kv_update.kernel import rope_kv_append
from ..kernels.paged_attention.kernel import paged_attention, \
    valid_positions
from ..layers.common import conv_step, unembed
from ..layers.rglru import gate_coeffs
from ..layers.ssd import mamba2_step


def embed_tp(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather; ids outside the vocabulary give zero rows (the
    reference's vocab-parallel mask at one shard)."""
    V = table.shape[0]
    ok = (tokens >= 0) & (tokens < V)
    rows = table[torch.clamp(tokens, 0, V - 1).long()]
    return torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                      device=table.device))


def logits_tp(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits [B, V] in fp32."""
    return unembed(x, table)


def greedy_sample_tp(logits: torch.Tensor) -> torch.Tensor:
    """Greedy token (first index of the max, as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=1).to(torch.int32)


def attn_decode_tp(cfg, p: dict, x: torch.Tensor, pos: torch.Tensor,
                   arena_k: torch.Tensor, arena_v: torch.Tensor,
                   block_table: torch.Tensor, *, freqs, lengths,
                   window: int = 0, scales=None):
    """One-token paged attention (KV in the model dtype, or int8).

    x:           [B, D]
    arena_k/v:   [pages, page, K, dh], the last page the dump page;
                 updated IN PLACE with this token's K/V
    scales:      None, or for int8 arenas (``cfg.kv_dtype == "int8"``)
                 the fp32 scale arenas (ks, vs) [pages, page, K], updated
                 IN PLACE with the new rows' scales (KIVI-style: a scale
                 per slot and KV head, quantized on write, dequantized on
                 gather inside the kernels)
    block_table: int32 [B, P] page ids (-1 unused)
    freqs:       ``rope_freqs(dh, theta)`` on x's device; None without
                 RoPE
    lengths:     int32 ``pos + 1``
                 (``decode_step`` computes both once a step, for every
                 layer)

    The new token's K/V land at page ``block_table[b, pos // page]``,
    slot ``pos % page`` (page id < 0 → the dump page).  The attention
    reads ``lengths`` positions through the block table; this agrees with
    the reference's per-slot ``kv_pos <= pos`` mask while pages fill
    contiguously (the engine contract).  With a window, a lane left with
    no valid position gets the mean of the V rows, as the reference's
    layer gives it (``windowed_empty_lanes``).  Returns y [B, D].
    """
    B, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim

    q = torch.matmul(x, p["wq"])
    k_new = torch.matmul(x, p["wk"])
    v_new = torch.matmul(x, p["wv"])
    bias = (p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else (None,) * 3
    q = rope_kv_append(q, k_new, v_new, *bias, freqs, pos, block_table,
                       arena_k, arena_v, scales)
    out = paged_attention(q, arena_k, arena_v, block_table, lengths,
                          window=window, scales=scales)
    if window:
        out = windowed_empty_lanes(out, arena_v, block_table, lengths,
                                   window, None if scales is None
                                   else scales[1])
    return torch.matmul(out.reshape(B, h * dh).to(x.dtype), p["wo"])


def windowed_empty_lanes(out, arena_v, block_table, lengths, window: int,
                         v_scale=None):
    """A windowed decode past its table (``pos >= P * page + window - 1``)
    leaves a lane no valid position.  The reference's layer then weighs
    every gathered row alike (its masked scores are all -1e30, so
    ``exp(s - max) = 1``): its output is the mean of the ``P * page`` V
    rows of the lane's table, a -1 page read as the dump page, summed in
    V's dtype and divided in fp32.  Gives such lanes that mean (the
    kernel gives them 0) and leaves the others' ``out`` as it is.  int8
    rows (``v_scale`` their fp32 scales) are dequantized first, as the
    reference dequantizes what it gathers: ``(v.float() * s)`` in the
    model dtype (``out``'s), which then is V's dtype."""
    B, H, dh = out.shape
    npages, page, K, _ = arena_v.shape
    P = block_table.shape[1]
    empty = ~valid_positions(block_table, lengths, page, window).any(dim=1)
    bt = torch.where(block_table < 0, npages - 1, block_table).long()
    rows = arena_v[bt].reshape(B, P * page, K, dh)
    if v_scale is not None:
        rows = (rows.float() * v_scale[bt].reshape(B, P * page, K, 1)).to(
            out.dtype)
    acc = rows.float().sum(dim=1).to(rows.dtype)
    mean = (acc.float() / (P * page)).to(out.dtype)
    mean = mean.repeat_interleave(H // K, dim=1)            # [B, H, dh]
    return torch.where(empty[:, None, None], mean, out)


def moe_decode_tp(cfg, p: dict, x: torch.Tensor):
    """One-token MoE feed-forward (the reference's ``moe_decode_tp`` at
    TP = 1): every expert, the padded ones included, runs densely over the
    B tokens; the top-k gates, scattered into [B, E] and padded with zeros
    to ``wi.shape[0]`` experts, weigh the combine in fp32.  No capacity,
    no drop, and no value read back to the host.  (Without SwiGLU the
    reference's decode applies GELU, whatever ``cfg.mlp`` says; so does
    this.)  Returns y [B, D] in x's dtype."""
    E = p["wi"].shape[0]
    probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
    gate, expert = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros((x.shape[0], E), dtype=torch.float32,
                        device=x.device).scatter_add_(1, expert, gate)
    h = torch.matmul(x, p["wi"])                            # [E, B, f]
    if cfg.mlp == "swiglu":
        g = torch.matmul(x, p["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.matmul(h, p["wo"])                            # [E, B, D]
    return torch.einsum("ebd,be->bd", y.float(), gates).to(x.dtype)


def _store(state: dict, new: dict) -> None:
    """Write a mixer's new recurrent state into its decode-state views."""
    for k, v in new.items():
        state[k].copy_(v)


def mamba2_decode_tp(cfg, p: dict, x: torch.Tensor, state: dict):
    """One-token Mamba-2 update (the reference's ``mamba2_decode_tp`` at
    TP = 1).  Its gated RMS norm divides ``sum(y * y)`` by d_inner, where
    the layer function takes a mean.  ``state`` ({"h", "conv_x",
    "conv_bc"}, fp32) is updated in place.  Returns y [B, D]."""
    y, z, new = mamba2_step(cfg, p, x, state)
    y = y * F.silu(z.float())
    ssq = torch.sum(y * y, dim=-1, keepdim=True) / y.shape[1]
    y = y * torch.rsqrt(ssq + 1e-6) * p["norm_w"]
    _store(state, new)
    return torch.matmul(y.to(x.dtype), p["out_proj"])


def rglru_decode_tp(cfg, p: dict, x: torch.Tensor, state: dict):
    """One-token RG-LRU update (the reference's ``rglru_decode_tp`` at
    TP = 1).  The gate matmuls take the convolution cast to x's dtype but
    the input gate multiplies the fp32 convolution (the layer function
    casts it first).  ``state`` ({"h", "conv"}, fp32) is updated in
    place.  Returns y [B, D]."""
    xr = torch.matmul(x, p["in_x"]).float()
    xg = torch.matmul(x, p["in_g"])
    hist = torch.cat([state["conv"], xr[:, None, :]], dim=1)
    conv = conv_step(hist, p["conv_w"], p["conv_b"])
    cx = conv.to(x.dtype)
    a, b = gate_coeffs(p, torch.matmul(cx, p["wa"]), torch.matmul(cx, p["wx"]),
                       conv)
    h = a * state["h"] + b
    y = h * F.gelu(xg.float(), approximate="tanh")
    _store(state, {"h": h, "conv": hist[:, 1:]})
    return torch.matmul(y.to(x.dtype), p["out"])
