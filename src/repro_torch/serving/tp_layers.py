"""Decode layers on one device (the reference's ``serving/tp_layers.py``
at tensor-parallel degree 1, where every ``psum`` / ``pmax`` is the
identity).

The KV write and the paged attention go through the kernel wrappers:
the CUDA kernels on a CUDA tensor, their plain versions on a CPU tensor.
The projections stay ``torch.matmul``, as the reference leaves them to
XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.kv_update.kernel import kv_update
from ..kernels.paged_attention.kernel import paged_attention
from ..layers.common import unembed
from ..layers.rope import apply_rope


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
                   block_table: torch.Tensor, *, window: int = 0):
    """One-token paged attention (bf16/fp32 KV).

    x:           [B, D]
    arena_k/v:   [pages, page, K, dh], the last page the dump page;
                 updated IN PLACE with this token's K/V
    block_table: int32 [B, P] page ids (-1 unused)

    The new token's K/V land at page ``block_table[b, pos // page]``,
    slot ``pos % page`` (page id < 0 → the dump page).  The attention
    reads ``lengths = pos + 1`` positions through the block table; this
    agrees with the reference's per-slot ``kv_pos <= pos`` mask while
    pages fill contiguously (the engine contract).  Returns y [B, D].
    """
    if cfg.kv_dtype == "int8":
        raise NotImplementedError("int8 KV decode is not ported yet")
    B, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page = arena_k.shape[1]
    P = block_table.shape[1]

    q = torch.matmul(x, p["wq"])
    k_new = torch.matmul(x, p["wk"])
    v_new = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k_new, v_new = q + p["bq"], k_new + p["bk"], v_new + p["bv"]
    q = q.reshape(B, h, dh)
    k_new = k_new.reshape(B, kvh, dh)
    v_new = v_new.reshape(B, kvh, dh)
    if cfg.use_rope:
        q = apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], pos[:, None],
                           cfg.rope_theta)[:, 0]

    slot = (pos % page).to(torch.int32)
    lpage = (pos // page).long()
    in_table = lpage < P
    pid = torch.gather(block_table, 1,
                       torch.clamp(lpage, max=P - 1)[:, None])[:, 0]
    pid = torch.where(in_table, pid, -1).to(torch.int32)
    kv_update(arena_k, arena_v, k_new.to(arena_k.dtype).contiguous(),
              v_new.to(arena_v.dtype).contiguous(), pid, slot)

    out = paged_attention(q.contiguous(), arena_k, arena_v, block_table,
                          (pos + 1).to(torch.int32), window=window)
    return torch.matmul(out.reshape(B, h * dh).to(x.dtype), p["wo"])


def mlp_decode_tp(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.matmul(x, p["wi"])
    if cfg.mlp == "swiglu":
        gg = torch.matmul(x, p["wg"])
        h = F.silu(gg.float()).to(x.dtype) * h
    elif cfg.mlp == "squared_relu":
        h = torch.square(torch.relu(h))
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.matmul(h, p["wo"])
