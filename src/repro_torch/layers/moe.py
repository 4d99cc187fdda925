"""Mixture-of-experts feed-forward with top-k routing (forward):
granite-moe-3b-a800m, moonshot-v1-16b-a3b.

Port of the reference's ``layers/moe.py``.  Dispatch is argsort-based
with a static per-expert capacity (GShard-style token dropping): a
stable argsort of the (token, choice) assignments by expert, each
assignment's rank in its expert's queue from ``searchsorted``, the
assignments past the capacity sent to a dump slot and dropped.  The same
sort, ranks and dump slot as the reference, so the same tokens drop.
The expert products are batched ``torch.matmul`` over the real experts
(``w[:E]``: padded experts take no token), as the reference leaves them
to XLA outside any Pallas kernel.  SiLU and GELU run in fp32 and are cast
back to the activation dtype; the combine is fp32.  No step reads a
value back to the host.  The one-token decode half is
``serving/tp_layers.py::moe_decode_tp``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route(cfg, p, x: torch.Tensor):
    """Router of x [B, S, D]: (gate fp32 [B, S, K] normalised to sum 1,
    expert int64 [B, S, K] in descending probability, aux), with aux the
    Switch load-balancing loss E * sum_e f_e * P_e."""
    E, K = cfg.num_experts, cfg.top_k
    probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
    gate, expert = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    flat = expert.reshape(-1)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=x.device)) / flat.numel()
    return gate, expert, E * torch.sum(me * ce)


def capacity(capacity_factor: float, n: int, E: int) -> int:
    """Slots per expert for ``n`` (token, choice) assignments (Python's
    ``round``, as the reference)."""
    return int(max(1, round(capacity_factor * n / E)))


def dispatch(flat_e: torch.Tensor, E: int, cap: int):
    """flat_e [R, N]: each row's assignments' experts, token-major.
    Returns (keep bool [R, N], slot int64 [R, N]): an assignment is kept
    when fewer than ``cap`` earlier assignments of its row chose its
    expert; a kept one goes to slot ``expert * cap + rank``, a dropped one
    to the dump slot ``E * cap``."""
    R, N = flat_e.shape
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, dtype=flat_e.dtype, device=flat_e.device)
    start = torch.searchsorted(sorted_e, experts.expand(R, E).contiguous())
    seq = torch.arange(N, dtype=torch.int64, device=flat_e.device)
    ranks = torch.empty_like(flat_e).scatter_(
        1, order, seq[None] - torch.gather(start, 1, sorted_e))
    keep = ranks < cap
    slot = torch.where(keep, flat_e * cap + ranks, E * cap)
    return keep, slot


def expert_ffn(cfg, p, buf: torch.Tensor, E: int) -> torch.Tensor:
    """buf [..., E, cap, D] through each real expert's feed-forward."""
    h = torch.matmul(buf, p["wi"][:E])
    if cfg.mlp == "swiglu":
        g = torch.matmul(buf, p["wg"][:E])
        h = F.silu(g.float()).to(buf.dtype) * h
    elif cfg.mlp == "squared_relu":
        h = torch.square(torch.relu(h))
    else:
        h = F.gelu(h.float(), approximate="tanh").to(buf.dtype)
    return torch.matmul(h, p["wo"][:E])


def apply_moe(cfg, p, x, *, capacity_factor: float = 1.25):
    """Dispatch on ``cfg.moe_dispatch``: 'local' (per batch row, the
    default) or 'global'.  Returns (y [B, S, D] in x's dtype, aux)."""
    if cfg.moe_dispatch == "local":
        return apply_moe_local(cfg, p, x, capacity_factor=capacity_factor)
    return apply_moe_global(cfg, p, x, capacity_factor=capacity_factor)


def apply_moe_local(cfg, p, x, *, capacity_factor: float = 1.25):
    """Per-batch-row dispatch: each row sorts and fills its own expert
    queues, with a per-row capacity of cf * S * K / E."""
    B, S, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    N = S * K
    gate, expert, aux = route(cfg, p, x)
    cap = capacity(capacity_factor, N, E)
    keep, slot = dispatch(expert.reshape(B, N), E, cap)

    tok = torch.arange(S, device=x.device).repeat_interleave(K)     # [N]
    b_ix = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, E * cap + 1, D), dtype=x.dtype, device=x.device)
    buf[b_ix, slot] = x[:, tok]
    out = expert_ffn(cfg, p, buf[:, :-1].reshape(B, E, cap, D), E)
    out = out.reshape(B, E * cap, D)
    got = torch.gather(out, 1, torch.clamp(slot, max=E * cap - 1)[..., None]
                       .expand(B, N, D))
    got = torch.where(keep[..., None], got, 0).float()
    # the K choices of a token are adjacent: sum them per token
    y = (got * gate.reshape(B, N, 1)).reshape(B, S, K, D).sum(dim=2)
    return y.to(x.dtype), aux


def apply_moe_global(cfg, p, x, *, capacity_factor: float = 1.25):
    """The original dispatch: all B * S tokens sorted jointly, a capacity
    of cf * B * S * K / E.  That is the per-row dispatch over one row of
    every token (the same aux, capacity, ranks and combine)."""
    B, S, D = x.shape
    y, aux = apply_moe_local(cfg, p, x.reshape(1, B * S, D),
                             capacity_factor=capacity_factor)
    return y.reshape(B, S, D), aux
