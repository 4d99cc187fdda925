"""Full-sequence forward of the model stack: logits, hidden states and the
next-token loss (prefill, scoring and training).

Port of the reference's ``models/transformer.py``.  Layers are grouped
into pattern units whose parameters are stacked; the reference's
``lax.scan`` over units is a Python loop over the stacked leaves, each
unbound once a pass (``unbind(0)``), so that under autograd one ``stack``
forms a stacked leaf's gradient.  ``forward`` runs under
``torch.inference_mode()``; ``hidden_states``, ``chunked_ce`` and
``loss_fn`` are differentiable, and callers that only score wrap them in
``torch.no_grad()``.  With grad enabled and ``cfg.remat == "unit"`` each
pattern unit runs under ``torch.utils.checkpoint.checkpoint`` (the
reference's ``jax.checkpoint``): only unit inputs are kept, and the
backward recomputes a unit's forward.  Each CE chunk is checkpointed
whenever grad is on, whatever ``cfg.remat`` says, as in the reference.
Attention runs the ``flash_attention`` kernels and Mamba-2 the
``ssd_scan`` kernels (forward and backward each) on a CUDA tensor;
RG-LRU's scan is plain PyTorch
(``layers/rglru.py::linear_scan``), and so is the MoE dispatch
(``layers/moe.py``), whose load-balancing losses sum into ``aux``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers import attention, rglru, ssd
from ..layers.common import apply_norm, embed, unembed
from ..layers.mlp import apply_mlp
from ..layers.moe import apply_moe
from .config import ModelConfig


def _apply_layer(cfg: ModelConfig, spec, p, x, positions):
    """One (mixer, ffn) layer.  Returns (x, aux, kv) -- aux is the MoE
    load-balancing loss (0 for the other feed-forwards), kv the layer's
    (k, v) [B, S, K, dh] for attention mixers, else None."""
    mixer, ffn = spec
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = None
    h = apply_norm(cfg.norm, p["norm1"], x)
    if mixer == "attn":
        h, kv = attention.attention_fwd(cfg, p["attn"], h, positions,
                                        causal=cfg.causal, window=0)
    elif mixer == "local_attn":
        h, kv = attention.attention_fwd(cfg, p["attn"], h, positions,
                                        causal=cfg.causal, window=cfg.window)
    elif mixer == "mamba2":
        h = ssd.mamba2_forward(cfg, p["ssd"], h)
    elif mixer == "rglru":
        h = rglru.rglru_forward(cfg, p["rglru"], h)
    else:
        raise NotImplementedError(f"unknown mixer {mixer!r}")
    x = x + h
    if ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if ffn == "moe":
            h, aux = apply_moe(cfg, p["ffn"], h,
                               capacity_factor=cfg.capacity_factor)
        else:
            h = apply_mlp(cfg, p["ffn"], h)
        x = x + h
    return x, aux, kv


def _unbind(params: dict, n: int) -> list[dict]:
    """The stacked unit parameters as ``n`` per-unit trees: each leaf
    unbound once along the unit axis."""
    if isinstance(params, dict):
        per_key = {k: _unbind(v, n) for k, v in params.items()}
        return [{k: per_key[k][u] for k in params} for u in range(n)]
    return params.unbind(0)


def _stack(cfg: ModelConfig, params, batch, collect_kv: bool):
    """Embed (or, with a front end, take ``batch["embeds"]``), every
    layer, final norm.  Returns (x, aux, kv), aux summed over the
    layers."""
    if cfg.frontend is not None and "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    else:
        x = embed(batch["tokens"], params["embed"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    kv_units = {f"l{i}": [] for i, (mx, _) in enumerate(cfg.pattern)
                if mx in ("attn", "local_attn")}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def unit_fn(x, unit_p):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = {}
        for i, spec in enumerate(cfg.pattern):
            x, a, kv = _apply_layer(cfg, spec, unit_p[f"l{i}"], x, positions)
            aux = aux + a
            if kv is not None:
                kvs[f"l{i}"] = kv
        return x, aux, kvs

    for unit_p in _unbind(params["units"], cfg.full_units):
        if cfg.remat == "unit" and torch.is_grad_enabled():
            x, a, kvs = checkpoint(unit_fn, x, unit_p, use_reentrant=False)
        else:
            x, a, kvs = unit_fn(x, unit_p)
        aux = aux + a
        if collect_kv:
            for name, kv in kvs.items():
                kv_units[name].append(kv)
    kv_tail = {}
    for i, spec in enumerate(cfg.tail_specs):
        x, a, kv = _apply_layer(cfg, spec, params["tail"][f"t{i}"], x,
                                positions)
        aux = aux + a
        if collect_kv and kv is not None:
            kv_tail[f"t{i}"] = kv
    x = apply_norm(cfg.norm, params["final_norm"], x)
    kv = None
    if collect_kv:
        units = {name: (torch.stack([k for k, _ in kvs]),
                        torch.stack([v for _, v in kvs]))
                 for name, kvs in kv_units.items() if kvs}
        kv = {"units": units, "tail": kv_tail}
    return x, aux, kv


def _table(cfg: ModelConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


@torch.inference_mode()
def forward(cfg: ModelConfig, params, batch, *, collect_kv: bool = False):
    """Full-sequence forward.

    batch: {"tokens": int [B, S]}, or {"embeds": [B, S, D]} for the
    front-end stubs (hubert-xlarge, internvl2-26b).  Returns (logits fp32
    [B, S, V], aux) and, with ``collect_kv``, a third item {"units": {"l{i}": (k, v)},
    "tail": {"t{i}": (k, v)}}: each attention layer's k/v [B, S, K, dh],
    stacked over units ([U, B, S, K, dh]) -- what prefill writes into the
    paged arena.
    """
    x, aux, kv = _stack(cfg, params, batch, collect_kv)
    logits = unembed(x, _table(cfg, params))
    if collect_kv:
        return logits, aux, kv
    return logits, aux


def hidden_states(cfg: ModelConfig, params, batch):
    """Final-norm hidden states [B, S, D] (the pre-unembed activations),
    and aux."""
    x, aux, _ = _stack(cfg, params, batch, collect_kv=False)
    return x, aux


def _ce_chunk(xs, table, ls):
    """Summed CE of one chunk (labels < 0 ignored) and its label count."""
    logits = unembed(xs, table)                          # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ls.clamp(min=0)[..., None])[..., 0]
    mask = ls >= 0
    return torch.where(mask, lse - gold, 0.0).sum(), mask.sum()


def chunked_ce(cfg: ModelConfig, x, table, labels, *, chunk: int = 256):
    """Mean cross-entropy over the vocabulary, ``chunk`` positions at a
    time, so no [B, S, V] fp32 logits are ever built (under remat the
    backward recomputes each chunk's logits).  Labels < 0 are ignored."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        args = (x[:, s0:s0 + chunk], table, labels[:, s0:s0 + chunk].long())
        if torch.is_grad_enabled():        # the reference remats always
            s, n = checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            s, n = _ce_chunk(*args)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            loss_chunk: int = 256):
    """Next-token (causal) or frame-classification CE loss.  Returns
    (loss, {"ce": ce, "aux": aux})."""
    x, aux = hidden_states(cfg, params, batch)
    labels = batch["labels"]
    if cfg.causal:
        # position t predicts label t + 1.  The last position, which has
        # no next label, is masked (-1) rather than sliced off: the same
        # mean, but the chunk search sees S and not S - 1 (8191 is prime,
        # and would give chunks of one position)
        labels = F.pad(labels[:, 1:], (0, 1), value=-1)
    ce = chunked_ce(cfg, x, _table(cfg, params), labels, chunk=loss_chunk)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
