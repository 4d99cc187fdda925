"""One batched decode step on one device.

Port of the reference's ``serving/decode.py`` (``make_dstate`` and
``_decode_local``) without the mesh: embed → per layer
``attn_decode_tp`` + ``mlp_decode_tp`` → final norm → logits → greedy
sample.  The decode state is a dict of tensors on one device:

  {"pos": i32[B], "block_table": i32[B, P], "kv_pos": i32[B, P, page],
   "units": {"l0": {"k": [U, pages, page, K, dh], "v": ...}}, "tail": {}}

``decode_step`` updates the state IN PLACE — the KV arenas (the
reference donates them to its jitted step instead), ``kv_pos`` and
``pos`` — and returns it.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..layers.common import apply_norm
from ..models.config import ModelConfig
from . import tp_layers as tpl


def make_dstate(cfg: ModelConfig, *, batch: int, max_seq: int,
                pages_per_shard: int | None = None, device=None) -> dict:
    """Zero decode state (KV arenas in ``cfg.dtype``); the engine fills
    the block tables."""
    dev = resolve_device(device)
    dtype = cfg.dtype
    page = cfg.page_size
    if cfg.kv_dtype == "int8":
        raise NotImplementedError("int8 KV decode is not ported yet")
    if cfg.tail_specs or any(m not in ("attn", "local_attn")
                             for m, _ in cfg.pattern):
        raise NotImplementedError(
            f"{cfg.name}: only attention mixers decode in the port so far")
    Pn = max(1, max_seq // page)
    if cfg.window:                        # ring buffer of window pages
        Pn = min(Pn, (cfg.window + page - 1) // page + 1)
    pages = pages_per_shard or max(batch, 1) * Pn + 1
    shape = (cfg.full_units, pages, page, cfg.num_kv_heads, cfg.head_dim)
    units = {f"l{i}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
             for i in range(len(cfg.pattern))}
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "block_table": torch.full((batch, Pn), -1, dtype=torch.int32,
                                  device=dev),
        "kv_pos": torch.full((batch, Pn, page), -1, dtype=torch.int32,
                             device=dev),
        "units": units,
        "tail": {},
    }


def _unit(tree, u: int):
    """Unit ``u``'s slice of a unit-stacked parameter/state tree."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _apply_layer(cfg: ModelConfig, spec, p, x, pos, block_table, state):
    mixer, ffn = spec
    h = apply_norm(cfg.norm, p["norm1"], x)
    win = cfg.window if mixer == "local_attn" else 0
    x = x + tpl.attn_decode_tp(cfg, p["attn"], h, pos, state["k"],
                               state["v"], block_table, window=win)
    if ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        x = x + tpl.mlp_decode_tp(cfg, p["ffn"], h)
    return x


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, dstate: dict,
                tokens: torch.Tensor, return_logits: bool = False):
    """Advance every sequence by one token.  Returns ``(dstate, next_tok)``
    (plus fp32 logits [B, V] with ``return_logits``); ``dstate`` is the
    same dict, updated in place."""
    pos = dstate["pos"]
    block_table = dstate["block_table"]
    kv_pos = dstate["kv_pos"]
    x = tpl.embed_tp(params["embed"], tokens)
    for u in range(cfg.full_units):
        unit_p = _unit(params["units"], u)
        for i, spec in enumerate(cfg.pattern):
            st = _unit(dstate["units"][f"l{i}"], u)
            x = _apply_layer(cfg, spec, unit_p[f"l{i}"], x, pos,
                             block_table, st)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = tpl.logits_tp(table, x)
    next_tok = tpl.greedy_sample_tp(logits)

    # the new token is resident at position pos for every sequence:
    # record it in kv_pos and advance (a position past the table drops,
    # as the reference's scatter drops it)
    page = kv_pos.shape[-1]
    lpage = (pos // page).long()
    in_table = lpage < kv_pos.shape[1]
    b_ix = torch.arange(pos.shape[0], device=pos.device)
    lpage = torch.clamp(lpage, max=kv_pos.shape[1] - 1)
    slot = (pos % page).long()
    kv_pos[b_ix, lpage, slot] = torch.where(in_table, pos,
                                            kv_pos[b_ix, lpage, slot])
    dstate["pos"] = pos + 1
    if return_logits:
        return dstate, next_tok, logits
    return dstate, next_tok
