"""One batched decode step on one device.

Port of the reference's ``serving/decode.py`` (``make_dstate`` and
``_decode_local``) without the mesh: embed → per layer its mixer
(``attn_decode_tp``, ``mamba2_decode_tp`` or ``rglru_decode_tp``) +
``apply_mlp`` or ``moe_decode_tp`` → the tail layers → final norm →
logits → greedy sample.
The decode state is a dict of tensors on one device:

  {"pos": i32[B], "block_table": i32[B, P], "kv_pos": i32[B, P, page],
   "units": {"l<i>": mixer state stacked over units}, "tail": {"t<i>": ...}}

An attention mixer's state is its KV arenas {"k", "v"} [U, pages, page,
K, dh] (with ``cfg.kv_dtype == "int8"``: int8, plus fp32 scale arenas
{"ks", "vs"} [U, pages, page, K]); a Mamba-2 mixer's {"h", "conv_x", "conv_bc"} and an RG-LRU
mixer's {"h", "conv"}, fp32 with the lanes second ([U, B, ...]).
``decode_step`` updates the state IN PLACE — the KV arenas and recurrent
states (the reference donates them to its jitted step instead),
``kv_pos`` and ``pos`` — and returns it.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..layers import rglru, ssd
from ..layers.common import apply_norm
from ..layers.mlp import apply_mlp
from ..layers.rope import rope_freqs
from ..models.config import ModelConfig
from . import tp_layers as tpl


def make_dstate(cfg: ModelConfig, *, batch: int, max_seq: int,
                pages_per_shard: int | None = None, device=None) -> dict:
    """Zero decode state (KV arenas in ``cfg.dtype``, or int8 with fp32
    scale arenas when ``cfg.kv_dtype == "int8"``; recurrent states in
    fp32); the engine fills the block tables."""
    dev = resolve_device(device)
    page = cfg.page_size
    if cfg.attn_layers == 0:
        Pn = 1                            # attention-free: vestigial table
    else:
        Pn = max(1, max_seq // page)
        if cfg.window:                    # ring buffer of window pages
            Pn = min(Pn, (cfg.window + page - 1) // page + 1)
    pages = pages_per_shard or max(batch, 1) * Pn + 1

    def mixer_state(mixer, lead: tuple):
        if mixer in ("attn", "local_attn"):
            sshape = lead + (pages, page, cfg.num_kv_heads)
            shape = sshape + (cfg.head_dim,)
            if cfg.kv_dtype == "int8":
                return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                        "ks": torch.zeros(sshape, dtype=torch.float32,
                                          device=dev),
                        "vs": torch.zeros(sshape, dtype=torch.float32,
                                          device=dev)}
            return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
        init = {"mamba2": ssd.mamba2_init_state,
                "rglru": rglru.rglru_init_state}[mixer]
        return {k: v.expand(lead + v.shape).contiguous()
                for k, v in init(cfg, batch, device=dev).items()}

    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
        "block_table": torch.full((batch, Pn), -1, dtype=torch.int32,
                                  device=dev),
        "kv_pos": torch.full((batch, Pn, page), -1, dtype=torch.int32,
                             device=dev),
        "units": {f"l{i}": mixer_state(mx, (cfg.full_units,))
                  for i, (mx, _) in enumerate(cfg.pattern)},
        "tail": {f"t{i}": mixer_state(mx, ())
                 for i, (mx, _) in enumerate(cfg.tail_specs)},
    }


def _dump_page(dstate: dict) -> int:
    """The last page of the KV arenas, where a -1 table column points."""
    for part in ("units", "tail"):
        for st in dstate[part].values():
            if "k" in st:
                return st["k"].shape[-4] - 1
    raise ValueError("the decode state holds no KV arena")


def _unit(tree, u: int):
    """Unit ``u``'s slice of a unit-stacked parameter/state tree."""
    if isinstance(tree, dict):
        return {k: _unit(v, u) for k, v in tree.items()}
    return tree[u]


def _apply_layer(cfg: ModelConfig, spec, p, x, pos, block_table, state,
                 step_in):
    mixer, ffn = spec
    h = apply_norm(cfg.norm, p["norm1"], x)
    if mixer in ("attn", "local_attn"):
        win = cfg.window if mixer == "local_attn" else 0
        scales = (state["ks"], state["vs"]) if "ks" in state else None
        y = tpl.attn_decode_tp(cfg, p["attn"], h, pos, state["k"],
                               state["v"], block_table, window=win,
                               scales=scales, **step_in)
    elif mixer == "mamba2":
        y = tpl.mamba2_decode_tp(cfg, p["ssd"], h, state)
    elif mixer == "rglru":
        y = tpl.rglru_decode_tp(cfg, p["rglru"], h, state)
    else:
        raise NotImplementedError(
            f"the {mixer!r} mixer does not decode in the port yet")
    x = x + y
    if ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if ffn == "moe":
            x = x + tpl.moe_decode_tp(cfg, p["ffn"], h)
        else:
            x = x + apply_mlp(cfg, p["ffn"], h)
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
    lengths = pos + 1
    if cfg.attn_layers:
        # a lane with no page at its position (an idle lane, or a finished
        # one not yet reused) attends as the reference's does: a -1 column
        # reads the dump page, where such lanes' K/V go, and the position
        # being written is not yet valid (the reference marks it in kv_pos
        # only where the page exists).  Active lanes are unchanged.  It
        # matters where a lane's recurrent state outlives its sequence
        # (ROADMAP C10)
        P, page = block_table.shape[1], kv_pos.shape[-1]
        col = (pos // page).long()
        own = torch.gather(block_table, 1,
                           col.clamp(max=P - 1)[:, None])[:, 0]
        lengths = lengths - ((col < P) & (own < 0)).to(pos.dtype)
        block_table = torch.where(block_table < 0, _dump_page(dstate),
                                  block_table)
    # what every layer of the step shares, computed once
    step_in = {"lengths": lengths.to(torch.int32),
               "freqs": rope_freqs(cfg.head_dim, cfg.rope_theta, pos.device)
               if cfg.use_rope else None}
    x = tpl.embed_tp(params["embed"], tokens)
    for u in range(cfg.full_units):
        unit_p = _unit(params["units"], u)
        for i, spec in enumerate(cfg.pattern):
            st = _unit(dstate["units"][f"l{i}"], u)
            x = _apply_layer(cfg, spec, unit_p[f"l{i}"], x, pos,
                             block_table, st, step_in)
    for i, spec in enumerate(cfg.tail_specs):
        x = _apply_layer(cfg, spec, params["tail"][f"t{i}"], x, pos,
                         block_table, dstate["tail"][f"t{i}"], step_in)
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
