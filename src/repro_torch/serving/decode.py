"""One batched decode step, on one device or on a mesh.

Port of the reference's ``serving/decode.py`` (``make_dstate``,
``_decode_local`` and ``make_decode_step``): embed → per layer its mixer
(``attn_decode_tp``, ``mamba2_decode_tp`` or ``rglru_decode_tp``) +
``mlp_decode_tp`` or ``moe_decode_tp`` → the tail layers → final norm →
logits → greedy sample.  ``decode_step`` runs it on one device;
``make_decode_step`` returns the step a rank of a mesh runs on its shards
(``distributed/mesh.py``; specs in ``distributed/specs.py``): batch and
K/V pages over the data axes (shard-local page ids, one arena a data
shard), or with ``batch_sharded=False`` the pages of every sequence over
the data axes (sequence parallelism, recurrent state replicated), and
tensor parallelism plus the arenas' page slots over ``model``.
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
from ..distributed.mesh import MODEL_AXIS, all_gather, axis_index, \
    axis_size, data_axes, dp_linear_index
from ..kernels.kv_update.kernel import Slots
from ..kernels.paged_attention.kernel import local_count
from ..layers import rglru, ssd
from ..layers.common import apply_norm
from ..layers.rope import rope_freqs
from ..models.config import ModelConfig
from . import tp_layers as tpl


def make_dstate(cfg: ModelConfig, *, batch: int, max_seq: int,
                pages_per_shard: int | None = None, dp_shards: int = 1,
                device=None) -> dict:
    """Zero decode state (KV arenas in ``cfg.dtype``, or int8 with fp32
    scale arenas when ``cfg.kv_dtype == "int8"``; recurrent states in
    fp32); the engine fills the block tables.  With ``dp_shards`` data
    shards the state is the global one a mesh shards
    (``distributed/specs.py`` ``dstate_specs``): the table's columns a
    multiple of ``dp_shards`` (sequence parallelism splits them), and the
    arenas one arena of ``pages`` pages (its last the dump page) a data
    shard, end to end."""
    dev = resolve_device(device)
    page = cfg.page_size
    if cfg.attn_layers == 0:
        Pn = dp_shards                    # attention-free: vestigial table
    else:
        Pn = max(1, max_seq // page)
        if cfg.window:                    # ring buffer of window pages
            Pn = min(Pn, (cfg.window + page - 1) // page + 1)
        Pn = -(-Pn // dp_shards) * dp_shards   # divisible for seq-parallel
    pages = pages_per_shard or max(batch // dp_shards, 1) * (
        Pn // dp_shards if batch < dp_shards else Pn) + 1
    pages *= dp_shards

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
                 step_in, mesh=None):
    mixer, ffn = spec
    h = apply_norm(cfg.norm, p["norm1"], x)
    if mixer in ("attn", "local_attn"):
        win = cfg.window if mixer == "local_attn" else 0
        scales = (state["ks"], state["vs"]) if "ks" in state else None
        y = tpl.attn_decode_tp(cfg, p["attn"], h, pos, state["k"],
                               state["v"], block_table, window=win,
                               scales=scales, mesh=mesh,
                               starts=step_in["starts"] if win else None,
                               **step_in["common"])
    elif mixer == "mamba2":
        y = tpl.mamba2_decode_tp(cfg, p["ssd"], h, state, mesh)
    elif mixer == "rglru":
        y = tpl.rglru_decode_tp(cfg, p["rglru"], h, state, mesh)
    else:
        raise NotImplementedError(
            f"the {mixer!r} mixer does not decode in the port yet")
    x = x + y
    if ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if ffn == "moe":
            x = x + tpl.moe_decode_tp(cfg, p["ffn"], h, mesh)
        else:
            x = x + tpl.mlp_decode_tp(cfg, p["ffn"], h, mesh)
    return x


class _Shard:
    """What a rank's step knows of the mesh: the mesh, this rank's model
    coordinate and, sequence-parallel, its data axes and coordinate, and
    whether the vocabulary is split."""

    def __init__(self, cfg: ModelConfig, mesh, batch_sharded: bool):
        self.mesh = mesh
        self.tp = axis_size(mesh, MODEL_AXIS)
        self.r = axis_index(mesh, MODEL_AXIS)
        self.seq_axes = () if batch_sharded else data_axes(mesh)
        self.d = dp_linear_index(mesh, self.seq_axes)
        self.vocab_sharded = cfg.vocab_size % self.tp == 0

    def slots(self, page_loc: int, P_loc: int) -> Slots:
        return Slots(page_loc * self.tp, self.r * page_loc,
                     self.d * P_loc if self.seq_axes else 0,
                     bool(self.seq_axes))


def _where(pos, slots: Slots, page_loc: int, P_loc: int):
    """(local column, local slot, held) of each lane's position ``pos``:
    held where the shard's table has the column and its arena the slot."""
    col = torch.div(pos, slots.page, rounding_mode="floor").long() \
        - slots.page0
    slot = (pos % slots.page).long() - slots.slot0
    held = (col >= 0) & (col < P_loc) & (slot >= 0) & (slot < page_loc)
    return col, slot, held


def _attn_inputs(cfg, dstate, pos, sh: _Shard | None) -> dict:
    """What every attention layer of the step shares, computed once: each
    lane's range of valid local positions, the table with -1 read as the
    dump page, RoPE's frequencies and, on a mesh, the shard's slots.

    A lane's global range ends at ``pos + 1``, less one where the shard
    that holds position ``pos`` has no page for it (an idle lane, or a
    finished one not yet reused): the reference marks the position in
    ``kv_pos`` only where its page exists.  Such a lane reads its -1
    columns as the dump page, where its K/V go, as the reference's does;
    it matters where a lane's recurrent state outlives its sequence
    (ROADMAP C10).  A windowed layer's range starts at ``pos - window +
    1``, as the reference's mask ``kv_pos > pos - window``.  On a mesh
    both ends map onto the shard's local positions (``local_count``)."""
    block_table, kv_pos = dstate["block_table"], dstate["kv_pos"]
    P_loc, page_loc = block_table.shape[1], kv_pos.shape[-1]
    slots = Slots(page_loc) if sh is None else sh.slots(page_loc, P_loc)
    col, _, held = _where(pos, slots, page_loc, P_loc)
    own = torch.gather(block_table, 1, col.clamp(0, P_loc - 1)[:, None])[:, 0]
    ends = local_count(pos + 1, slots, page_loc, P_loc) - (
        held & (own < 0)).to(torch.int32)
    starts = local_count(torch.clamp(pos - cfg.window + 1, min=0), slots,
                         page_loc, P_loc) if cfg.window else None
    common = {"lengths": ends,
              "freqs": rope_freqs(cfg.head_dim, cfg.rope_theta, pos.device)
              if cfg.use_rope else None}
    if sh is not None:
        common.update(slots=slots, seq_dp_axes=sh.seq_axes)
    return {"starts": starts, "common": common,
            "table": torch.where(block_table < 0, _dump_page(dstate),
                                 block_table)}


def _step(cfg: ModelConfig, params: dict, dstate: dict,
          tokens: torch.Tensor, return_logits: bool, sh: _Shard | None):
    mesh = None if sh is None else sh.mesh
    vocab = sh is None or sh.vocab_sharded
    pos = dstate["pos"]
    block_table = dstate["block_table"]
    kv_pos = dstate["kv_pos"]
    step_in = None
    if cfg.attn_layers:
        step_in = _attn_inputs(cfg, dstate, pos, sh)
        block_table = step_in["table"]
    x = tpl.embed_tp(params["embed"], tokens, mesh, vocab)
    for u in range(cfg.full_units):
        unit_p = _unit(params["units"], u)
        for i, spec in enumerate(cfg.pattern):
            st = _unit(dstate["units"][f"l{i}"], u)
            x = _apply_layer(cfg, spec, unit_p[f"l{i}"], x, pos,
                             block_table, st, step_in, mesh)
    for i, spec in enumerate(cfg.tail_specs):
        x = _apply_layer(cfg, spec, params["tail"][f"t{i}"], x, pos,
                         block_table, dstate["tail"][f"t{i}"], step_in, mesh)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = tpl.logits_tp(table, x)
    if return_logits and sh is not None and sh.vocab_sharded:
        # the whole vocabulary's logits, gathered over ``model``; the token
        # from them (the same first index of the global max), one
        # collective for both
        logits = all_gather(logits, mesh, MODEL_AXIS).permute(
            1, 0, 2).reshape(logits.shape[0], -1)
        next_tok = tpl.greedy_sample_tp(logits)
    else:
        next_tok = tpl.greedy_sample_tp(logits, mesh, vocab)

    # the new token is resident at position pos for every sequence:
    # record it in kv_pos where this shard holds the position and advance
    # (a position past the table drops, as the reference's scatter drops
    # it)
    page_loc, P_loc = kv_pos.shape[-1], kv_pos.shape[1]
    slots = Slots(page_loc) if sh is None else sh.slots(page_loc, P_loc)
    col, slot, held = _where(pos, slots, page_loc, P_loc)
    b_ix = torch.arange(pos.shape[0], device=pos.device)
    col, slot = col.clamp(0, P_loc - 1), slot.clamp(0, page_loc - 1)
    kv_pos[b_ix, col, slot] = torch.where(held, pos, kv_pos[b_ix, col, slot])
    dstate["pos"] = pos + 1
    if return_logits:
        return dstate, next_tok, logits
    return dstate, next_tok


@torch.no_grad()
def decode_step(cfg: ModelConfig, params: dict, dstate: dict,
                tokens: torch.Tensor, return_logits: bool = False):
    """Advance every sequence by one token.  Returns ``(dstate, next_tok)``
    (plus fp32 logits [B, V] with ``return_logits``); ``dstate`` is the
    same dict, updated in place."""
    return _step(cfg, params, dstate, tokens, return_logits, None)


def make_decode_step(cfg: ModelConfig, mesh, params, *,
                     batch_sharded: bool = True,
                     return_logits: bool = False):
    """The step a rank of ``mesh`` runs: ``step(params_loc, dstate_loc,
    tokens_loc) -> (dstate_loc, next_tok_loc[, logits])`` on its shards
    (``distributed/specs.py``: ``shard_tree`` with ``serve_param_specs``
    and ``dstate_specs``), the state updated in place.  ``params`` is this
    rank's tree, checked against the specs' block shapes.

    ``batch_sharded=False`` is sequence parallelism, for a batch smaller
    than the data shards: every sequence's table columns (and arena
    pages) are split over the data axes, recurrent state and tokens are
    replicated, and the attention's merge spans the data axes and
    ``model``.  The tokens and logits (with ``return_logits``, the whole
    vocabulary, gathered over ``model``) are the rank's lanes: its data
    shard's with ``batch_sharded``, else all of them.  A mesh of one rank,
    or none, takes ``decode_step``."""
    if mesh is None or mesh.size() == 1:
        def one(params_loc, dstate_loc, tokens_loc):
            return decode_step(cfg, params_loc, dstate_loc, tokens_loc,
                               return_logits)
        return one
    sh = _Shard(cfg, mesh, batch_sharded)
    rows = cfg.vocab_size // sh.tp if sh.vocab_sharded else cfg.vocab_size
    if params["embed"].shape[0] != rows:
        raise ValueError(f"params hold {params['embed'].shape[0]} vocabulary "
                         f"rows, a shard of {tuple(mesh.shape)} holds {rows}: "
                         f"pass this rank's blocks (shard_tree)")

    @torch.no_grad()
    def step(params_loc, dstate_loc, tokens_loc):
        return _step(cfg, params_loc, dstate_loc, tokens_loc, return_logits,
                     sh)
    return step
