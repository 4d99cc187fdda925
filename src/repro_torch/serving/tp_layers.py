"""Decode layers, on one device or on a shard of a mesh (the reference's
``serving/tp_layers.py``).

Without a mesh (``mesh=None``) each function is the reference's at
tensor-parallel degree 1, where every ``psum`` / ``pmax`` is the
identity.  On a shard (``mesh`` a ``DeviceMesh`` with a ``model`` axis,
``distributed/mesh.py``) the weights are this rank's blocks
(``distributed/specs.py`` ``serve_param_specs``: Megatron-style row /
column parallel over ``model``, the vocabulary sharded where it divides,
the experts, SSD heads and RG-LRU width split), activations [B, D] are
replicated over ``model``, and each function reduces over the ``model``
axis's process group where the reference's ``psum`` / ``pmax`` /
``all_gather`` do; a row-parallel product's partials are kept in fp32,
summed in fp32 and rounded once (``_rowpar``), as one device's product
rounds it.  The K/V arenas hold
this shard's page slots (and, sequence-parallel, its table columns):
``attn_decode_tp`` writes only the rows the shard holds, attends over its
local slots with the kernel's log-sum-exp output, and merges the shards'
partial softmax in fp32 from one gather of every shard's (lse, o): ``m =
max(lse)``, ``w = exp(lse - m)``, ``out = sum(w o) / sum(w)``.

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

from ..distributed.collectives import mm32 as _mm32
from ..distributed.mesh import MODEL_AXIS, all_gather, axis_index, \
    axis_size, psum
from ..kernels.kv_update.kernel import rope_kv_append
from ..kernels.paged_attention.kernel import paged_attention, \
    valid_positions
from ..layers.common import conv_step, unembed
from ..layers.mlp import apply_mlp, mlp_hidden
from ..layers.rglru import gate_coeffs
from ..layers.ssd import mamba2_step


def _rowpar(a: torch.Tensor, w: torch.Tensor, mesh, dtype) -> torch.Tensor:
    """A row-parallel product: this shard's ``a @ w`` in fp32, summed over
    ``model`` and rounded to ``dtype`` once, as one device's product
    rounds it."""
    return psum(_mm32(a, w), mesh, MODEL_AXIS).to(dtype)


def _xslice(x: torch.Tensor, mesh) -> torch.Tensor:
    """This shard's slice of a model-replicated activation's last dim."""
    n = x.shape[-1] // axis_size(mesh, MODEL_AXIS)
    i = axis_index(mesh, MODEL_AXIS)
    return x[..., i * n:(i + 1) * n]


def embed_tp(table: torch.Tensor, tokens: torch.Tensor, mesh=None,
             sharded: bool = True) -> torch.Tensor:
    """Embedding gather; ids outside the table give zero rows.  On a mesh
    with ``sharded`` the table is this shard's rows of the vocabulary,
    and the shards' rows are summed (the reference's vocab-parallel
    gather); without it the table is whole (replicated)."""
    V = table.shape[0]
    if mesh is not None and sharded:
        tokens = tokens - axis_index(mesh, MODEL_AXIS) * V
    ok = (tokens >= 0) & (tokens < V)
    rows = table[torch.clamp(tokens, 0, V - 1).long()]
    rows = torch.where(ok[:, None], rows, torch.zeros((), dtype=table.dtype,
                                                      device=table.device))
    return psum(rows, mesh, MODEL_AXIS) if mesh is not None and sharded \
        else rows


def logits_tp(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits [B, V] in fp32 (on a mesh, this shard's vocabulary rows)."""
    return unembed(x, table)


def greedy_sample_tp(logits: torch.Tensor, mesh=None,
                     sharded: bool = True) -> torch.Tensor:
    """Greedy token (first index of the max, as ``jnp.argmax``).  On a
    mesh with ``sharded`` each shard takes its own max and first argmax,
    the shards' pairs are gathered in one collective (the index is exact
    in fp32 below 2^24), and the first shard holding the largest max
    wins: the first index of the global max."""
    if mesh is None or not sharded:
        return torch.argmax(logits, dim=1).to(torch.int32)
    V = logits.shape[1]
    m, arg = torch.max(logits, dim=1)
    arg = arg + axis_index(mesh, MODEL_AXIS) * V
    both = all_gather(torch.stack([m, arg.float()]), mesh, MODEL_AXIS)
    win = torch.argmax(both[:, 0], dim=0)                       # [B]
    return both[:, 1].gather(0, win[None])[0].to(torch.int32)


def attn_decode_tp(cfg, p: dict, x: torch.Tensor, pos: torch.Tensor,
                   arena_k: torch.Tensor, arena_v: torch.Tensor,
                   block_table: torch.Tensor, *, freqs, lengths,
                   starts=None, window: int = 0, scales=None, mesh=None,
                   slots=None, seq_dp_axes: tuple = ()):
    """One-token paged attention (KV in the model dtype, or int8).

    x:           [B, D] (replicated over ``model`` on a mesh)
    arena_k/v:   [pages, page, K, dh], the last page the dump page;
                 updated IN PLACE with this token's K/V (on a mesh this
                 shard's page slots: ``page`` of them, from
                 ``slots.slot0`` of each global page)
    scales:      None, or for int8 arenas (``cfg.kv_dtype == "int8"``)
                 the fp32 scale arenas (ks, vs) [pages, page, K], updated
                 IN PLACE with the new rows' scales (KIVI-style: a scale
                 per slot and KV head, quantized on write, dequantized on
                 gather inside the kernels)
    block_table: int32 [B, P] page ids (-1 unused)
    freqs:       ``rope_freqs(dh, theta)`` on x's device; None without
                 RoPE
    lengths:     int32 [B], the end of each lane's range of valid local
                 positions (``pos + 1`` on one device)
    starts:      None or int32 [B], its start; without it the range starts
                 at ``lengths - window``
                 (``decode_step`` computes the range once a step, for
                 every layer)
    mesh, slots, seq_dp_axes: on a mesh, the mesh, this shard's
                 ``Slots`` and the data axes its table columns are split
                 over (sequence parallelism; the merge then spans them
                 and ``model``)

    The new token's K/V land at page ``block_table[b, pos // page]``,
    slot ``pos % page`` (page id < 0 → the dump page; on a mesh only on
    the shard that holds the position).  The attention reads the lane's
    range through the block table; this agrees with the reference's
    per-slot ``kv_pos`` mask while pages fill contiguously (the engine
    contract).  With a window, a lane left with no valid position gets
    the mean of the V rows, as the reference's layer gives it
    (``windowed_empty_lanes``).  Returns y [B, D].
    """
    B, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bias = (p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else (None,) * 3
    if mesh is None:
        q = rope_kv_append(torch.matmul(x, p["wq"]), torch.matmul(x, p["wk"]),
                           torch.matmul(x, p["wv"]), *bias, freqs, pos,
                           block_table, arena_k, arena_v, scales)
        out = paged_attention(q, arena_k, arena_v, block_table, lengths,
                              window=0 if starts is not None else window,
                              starts=starts, scales=scales)
        if window:
            out = windowed_empty_lanes(out, arena_v, block_table, lengths,
                                       window, None if scales is None
                                       else scales[1], starts=starts)
        return torch.matmul(out.reshape(B, h * dh).to(x.dtype), p["wo"])

    # fused row-parallel QKV: one psum
    xs = _xslice(x, mesh)
    qkv = psum(torch.cat([_mm32(xs, p["wq"]), _mm32(xs, p["wk"]),
                          _mm32(xs, p["wv"])], dim=-1),
               mesh, MODEL_AXIS).to(x.dtype)
    q, k, v = (t.contiguous() for t in torch.split(
        qkv, [h * dh, kvh * dh, kvh * dh], dim=-1))
    q = rope_kv_append(q, k, v, *bias, freqs, pos, block_table, arena_k,
                       arena_v, scales, slots)
    o, lse = paged_attention(q, arena_k, arena_v, block_table, lengths,
                             starts=starts, scales=scales, return_lse=True)
    # the shards' partial softmax merged in fp32, from one gather of every
    # shard's (lse, o): weights exp(lse - m) with m the largest lse, 0 for
    # a shard with no valid position (and for every shard where the lane
    # has none anywhere), summed in shard order; with a window the shards'
    # V sums ride along for windowed_empty_lanes
    merge = tuple(seq_dp_axes) + (MODEL_AXIS,)
    parts = [lse, o.reshape(B, -1)]
    if window:
        parts.append(v_row_sum(arena_v, block_table, None if scales is None
                               else scales[1], x.dtype).reshape(B, -1))
    got = all_gather(torch.cat(parts, dim=1), mesh, merge)   # [n, B, .]
    lse_all = got[:, :, :h]
    m = lse_all.max(dim=0).values                              # [B, H]
    w = torch.where(torch.isfinite(m), torch.exp(lse_all - m), 0.0)
    o_all = got[:, :, h:h + h * dh].reshape(-1, B, h, dh)
    out = (w[..., None] * o_all).sum(dim=0) / torch.clamp(
        w.sum(dim=0), min=1e-20)[..., None]
    out = out.to(x.dtype)
    if window:
        n = block_table.shape[1] * arena_v.shape[1] * got.shape[0]
        mean = (got[:, :, h + h * dh:].sum(dim=0).reshape(B, kvh, dh)
                / n).to(x.dtype)
        out = torch.where(~torch.isfinite(m[:, :1, None]),
                          mean.repeat_interleave(h // kvh, dim=1), out)
    # row-parallel output projection
    return _rowpar(_xslice(out.reshape(B, h * dh), mesh), p["wo"], mesh,
                   x.dtype)


def v_row_sum(arena_v, block_table, v_scale, dtype) -> torch.Tensor:
    """[B, K, dh] fp32: the sum of the ``P * page`` V rows of each lane's
    table (a -1 page read as the dump page), summed in V's dtype as the
    reference's layer sums them; int8 rows (``v_scale`` their fp32
    scales) dequantized first into ``dtype``, the model dtype, as the
    reference dequantizes what it gathers: ``(v.float() * s)``."""
    npages, page, K, dh = arena_v.shape
    B, P = block_table.shape
    bt = torch.where(block_table < 0, npages - 1, block_table).long()
    rows = arena_v[bt].reshape(B, P * page, K, dh)
    if v_scale is not None:
        rows = (rows.float() * v_scale[bt].reshape(B, P * page, K, 1)).to(
            dtype)
    return rows.float().sum(dim=1).to(rows.dtype).float()


def windowed_empty_lanes(out, arena_v, block_table, lengths, window: int,
                         v_scale=None, starts=None):
    """A windowed decode past its table (``pos >= P * page + window - 1``)
    leaves a lane no valid position.  The reference's layer then weighs
    every gathered row alike (its masked scores are all -1e30, so
    ``exp(s - max) = 1``): its output is the mean of the ``P * page`` V
    rows of the lane's table (``v_row_sum``), divided in fp32.  Gives
    such lanes that mean (the kernel gives them 0) and leaves the others'
    ``out`` as it is.  The lanes' ranges are ``[starts, lengths)``, or
    without ``starts`` as the kernel takes them from the window.  On a
    mesh ``attn_decode_tp`` sums the shards' ``v_row_sum`` in its merge
    and divides by the global ``P * page``."""
    B, H, dh = out.shape
    _, page, K, _ = arena_v.shape
    P = block_table.shape[1]
    empty = ~valid_positions(block_table, lengths, page, window,
                             starts).any(dim=1)
    mean = (v_row_sum(arena_v, block_table, v_scale, out.dtype)
            / (P * page)).to(out.dtype)
    mean = mean.repeat_interleave(H // K, dim=1)            # [B, H, dh]
    return torch.where(empty[:, None, None], mean, out)


def mlp_decode_tp(cfg, p: dict, x: torch.Tensor, mesh=None):
    """One-token feed-forward: ``apply_mlp``; on a mesh column-parallel
    ``wi`` / ``wg`` and row-parallel ``wo``, one psum."""
    if mesh is None:
        return apply_mlp(cfg, p, x)
    return _rowpar(mlp_hidden(cfg, p, x), p["wo"], mesh, x.dtype)


def moe_decode_tp(cfg, p: dict, x: torch.Tensor, mesh=None):
    """One-token MoE feed-forward (the reference's ``moe_decode_tp``):
    every expert, the padded ones included, runs densely over the B
    tokens; the top-k gates, scattered into [B, E] and padded with zeros
    to ``wi.shape[0]`` experts a shard times the shards, weigh the combine
    in fp32 (on a mesh each shard's experts their slice of the gates, and
    one psum merges the shards).  No capacity, no drop, and no value read
    back to the host.  (Without SwiGLU the reference's decode applies
    GELU, whatever ``cfg.mlp`` says; so does this.)  Returns y [B, D] in
    x's dtype."""
    E = p["wi"].shape[0]
    tp = 1 if mesh is None else axis_size(mesh, MODEL_AXIS)
    probs = torch.softmax(torch.matmul(x.float(), p["router"]), dim=-1)
    gate, expert = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    gates = torch.zeros((x.shape[0], E * tp), dtype=torch.float32,
                        device=x.device).scatter_add_(1, expert, gate)
    if mesh is not None:
        gates = _xslice(gates, mesh)
    h = torch.matmul(x, p["wi"])                            # [E, B, f]
    if cfg.mlp == "swiglu":
        g = torch.matmul(x, p["wg"])
        h = F.silu(g.float()).to(x.dtype) * h
    else:
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    y = torch.matmul(h, p["wo"])                            # [E, B, D]
    y = torch.einsum("ebd,be->bd", y.float(), gates)
    return (y if mesh is None else psum(y, mesh, MODEL_AXIS)).to(x.dtype)


def _store(state: dict, new: dict) -> None:
    """Write a mixer's new recurrent state into its decode-state views."""
    for k, v in new.items():
        state[k].copy_(v)


def mamba2_decode_tp(cfg, p: dict, x: torch.Tensor, state: dict,
                     mesh=None):
    """One-token Mamba-2 update (the reference's ``mamba2_decode_tp``; on
    a mesh the heads are split over ``model``, B and C replicated).  Its
    gated RMS norm divides ``sum(y * y)`` (summed over the shards) by
    d_inner, where the layer function takes a mean.  ``state`` ({"h",
    "conv_x", "conv_bc"}, fp32) is updated in place.  Returns y [B, D]."""
    y, z, new = mamba2_step(cfg, p, x, state)
    y = y * F.silu(z.float())
    ssq = torch.sum(y * y, dim=-1, keepdim=True)
    tp = 1
    if mesh is not None:
        ssq, tp = psum(ssq, mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS)
    y = y * torch.rsqrt(ssq / (y.shape[1] * tp) + 1e-6) * p["norm_w"]
    _store(state, new)
    if mesh is None:
        return torch.matmul(y.to(x.dtype), p["out_proj"])
    return _rowpar(y.to(x.dtype), p["out_proj"], mesh, x.dtype)


def rglru_decode_tp(cfg, p: dict, x: torch.Tensor, state: dict,
                    mesh=None):
    """One-token RG-LRU update (the reference's ``rglru_decode_tp``; on a
    mesh the width is split over ``model``: the gate projections are
    row-parallel, so their pre-activations are psum'd, in one collective,
    and each shard keeps its width's slice).  The gate matmuls take the
    convolution cast to x's dtype but the input gate multiplies the fp32
    convolution (the layer function casts it first).  ``state`` ({"h",
    "conv"}, fp32) is updated in place.  Returns y [B, D]."""
    xr = torch.matmul(x, p["in_x"]).float()
    xg = torch.matmul(x, p["in_g"])
    hist = torch.cat([state["conv"], xr[:, None, :]], dim=1)
    conv = conv_step(hist, p["conv_w"], p["conv_b"])
    cx = conv.to(x.dtype)
    if mesh is None:
        ga, gi = torch.matmul(cx, p["wa"]), torch.matmul(cx, p["wx"])
    else:
        g = psum(torch.cat([_mm32(cx, p["wa"]), _mm32(cx, p["wx"])], dim=-1),
                 mesh, MODEL_AXIS).to(x.dtype)
        ga, gi = (_xslice(t, mesh) for t in torch.chunk(g, 2, dim=-1))
    a, b = gate_coeffs(p, ga, gi, conv)
    h = a * state["h"] + b
    y = h * F.gelu(xg.float(), approximate="tanh")
    _store(state, {"h": h, "conv": hist[:, 1:]})
    if mesh is None:
        return torch.matmul(y.to(x.dtype), p["out"])
    return _rowpar(y.to(x.dtype), p["out"], mesh, x.dtype)
