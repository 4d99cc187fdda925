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

On a mesh (``mesh=``, a ``DeviceMesh`` of the training layout,
``distributed/sharding.py``) ``hidden_states`` and ``loss_fn`` run one
rank's share of the step in eager SPMD: the parameters are this rank's
blocks (``train_param_specs``), the batch its shard over the data axes.
Each layer's leaves are gathered over ``data`` where it runs
(``gather_fsdp``: inside the unit, so the remat gathers them again in
the backward and no unit's whole leaves outlive it); with a ``model``
axis of more than one rank the attention, MLP, Mamba-2 and RG-LRU layers
run this rank's heads, columns or channels by the plan
(``distributed/collectives.py`` ``unit_ranges``: even or not), the
embedding and the CE its rows of the vocabulary (or the whole table
where the vocabulary does not split).  The loss a rank returns is its
batch shard's summed CE over the global label count: summed over the
data axes it is the mean over the global batch.  MoE on any mesh of more
than one rank is ROADMAP A8b (2), and raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..layers import attention, rglru, ssd
from ..distributed.collectives import copy_to_model, gather_fsdp, \
    gather_leaves, model_index, model_size, psum_data, reduce_from_model
from ..distributed.mesh import MODEL_AXIS, pmax
from ..distributed.sharding import make_batch_constrainer, \
    model_train_specs
from ..layers.common import apply_norm, embed, unembed
from ..layers.mlp import apply_mlp
from ..layers.moe import apply_moe
from .config import ModelConfig


def check_mesh(cfg: ModelConfig, mesh) -> None:
    """Raise where ``cfg`` needs what the sharded step does not have: MoE
    on a mesh of more than one rank (ROADMAP A8b (2)).  A split dim with
    fewer units than ``model`` has ranks raises in its layer
    (``unit_ranges``)."""
    if mesh is None:
        return
    if any(f == "moe" for _, f in cfg.layer_specs) and mesh.size() > 1:
        raise NotImplementedError(
            f"{cfg.name}: MoE training on a mesh of more than one rank is "
            f"ROADMAP A8b (2) (its capacity and aux loss are functions of "
            f"the whole batch)")


def _apply_layer(cfg: ModelConfig, spec, p, x, positions, tp_mesh=None):
    """One (mixer, ffn) layer.  Returns (x, aux, kv) -- aux is the MoE
    load-balancing loss (0 for the other feed-forwards), kv the layer's
    (k, v) [B, S, K, dh] for attention mixers, else None.  With
    ``tp_mesh`` (a model axis of more than one rank) this rank's heads
    and columns of the layer, ``p`` gathered over ``data``."""
    mixer, ffn = spec
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kv = None
    h = apply_norm(cfg.norm, p["norm1"], x)
    if mixer == "attn":
        h, kv = attention.attention_fwd(cfg, p["attn"], h, positions,
                                        causal=cfg.causal, window=0,
                                        mesh=tp_mesh)
    elif mixer == "local_attn":
        h, kv = attention.attention_fwd(cfg, p["attn"], h, positions,
                                        causal=cfg.causal, window=cfg.window,
                                        mesh=tp_mesh)
    elif mixer == "mamba2":
        h = ssd.mamba2_forward(cfg, p["ssd"], h, mesh=tp_mesh)
    elif mixer == "rglru":
        h = rglru.rglru_forward(cfg, p["rglru"], h, mesh=tp_mesh)
    else:
        raise NotImplementedError(f"unknown mixer {mixer!r}")
    x = x + h
    if ffn != "none":
        h = apply_norm(cfg.norm, p["norm2"], x)
        if ffn == "moe":
            h, aux = apply_moe(cfg, p["ffn"], h,
                               capacity_factor=cfg.capacity_factor)
        else:
            h = apply_mlp(cfg, p["ffn"], h, mesh=tp_mesh)
        x = x + h
    return x, aux, kv


def _unbind(params: dict, n: int) -> list[dict]:
    """The stacked unit parameters as ``n`` per-unit trees: each leaf
    unbound once along the unit axis."""
    if isinstance(params, dict):
        per_key = {k: _unbind(v, n) for k, v in params.items()}
        return [{k: per_key[k][u] for k in params} for u in range(n)]
    return params.unbind(0)


def _vocab_parallel(specs) -> bool:
    return specs["embed"][0] == MODEL_AXIS


def _unit_specs(specs: dict) -> dict:
    """The stacked leaves' specs without their unit dim."""
    if isinstance(specs, dict):
        return {k: _unit_specs(v) for k, v in specs.items()}
    return specs[1:]


def _stack(cfg: ModelConfig, params, batch, collect_kv: bool, mesh=None,
           specs=None):
    """Embed (or, with a front end, take ``batch["embeds"]``), every
    layer, final norm.  Returns (x, aux, kv), aux summed over the
    layers.  With ``mesh``: this rank's share, ``specs`` the blocks'
    (see the module's docstring)."""
    def leaves(tree, sp):
        return tree if mesh is None else gather_leaves(tree, sp, mesh)

    tp_mesh = mesh if mesh is not None and model_size(mesh) > 1 else None
    if cfg.frontend is not None and "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    elif mesh is None:
        x = embed(batch["tokens"], params["embed"])
    else:
        x = embed(batch["tokens"], gather_fsdp(params["embed"],
                                               specs["embed"], mesh),
                  tp_mesh if _vocab_parallel(specs) else None)
    constrain = make_batch_constrainer(mesh, x.shape[0])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    kv_units = {f"l{i}": [] for i, (mx, _) in enumerate(cfg.pattern)
                if mx in ("attn", "local_attn")}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    unit_specs = _unit_specs(specs["units"]) if mesh is not None else None

    def unit_fn(x, unit_p):
        unit_p = leaves(unit_p, unit_specs)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        kvs = {}
        for i, spec in enumerate(cfg.pattern):
            x, a, kv = _apply_layer(cfg, spec, unit_p[f"l{i}"], x, positions,
                                    tp_mesh)
            x = constrain(x)
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
        name = f"t{i}"
        x, a, kv = _apply_layer(cfg, spec, leaves(
            params["tail"][name], specs and specs["tail"][name]), x,
            positions, tp_mesh)
        aux = aux + a
        if collect_kv and kv is not None:
            kv_tail[name] = kv
    x = apply_norm(cfg.norm, leaves(params["final_norm"],
                                    specs and specs["final_norm"]), x)
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


def hidden_states(cfg: ModelConfig, params, batch, *, mesh=None,
                  specs=None):
    """Final-norm hidden states [B, S, D] (the pre-unembed activations),
    and aux.  With ``mesh``, this rank's batch shard (its blocks
    described by ``specs``, by default ``model_train_specs``)."""
    if mesh is not None:
        check_mesh(cfg, mesh)
        specs = specs or model_train_specs(cfg, mesh)
    x, aux, _ = _stack(cfg, params, batch, collect_kv=False, mesh=mesh,
                       specs=specs)
    return x, aux


def _ce_chunk(xs, table, ls):
    """Summed CE of one chunk (labels < 0 ignored) and its label count."""
    logits = unembed(xs, table)                          # [B, c, V] fp32
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ls.clamp(min=0)[..., None])[..., 0]
    mask = ls >= 0
    return torch.where(mask, lse - gold, 0.0).sum(), mask.sum()


def _ce_chunk_vp(xs, table, ls, mesh):
    """``_ce_chunk`` against this model rank's rows of the vocabulary:
    each row's max over the ranks (``pmax``, no gradient: the shift
    cancels), the sum of exp and the gold logit (from the rank that holds
    the label) summed over ``model`` in one collective."""
    logits = unembed(xs, table)                          # [B, c, V/tp]
    V = table.shape[0]
    m = pmax(logits.detach().amax(dim=-1), mesh, MODEL_AXIS)
    local = ls - model_index(mesh) * V
    ok = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, local.clamp(0, V - 1)[..., None])[..., 0]
    se, gold = reduce_from_model(torch.stack([
        torch.exp(logits - m[..., None]).sum(dim=-1),
        torch.where(ok, gold, 0.0)]), mesh)
    mask = ls >= 0
    return torch.where(mask, m + torch.log(se) - gold, 0.0).sum(), mask.sum()


def chunked_ce(cfg: ModelConfig, x, table, labels, *, chunk: int = 256,
               mesh=None, count=None):
    """Mean cross-entropy over the vocabulary, ``chunk`` positions at a
    time, so no [B, S, V] fp32 logits are ever built (under remat the
    backward recomputes each chunk's logits).  Labels < 0 are ignored.
    With ``mesh`` (a model axis of more than one rank) ``table`` is this
    rank's rows of the vocabulary; with ``count`` the summed CE is divided
    by it (the global label count of a mesh) instead of this batch's."""
    B, S, D = x.shape
    if mesh is not None:
        x = copy_to_model(x, mesh)
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        args = (x[:, s0:s0 + chunk], table, labels[:, s0:s0 + chunk].long())
        fn = _ce_chunk
        if mesh is not None:
            fn, args = _ce_chunk_vp, args + (mesh,)
        if torch.is_grad_enabled():        # the reference remats always
            s, n = checkpoint(fn, *args, use_reentrant=False)
        else:
            s, n = fn(*args)
        tot = tot + s
        cnt = cnt + n
    return tot / torch.clamp(cnt if count is None else count, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch, *, aux_weight: float = 0.01,
            loss_chunk: int = 256, mesh=None, specs=None):
    """Next-token (causal) or frame-classification CE loss.  Returns
    (loss, {"ce": ce, "aux": aux}).  With ``mesh``: this rank's share of
    the loss (its batch shard's summed CE over the global label count;
    the sum over the data axes is the loss)."""
    if mesh is not None:
        specs = specs or model_train_specs(cfg, mesh)
    x, aux = hidden_states(cfg, params, batch, mesh=mesh, specs=specs)
    labels = batch["labels"]
    if cfg.causal:
        # position t predicts label t + 1.  The last position, which has
        # no next label, is masked (-1) rather than sliced off: the same
        # mean, but the chunk search sees S and not S - 1 (8191 is prime,
        # and would give chunks of one position)
        labels = F.pad(labels[:, 1:], (0, 1), value=-1)
    if mesh is None:
        ce = chunked_ce(cfg, x, _table(cfg, params), labels,
                        chunk=loss_chunk)
        return ce + aux_weight * aux, {"ce": ce, "aux": aux}
    name = "embed" if cfg.tie_embeddings else "unembed"
    table = gather_fsdp(params[name], specs[name], mesh)
    vp = model_size(mesh) > 1 and _vocab_parallel(specs)
    count = psum_data((labels >= 0).sum().float(), mesh)
    ce = chunked_ce(cfg, x, table, labels, chunk=loss_chunk,
                    mesh=mesh if vp else None, count=count)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
