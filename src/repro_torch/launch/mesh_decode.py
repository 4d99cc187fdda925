"""The sharded decode step driven on a mesh of ranks.

The ranks are started by ``launch/ranks.py`` ``run_ranks``.
``decode_rank`` is a rank's side of a decode run: it builds its blocks of
the weights (from a numpy tree, or seeded and cut leaf by leaf so that no
rank holds the whole tree) and of the decode state, runs
``serving/decode.py`` ``make_decode_step`` over the tokens and gathers
what the caller compares.
"""

from __future__ import annotations

import time

import numpy as np
import torch



def kernel_counts() -> dict:
    """The serving kernels' launch counters in this process."""
    from ..kernels.kv_update import kernel as kvk
    from ..kernels.paged_attention import kernel as pak
    return {"rope_kv_append": kvk.rope_kv_append_launches,
            "rope_kv_append_int8": kvk.rope_kv_append_int8_launches,
            "paged_attention": pak.launches,
            "paged_attention_int8": pak.int8_launches,
            "kv_update": kvk.launches}


def zero_kernel_counts() -> None:
    from ..kernels.kv_update import kernel as kvk
    from ..kernels.paged_attention import kernel as pak
    kvk.rope_kv_append_launches = kvk.rope_kv_append_int8_launches = 0
    kvk.launches = pak.launches = pak.int8_launches = 0


def shard_local_table(dstate: dict, batch: int, dp: int,
                      batch_sharded: bool) -> np.ndarray:
    """A global block table whose page ids are shard-local, as the
    reference's multi-device test builds it: batch-sharded, lane b (the
    i-th of its data shard) takes pages i * P .. i * P + P - 1 of its
    shard's arena; sequence-parallel, table column j lives on data shard
    j // (P / dp) as page j % (P / dp)."""
    P = dstate["block_table"].shape[1]
    if not batch_sharded:
        return np.tile((np.arange(P) % (P // dp)).astype(np.int32),
                       (batch, 1))
    per = batch // dp
    return np.stack([(b % per) * P + np.arange(P)
                     for b in range(batch)]).astype(np.int32)


def mesh_pages(table: np.ndarray, dp: int, pages_loc: int,
               batch_sharded: bool) -> np.ndarray:
    """[B, P] global arena page of each (lane, column) of a shard-local
    table (-1 kept): data shard d's arena is global pages d * pages_loc
    .. (d + 1) * pages_loc - 1; batch-sharded, lane b lives on data shard
    b // (B / dp), sequence-parallel column j on j // (P / dp)."""
    B, P = table.shape
    d = (np.arange(B)[:, None] // (B // dp)) if batch_sharded else \
        (np.arange(P)[None, :] // (P // dp))
    return np.where(table >= 0, d * pages_loc + table, -1)


def to_mesh_layout(cfg, dstate: dict, *, max_seq: int, dp: int,
                   batch_sharded: bool) -> dict:
    """A one-device decode state (every lane's pages its own) laid out as
    a mesh with ``dp`` data shards holds it globally: ``make_dstate(...,
    dp_shards=dp)``'s shapes, ``shard_local_table``'s table, each
    written page moved to the page the shard-local table names; ``pos``,
    ``kv_pos`` (columns past the one-device table -1) and the recurrent
    states as they are.  On the state's device."""
    from ..serving.decode import make_dstate
    B = dstate["pos"].shape[0]
    dev = dstate["pos"].device
    out = make_dstate(cfg, batch=B, max_seq=max_seq, dp_shards=dp,
                      device=dev)
    table = shard_local_table(out, B, dp, batch_sharded)
    out["block_table"] = torch.as_tensor(table, device=dev)
    src = dstate["block_table"].cpu().numpy()
    P = src.shape[1]
    out["pos"].copy_(dstate["pos"])
    out["kv_pos"][:, :P] = dstate["kv_pos"]
    for part in ("units", "tail"):
        for name, st in dstate[part].items():
            lead = 1 if part == "units" else 0
            for key, leaf in st.items():
                dst = out[part][name][key]
                if key not in ("k", "v", "ks", "vs"):
                    dst.copy_(leaf)
                    continue
                pages_loc = dst.shape[lead] // dp
                to = mesh_pages(table, dp, pages_loc, batch_sharded)[:, :P]
                ok = src >= 0
                idx = (slice(None),) * lead
                dst[idx + (torch.as_tensor(to[ok], device=dev),)] = \
                    leaf[idx + (torch.as_tensor(src[ok], device=dev),)]
    return out


def decode_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of a decode run.  ``job``: ``cfg``; ``mesh`` (shape,
    names); ``device`` ("cpu" or "cuda"); ``batch_sharded``; ``params``
    (a numpy tree, global) or ``seed`` (``init_params`` on the device,
    each leaf cut as it is made); ``max_seq``, ``tokens``
    (int32 [B, S], fed one column a step); optionally ``state_file`` (a
    global state saved by ``torch.save``, laid out by ``to_mesh_layout``)
    to go on from (else a zero state with ``shard_local_table``),
    ``keep_steps`` (the steps whose logits come back; default all),
    ``gather_state``.  Every rank
    returns its launch counts and step times; rank 0 also the greedy
    tokens [S, B], the kept logits [len(keep_steps), B, V] and (with
    ``gather_state``) the final state gathered into global numpy
    arrays."""
    from ..distributed.mesh import data_axes, axis_size, make_mesh
    from ..distributed.specs import (dstate_specs, gather_block, gather_tree,
                                     local_block, param_spec,
                                     serve_param_specs, shard_tree)
    from ..models.params import from_numpy_tree, init_params
    from ..serving.decode import make_decode_step, make_dstate

    cfg = job["cfg"]
    dev = torch.device("cpu") if job.get("device", "cpu") == "cpu" \
        else torch.device("cuda", 0)
    shape, names = job["mesh"]
    mesh = make_mesh(shape, names, dev.type)
    dp = axis_size(mesh, data_axes(mesh))
    tp = axis_size(mesh, "model")
    bs = job.get("batch_sharded", True)
    B, S = job["tokens"].shape

    if "params" in job:
        glob = from_numpy_tree(job["params"], dev)
        params = shard_tree(glob, serve_param_specs(cfg, glob, tp), mesh)
        del glob
    else:
        def keep(path, leaf):             # each leaf cut as it is made
            return local_block(leaf, param_spec(cfg, path, leaf.dim(), tp),
                               mesh)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            job["seed"]), device=dev, keep=keep)

    if "state_file" in job:           # a state decoded elsewhere
        glob = torch.load(job["state_file"], map_location=dev)
    else:
        glob = make_dstate(cfg, batch=B, max_seq=job["max_seq"],
                           dp_shards=dp, device=dev)
        glob["block_table"] = torch.as_tensor(
            shard_local_table(glob, B, dp, bs), device=dev)
    sspecs = dstate_specs(cfg, mesh, bs)
    ds = shard_tree(glob, sspecs, mesh)
    del glob
    step = make_decode_step(cfg, mesh, params, batch_sharded=bs,
                            return_logits=True)
    tokens = torch.as_tensor(job["tokens"], device=dev)
    if bs:
        tokens = local_block(tokens, (data_axes(mesh), None), mesh)
    keep_steps = set(job.get("keep_steps", range(S)))

    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_kernel_counts()
    toks, kept, times = [], [], []
    for t in range(S):
        t0 = time.perf_counter()
        ds, tok, lg = step(params, ds, tokens[:, t].contiguous())
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        toks.append(tok)
        if t in keep_steps:
            kept.append(lg)
    counts = kernel_counts()
    bspec = (None, data_axes(mesh)) if bs else (None, None)
    toks = gather_block(torch.stack(toks), bspec, mesh)
    lgs = gather_block(torch.stack(kept), bspec + (None,), mesh) \
        if kept else None
    state = gather_tree(ds, sspecs, mesh) if job.get("gather_state") else None
    res = {"rank": rank, "launches": counts, "step_s": times}
    if rank == 0:
        res["tokens"] = toks.cpu().numpy()
        res["logits"] = None if lgs is None else lgs.float().cpu().numpy()
        if state is not None:
            res["state"] = _numpy_tree(state)
    return res


def one_device_decode(cfg, dev, tokens, max_seq: int, keep, hand_off=None,
                      seed: int = 0) -> dict:
    """``decode_step`` on ``dev`` over ``tokens`` [B, S] (numpy) with the
    seeded weights a mesh's ranks cut (``init_params`` from ``seed``),
    every lane on pages of its own: the logits at the ``keep`` steps, the
    greedy tokens [S, B], the median step time and the kernels' launches.
    ``hand_off`` (step, [(data shards, batch-sharded, path)]): before that
    step the state is laid out for each mesh (``to_mesh_layout``) and
    saved at its path, for ``decode_rank``'s ``state_file``."""
    from ..models.params import init_params
    from ..serving.decode import decode_step, make_dstate
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    B, S = tokens.shape
    ds = make_dstate(cfg, batch=B, max_seq=max_seq, device=dev)
    Pn = ds["block_table"].shape[1]
    ds["block_table"] = torch.arange(B * Pn, dtype=torch.int32,
                                     device=dev).reshape(B, Pn)
    toks = torch.as_tensor(tokens, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    zero_kernel_counts()
    kept, out, times = [], [], []
    for t in range(S):
        if hand_off is not None and t == hand_off[0]:
            for dp, bs, path in hand_off[1]:
                torch.save(to_mesh_layout(cfg, ds, max_seq=max_seq, dp=dp,
                                          batch_sharded=bs), path)
        t0 = time.perf_counter()
        ds, tok, lg = decode_step(cfg, params, ds, toks[:, t].contiguous(),
                                  return_logits=True)
        sync()
        times.append(time.perf_counter() - t0)
        out.append(tok)
        if t in keep:
            kept.append(lg.float().cpu().numpy())
    return {"logits": np.stack(kept),
            "tokens": torch.stack(out).cpu().numpy(),
            "launches": kernel_counts(),
            "ms_per_step_median": 1e3 * float(np.median(times[2:]))}


def decode_jobs(rank: int, world: int, jobs: list) -> list:
    """``decode_rank`` for each job in turn (one start-up of the ranks for
    several runs); each job's tensors are freed before the next."""
    out = []
    for job in jobs:
        out.append(decode_rank(rank, world, job))
        if job.get("device", "cpu") != "cpu":
            torch.cuda.empty_cache()
    return out


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    t = tree.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

