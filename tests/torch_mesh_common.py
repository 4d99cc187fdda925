"""Shared by the mesh decode tests: the reference's decode on a one-device
mesh and the port's on gloo ranks, fed the same numpy weights, block
tables and tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config
from repro.models import transformer as T
from repro.runtime import make_host_mesh
from repro.serving import decode as dec
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch.mesh_decode import decode_rank, mesh_pages
from repro_torch.launch.ranks import run_ranks


def configs(arch, **over):
    """The reference's and the port's smoke config of ``arch`` in fp32
    with ``over`` applied."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=jnp.float32,
                               **over)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=torch.float32, **over)
    return jcfg, tcfg


def weights(jcfg, seed):
    """The reference's init as numpy, QKV biases made non-zero."""
    params = jax.tree.map(np.asarray, T.init_params(
        jcfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    if jcfg.qkv_bias:
        for part in ("units", "tail"):
            for layer in params.get(part, {}).values():
                for b in ("bq", "bk", "bv"):
                    if "attn" in layer:
                        a = layer["attn"][b]
                        layer["attn"][b] = (0.5 * rng.standard_normal(
                            a.shape)).astype(a.dtype)
    return params


def reference_decode(jcfg, params, toks, *, dp, batch_sharded, max_seq):
    """The reference's ``make_decode_step`` on a (1, 1) mesh, its state
    sized for ``dp`` data shards (so its table has the port's columns) and
    every lane on pages of its own.  (logits [S, B, V], tokens [S, B],
    the final state as numpy, the block table)."""
    B, S = toks.shape
    jparams = jax.tree.map(jnp.asarray, params)
    step, _, _ = dec.make_decode_step(
        jcfg, make_host_mesh(), jax.eval_shape(lambda: jparams),
        batch_sharded=batch_sharded, return_logits=True)
    ds = dec.make_dstate(jcfg, batch=B, max_seq=max_seq, dp_shards=dp)
    Pn = ds["block_table"].shape[1]
    bt = (np.arange(B * Pn, dtype=np.int32).reshape(B, Pn) if batch_sharded
          else np.arange(Pn, dtype=np.int32)[None])
    ds["block_table"] = jnp.asarray(bt)
    logits, out = [], []
    for t in range(S):
        ds, tok, lg = step(jparams, ds, jnp.asarray(toks[:, t]))
        logits.append(np.asarray(lg, np.float32))
        out.append(np.asarray(tok))
    return (np.stack(logits), np.stack(out),
            jax.tree.map(lambda a: np.asarray(a, np.float32)
                         if a.dtype == jnp.bfloat16 else np.asarray(a), ds),
            bt)


def port_decode(tcfg, params, toks, *, mesh, batch_sharded, max_seq):
    """The port's ``make_decode_step`` on gloo ranks (CPU): rank 0's
    result (tokens [S, B], logits [S, B, V], the gathered state) and the
    shard-local table it ran with."""
    world = int(np.prod(mesh))
    res = run_ranks(decode_rank, world, {
        "cfg": tcfg, "mesh": (mesh, ("data", "model")), "device": "cpu",
        "batch_sharded": batch_sharded, "params": params,
        "max_seq": max_seq, "tokens": toks, "gather_state": True},
        device="cpu")
    return res[0]


def assert_arenas_match(jstate, tstate, jbt, dp, batch_sharded, rel):
    """Every lane's table pages in the reference's arenas and the port's
    gathered ones (the dump pages left out) within ``rel`` of the
    largest value."""
    B, P = tstate["block_table"].shape
    for part in ("units", "tail"):
        for name, st in tstate[part].items():
            for key in ("k", "v"):
                if key not in st:
                    continue
                got, want = st[key], jstate[part][name][key]
                lead = got.ndim - 4
                pages_loc = got.shape[lead] // dp
                tp_pages = mesh_pages(tstate["block_table"], dp, pages_loc,
                                      batch_sharded)
                idx = (slice(None),) * lead
                g = got[idx + (tp_pages,)].astype(np.float32)
                w = want[idx + (np.broadcast_to(jbt, (B, P)),)].astype(
                    np.float32)
                scale = np.abs(w).max() + 1e-9
                assert np.abs(g - w).max() <= rel * scale, (part, name, key)

