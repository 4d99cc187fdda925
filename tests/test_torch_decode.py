"""The port's decode step against the reference's ``make_decode_step``
(one host device) and against the full-sequence ``transformer.forward``,
on the qwen2.5 smoke config with nonzero QKV biases.

fp32: logits within 1e-3 of the reference step and identical greedy
tokens at every step.  bf16: within 3e-2 relative to the largest logit
(the reference rounds the attention weights to bf16 before P.V; the
port's kernel keeps them in fp32)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.runtime import make_host_mesh  # noqa: E402
from repro.serving import decode as dec  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.serving import decode as tdec  # noqa: E402

_DT = {"fp32": (jnp.float32, torch.float32),
       "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S = 2, 24


def _setup(dt, page):
    jdt, tdt = _DT[dt]
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"), dtype=jdt,
                               page_size=page)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_32b"), dtype=tdt,
                               page_size=page)
    params = jax.tree.map(np.asarray,
                          T.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(5)
    attn = params["units"]["l0"]["attn"]
    for b in ("bq", "bk", "bv"):          # init zeroes them; use them
        attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(
            attn[b].dtype)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, tcfg, params, toks


def _tables(cfg, rng):
    """A scattered block table: each sequence's pages come from a
    shuffled pool, so page ids are not positions."""
    Pn = max(1, 64 // cfg.page_size)
    pool = rng.permutation(B * Pn).astype(np.int32)
    return pool.reshape(B, Pn)


@pytest.mark.parametrize("dt,page", [("fp32", 128), ("fp32", 8),
                                     ("bf16", 128), ("bf16", 8)])
def test_decode_step_matches_reference(dt, page):
    jcfg, tcfg, params, toks = _setup(dt, page)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_numpy_tree(params)
    step, _, _ = dec.make_decode_step(
        jcfg, make_host_mesh(), jax.eval_shape(lambda: jparams),
        return_logits=True)
    bt = _tables(jcfg, np.random.default_rng(0))
    ds = dec.make_dstate(jcfg, batch=B, max_seq=64)
    ds["block_table"] = jnp.asarray(bt)
    ts = tdec.make_dstate(tcfg, batch=B, max_seq=64, device="cpu")
    ts["block_table"] = torch.as_tensor(bt)
    full, _ = T.forward(jcfg, jparams, {"tokens": jnp.asarray(toks)})
    full = np.asarray(full, np.float32)
    scale = float(np.abs(full).max()) + 1e-9
    for t in range(S):
        ds, jtok, jlg = step(jparams, ds, jnp.asarray(toks[:, t]))
        ts, ttok, tlg = tdec.decode_step(tcfg, tparams, ts,
                                         torch.as_tensor(toks[:, t]),
                                         return_logits=True)
        jlg = np.asarray(jlg, np.float32)
        tlg = tlg.numpy()
        if dt == "fp32":
            assert np.abs(jlg - tlg).max() < 1e-3, t
            np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
            assert np.abs(tlg - full[:, t]).max() / scale < 1e-3, t
        else:
            assert np.abs(jlg - tlg).max() / scale < 3e-2, t
            assert np.abs(tlg - full[:, t]).max() / scale < 3e-2, t
    np.testing.assert_array_equal(np.asarray(ds["kv_pos"]),
                                  ts["kv_pos"].numpy())
    np.testing.assert_array_equal(np.asarray(ds["pos"]), ts["pos"].numpy())
    # the arenas hold the same K/V (in place on the port's side)
    for f in ("k", "v"):
        a = np.asarray(ds["units"]["l0"][f], np.float32)
        b_ = ts["units"]["l0"][f].float().numpy()
        tol = 3e-2 * np.abs(a).max() if dt == "bf16" else 1e-4
        assert np.abs(a - b_).max() <= tol
