"""A windowed (``local_attn``) decode run past its page table: the port's
decode step against the reference's ``make_decode_step``.

The reference sizes a windowed table as window pages + 1 (here 3 pages
of 8: 24 positions) and never wraps ``pos // page``.  Past the table the
new K/V go to the dump page; once ``pos >= 24 + window - 1`` no position
is valid, and the reference's decode layer returns the mean of the V rows
it gathers.  The port's decode layer gives such a lane the same mean
(its paged kernel alone would give 0).  fp32: logits within 1e-3 and
identical greedy tokens at every one of the 48 steps."""

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

B, STEPS, WINDOW, PAGE, MAX_SEQ = 2, 48, 16, 8, 64
PATTERN = (("local_attn", "mlp"),)


def _configs():
    over = dict(pattern=PATTERN, window=WINDOW, page_size=PAGE)
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"),
                               dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_32b"), dtype=torch.float32,
                               **over)
    return jcfg, tcfg


def test_windowed_decode_past_the_table_matches_reference():
    jcfg, tcfg = _configs()
    params = jax.tree.map(np.asarray,
                          T.init_params(jcfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(7)
    for u in params["units"].values():          # init zeroes the biases
        for b in ("bq", "bk", "bv"):
            u["attn"][b] = (0.5 * rng.standard_normal(
                u["attn"][b].shape)).astype(u["attn"][b].dtype)
    toks = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = from_numpy_tree(params)
    step, _, _ = dec.make_decode_step(
        jcfg, make_host_mesh(), jax.eval_shape(lambda: jparams),
        return_logits=True)
    ds = dec.make_dstate(jcfg, batch=B, max_seq=MAX_SEQ)
    ts = tdec.make_dstate(tcfg, batch=B, max_seq=MAX_SEQ, device="cpu")
    Pn = ts["block_table"].shape[1]
    assert Pn == WINDOW // PAGE + 1 and Pn * PAGE + WINDOW - 1 < STEPS
    bt = rng.permutation(B * Pn).astype(np.int32).reshape(B, Pn)
    ds["block_table"] = jnp.asarray(bt)
    ts["block_table"] = torch.as_tensor(bt)
    for t in range(STEPS):
        ds, jtok, jlg = step(jparams, ds, jnp.asarray(toks[:, t]))
        ts, ttok, tlg = tdec.decode_step(tcfg, tparams, ts,
                                         torch.as_tensor(toks[:, t]),
                                         return_logits=True)
        err = np.abs(np.asarray(jlg, np.float32) - tlg.numpy()).max()
        assert err < 1e-3, (t, err)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(),
                                      err_msg=f"step {t}")
    np.testing.assert_array_equal(np.asarray(ds["pos"]), ts["pos"].numpy())
