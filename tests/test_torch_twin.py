"""Harness for the port-vs-reference engine tests: a ``Twin`` drives the
reference engine and the port's engine with the same calls (the engine
scripts live in ``test_torch_engine*.py``; this file tests the harness).

Both engines run the qwen2.5 smoke config in fp32 from the same weights
(the reference's ``init_params`` with nonzero biases, handed over as
numpy) and are driven by the scripts of the reference's engine tests.
After every call the emitted tokens, block tables, ``kv_pos``, every
``AllocState`` field, the durable prefix-store words and the lane span
records must be equal, and each active lane's ``kv_pos`` rows must hold
its positions in order; ``crash_and_recover`` must return equal stats.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import jax_alloc as ja  # noqa: E402
from repro.models import transformer as T  # noqa: E402
from repro.runtime import make_host_mesh  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models.params import from_numpy_tree  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

PAGE = 8


@pytest.fixture(scope="module")
def jit_reference_recover():
    """The reference engine calls ``jax_recovery.recover`` eagerly, which
    recompiles its fixed-point loop on every crash; the same function
    under ``jax.jit`` gives the same integers in a fraction of the time."""
    from repro.serving import engine as jeng
    mp = pytest.MonkeyPatch()
    mp.setattr(jeng.jr, "recover",
               jax.jit(jeng.jr.recover, static_argnums=(0, 3)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(get_smoke_config("qwen2_5_32b"), page_size=PAGE,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(t_smoke("qwen2_5_32b"), page_size=PAGE,
                               dtype=torch.float32)
    params = jax.tree.map(np.asarray, T.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(42)
    attn = params["units"]["l0"]["attn"]
    for b in ("bq", "bk", "bv"):    # init zeroes the biases; exercise them
        attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(
            attn[b].dtype)
    jparams = jax.tree.map(jnp.asarray, params)
    return jcfg, tcfg, jparams, from_numpy_tree(params)


class Twin:
    """Drive the reference and the port with the same calls and compare
    their observable state after each one."""

    def __init__(self, models, **kw):
        jcfg, tcfg, jparams, tparams = models
        self.cfg = jcfg
        self.j = JEngine(jcfg, make_host_mesh(), jparams, **kw)
        self.t = TEngine(tcfg, tparams, device="cpu", **kw)
        self.check("init")

    def __call__(self, name, *args, **kw):
        rj = getattr(self.j, name)(*args, **kw)
        rt = getattr(self.t, name)(*args, **kw)
        if name == "crash_and_recover":
            for r in (rj, rt):
                r["phases"] = {k: v["items"] for k, v in r["phases"].items()}
        assert rj == rt, (name, rj, rt)
        self.check(name)
        return rt

    def steps(self, n):
        for _ in range(n):
            self("step")

    def check(self, where):
        j, t = self.j, self.t
        for f in ("pos", "block_table", "kv_pos"):
            np.testing.assert_array_equal(np.asarray(j.dstate[f]),
                                          t.dstate[f].numpy(),
                                          err_msg=f"{where}: {f}")
        # ROADMAP C9: the port's decode attention takes validity from
        # lengths = pos + 1 and the block table, which agrees with the
        # reference's per-slot kv_pos while each active lane's rows fill in
        # order: positions 0 .. n - 1 slot by slot, then -1, n = pos (or
        # the table's width, past which positions drop)
        kv, pos = t.dstate["kv_pos"].numpy(), t.dstate["pos"].numpy()
        for lane, sess in t.sessions.items():
            if sess.done:
                continue
            flat = kv[lane].reshape(-1)
            n = int((flat >= 0).sum())
            np.testing.assert_array_equal(
                flat[:n], np.arange(n),
                err_msg=f"{where}: lane {lane}'s kv_pos rows out of order")
            assert (flat[n:] == -1).all(), (where, lane, flat)
            assert n == min(int(pos[lane]), flat.size), (where, lane, n,
                                                         pos[lane])
        for f in ja.AllocState._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(j.astate, f)),
                getattr(t.astate, f).numpy(), err_msg=f"{where}: {f}")
        np.testing.assert_array_equal(j.prefix_store.words,
                                      t.prefix_store.words,
                                      err_msg=f"{where}: prefix records")
        assert j.prefix_store.heads == t.prefix_store.heads, where
        assert j.large_spans == t.large_spans, where
        assert j.shared_spans == t.shared_spans, where
        assert j.page_refs == t.page_refs, where
        assert {k: s.tokens for k, s in j.sessions.items()} == \
            {k: s.tokens for k, s in t.sessions.items()}, where
        np.testing.assert_array_equal(j.cur_tokens, t.cur_tokens)


def _prompt(seed, n, vocab=128):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, vocab, size=n)]


def test_twin_detects_divergence(models):
    """The harness has teeth: a one-field difference between the two
    engines' allocator states, kv_pos rows out of order in both, or a
    difference in a lane's tokens, fails ``check``."""
    from repro_torch.core import alloc as ta
    tw = Twin(models, lanes=2, max_seq=32)
    lane = tw("add_request", [3, 1, 4])
    tw.steps(2)
    saved = tw.t.astate
    tw.t.astate = ta.set_root(saved, 1, 5)
    with pytest.raises(AssertionError):
        tw.check("corrupted root")
    tw.t.astate = saved
    # kv_pos rows out of order in both engines alike: equal, but not the
    # in-order fill the port's decode attention relies on (ROADMAP C9)
    kv = tw.t.dstate["kv_pos"].clone()
    kv[lane, 0, [0, 1]] = kv[lane, 0, [1, 0]]
    good_j, good_t = tw.j.dstate, tw.t.dstate
    tw.j.dstate = dict(good_j, kv_pos=jnp.asarray(kv.numpy()))
    tw.t.dstate = dict(good_t, kv_pos=kv)
    with pytest.raises(AssertionError, match="out of order"):
        tw.check("swapped kv_pos")
    tw.j.dstate, tw.t.dstate = good_j, good_t
    tw.check("restored")
    tw.t.sessions[lane].tokens.append(0)
    with pytest.raises(AssertionError):
        tw.check("corrupted tokens")
