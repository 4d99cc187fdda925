"""The port's device allocator and recovery against the reference, in
lock step: the same random op traces through ``repro.core.jax_alloc`` and
``repro_torch.core.alloc`` must leave every ``AllocState`` field equal
after every op, and recovery of the same snapshot must rebuild equal
state and marks."""

import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import jax_alloc as ja  # noqa: E402
from repro.core import jax_recovery as jr  # noqa: E402
from repro_torch.core import alloc as ta  # noqa: E402
from repro_torch.core import recovery as tr  # noqa: E402

# two classes (8 and 2 blocks per superblock), a small cache so spills
# happen, and 4 run buckets so the overflow-bucket fallback runs too
GEOM = dict(num_sbs=20, sb_words=32, class_words=(4, 16), cache_cap=8,
            expand_sbs=2, run_buckets=4)
JCFG = ja.ArenaConfig(**GEOM)
TCFG = ta.ArenaConfig(**GEOM)
LANES = 6
ROOTS = 8


@functools.lru_cache(maxsize=None)
def _jfn(name: str, cls: int = -1):
    fn = getattr(ja, name)
    kw = {"cfg": JCFG} if cls < 0 else {"cfg": JCFG, "cls": cls}
    return jax.jit(functools.partial(fn, **kw))


def _tfn(name: str, cls: int = -1):
    fn = getattr(ta, name)
    kw = {"cfg": TCFG} if cls < 0 else {"cfg": TCFG, "cls": cls}
    return functools.partial(fn, **kw)


def assert_state_equal(js, ts, where=""):
    for f in ja.AllocState._fields:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (where, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {f}")


def _run_trace(seed: int, n_ops: int):
    """Drive one random trace through both allocators; returns both final
    states plus the live small blocks and span heads."""
    rng = np.random.default_rng(seed)
    js = ja.init_state(JCFG, max_roots=ROOTS)
    ts = ta.init_state(TCFG, max_roots=ROOTS, device="cpu")
    assert_state_equal(js, ts, "init")
    live = {0: [], 1: []}
    spans: list[int] = []
    sbw = JCFG.sb_words
    for i in range(n_ops):
        op = rng.choice(["alloc", "free", "alloc_large", "acquire",
                         "free_large", "trim", "root"],
                        p=[0.25, 0.2, 0.15, 0.12, 0.12, 0.1, 0.06])
        where = f"seed {seed} op {i} {op}"
        if op == "alloc":
            cls = int(rng.integers(2))
            need = rng.random(LANES) < 0.7
            js, jo = _jfn("alloc", cls)(state=js, need=jnp.asarray(need))
            ts, to = _tfn("alloc", cls)(state=ts, need=torch.as_tensor(need))
            np.testing.assert_array_equal(np.asarray(jo), to.numpy(),
                                          err_msg=where)
            live[cls] += [int(o) for o in to.tolist() if o >= 0]
        elif op == "free":
            cls = int(rng.integers(2))
            offs = np.full(LANES, -1, np.int32)
            k = min(len(live[cls]), int(rng.integers(1, LANES + 1)))
            pick = rng.choice(len(live[cls]), size=k, replace=False) \
                if k else []
            offs[:k] = [live[cls][j] for j in pick]
            if rng.random() < 0.3:          # invalid lane: a span interior
                offs[-1] = int(rng.integers(0, JCFG.total_words))
            live[cls] = [o for j, o in enumerate(live[cls]) if j not in
                         set(int(p) for p in pick)]
            mask = offs >= 0
            js = _jfn("free", cls)(state=js, offs=jnp.asarray(offs),
                                   mask=jnp.asarray(mask))
            ts = _tfn("free", cls)(state=ts, offs=torch.as_tensor(offs),
                                   mask=torch.as_tensor(mask))
        elif op == "alloc_large":
            nwords = int(rng.integers(0, 5 * sbw))
            js, jo = _jfn("alloc_large")(state=js, nwords=jnp.int32(nwords))
            ts, to = _tfn("alloc_large")(state=ts, nwords=nwords)
            assert int(jo) == int(to), where
            if int(to) >= 0:
                spans.append(int(to))
        else:
            off = (spans[int(rng.integers(len(spans)))]
                   if spans and rng.random() < 0.85
                   else int(rng.integers(-1, JCFG.total_words)))
            if op == "acquire":
                n = int(rng.integers(-1, 4))
                js, jv = _jfn("acquire_span")(state=js, off=jnp.int32(off),
                                              n_sbs=jnp.int32(n))
                ts, tv = _tfn("acquire_span")(state=ts, off=off, n_sbs=n)
                assert bool(jv) == bool(tv), where
            elif op == "free_large":
                n = int(rng.integers(-1, 4))
                js = _jfn("free_large")(state=js, off=jnp.int32(off),
                                        n_sbs=jnp.int32(n))
                ts = _tfn("free_large")(state=ts, off=off, n_sbs=n)
            elif op == "trim":
                keep, held = int(rng.integers(0, 4)), int(rng.integers(-1, 5))
                js, jv = _jfn("trim_large")(
                    state=js, off=jnp.int32(off), n_keep=jnp.int32(keep),
                    n_held=jnp.int32(held))
                ts, tv = _tfn("trim_large")(state=ts, off=off, n_keep=keep,
                                            n_held=held)
                assert bool(jv) == bool(tv), where
            else:
                slot = int(rng.integers(ROOTS))
                js = ja.set_root(js, slot, jnp.int32(off))
                ts = ta.set_root(ts, slot, off)
        assert_state_equal(js, ts, where)
    return js, ts, live, spans


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alloc_lockstep_trace(seed):
    js, ts, _, _ = _run_trace(seed, n_ops=70)
    assert ja.free_runs(js, JCFG) == ta.free_runs(ts, TCFG)
    assert ja.live_blocks(js, JCFG) == ta.live_blocks(ts, TCFG)
    for nsb in (1, 2, 5):
        jh, jl, jf = ja.scan_best_fit(js, JCFG, nsb)
        th, tl, tf = ta.scan_best_fit(ts, TCFG, nsb)
        assert (bool(jh), int(jl), int(jf)) == (bool(th), int(tl), int(tf))


@pytest.mark.parametrize("seed", [3, 4])
def test_recovery_matches_reference(seed):
    """The same persistent snapshot and reference table through
    ``jr.recover`` and the port: marks and every rebuilt field equal."""
    js, ts, live, spans = _run_trace(seed, n_ops=50)
    rng = np.random.default_rng(seed + 100)
    S = jr.num_slots(JCFG)
    minw = min(JCFG.class_words)
    blocks = live[0] + live[1] + spans
    roots = np.full((ROOTS,), -1, np.int32)
    ref = np.full((S, 3), -1, np.int32)
    if blocks:
        nroot = min(len(blocks), 3)
        roots[:nroot] = rng.choice(blocks, size=nroot, replace=False)
        for src in blocks:                  # a random reference graph
            tg = rng.choice(blocks, size=int(rng.integers(0, 3)))
            ref[src // minw, :len(tg)] = tg
    jp = ja.persistent_snapshot(js)
    jp["roots"] = jnp.asarray(roots)
    tp = ta.persistent_snapshot(ts)
    tp["roots"] = torch.as_tensor(roots)
    jst, jm = jax.jit(functools.partial(jr.recover, JCFG))(
        jp, jnp.asarray(ref))
    tst, tm = tr.recover(TCFG, tp, torch.as_tensor(ref))
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    assert_state_equal(jst, tst, "recovered")
    jc = jr.span_ref_counts(JCFG, jp["roots"], jnp.asarray(ref), jm)
    tc = tr.span_ref_counts(TCFG, tp["roots"], torch.as_tensor(ref), tm)
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    offs = np.asarray(blocks[:4] + [-1], np.int32)
    seal = rng.random(offs.shape[0]) < 0.8
    np.testing.assert_array_equal(
        np.asarray(jr.live_record_mask(JCFG, jm, jnp.asarray(offs),
                                       seal_ok=jnp.asarray(seal))),
        tr.live_record_mask(TCFG, tm, offs, seal_ok=seal).numpy())


def test_free_run_table_matches_reference():
    rng = np.random.default_rng(9)
    for _ in range(5):
        mask = rng.random(JCFG.num_sbs) < 0.5
        jl, js_ = ja.free_run_table(jnp.asarray(mask), JCFG.num_sbs)
        tl, ts_ = ta.free_run_table(torch.as_tensor(mask), TCFG.num_sbs)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(js_), ts_.numpy())
