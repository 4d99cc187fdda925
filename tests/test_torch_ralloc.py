"""The port's host Ralloc against the reference's.

A seeded op trace -- small and large mallocs, frees (a continuation
pointer among them), span leases, typed (``stack_node`` / ``tree_node``)
and untyped roots, batched roots, ``flush_range``, fences, a crash, a
reopen over the durable image and ``recover`` -- runs through both heaps
with the same heap seed.  After every op the two images (and, in sim
mode, the write-back caches) are equal word for word, every op returns
the same value, the recovery stats agree but for their timings, and the
``heap.*`` obs sources read the same counts.  Then the reference's own
invariant cases (``tests/test_core_ralloc.py``, ``tests/test_recovery.py``)
run on the port, and the port's additions: the bulk word paths, the
chunked conservative scan, the refused ``prefix_index`` / ``prefix_trie``
roots and the fault sites."""

import os
import threading

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                      # container without dev deps
    from _hypothesis_fallback import given, settings, strategies as st

from repro import obs as jobs  # noqa: E402
from repro.analysis import faults as jfaults  # noqa: E402
from repro.core import layout as jlayout  # noqa: E402
from repro.core import recovery as jrec  # noqa: E402
from repro.core.ralloc import Ralloc as JRalloc  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.analysis import faults as tfaults  # noqa: E402
from repro_torch.core import heap_recovery as trec  # noqa: E402
from repro_torch.core import layout  # noqa: E402
from repro_torch.core import pptr as pp  # noqa: E402
from repro_torch.core.atomics import NVMArray  # noqa: E402
from repro_torch.core.filters import FilterRegistry, NotPorted  # noqa: E402
from repro_torch.core.ralloc import Ralloc  # noqa: E402

MB = 1 << 20
HEAP_SOURCES = ("heap.flush", "heap.fence", "heap.cas", "heap.drain")
TIMINGS = ("mark_seconds", "sweep_seconds", "total_seconds")


def _untimed(stats: dict) -> dict:
    out = {k: v for k, v in stats.items() if k not in TIMINGS}
    out["phases"] = {k: v["items"] for k, v in stats["phases"].items()}
    return out


class Twin:
    """The reference's heap and the port's, driven op for op."""

    def __init__(self, size, *, sim, seed, images=(None, None)):
        self.sim = sim
        self.heaps = [cls(None, size, sim_nvm=sim, seed=seed, backing=img)
                      for cls, img in zip((JRalloc, Ralloc), images)]
        self.check()

    def do(self, name, *args):
        outs = [getattr(h, name)(*args) for h in self.heaps]
        assert outs[0] == outs[1], (name, args, outs)
        self.check()
        return outs[0]

    def crash(self):
        for h in self.heaps:
            h.heap.crash()
        self.check()

    def check(self):
        a, b = self.heaps
        assert np.array_equal(a.mem.nvm, b.mem.nvm)
        assert (a.mem.n_flush, a.mem.n_fence, a.mem.n_cas, a.mem.n_drain) \
            == (b.mem.n_flush, b.mem.n_fence, b.mem.n_cas, b.mem.n_drain)
        if self.sim:
            assert a.mem._cache == b.mem._cache
            assert a.mem._scheduled == b.mem._scheduled

    def images(self):
        return tuple(h.mem.nvm.copy() for h in self.heaps)


def _sources():
    j, t = jobs.snapshot()["counters"], tobs.snapshot()["counters"]
    return {k: j[k] for k in HEAP_SOURCES}, {k: t[k] for k in HEAP_SOURCES}


def _run_trace(seed: int, n_ops: int, sim: bool) -> None:
    rng = np.random.default_rng(seed)
    tw = Twin(16 * MB, sim=sim, seed=seed)
    live: dict[int, int] = {}        # block -> bytes
    leases: dict[int, int] = {}      # large block -> extra leases held
    rooted: set[int] = set()
    stack = tree = None

    def pick(pred=lambda p: True):
        cands = sorted(p for p in live if p not in rooted and pred(p))
        return None if not cands else cands[int(rng.integers(len(cands)))]

    for _ in range(n_ops):
        op = rng.choice(["small", "small", "large", "free", "free", "stack",
                         "tree", "root", "roots", "write", "fence",
                         "acquire"])
        if op == "small":
            size = int(rng.choice([8, 24, 64, 200, 1000, 4096, 14336]))
            p = tw.do("malloc", size)
            if p is not None:
                live[p] = size
        elif op == "large":
            size = int(rng.integers(70_000, 400_000))
            p = tw.do("malloc", size)
            if p is not None:
                live[p] = size
        elif op == "free":
            p = pick()
            if p is None:
                continue
            size = live[p]
            q = p
            if size > layout.MAX_SMALL and size > layout.SB_SIZE and \
                    rng.random() < 0.3:
                q = p + layout.SB_WORDS + 7      # a continuation pointer
            tw.do("free", q)
            if leases.get(p):
                leases[p] -= 1
            else:
                del live[p]
        elif op == "acquire":
            p = pick(lambda b: live[b] > layout.MAX_SMALL)
            if p is not None:
                tw.do("span_acquire", p)
                leases[p] = leases.get(p, 0) + 1
        elif op == "stack":
            node = tw.do("malloc", 16)
            if node is None:
                continue
            tw.do("write_word", node, pp.PPTR_NULL if stack is None
                  else pp.encode(node, stack))
            tw.do("write_word", node + 1, int(rng.integers(1 << 40)))
            tw.do("flush_range", node, 2)
            tw.do("fence")
            stack = node
            rooted.add(node)
            tw.do("set_root", 0, node, "stack_node")
        elif op == "tree":
            node = tw.do("malloc", 32)
            if node is None:
                continue
            key = int(rng.integers(1 << 20))
            for k, v in enumerate((key, key * 10, pp.PPTR_NULL,
                                   pp.PPTR_NULL)):
                tw.do("write_word", node + k, v)
            tw.do("flush_range", node, 4)
            tw.do("fence")
            rooted.add(node)
            if tree is None:
                tree = node
                tw.do("set_root", 1, node, "tree_node")
                continue
            cur = tree
            while True:
                slot = 2 if key < tw.heaps[1].read_word(cur) else 3
                child = pp.decode(cur + slot,
                                  tw.heaps[1].read_word(cur + slot))
                if child is None:
                    tw.do("write_word", cur + slot,
                          pp.encode(cur + slot, node))
                    tw.do("flush_range", cur + slot, 1)
                    tw.do("fence")
                    break
                cur = child
        elif op == "root":
            p = pick()
            if p is not None:
                rooted.add(p)
                tw.do("set_root", 2, p)
        elif op == "roots":
            a, b = pick(), pick()
            if a is not None and b is not None:
                rooted.update((a, b))
                tw.do("set_roots", [(3, a), (4, b)])
        elif op == "write":
            p = pick()
            if p is None:
                continue
            n = min(16, max(1, live[p] // 8))
            for k in range(n):
                tw.do("write_word", p + k, int(rng.integers(-2**62, 2**62)))
            tw.do("flush_range", p, n)
        elif op == "fence":
            tw.do("fence")
    want, got = _sources()
    assert want == got

    # a crash, a reopen over each package's durable image, recovery
    tw.crash()
    tw2 = Twin(16 * MB, sim=sim, seed=seed + 1, images=tw.images())
    assert all(h.dirty_restart for h in tw2.heaps)
    for slot, typename in ((0, "stack_node"), (1, "tree_node"), (2, None),
                           (3, None), (4, None)):
        tw2.do("get_root", slot, typename)
    stats = [h.recover() for h in tw2.heaps]
    assert _untimed(stats[0]) == _untimed(stats[1])
    assert list(stats[1]["phases"]) == list(trec.PHASES) == list(jrec.PHASES)
    tw2.check()
    for size in (64, 14336, 200_000, 8):
        tw2.do("malloc", size)
    tw2.do("close")
    want, got = _sources()
    assert want == got


@pytest.mark.parametrize("sim", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_trace_matches_reference(seed, sim):
    _run_trace(seed, 250, sim)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_property_op_trace_matches_reference(seed):
    _run_trace(seed, 120, True)


def test_obs_heap_sources_and_resets():
    r = Ralloc(None, 8 * MB)
    r.free(r.malloc(64))
    r.set_root(0, r.malloc(64))
    snap = tobs.snapshot()["counters"]
    assert {k: snap[k] for k in HEAP_SOURCES} == {
        "heap.flush": r.mem.n_flush, "heap.fence": r.mem.n_fence,
        "heap.cas": r.mem.n_cas, "heap.drain": r.mem.n_drain}
    assert r.mem.n_fence > 0 and r.mem.n_cas > 0
    tobs.reset(*HEAP_SOURCES)
    assert (r.mem.n_flush, r.mem.n_fence, r.mem.n_cas) == (0, 0, 0)
    with pytest.raises(tobs.UnknownMetric):
        tobs.reset("heap.nope")
    tobs.counter("test.torch_ralloc").inc(3)
    tobs.reset_all()
    assert tobs.snapshot()["counters"]["test.torch_ralloc"] == 0


@pytest.mark.parametrize("site", sorted(tfaults.SITES))
def test_fault_sites_match_reference(site):
    """A suppressed site skips the same flush/fence in both packages."""
    assert site in jfaults.SITES
    tw = Twin(8 * MB, sim=True, seed=5)
    with jfaults.suppress(site), tfaults.suppress(site):
        big = tw.do("malloc", 300_000)
        tw.do("span_acquire", big, 2)
        tw.do("set_root", 0, big)
        tw.do("span_trim", big, 1, 5)       # the trim's tail persist
        tw.do("free", big)
        tw.do("free", big)                  # the last lease: the span frees
    tw.crash()
    with pytest.raises(ValueError):
        with tfaults.suppress("prefix_index.publish.fields_persist"):
            pass


# ---------------------------------------------------------------------------
# the port's additions
# ---------------------------------------------------------------------------
def test_bulk_word_paths_match_per_word_paths():
    rng = np.random.default_rng(0)
    vals = rng.integers(-2**63, 2**63 - 1, 1000, dtype=np.int64)
    fast = NVMArray(4096)
    slow = NVMArray(4096)
    slow.tracer = type("T", (), {"record": lambda *a, **k: None})()
    for m in (fast, slow):
        m.write_words(13, vals)
        m.flush_range(13, 1000)
        m.flush_range(5, 0)
    assert fast.bulk and not slow.bulk
    assert np.array_equal(fast.nvm, slow.nvm)
    assert fast.n_flush == slow.n_flush == (1012 // 8 - 13 // 8 + 1) + 1
    assert fast.flush_pending and slow.flush_pending
    assert np.array_equal(fast.read_view(13, 1000), vals)
    sim = NVMArray(4096, sim=True, seed=1)
    sim.write_words(13, vals)
    assert np.array_equal(sim.read_view(13, 1000), vals)
    with pytest.raises(RuntimeError):
        sim.byte_view(0, 4)


def test_chunked_conservative_scan_matches_reference(monkeypatch):
    """Tagged words planted across scan-chunk edges: the same targets in
    the same order as the reference's one-pass scan."""
    r, j = Ralloc(None, 8 * MB), JRalloc(None, 8 * MB)
    big = r.malloc(300_000)
    assert j.malloc(300_000) == big
    rng = np.random.default_rng(3)
    words = rng.integers(-2**40, 2**40, 300_000 // 8, dtype=np.int64)
    for k in (0, 999, 1000, 1001, 2047, 2048, 30_000, len(words) - 1):
        words[k] = pp.encode(big + k, big + (k * 7919) % len(words) + 1)
    words[5] = pp.encode(big + 5, None)       # tagged, delta 0: no target
    r.mem.write_words(big, words)
    j.mem.write_block(big, words)
    monkeypatch.setattr(trec, "SCAN_CHUNK", 1000)
    want = jrec._conservative_targets(j, big, 300_000)
    assert len(want) == 8
    assert trec._conservative_targets(r, big, 300_000) == want


@pytest.mark.parametrize("typename", ["prefix_index", "prefix_trie"])
def test_unported_typed_roots_raise(typename):
    with pytest.raises(NotPorted, match="not ported"):
        FilterRegistry().get(typename)
    r = Ralloc(None, 8 * MB)
    r.set_root(0, r.malloc(64), typename)
    with pytest.raises(NotPorted, match="not ported"):
        r.recover()


def test_layout_matches_reference():
    assert layout.SIZE_CLASSES == jlayout.SIZE_CLASSES
    for name in ("M_END", "M_ROOTS", "MAGIC", "NUM_CLASSES", "SB_WORDS",
                 "DESC_WORDS", "MAX_ROOTS"):
        assert getattr(layout, name) == getattr(jlayout, name), name
    cfg, jcfg = layout.HeapConfig(size=32 * MB), jlayout.HeapConfig(
        size=32 * MB)
    assert (cfg.sb_base, cfg.total_words) == (jcfg.sb_base, jcfg.total_words)


# ---------------------------------------------------------------------------
# the reference's invariant cases, on the port
# ---------------------------------------------------------------------------
@given(st.integers(1, 14336))
def test_size_to_class_covers(sz):
    cls = layout.size_to_class(sz)
    assert 1 <= cls < layout.NUM_CLASSES
    assert layout.class_block_size(cls) >= sz
    if cls > 1:
        assert layout.class_block_size(cls - 1) < sz


@given(st.integers(0, 2), st.integers(0, (1 << 20) - 1),
       st.integers(0, (1 << 20) - 1), st.integers(0, (1 << 22) - 1))
def test_anchor_roundtrip(state, avail, count, tag):
    a = layout.pack_anchor(state, avail, count, tag)
    assert layout.unpack_anchor(a) == (state, avail, count, tag)


@given(st.integers(0, 1 << 40), st.integers(0, 1 << 40))
def test_pptr_roundtrip(holder, target):
    if holder == target:
        target += 1
    enc = pp.encode(holder, target)
    assert pp.is_pptr(enc)
    assert pp.decode(holder, enc) == target


def test_malloc_free_no_overlap():
    r = Ralloc(None, 16 * MB)
    sizes = [8, 64, 400, 4096, 14336] * 50
    ptrs = [r.malloc(sz) for sz in sizes]
    assert None not in ptrs
    spans = sorted((p, p + -(-sz // 8)) for p, sz in zip(ptrs, sizes))
    for (_, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0


def test_persistence_cost_near_zero():
    r = Ralloc(None, 16 * MB)
    r.malloc(64)
    r.mem.reset_counters()
    for _ in range(1000):
        r.free(r.malloc(64))
    assert r.mem.n_flush <= 4 and r.mem.n_fence <= 2


def test_large_blocks_span_superblocks():
    r = Ralloc(None, 32 * MB)
    big = r.malloc(200_000)
    sb = r.heap.sb_of(big)
    assert r.mem.read(r.desc(sb, layout.D_BLOCK_SIZE)) == 200_000
    assert r.mem.read(r.desc(sb + 1, layout.D_SIZE_CLASS)) == \
        layout.LARGE_CONT
    r.free(big)
    assert None not in [r.malloc(60_000) for _ in range(4)]


def test_free_large_resets_continuation_metadata():
    r = Ralloc(None, 32 * MB)
    big = r.malloc(300_000)                # 5-superblock span
    sb = r.heap.sb_of(big)
    r.free(big)
    for s in range(sb, sb + 5):
        assert r.mem.read(r.desc(s, layout.D_SIZE_CLASS)) == 0
        assert r.mem.read(r.desc(s, layout.D_BLOCK_SIZE)) == 0


def test_free_of_continuation_pointer_redirects_to_head():
    r = Ralloc(None, 4 * MB)
    big = r.malloc(200_000)
    r.free(big + layout.SB_WORDS + 7)
    sb = r.heap.sb_of(big)
    assert r.mem.read(r.desc(sb, layout.D_BLOCK_SIZE)) == 0
    got_sbs = set()
    while (p := r.malloc(14336)) is not None:
        got_sbs.add(r.heap.sb_of(p))
    assert {sb, sb + 1, sb + 2, sb + 3} <= got_sbs


def test_double_free_of_large_block_rejected():
    r = Ralloc(None, 32 * MB)
    big = r.malloc(200_000)
    r.free(big)
    with pytest.raises(ValueError):
        r.free(big)


def test_block_reuse_and_out_of_memory():
    r = Ralloc(None, 8 * MB)
    a = r.malloc(128)
    r.free(a)
    assert r.malloc(128) == a          # LIFO thread cache
    small = Ralloc(None, 2 * MB)
    got = [small.malloc(14336) for _ in range(500)]
    assert got[0] is not None and None in got


def test_multithreaded_no_overlap():
    r = Ralloc(None, 64 * MB)
    live, errs = [[] for _ in range(4)], []

    def worker(t):
        try:
            rng = np.random.default_rng(t)
            mine = []
            for _ in range(600):
                if mine and rng.random() < 0.45:
                    r.free(mine.pop(int(rng.integers(len(mine)))))
                else:
                    p = r.malloc(int(rng.choice([16, 64, 256, 400])))
                    assert p is not None
                    mine.append(p)
            live[t] = mine
        except Exception as e:         # pragma: no cover
            errs.append(repr(e))

    ts = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errs
    flat = [p for lst in live for p in lst]
    assert len(flat) == len(set(flat))


def _durable_stack(r, n, base=1000):
    head = None
    for k in range(n):
        node = r.malloc(16)
        r.write_word(node, pp.PPTR_NULL if head is None else
                     pp.encode(node, head))
        r.write_word(node + 1, base + k)
        r.flush_range(node, 2)
        r.fence()
        head = node
    return head


def _walk_stack(r, head):
    vals, w = [], head
    while w is not None:
        vals.append(r.read_word(w + 1))
        w = pp.decode(w, r.read_word(w))
    return vals


@pytest.mark.parametrize("typed", [True, False])
def test_crash_recover_stack(tmp_path, typed):
    path = str(tmp_path / "h")
    typename = "stack_node" if typed else None
    r = Ralloc(path, 8 * MB, sim_nvm=True, seed=11)
    r.set_root(0, _durable_stack(r, 80), typename)
    for _ in range(300):
        r.malloc(64)                   # leaked: allocated, never attached
    r.heap.crash()
    del r
    r2 = Ralloc(path, 8 * MB, sim_nvm=True, seed=12)
    assert r2.dirty_restart
    root = r2.get_root(0, typename)
    stats = r2.recover()
    assert stats["reachable_blocks"] == 80
    assert _walk_stack(r2, root) == [1079 - k for k in range(80)]
    live, w = set(), root
    while w is not None:
        live.add(w)
        w = pp.decode(w, r2.read_word(w))
    fresh = {r2.malloc(16) for _ in range(4000)}
    assert None not in fresh and not (fresh & live)
    r2.close()
    os.unlink(path)


def test_tree_recovery_binary_filter():
    r = Ralloc(None, 8 * MB, sim_nvm=True, seed=41)

    def insert(root, key):
        node = r.malloc(32)
        for k, v in enumerate((key, key * 10, pp.PPTR_NULL, pp.PPTR_NULL)):
            r.write_word(node + k, v)
        r.flush_range(node, 4)
        r.fence()
        if root is None:
            return node
        cur = root
        while True:
            slot = 2 if key < r.read_word(cur) else 3
            child = pp.decode(cur + slot, r.read_word(cur + slot))
            if child is None:
                r.write_word(cur + slot, pp.encode(cur + slot, node))
                r.flush_range(cur + slot, 1)
                r.fence()
                return root
            cur = child

    root = None
    for k in np.random.default_rng(0).permutation(200):
        root = insert(root, int(k))
    r.set_root(0, root, "tree_node")
    r.heap.crash()
    r2 = Ralloc(None, 8 * MB, sim_nvm=True, seed=42, backing=r.mem.nvm)
    rt = r2.get_root(0, "tree_node")
    assert r2.recover()["reachable_blocks"] == 200

    def count(n):
        if n is None:
            return 0
        return 1 + count(pp.decode(n + 2, r2.read_word(n + 2))) + \
            count(pp.decode(n + 3, r2.read_word(n + 3)))
    assert count(rt) == 200


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 60), st.integers(0, 200))
def test_property_crash_anywhere_recovers(seed, n_nodes, n_leaks):
    r = Ralloc(None, 8 * MB, sim_nvm=True, seed=seed)
    r.set_root(0, _durable_stack(r, n_nodes), "stack_node")
    rng = np.random.default_rng(seed)
    for _ in range(n_leaks):
        r.malloc(int(rng.choice([16, 64, 400])))
    r.heap.crash()
    r2 = Ralloc(None, 8 * MB, sim_nvm=True, seed=seed + 1,
                backing=r.mem.nvm)
    assert r2.dirty_restart
    root = r2.get_root(0, "stack_node")
    assert r2.recover()["reachable_blocks"] == n_nodes
    assert len(_walk_stack(r2, root)) == n_nodes


def test_crash_after_free_large_and_a_live_large_block():
    r = Ralloc(None, 16 * MB, sim_nvm=True, seed=61)
    r.set_root(0, _durable_stack(r, 10), "stack_node")
    r.free(r.malloc(300_000))
    big = r.malloc(200_000)
    for k in range(16):
        r.write_word(big + k, 4242 + k)
    r.flush_range(big, 16)
    r.fence()
    r.set_root(1, big, None)
    r.heap.crash()
    r2 = Ralloc(None, 16 * MB, sim_nvm=True, seed=62, backing=r.mem.nvm)
    r2.get_root(0, "stack_node")
    big2 = r2.get_root(1)
    stats = r2.recover()
    assert stats["large_blocks"] == 1
    used = int(r2.mem.read(layout.M_USED_SBS))
    conts = [sb for sb in range(used) if r2.mem.read(
        r2.desc(sb, layout.D_SIZE_CLASS)) == layout.LARGE_CONT]
    assert conts == [r2.heap.sb_of(big2) + k for k in range(1, 4)]
    assert [r2.read_word(big2 + k) for k in range(16)] == \
        [4242 + k for k in range(16)]
    assert len(_walk_stack(r2, r2.get_root(0))) == 10


def test_clean_restart_no_gc(tmp_path):
    path = str(tmp_path / "h")
    r = Ralloc(path, 8 * MB, sim_nvm=True, seed=51)
    r.set_root(0, _durable_stack(r, 10), "stack_node")
    r.close()
    r2 = Ralloc(path, 8 * MB, sim_nvm=True, seed=52)
    assert not r2.dirty_restart
    assert len(_walk_stack(r2, r2.get_root(0))) == 10
    assert r2.malloc(64) is not None
    r2.close()
