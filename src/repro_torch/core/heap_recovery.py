"""Post-crash recovery of the host heap: trace-based GC + metadata
reconstruction (paper §4.5).

Port of the reference's ``core/recovery.py`` (the port's
``core/recovery.py`` is the device allocator's, from ``jax_recovery.py``):
the same phases (:data:`PHASES`), stats and marks.  Two differences, both
leaving the recovered image equal to the reference's:

  * ``_conservative_targets`` scans a block in chunks of ``SCAN_CHUNK``
    words, testing each word's top 16 bits for the pptr tag through a
    strided view, so a multi-GB checkpoint shard costs no full-size
    temporaries; the bytes scanned add to the
    ``recovery.conservative_scan_bytes`` counter;
  * a root typed ``prefix_index`` or ``prefix_trie`` raises
    ``filters.NotPorted`` before recovery writes anything (those modules
    are not ported); the reference's prune and re-trim phases, which
    only act on such roots, are empty spans here.

Recovery steps (paper numbering):
  2.  thread-local caches start empty (fresh process)
  3.  superblock free list and partial lists reset to empty
  4.  filter functions were registered by ``get_root`` calls
  5.  trace all blocks reachable from persistent roots
  6–9. sweep the superblock region: keep only traced blocks, rebuild every
      descriptor, partial list, and the superblock free list
  10. write back the three regions and fence

"In use" after recovery = reachable, even if never malloc'd pre-crash
(conservative false positives leak, never corrupt — paper Thm 5.4).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from . import layout
from . import pptr as pp
from .. import obs
from .filters import refuse_not_ported
from .layout import (ANCHOR_NIL_AVAIL, D_ANCHOR, D_BLOCK_SIZE, D_NEXT_FREE,
                     D_NEXT_PARTIAL, D_SIZE_CLASS, EMPTY, FULL, LARGE_CLASS,
                     LARGE_CONT, PARTIAL, SB_WORDS, WORD, pack_anchor,
                     pack_head)


def _valid_block_start(r, word: int, used_sbs: int) -> tuple[bool, int, int]:
    """Validate a traced target as a block start.

    Returns (valid, size_class, size_bytes).  Interior pointers are not
    supported (paper §4.5); stale size classes on free superblocks can
    admit false positives — a tolerated, safe leak.
    """
    base = r.config.sb_base
    if not (base <= word < base + used_sbs * SB_WORDS):
        return False, 0, 0
    sb = (word - base) // SB_WORDS
    cls = int(r.mem.read(r.desc(sb, D_SIZE_CLASS)))
    bs = int(r.mem.read(r.desc(sb, D_BLOCK_SIZE)))
    if cls == LARGE_CONT:
        return False, 0, 0
    if cls == LARGE_CLASS:
        if bs > 0 and word == r.heap.sb_word(sb):
            return True, LARGE_CLASS, bs
        return False, 0, 0
    if not (1 <= cls < layout.NUM_CLASSES) or bs <= 0:
        return False, 0, 0
    if bs != layout.class_block_size(cls):
        return False, 0, 0
    bw = bs // WORD if bs % WORD == 0 else max(1, -(-bs // WORD))
    off = word - r.heap.sb_word(sb)
    if off % bw != 0 or off + bw > SB_WORDS:
        return False, 0, 0
    return True, cls, bs


#: words a conservative-scan pass reads (128 MiB): bounds its transients
SCAN_CHUNK = 1 << 24
# the uint16 holding a word's top 16 bits, in the machine's byte order
_TOP_HALF = 3 if sys.byteorder == "little" else 0
_OBS_SCAN_BYTES = obs.counter("recovery.conservative_scan_bytes")


def _conservative_targets(r, block_word: int, size_bytes: int):
    """Vectorized conservative scan of one block, chunk by chunk: the
    targets of every word tagged as a pptr, in word order."""
    nwords = max(1, size_bytes // WORD)
    _OBS_SCAN_BYTES.inc(nwords * WORD)
    out = []
    for lo in range(0, nwords, SCAN_CHUNK):
        vals = r.mem.read_view(block_word + lo,
                               min(SCAN_CHUNK, nwords - lo))
        tagged = vals.view(np.uint16)[_TOP_HALF::4] == pp.PPTR_TAG
        for k in np.flatnonzero(tagged).tolist():
            tgt = pp.decode(block_word + lo + k, int(vals[k]))
            if tgt is not None:
                out.append((tgt, None))
    return out


def trace(r, span_refs: dict[int, int] | None = None
          ) -> dict[int, tuple[int, int]]:
    """Mark phase: BFS from persistent roots (paper Fig. 3 ``collect``).

    Returns {block_word: (size_class, size_bytes)} for every reachable block.

    When ``span_refs`` is given, the trace additionally counts — at zero
    extra passes — how many root-reachable references target each live
    large-span *head* (``span_refs[head_sb] += 1`` per reference, roots
    included).  Each such reference IS one range lease: lease lengths are
    transient and unrecoverable, so recovery rebuilds every reference as
    a lease over the span's remaining *persisted* extent (trims shrink
    that extent durably, so a trimmed tail never comes back).  The
    transient ``RangeLeaseTable`` is reconstructed the same way the free
    lists are — from the persisted minimum plus GC reachability (see
    ``core.spans``).
    """
    used_sbs = int(r.mem.read(layout.M_USED_SBS))
    visited: dict[int, tuple[int, int]] = {}
    pending: list[tuple[int, str | None]] = []

    def visit(word: int, typename: str | None) -> None:
        ok, cls, bs = _valid_block_start(r, word, used_sbs)
        if not ok:
            return
        if span_refs is not None and cls == LARGE_CLASS:
            sb = r.heap.sb_of(word)
            span_refs[sb] = span_refs.get(sb, 0) + 1
        if word not in visited:
            visited[word] = (cls, bs)
            pending.append((word, typename))

    for i, typename in list(r._root_filters.items()):
        root = r.heap.get_root(i)
        if root is not None:
            visit(root, typename)
    # also trace any set roots without registered filters (conservative)
    for i in range(layout.MAX_ROOTS):
        root = r.heap.get_root(i)
        if root is not None and i not in r._root_filters:
            visit(root, None)

    while pending:
        word, typename = pending.pop()
        _, bs = visited[word]
        if typename is None:
            for tgt, child in _conservative_targets(r, word, bs):
                visit(tgt, child)
        else:
            fn = r.filters.get(typename)
            for tgt, child in fn(r, word, bs):
                visit(tgt, child)
    return visited


#: the named, timed phases every ``recover()`` run reports (in order) —
#: pinned by the recovery-stats test so a renamed/dropped phase fails
#: loudly instead of silently vanishing from dashboards.
PHASES = ("prune_index", "prune_trie", "mark", "sweep", "reconstruct",
          "retrim_index", "retrim_trie", "drain")


def recover(r) -> dict:
    """Full recovery: steps 3 + 5–10.  Returns stats for the caller.

    Every step runs inside a named ``obs`` span (``recovery.<phase>``,
    names in :data:`PHASES`); the returned stats carry the same timings
    under ``"phases"`` — ``{name: {"seconds": float, "items": int}}`` —
    so a single recovery's profile travels with its result while the
    registry accumulates across runs for the benchmark snapshot.
    """
    t0 = time.perf_counter()
    phases: dict[str, dict] = {}

    def _phase(span):
        phases[span.name.split(".", 1)[1]] = {"seconds": span.seconds,
                                              "items": span.items}

    m = r.mem
    for typename in r._root_filters.values():
        refuse_not_ported(typename)
    # step 2: thread caches are empty in a fresh process; for in-process
    # recovery (tests, partial-failure GC) drop them stop-the-world.
    r.drop_all_caches()
    # step 3: empty global lists
    m.write(layout.M_FREE_HEAD, pack_head(-1, 0))
    for c in range(layout.NUM_CLASSES):
        m.write(layout.M_PARTIAL_HEADS + c, pack_head(-1, 0))

    # step 4½: the reference prunes torn prefix-index / prefix-trie
    # records here; with no such roots (refused above) nothing to prune
    for name in ("prune_index", "prune_trie"):
        with obs.span(f"recovery.{name}") as sp:
            pass
        _phase(sp)

    # step 5: mark (+ span-refcount reconstruction, same pass)
    span_refs: dict[int, int] = {}
    with obs.span("recovery.mark") as sp:
        visited = trace(r, span_refs)
        sp.add(len(visited))
    _phase(sp)
    t_mark = time.perf_counter()

    # steps 6–9: sweep & rebuild
    sweep_span = obs.span("recovery.sweep")
    sweep_span.__enter__()
    used_sbs = int(m.read(layout.M_USED_SBS))
    by_sb: dict[int, list[int]] = {}
    large_heads: dict[int, int] = {}       # sb -> span length
    for word, (cls, bs) in visited.items():
        sb = r.heap.sb_of(word)
        if cls == LARGE_CLASS:
            large_heads[sb] = -(-bs // layout.SB_SIZE)
        else:
            by_sb.setdefault(sb, []).append(word)

    in_large_span: set[int] = set()
    for sb, nsb in large_heads.items():
        in_large_span.update(range(sb, sb + nsb))

    n_free_sbs = n_partial = n_full = 0
    for sb in range(used_sbs):
        aw = r.desc(sb, D_ANCHOR)
        if sb in in_large_span:
            if sb in large_heads:
                m.write(aw, pack_anchor(FULL, ANCHOR_NIL_AVAIL, 0, 0))
                n_full += 1
            else:
                m.write(r.desc(sb, D_SIZE_CLASS), LARGE_CONT)
            continue
        marked = by_sb.get(sb)
        if not marked:
            # clear stale class records (mirrors the device sweep): a
            # crash mid-_free_large can leave a dead head / orphaned
            # LARGE_CONT here, and a free-listed superblock still tagged
            # as a live large head would let a stale pointer re-free the
            # span into duplicate free-list entries
            m.write(r.desc(sb, D_SIZE_CLASS), 0)
            m.write(r.desc(sb, D_BLOCK_SIZE), 0)
            m.write(aw, pack_anchor(EMPTY, ANCHOR_NIL_AVAIL, 0, 0))
            _push(r, layout.M_FREE_HEAD, D_NEXT_FREE, sb)
            n_free_sbs += 1
            continue
        cls = int(m.read(r.desc(sb, D_SIZE_CLASS)))
        bs = layout.class_block_size(cls)
        bw = bs // WORD
        total = layout.blocks_per_sb(bs)
        base = r.heap.sb_word(sb)
        marked_idx = {(w - base) // bw for w in marked}
        free_idx = [b for b in range(total) if b not in marked_idx]
        if free_idx:
            # rebuild the in-superblock free chain (transient words)
            for a, b in zip(free_idx, free_idx[1:]):
                wa = base + a * bw
                m.write(wa, pp.encode(wa, base + b * bw))
            last = base + free_idx[-1] * bw
            m.write(last, pp.PPTR_NULL)
            m.write(aw, pack_anchor(PARTIAL, free_idx[0], len(free_idx), 0))
            _push(r, layout.M_PARTIAL_HEADS + cls, D_NEXT_PARTIAL, sb)
            n_partial += 1
        else:
            m.write(aw, pack_anchor(FULL, ANCHOR_NIL_AVAIL, 0, 0))
            n_full += 1
    sweep_span.add(used_sbs)
    sweep_span.__exit__(None, None, None)
    _phase(sweep_span)

    # rebuild the transient range-lease table and free-run index exactly
    # like the paper rebuilds thread caches and Treiber stacks: each
    # root-reachable reference to a live head becomes one lease over the
    # span's persisted extent, the index comes from the swept free list.
    # Dead heads that the conservative scan touched are not registered —
    # only live spans carry leases.
    with obs.span("recovery.reconstruct") as sp:
        live_leases = {sb: (large_heads[sb], c)
                       for sb, c in span_refs.items() if sb in large_heads}
        r.leases.reconstruct(live_leases)
        r._run_index.rebuild(free_superblock_list(r))
        sp.add(len(live_leases))
    _phase(sp)

    # the reference re-trims the leases prefix-index / prefix-trie
    # records shadow here: none (refused above)
    for name in ("retrim_index", "retrim_trie"):
        with obs.span(f"recovery.{name}") as sp:
            pass
        _phase(sp)

    # step 10: write back all three regions.  drain() IS the write-back
    # (clean-shutdown semantics: every line durable on return); the
    # fence that used to follow it had nothing left to order — persist-
    # lint counts exactly that as an empty fence, and the waste gauges
    # now gate it to zero.
    with obs.span("recovery.drain") as sp:
        m.drain()
    _phase(sp)
    t_end = time.perf_counter()
    return {
        "reachable_blocks": len(visited),
        "free_superblocks": n_free_sbs,
        "free_runs": len(free_superblock_runs(r)),
        "index_records": 0,
        "index_retrims": 0,
        "index_pruned": 0,
        "trie_records": 0,
        "trie_retrims": 0,
        "trie_pruned": 0,
        "partial_superblocks": n_partial,
        "full_superblocks": n_full,
        "large_blocks": len(large_heads),
        "shared_spans": sum(1 for sb, c in span_refs.items()
                            if sb in large_heads and c > 1),
        "mark_seconds": t_mark - t0,
        "sweep_seconds": t_end - t_mark,
        "total_seconds": t_end - t0,
        "phases": phases,
    }


def _push(r, head_word: int, next_field: int, sb: int) -> None:
    """Single-threaded (offline) list push — no CAS needed during recovery."""
    idx, ctr = layout.unpack_head(r.mem.read(head_word))
    r.mem.write(r.desc(sb, next_field), idx if idx >= 0 else -1)
    r.mem.write(head_word, pack_head(sb, ctr + 1))


def free_superblock_list(r) -> list[int]:
    """Walk the superblock free list; raises on a cycle (a cycle would
    double-count superblocks and hand the same span out twice)."""
    out: list[int] = []
    seen: set[int] = set()
    idx, _ = layout.unpack_head(r.mem.read(layout.M_FREE_HEAD))
    while idx >= 0:
        if idx in seen:
            raise AssertionError(f"free-list cycle at superblock {idx}")
        seen.add(idx)
        out.append(idx)
        nxt = int(r.mem.read(r.desc(idx, D_NEXT_FREE)))
        idx = nxt if nxt >= 0 else -1
    return out


def free_superblock_runs(r) -> list[tuple[int, int]]:
    """Maximal contiguous runs ``(start, length)`` of free-listed
    superblocks — the search space of ``Ralloc._claim_free_run``.

    Recovery pushes every swept superblock back onto the free list and
    the best-fit search sorts the drained set before scanning, so
    large-object placement after recovery depends only on free-set
    membership — never on stack order.  This is the placement-
    equivalence guarantee the crash-injection and differential suites
    assert; the device analogue is ``alloc.free_runs``.
    """
    return layout.contiguous_runs(sorted(free_superblock_list(r)))
