"""Ralloc — nonblocking recoverable persistent allocator (paper §4).

Port of the reference's ``core/ralloc.py``: the same placement, thread
caches, large spans, leases, roots, recovery and close, so one op trace
lands the same blocks at the same words.  Added for the checkpoint store:
``write_words`` / ``read_words``, and ``flush_range`` through
``NVMArray.flush_range`` -- word ranges in bulk in fast mode, the
reference's per-word and per-line calls otherwise (``core.atomics``).

Faithful host-side port of the paper's algorithm:

  * size-class-segregated allocation with per-thread caches (the fast path
    touches no shared state at all);
  * global superblock free list and per-class partial lists as Treiber
    stacks of *descriptors* (single-word CAS heads with ABA counters);
  * per-superblock block free lists threaded through the first word of
    each free block as a self-relative pptr (transient — never flushed);
  * anchors (state | avail | count | tag) updated with one CAS;
  * the only *persistent* writes during normal operation: a superblock's
    ``size_class``/``block_size`` at superblock (re)initialization and the
    region ``used`` watermark at expansion — each a write-back + fence.
    Typical mallocs/frees persist **nothing** (the paper's headline
    property);
  * ``recover()`` (see ``core.heap_recovery``) reconstructs every transient
    structure from the persisted minimum plus GC reachability.

Addresses are word indices into the heap array; the public API hands out
block addresses ("pointers") that test data structures store as pptrs.
"""

from __future__ import annotations

import math
import threading

from . import heap_recovery, layout
from .. import obs
from ..analysis.faults import is_suppressed
from .atomics import CACHELINE_WORDS
from .filters import FilterRegistry
from .heap import PersistentHeap
from .layout import (ANCHOR_NIL_AVAIL, D_ANCHOR, D_BLOCK_SIZE, D_NEXT_FREE,
                     D_NEXT_PARTIAL, D_SIZE_CLASS, EMPTY, FULL, HeapConfig,
                     LARGE_CLASS, LARGE_CONT, PARTIAL, SB_SIZE,
                     WORD, pack_anchor, pack_head, unpack_anchor, unpack_head)
from . import pptr as pp
from .spans import FreeRunIndex, RangeLeaseTable


class OutOfMemory(Exception):
    pass


# Allocator-path metrics (cached at import: the hot-path cost is one
# bound call + enabled-flag branch; see the obs package).
_OBS_SMALL = obs.counter("alloc.small")
_OBS_LARGE = obs.counter("alloc.large")
_OBS_TCACHE_HIT = obs.counter("alloc.tcache_hit")
_OBS_TCACHE_MISS = obs.counter("alloc.tcache_miss")
_OBS_REFILL_PARTIAL = obs.counter("alloc.refill_partial")
_OBS_REFILL_FREE_SB = obs.counter("alloc.refill_free_sb")
_OBS_REFILL_EXPAND = obs.counter("alloc.refill_expand")
_OBS_GROWTH_SBS = obs.counter("alloc.watermark_growth_sbs")
_OBS_PLACE_RESYNC = obs.counter("placement.resync")
_OBS_PLACE_WATERMARK = obs.counter("placement.watermark")
_OBS_SPAN_ACQUIRE = obs.counter("span.acquire")
_OBS_SPAN_RELEASE = obs.counter("span.release")
_OBS_SPAN_TRIM = obs.counter("span.trim")
_OBS_LEASE_RELEASE = obs.counter("span.lease_release")
_OBS_SPAN_FREE = obs.counter("span.free")
_OBS_TAIL_TRIM = obs.counter("span.tail_trim")


class Ralloc:
    """One persistent heap + allocator instance (paper Fig. 1 API)."""

    def __init__(self, path: str | None, size: int, *, sim_nvm: bool = False,
                 seed: int = 0, tcache_cap: int = 64, persist: bool = True,
                 expand_sbs: int = 16, keep_half: bool = False,
                 flush_ns: int = 0, fence_ns: int = 0, backing=None):
        """``persist=False`` disables flush/fence → LRMalloc-equivalent mode.

        ``backing`` hands the heap a pre-existing durable image (an int64
        array) instead of a file — crash-injection tests use it to reopen
        snapshots captured at persist boundaries.
        """
        self.config = HeapConfig(size=size, sim_nvm=sim_nvm, seed=seed,
                                 tcache_cap=tcache_cap, expand_sbs=expand_sbs,
                                 flush_ns=flush_ns, fence_ns=fence_ns)
        self.keep_half = keep_half
        self.heap = PersistentHeap(path, self.config, backing=backing)
        self.persist_on = persist
        self.filters = FilterRegistry()
        from .filters import register_stock_filters
        register_stock_filters(self.filters)
        self._root_filters: dict[int, str | None] = {}
        self._tls = threading.local()
        self._all_caches: list[list[list[int]]] = []
        self._caches_lock = threading.Lock()
        # serializes span placement AND the lease-release decision
        # (reentrant: _release_range holds it across the decrement and
        # the _free_large/_trim_tail it decides on, which re-acquire it
        # around their free-stack pushes — without one lock over the
        # whole read-extent → decrement → free sequence, two concurrent
        # releases of a shared span could both observe a stale extent
        # and double-push the same tail superblocks)
        self._large_lock = threading.RLock()
        # transient span metadata (never flushed; GC-reconstructed):
        # per-superblock-range lease counts per live span + the
        # size-bucketed free-run index that mirrors free-stack membership
        # (always take _large_lock before _free_lock when both are needed)
        self.leases = RangeLeaseTable()
        self._run_index = FreeRunIndex()
        self._free_lock = threading.Lock()
        self._closed = False
        self.dirty_restart = self.heap.init()

    # ------------------------------------------------------------------ misc
    @property
    def mem(self):
        return self.heap.mem

    def _persist(self, *words: int) -> None:
        """flush(+fence) persistent fields — the paper's bold writes.

        One clwb per dirty *line*: adjacent descriptor fields (and the
        descriptors of neighbouring superblocks in a span batch) share
        cache lines, and re-flushing a line already scheduled with
        nothing newly dirty is pure waste (persist-lint: redundant
        flush).  Fence count is unchanged — ordering is identical."""
        if self.persist_on:
            m = self.mem
            seen_lines = set()
            for w in words:
                line = w // CACHELINE_WORDS
                if line not in seen_lines:
                    seen_lines.add(line)
                    m.flush(w)
            m.fence()

    def _tcache(self) -> list[list[int]]:
        c = getattr(self._tls, "cache", None)
        if c is None:
            c = [[] for _ in range(layout.NUM_CLASSES)]
            self._tls.cache = c
            with self._caches_lock:
                self._all_caches.append(c)
        return c

    def drop_all_caches(self) -> None:
        """Stop-the-world discard of every thread cache (recovery step 2)."""
        with self._caches_lock:
            for c in self._all_caches:
                for cls in range(layout.NUM_CLASSES):
                    c[cls].clear()

    # ------------------------------------------------------------------- API
    def recover(self) -> dict:
        """Offline GC + metadata reconstruction; returns recovery stats."""
        return heap_recovery.recover(self)

    def close(self) -> None:
        """Return cached blocks, write back the heap, clear the dirty flag."""
        if self._closed:
            return
        cache = self._tcache()
        for cls in range(1, layout.NUM_CLASSES):
            if cache[cls]:
                self._flush_cache(cls, keep=0)
        self.heap.close()
        self._closed = True

    def malloc(self, size: int) -> int | None:
        """Allocate ``size`` bytes; returns the block word address (or None)."""
        if size <= 0:
            return None
        cls = layout.size_to_class(size)
        if cls == LARGE_CLASS:
            _OBS_LARGE.inc()
            return self._malloc_large(size)
        _OBS_SMALL.inc()
        cache = self._tcache()[cls]
        if cache:
            _OBS_TCACHE_HIT.inc()
        else:
            _OBS_TCACHE_MISS.inc()
            if not self._refill(cls):
                return None
        return cache.pop()

    def free(self, ptr: int) -> None:
        sb = self.heap.sb_of(ptr)
        assert 0 <= sb < self.config.num_sbs, "free of non-heap pointer"
        cls = self.mem.read(self.desc(sb, D_SIZE_CLASS))
        if cls == LARGE_CONT:
            # interior pointer into a live large span: redirect to the
            # owning head superblock instead of indexing the thread cache
            # with the sentinel (which silently corrupted the last class)
            while cls == LARGE_CONT:
                sb -= 1
                cls = self.mem.read(self.desc(sb, D_SIZE_CLASS))
            if cls != LARGE_CLASS:
                raise ValueError(
                    f"free of pointer {ptr} inside an orphaned large-span "
                    f"continuation (no owning head superblock)")
        if cls == LARGE_CLASS:
            # range-leased span (see core.spans): a plain free releases one
            # full-extent lease — while other leases remain the decrement is
            # purely transient and the leased prefix stays placed; only a
            # superblock range nobody leases any more actually frees (the
            # unleased tail via _trim_tail, everything when the head range's
            # last lease drops).  Check-dead + release are one locked step:
            # a racing last release could free and re-place this head.
            with self._large_lock:
                if self.mem.read(self.desc(sb, D_BLOCK_SIZE)) <= 0:
                    raise ValueError(
                        f"double/invalid free of large block at "
                        f"superblock {sb}")
                self._release_range(sb, 0, None)
            return
        cache = self._tcache()[cls]
        cache.append(ptr)
        if len(cache) > self._cache_cap(cls):
            # paper: transfer the cache "in its entirety"; keep_half is the
            # Makalu-style locality tweak (beyond-paper option, §6.3 discussion)
            keep = len(cache) // 2 if self.keep_half else 0
            self._flush_cache(cls, keep=keep)

    # ----------------------------------------------------------- span leases
    def _span_head(self, ptr: int) -> tuple[int, int]:
        """Validate ``ptr`` as a live span head; returns (head_sb, extent)."""
        sb = self.heap.sb_of(ptr)
        cls = self.mem.read(self.desc(sb, D_SIZE_CLASS))
        bs = self.mem.read(self.desc(sb, D_BLOCK_SIZE))
        if cls != LARGE_CLASS or bs <= 0 or ptr != self.heap.sb_word(sb):
            raise ValueError(
                f"span lease op on non-head/dead span pointer {ptr}")
        return sb, -(-int(bs) // SB_SIZE)

    def span_acquire(self, ptr: int, n_sbs: int | None = None) -> int:
        """Lease the ``n_sbs``-superblock *prefix* of a live large span
        (default: the whole remaining extent).

        ``ptr`` must be the span head block address.  Returns the new
        head-range lease count.  Raises on a dead / non-head pointer or a
        non-positive range — the host-side strictness mirror of the
        device's masked no-op ``acquire_span`` (same asymmetry the
        feature matrix documents for ``free_large``).  Acquire persists
        nothing: after a crash each root-reachable reference to the head
        is rebuilt as one full-extent lease during GC.
        """
        with self._large_lock:      # vs a concurrent release freeing it
            sb, ext = self._span_head(ptr)
            n = ext if n_sbs is None else n_sbs
            if n < 1:
                raise ValueError(f"span_acquire of an empty range ({n} sbs)")
            _OBS_SPAN_ACQUIRE.inc()
            self.leases.ensure(sb, ext)
            return self.leases.acquire(sb, min(n, ext))

    def span_release(self, ptr: int, n_sbs: int | None = None) -> None:
        """Drop one lease on the ``n_sbs``-superblock prefix (default: the
        whole remaining extent — equivalent to ``free``).  A range whose
        count drops to zero frees: the head range's last release tears
        down whatever remains of the span, an unleased tail suffix
        returns to the free set while the shared prefix stays placed.

        ``n_sbs`` must match a lease the caller actually holds.  The
        table is identity-free (counts, not holder ids), so a mismatched
        length that other holders' counts happen to cover is not
        detectable: it leaves an interior zero-count range that stays
        placed — a safe leak (paper Thm 5.4 direction: leak, never
        corrupt) reclaimed at the head range's last release — while a
        mismatch the counts do NOT cover raises ``LeaseUnderflow``."""
        if n_sbs is None:
            self.free(ptr)
            return
        with self._large_lock:      # validation + release are one step:
            # a concurrent last release could free the span and a new
            # placement reuse its head between the check and the act
            sb, _ = self._span_head(ptr)
            if n_sbs < 1:
                raise ValueError(
                    f"span_release of an empty range ({n_sbs} sbs)")
            _OBS_SPAN_RELEASE.inc()
            self._release_range(sb, 0, n_sbs)

    def span_trim(self, ptr: int, n_keep: int,
                  n_held: int | None = None) -> int:
        """Shrink the caller's lease to the ``n_keep`` prefix, freeing
        whatever tail no other holder leases (the decode-ahead reserver's
        "sequence finished short" path).  Returns the span's remaining
        extent in superblocks.

        ``n_held`` is the length of the lease being shrunk — default: the
        span's whole current extent, i.e. a full-extent lease.  A caller
        re-trimming a lease it already shrank (while other holders pin
        the extent) MUST pass its current ``n_held``; defaulting would
        release ``[n_keep, extent)`` and silently consume the other
        holders' tail leases.  ``n_keep`` >= the held length is a no-op;
        ``n_keep`` < 1 raises (the head range cannot be trimmed away —
        that is ``free``'s job)."""
        with self._large_lock:
            sb, ext = self._span_head(ptr)
            if n_keep < 1:
                raise ValueError(f"span_trim cannot drop the head (keep="
                                 f"{n_keep})")
            b = ext if n_held is None else min(n_held, ext)
            if n_keep >= b:
                return ext
            _OBS_SPAN_TRIM.inc()
            self._release_range(sb, n_keep, b)
            _, ext = self._span_head(ptr)
            return ext

    def span_refcount(self, ptr: int) -> int:
        """Current transient lease count at the span's *head* range."""
        return self.leases.count(self.heap.sb_of(ptr))

    def span_lease_counts(self, ptr: int) -> list[int]:
        """Per-superblock lease counts over the span holding ``ptr`` —
        comparable with the device's ``span_refs`` vector slice."""
        return self.leases.counts(self.heap.sb_of(ptr))

    def span_extent(self, ptr: int) -> int:
        """Current persisted extent (superblocks) of the live span headed
        at ``ptr`` — the device analogue is ``span_sbs(sb_block_words)``.
        Raises on a dead / non-head pointer."""
        return self._span_head(ptr)[1]

    def _release_range(self, head: int, a_sbs: int, b_sbs: int | None
                       ) -> None:
        """Drop one lease on superblocks ``[head+a, head+b)`` and free
        whatever the decrement leaves unleased (tentpole mechanics):

          * head-range count hits zero → ``_free_large`` on the whole
            remaining extent (stray interior counts from conservative
            reconstruction cannot outlive the head — every genuine lease
            is a prefix and includes it);
          * a zero-count tail suffix → ``_trim_tail`` returns exactly
            those superblocks to the free set and durably shrinks the
            head's size record so recovery can never resurrect them.

        Raises ``LeaseUnderflow`` (a ``ValueError``) if the range is not
        fully leased — the host strictness the device mirrors as a
        masked no-op.  ``_large_lock`` (reentrant) covers the whole
        read-extent → decrement → free/trim sequence: concurrent
        releases of a shared span must not both act on a stale extent
        (double-pushing the same tail superblocks to the free set).
        """
        with self._large_lock:
            size = int(self.mem.read(self.desc(head, D_BLOCK_SIZE)))
            ext = -(-size // SB_SIZE)
            if ext < 1:      # lost a release race: the span already died
                raise ValueError(
                    f"double/invalid release of the dead span at "
                    f"superblock {head}")
            self.leases.ensure(head, ext)
            b = ext if b_sbs is None else min(b_sbs, ext)
            _OBS_LEASE_RELEASE.inc()
            head_count, new_ext = self.leases.release(head, head + a_sbs,
                                                      head + b)
            if head_count == 0:
                self._free_large(head)
            elif new_ext < ext:
                self._trim_tail(head, new_ext, ext)

    def _cache_cap(self, cls: int) -> int:
        """Cache capacity: one superblock's worth of blocks (LRMalloc)."""
        return max(self.config.tcache_cap,
                   layout.blocks_per_sb(layout.class_block_size(cls)))

    def set_root(self, i: int, ptr: int | None, typename: str | None = None) -> None:
        self._root_filters[i] = typename
        self.heap.set_root(i, ptr)

    def set_roots(self, pairs, typename: str | None = None) -> None:
        """Swing several typed roots behind one shared fence."""
        pairs = list(pairs)
        for i, _ in pairs:
            self._root_filters[i] = typename
        self.heap.set_roots(pairs)

    def get_root(self, i: int, typename: str | None = None) -> int | None:
        """Retrieve root ``i`` and (re)register its filter type (paper §4.5.1)."""
        self._root_filters[i] = typename
        return self.heap.get_root(i)

    # ------------------------------------------------------- address helpers
    def desc(self, sb_idx: int, field: int) -> int:
        return self.heap.desc_word(sb_idx, field)

    def block_words(self, block_size: int) -> int:
        return block_size // WORD if block_size % WORD == 0 else max(1, math.ceil(block_size / WORD))

    # --------------------------------------------------------- Treiber lists
    def _push_list(self, head_word: int, next_field: int, sb_idx: int) -> None:
        m = self.mem
        nf = self.desc(sb_idx, next_field)
        while True:
            old = m.read(head_word)
            idx, ctr = unpack_head(old)
            m.write(nf, idx if idx >= 0 else -1)
            if m.cas(head_word, old, pack_head(sb_idx, ctr + 1)):
                return

    def _pop_list(self, head_word: int, next_field: int) -> int | None:
        m = self.mem
        while True:
            old = m.read(head_word)
            idx, ctr = unpack_head(old)
            if idx < 0:
                return None
            nxt = m.read(self.desc(idx, next_field))
            if m.cas(head_word, old, pack_head(int(nxt), ctr + 1)):
                return idx

    # ------------------------------------------------- free stack + run index
    # All superblock free-stack traffic goes through these wrappers so the
    # size-bucketed run index (core.spans.FreeRunIndex) stays an exact
    # mirror of stack membership — the index is what lets the large-object
    # placement answer best-fit queries without draining + sorting the
    # stack on every request.
    def _free_push(self, sb: int) -> None:
        with self._free_lock:
            self._push_list(layout.M_FREE_HEAD, D_NEXT_FREE, sb)
            self._run_index.add(sb)

    def _free_pop(self) -> int | None:
        with self._free_lock:
            sb = self._pop_list(layout.M_FREE_HEAD, D_NEXT_FREE)
            if sb is not None:
                self._run_index.discard(sb)
            return sb

    # ------------------------------------------------------------ expansion
    def _expand(self, nsb: int) -> int | None:
        """Advance the used watermark by ``nsb`` superblocks (CAS+flush+fence).

        Returns the first new superblock index, or None if out of space.
        The watermark is durable *before* any block in the new superblocks
        can be handed out — recovery must never see reachable blocks above
        a stale watermark.
        """
        m = self.mem
        while True:
            old = m.read(layout.M_USED_SBS)
            if old + nsb > self.config.num_sbs:
                return None
            if m.cas(layout.M_USED_SBS, old, old + nsb):
                self._persist(layout.M_USED_SBS)
                _OBS_GROWTH_SBS.inc(nsb)
                return old

    # --------------------------------------------------------------- refill
    def _refill(self, cls: int) -> bool:
        """Recharge the thread cache for ``cls`` (paper §4.4)."""
        cache = self._tcache()[cls]
        bs = layout.class_block_size(cls)
        bw = self.block_words(bs)
        total = layout.blocks_per_sb(bs)
        m = self.mem
        phead = layout.M_PARTIAL_HEADS + cls

        while True:
            # 1. partial superblock of this class
            sb = self._pop_list(phead, D_NEXT_PARTIAL)
            if sb is not None:
                status, taken = self._reserve_all(sb)
                if status == "empty":      # became EMPTY while listed → retire
                    self._init_free_sb(sb)
                    self._free_push(sb)
                    continue
                if status == "full":       # raced empty-handed; try the next
                    continue
                avail, count = taken
                base = self.heap.sb_word(sb)
                w = base + avail * bw
                for _ in range(count):
                    cache.append(w)
                    nxt = pp.decode(w, m.read(w))
                    if nxt is None:
                        break
                    w = nxt
                _OBS_REFILL_PARTIAL.inc()
                return True

            # 2. free superblock (any class) — (re)initialize it for cls
            from_expand = False
            sb = self._free_pop()
            if sb is None:
                # 3. expand the used prefix of the superblock region.  A
                # concurrent span placement may be holding the *entire*
                # drained free stack (_claim_free_run), so re-check under
                # the placement lock before consuming fresh watermark —
                # expanding here would durably leak the address space the
                # free-run search exists to reclaim.
                with self._large_lock:
                    sb = self._free_pop()
                    if sb is None:
                        from_expand = True
                        first = self._expand(self.config.expand_sbs)
                        if first is None:
                            first = self._expand(1)   # partial final expansion
                            if first is None:
                                return False
                            sb = first
                        else:
                            sb = first
                            for extra in range(first + 1,
                                               first + self.config.expand_sbs):
                                self._init_free_sb(extra)
                                self._free_push(extra)
            # persist size class & block size BEFORE any block escapes —
            # recovery depends on them (paper: "has to be persisted before a
            # superblock is used for allocation")
            m.write(self.desc(sb, D_SIZE_CLASS), cls)
            m.write(self.desc(sb, D_BLOCK_SIZE), bs)
            self._persist(self.desc(sb, D_SIZE_CLASS), self.desc(sb, D_BLOCK_SIZE))
            _, _, _, tag = unpack_anchor(m.read(self.desc(sb, D_ANCHOR)))
            m.write(self.desc(sb, D_ANCHOR),
                    pack_anchor(FULL, ANCHOR_NIL_AVAIL, 0, tag + 1))
            base = self.heap.sb_word(sb)
            for b in range(total):
                cache.append(base + b * bw)
            (_OBS_REFILL_EXPAND if from_expand else _OBS_REFILL_FREE_SB).inc()
            return True

    def _reserve_all(self, sb: int) -> tuple[str, tuple[int, int] | None]:
        """CAS the anchor to (FULL, nil, 0), reserving every free block."""
        m = self.mem
        aw = self.desc(sb, D_ANCHOR)
        while True:
            old = m.read(aw)
            state, avail, count, tag = unpack_anchor(old)
            if state == EMPTY or count == total_blocks(self, sb):
                return "empty", None             # retire-on-fetch (paper §4.4)
            if count == 0:
                return "full", None              # nothing to take
            if m.cas(aw, old, pack_anchor(FULL, ANCHOR_NIL_AVAIL, 0, tag + 1)):
                return "ok", (avail, count)

    def _init_free_sb(self, sb: int) -> None:
        m = self.mem
        _, _, _, tag = unpack_anchor(m.read(self.desc(sb, D_ANCHOR)))
        m.write(self.desc(sb, D_ANCHOR),
                pack_anchor(EMPTY, ANCHOR_NIL_AVAIL, 0, tag + 1))

    # ---------------------------------------------------------- cache flush
    def _flush_cache(self, cls: int, keep: int = 0) -> None:
        """Push cached blocks back to their superblocks' free lists."""
        cache = self._tcache()[cls]
        give = cache[keep:]
        del cache[keep:]
        bs = layout.class_block_size(cls)
        bw = self.block_words(bs)
        total = layout.blocks_per_sb(bs)
        by_sb: dict[int, list[int]] = {}
        for w in give:
            by_sb.setdefault(self.heap.sb_of(w), []).append(w)
        m = self.mem
        for sb, blocks in by_sb.items():
            base = self.heap.sb_word(sb)
            aw = self.desc(sb, D_ANCHOR)
            k = len(blocks)
            while True:
                old = m.read(aw)
                state, avail, count, tag = unpack_anchor(old)
                # thread the chain through the blocks' first words (transient)
                for i, w in enumerate(blocks[:-1]):
                    m.write(w, pp.encode(w, blocks[i + 1]))
                lastw = blocks[-1]
                if avail == ANCHOR_NIL_AVAIL:
                    m.write(lastw, pp.PPTR_NULL)
                else:
                    m.write(lastw, pp.encode(lastw, base + avail * bw))
                new_count = count + k
                new_state = EMPTY if new_count == total else (
                    PARTIAL if state == FULL else state)
                new_avail = (blocks[0] - base) // bw
                if m.cas(aw, old, pack_anchor(new_state, new_avail,
                                              new_count, tag + 1)):
                    break
            if state == FULL and new_state == EMPTY:
                self._free_push(sb)
            elif state == FULL and new_state == PARTIAL:
                self._push_list(layout.M_PARTIAL_HEADS + cls, D_NEXT_PARTIAL, sb)
            # PARTIAL→EMPTY: stays in the partial list; retired when fetched.

    # ----------------------------------------------------------------- large
    def _claim_free_run(self, nsb: int) -> int | None:
        """Best-fit contiguous-run search, driven by the size-bucketed
        run index (``core.spans.FreeRunIndex``).

        The index mirrors free-stack *membership* (every push/pop goes
        through ``_free_push``/``_free_pop``), so the best-fit answer —
        smallest run >= ``nsb``, leftmost on ties — is identical to the
        old drain-the-stack-and-sort search, and identical to the device
        allocator's suffix-min scan over ``sb_class == FREE_CLS``: host
        and device still place spans identically given identical free
        sets, and placement still depends only on membership, never on
        stack order (the placement-equivalence invariant).  What changed
        is cost: a miss is O(log) with zero stack traffic, and a hit
        only pops the stack until the claimed run's members are
        collected instead of draining + sorting everything.

        Returns the head superblock index, or None when no run of
        ``nsb`` exists.  Callers must hold ``_large_lock``: two
        concurrent claims would split one run across two searchers,
        making both miss it (one would then expand the watermark a
        fitting run exists for — the exact leak this search removes).
        """
        with self._free_lock:
            first = self._run_index.best_fit(nsb)
            if first is None:
                return None
            want = set(range(first, first + nsb))
            popped: list[int] = []
            while want:
                sb = self._pop_list(layout.M_FREE_HEAD, D_NEXT_FREE)
                if sb is None:
                    break
                popped.append(sb)
                want.discard(sb)
            if want:
                # the index drifted from the stack (an offline/raw stack
                # edit): the stack is fully drained now, so resync the
                # index to the drained membership and redo the search —
                # this degenerate path is exactly the old algorithm
                _OBS_PLACE_RESYNC.inc()
                self._run_index.rebuild(popped)
                first = self._run_index.best_fit(nsb)
                if first is None:
                    for sb in popped:
                        self._push_list(layout.M_FREE_HEAD, D_NEXT_FREE, sb)
                    return None
            self._run_index.claim(first, nsb)
            for sb in popped:
                if not first <= sb < first + nsb:
                    self._push_list(layout.M_FREE_HEAD, D_NEXT_FREE, sb)
            return first

    def _malloc_large(self, size: int) -> int | None:
        nsb = math.ceil(size / SB_SIZE)
        # placement: best-fit over freed contiguous runs first — only when
        # no run fits does the span consume fresh watermark (the paper's
        # watermark-only policy leaks address space under span churn).
        # The lock serializes large-span *placement* only: the small-class
        # fast path stays synchronization-free, and the device allocator
        # gets the same atomicity by construction (one program step).
        with self._large_lock:
            first = self._claim_free_run(nsb)
            if first is None:
                first = self._expand(nsb)
                if first is None:
                    return None
                _OBS_PLACE_WATERMARK.inc()
        m = self.mem
        m.write(self.desc(first, D_SIZE_CLASS), LARGE_CLASS)
        m.write(self.desc(first, D_BLOCK_SIZE), size)
        to_persist = [self.desc(first, D_SIZE_CLASS), self.desc(first, D_BLOCK_SIZE)]
        for sb in range(first + 1, first + nsb):
            m.write(self.desc(sb, D_SIZE_CLASS), LARGE_CONT)
            m.write(self.desc(sb, D_BLOCK_SIZE), 0)
            to_persist.append(self.desc(sb, D_SIZE_CLASS))
        self._persist(*to_persist)
        _, _, _, tag = unpack_anchor(m.read(self.desc(first, D_ANCHOR)))
        m.write(self.desc(first, D_ANCHOR),
                pack_anchor(FULL, ANCHOR_NIL_AVAIL, 0, tag + 1))
        # one (transient) full-extent owner lease
        self.leases.register(first, nsb)
        return self.heap.sb_word(first)

    def _free_large(self, first: int) -> None:
        m = self.mem
        size = m.read(self.desc(first, D_BLOCK_SIZE))
        nsb = math.ceil(size / SB_SIZE)
        # clear the persistent span records (head size + LARGE_CONT
        # continuation markers) *before* the superblocks become reachable
        # from the free list: a crash between the push and a lazy reset
        # would otherwise leave recovery staring at orphaned continuation
        # markers / a stale head that could resurrect the whole span
        to_persist = []
        for sb in range(first, first + nsb):
            m.write(self.desc(sb, D_SIZE_CLASS), 0)
            m.write(self.desc(sb, D_BLOCK_SIZE), 0)
            to_persist += [self.desc(sb, D_SIZE_CLASS),
                           self.desc(sb, D_BLOCK_SIZE)]
        if not is_suppressed("ralloc.free_large.persist"):
            self._persist(*to_persist)
        self.mem.note("span_free", head=first, nsb=nsb)
        _OBS_SPAN_FREE.inc()
        # the span re-enters the free set as one atomic unit: a placement
        # drain interleaving between the pushes would observe a torn run
        # (a prefix of the span), claim it misaligned, and leave stranded
        # fragments no later request can use
        self.leases.forget(first)
        with self._large_lock:
            for sb in range(first, first + nsb):
                self._init_free_sb(sb)
                self._free_push(sb)

    def _trim_tail(self, head: int, new_ext: int, old_ext: int) -> None:
        """Return the unleased tail ``[head+new_ext, head+old_ext)`` of a
        still-live span to the free set.

        The persistent records change exactly like a free of the tail
        alone: the head's size record shrinks to the kept prefix and the
        tail's continuation markers clear, all durable *before* the
        superblocks become reachable from the free list.  Either side of
        a crash mid-trim is safe: head-shrink durable without some tail
        clears leaves orphaned ``LARGE_CONT`` markers recovery sweeps to
        the free set; tail clears durable without the head shrink leaves
        the span looking whole and recovery re-installs the continuation
        markers (a safe leak of the tail back into the span — the same
        conservative direction every GC false positive takes).
        """
        m = self.mem
        size = int(m.read(self.desc(head, D_BLOCK_SIZE)))
        m.write(self.desc(head, D_BLOCK_SIZE),
                min(size, new_ext * SB_SIZE))
        to_persist = [self.desc(head, D_BLOCK_SIZE)]
        for sb in range(head + new_ext, head + old_ext):
            m.write(self.desc(sb, D_SIZE_CLASS), 0)
            m.write(self.desc(sb, D_BLOCK_SIZE), 0)
            to_persist += [self.desc(sb, D_SIZE_CLASS),
                           self.desc(sb, D_BLOCK_SIZE)]
        if not is_suppressed("ralloc.trim_tail.persist"):
            self._persist(*to_persist)
        self.mem.note("tail_free", head=head, new_ext=new_ext,
                      old_ext=old_ext)
        _OBS_TAIL_TRIM.inc()
        # the tail re-enters the free set atomically (same torn-run
        # argument as _free_large)
        with self._large_lock:
            for sb in range(head + new_ext, head + old_ext):
                self._init_free_sb(sb)
                self._free_push(sb)

    # ------------------------------------------------------------ block I/O
    # Convenience accessors used by test data structures & benchmarks: they
    # model application loads/stores to heap blocks (word granularity).
    def read_word(self, w: int) -> int:
        return self.mem.read(w)

    def write_word(self, w: int, v: int) -> None:
        self.mem.write(w, v)

    def write_words(self, w: int, values) -> None:
        """Store a word range (``write_word`` over each value, in order;
        one slice assignment in fast mode -- ``NVMArray.write_words``)."""
        self.mem.write_words(w, values)

    def read_words(self, w: int, n: int):
        """Words ``[w, w + n)``, cache-coherent (a view in fast mode, to
        read only -- ``NVMArray.read_view``)."""
        return self.mem.read_view(w, n)

    def flush_range(self, w: int, nwords: int) -> None:
        """Application-side durability (durable linearizability is the app's job)."""
        if self.persist_on:
            self.mem.flush_range(w, nwords)

    def fence(self) -> None:
        if self.persist_on:
            self.mem.fence()

    def fence_if_pending(self) -> None:
        """The persist-boundary idiom: sfence only when a clwb has been
        issued since the last fence.  An elided fence is free — nothing
        is scheduled, so it would commit nothing (persist-lint counts it
        as an ``empty fence``)."""
        if self.persist_on and self.mem.flush_pending:
            self.mem.fence()

    def flush_ranges(self, ranges) -> None:
        """Line-deduplicated batch flush: every cache line under any
        ``(word, nwords)`` range is flushed exactly once.  Group-commit
        paths flush many small records whose 40/64-byte blocks share
        lines; per-record ``flush_range`` calls would re-issue clwb for
        the shared lines (persist-lint: ``redundant flush``)."""
        if not self.persist_on:
            return
        lines: set[int] = set()
        for w, nwords in ranges:
            lines.update(range(w // 8, (w + max(nwords, 1) - 1) // 8 + 1))
        for line in sorted(lines):
            self.mem.flush(line * 8)


def total_blocks(r: Ralloc, sb: int) -> int:
    bs = r.mem.read(r.desc(sb, D_BLOCK_SIZE))
    return layout.blocks_per_sb(int(bs)) if bs > 0 else 0
