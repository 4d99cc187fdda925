"""Span range leases: transient per-range refcounts + free-run index.

Port of the reference's ``core/spans.py``, unchanged.

Ralloc's thesis is that metadata which recovery-time GC can rebuild need
not be persisted on the hot path.  This module applies that philosophy to
two pieces of large-span bookkeeping, both held **only in transient
memory** — nothing here is ever flushed:

  * ``RangeLeaseTable`` — per live ``LARGE_CLASS`` span, a table of
    ``[start_sb, end_sb) -> refs`` intervals (its *leases*).  Every lease
    is a **prefix** of the span: the owner's reservation leases the whole
    extent, while a follower that only reads the first pages
    (``Ralloc.span_acquire(n_sbs=…)``) leases just that prefix.  A
    release decrements a range; a superblock *suffix* whose count drops
    to zero is no longer leased by anyone and returns to the free set
    (``Ralloc._trim_tail``) while the shared prefix stays placed — this
    is what unpins the decode-ahead tail of a published span.  The head
    range reaching zero frees whatever remains of the span.  After a
    crash the counts are reconstructed by the existing mark phase: each
    root-reachable reference to a span head is one lease over the span's
    remaining (persisted) extent — lease lengths are transient, so
    recovery conservatively rebuilds them at full extent
    (``heap_recovery.trace`` counts references while marking;
    ``recovery.span_ref_counts`` is the vectorized device analogue).
    No acquire/trim/release ever writes NVM beyond the records a real
    free already wrote — the paper's "pay almost nothing for
    persistence" property extends from sharing to *partial* sharing.

  * ``FreeRunIndex`` — maximal contiguous runs of free superblocks,
    bucketed by length.  ``Ralloc._claim_free_run`` previously drained
    and sorted the whole Treiber free stack per large allocation
    (O(num_sbs log num_sbs)); the index answers best-fit queries
    (smallest run >= request, leftmost on ties) in O(log) and answers
    *misses* in O(1) without touching the stack at all.  It is a mirror
    of free-stack membership, updated at every push/pop, so placement
    still depends only on free-set membership — the property the
    differential-fuzz suite pins host/device lock-step to.

Both structures are rebuilt from scratch by ``heap_recovery.recover`` (the
index from the swept free list, the leases from the GC trace), exactly
like the paper's thread caches and Treiber stacks.
"""

from __future__ import annotations

import bisect
import threading

from .. import obs

# best-fit query outcomes (cached at import; see the obs package's conventions):
# an exact-length bucket hit, a larger-run overflow fallback, or a miss
_OBS_PLACE_EXACT = obs.counter("placement.exact_bucket")
_OBS_PLACE_OVERFLOW = obs.counter("placement.overflow_fallback")
_OBS_PLACE_MISS = obs.counter("placement.miss")


class LeaseUnderflow(ValueError):
    """A range release would drop some superblock's lease count below
    zero — the caller is releasing a range it never leased."""


class RangeLeaseTable:
    """Transient per-superblock-range lease counts, keyed by span head.

    Each live span is a sorted, coalesced interval list
    ``[[start_sb, end_sb, refs], …]`` covering ``[head, head + extent)``.
    Counts are *advisory until reconstructed*: a span never registered
    (e.g. a reopened heap before ``recover()`` runs) defaults to one
    full-extent lease, which preserves the pre-lease free semantics —
    callers ``ensure`` a span from its persistent size record before
    touching it.

    Invariants the operations maintain:
      * intervals are contiguous, ascending, and merged when adjacent
        counts are equal;
      * the last interval always has ``refs > 0`` (a zero-count suffix is
        reported to the caller via ``release`` and dropped — it is the
        caller's job to return those superblocks to the free set);
      * interior zero-count intervals can arise from conservative
        post-crash reconstruction followed by partial releases, or from
        a caller releasing a length it never leased that other holders'
        counts happen to cover (the table is identity-free, so such a
        mismatch is undetectable); either way they stay placed — a safe
        leak in the paper's leak-never-corrupt direction — until the
        head range's last release frees whatever remains.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: dict[int, list[list[int]]] = {}

    # ------------------------------------------------------------ internals
    @staticmethod
    def _split(segs: list[list[int]], at: int) -> None:
        """Ensure ``at`` is an interval boundary (interval split)."""
        for i, (s, e, c) in enumerate(segs):
            if s < at < e:
                segs[i] = [s, at, c]
                segs.insert(i + 1, [at, e, c])
                return

    @staticmethod
    def _coalesce(segs: list[list[int]]) -> None:
        """Merge adjacent intervals with equal counts (interval merge)."""
        i = 0
        while i + 1 < len(segs):
            if segs[i][2] == segs[i + 1][2] and segs[i][1] == segs[i + 1][0]:
                segs[i][1] = segs[i + 1][1]
                del segs[i + 1]
            else:
                i += 1

    # ------------------------------------------------------------------ API
    def register(self, head_sb: int, nsb: int) -> None:
        """A freshly placed ``nsb``-superblock span: one full-extent lease
        (its owner)."""
        with self._lock:
            self._spans[head_sb] = [[head_sb, head_sb + nsb, 1]]

    def ensure(self, head_sb: int, nsb: int) -> None:
        """Register a span not yet tracked (reopened heap before
        ``recover()``) with the single-owner default; no-op if known."""
        with self._lock:
            if head_sb not in self._spans:
                self._spans[head_sb] = [[head_sb, head_sb + nsb, 1]]

    def extent(self, head_sb: int) -> int | None:
        """Tracked extent in superblocks (None if unknown)."""
        with self._lock:
            segs = self._spans.get(head_sb)
            return None if not segs else segs[-1][1] - head_sb

    def acquire(self, head_sb: int, n_sbs: int) -> int:
        """Lease the ``n_sbs``-superblock prefix ``[head, head + n)``
        (clamped to the extent); returns the new head-range count."""
        with self._lock:
            segs = self._spans[head_sb]
            end = min(head_sb + max(1, n_sbs), segs[-1][1])
            self._split(segs, end)
            for seg in segs:
                if seg[0] < end:
                    seg[2] += 1
            self._coalesce(segs)
            return segs[0][2]

    def release(self, head_sb: int, start: int, end: int
                ) -> tuple[int, int]:
        """Drop one lease on ``[start, end)`` (absolute superblocks).

        Returns ``(head_count, new_extent_sbs)`` after the decrement:
        ``head_count == 0`` means the whole remaining span is unleased
        (the caller frees it; the record is dropped here); otherwise a
        zero-count *suffix* was truncated and ``new_extent_sbs`` tells
        the caller how much of the span is still leased — superblocks
        past it must return to the free set.  Raises ``LeaseUnderflow``
        (without mutating) if any part of the range is not leased.
        """
        with self._lock:
            segs = self._spans[head_sb]
            end = min(end, segs[-1][1])
            if not head_sb <= start < end:
                raise LeaseUnderflow(
                    f"empty/invalid release range [{start}, {end}) on the "
                    f"span at superblock {head_sb}")
            if any(c < 1 for s, e, c in segs if s < end and e > start):
                raise LeaseUnderflow(
                    f"release of unleased range [{start}, {end}) on the "
                    f"span at superblock {head_sb}")
            self._split(segs, start)
            self._split(segs, end)
            for seg in segs:
                if start <= seg[0] < end:
                    seg[2] -= 1
            if segs[0][2] <= 0:            # head range unleased → span dies
                del self._spans[head_sb]
                return 0, 0
            while segs and segs[-1][2] == 0:
                segs.pop()                 # unleased tail → caller frees it
            self._coalesce(segs)
            return segs[0][2], segs[-1][1] - head_sb

    def count(self, head_sb: int, sb_off: int = 0) -> int:
        """Lease count at ``head + sb_off`` (unknown span = one owner)."""
        with self._lock:
            segs = self._spans.get(head_sb)
            if not segs:
                return 1 if sb_off == 0 else 0
            for s, e, c in segs:
                if s <= head_sb + sb_off < e:
                    return c
            return 0

    def counts(self, head_sb: int) -> list[int]:
        """Per-superblock lease counts over the tracked extent."""
        with self._lock:
            segs = self._spans.get(head_sb, [])
            return [c for s, e, c in segs for _ in range(s, e)]

    def intervals(self, head_sb: int) -> list[tuple[int, int, int]]:
        """The coalesced ``(start_sb, end_sb, refs)`` lease intervals."""
        with self._lock:
            return [tuple(seg) for seg in self._spans.get(head_sb, [])]

    def forget(self, head_sb: int) -> None:
        """Drop the record entirely (the span was freed)."""
        with self._lock:
            self._spans.pop(head_sb, None)

    def reconstruct(self, spans: dict[int, tuple[int, int]]) -> None:
        """Replace everything with the GC-reconstructed map
        ``{head: (extent_sbs, count)}`` (recovery).  Lease lengths are
        transient and unrecoverable, so every reference conservatively
        becomes a full-extent lease — the tail stays pinned until the
        surviving holders release their (range) leases."""
        with self._lock:
            self._spans = {
                sb: [[sb, sb + nsb, max(1, int(c))]]
                for sb, (nsb, c) in spans.items() if nsb > 0}

    def snapshot(self) -> dict[int, list[tuple[int, int, int]]]:
        with self._lock:
            return {sb: [tuple(s) for s in segs]
                    for sb, segs in self._spans.items()}


class FreeRunIndex:
    """Size-bucketed maximal runs of free superblock indices.

    Mirrors the membership of the superblock free stack.  Maintained
    incrementally: ``add``/``discard`` are amortized O(run) on merges and
    splits, ``best_fit`` is O(log #lengths), and a miss (no run of the
    requested length) costs O(log) with no stack traffic at all.
    """

    def __init__(self) -> None:
        self._start_len: dict[int, int] = {}     # run start -> length
        self._end_start: dict[int, int] = {}     # run end (exclusive) -> start
        self._of_run: dict[int, int] = {}        # member sb -> run start
        self._by_len: dict[int, list[int]] = {}  # length -> sorted starts
        self._lens: list[int] = []               # sorted distinct lengths

    # ------------------------------------------------------------ internals
    def _link(self, start: int, length: int) -> None:
        self._start_len[start] = length
        self._end_start[start + length] = start
        bucket = self._by_len.get(length)
        if bucket is None:
            self._by_len[length] = [start]
            bisect.insort(self._lens, length)
        else:
            bisect.insort(bucket, start)
        for sb in range(start, start + length):
            self._of_run[sb] = start

    def _unlink(self, start: int) -> int:
        length = self._start_len.pop(start)
        del self._end_start[start + length]
        bucket = self._by_len[length]
        bucket.pop(bisect.bisect_left(bucket, start))
        if not bucket:
            del self._by_len[length]
            self._lens.pop(bisect.bisect_left(self._lens, length))
        return length

    # ------------------------------------------------------------------ API
    def __contains__(self, sb: int) -> bool:
        return sb in self._of_run

    def __len__(self) -> int:
        return len(self._of_run)

    def add(self, sb: int) -> None:
        """A superblock entered the free set; merge with its neighbours."""
        if sb in self._of_run:
            return
        start, length = sb, 1
        left = self._end_start.get(sb)           # run ending right at sb
        if left is not None:
            length += self._unlink(left)
            start = left
        right_len = self._start_len.get(sb + 1)  # run starting right after
        if right_len is not None:
            self._unlink(sb + 1)
            length += right_len
        self._link(start, length)

    def discard(self, sb: int) -> None:
        """A superblock left the free set (popped for a small-class refill);
        split its run.  Tolerates non-members (offline/raw stack edits)."""
        start = self._of_run.pop(sb, None)
        if start is None:
            return
        length = self._unlink(start)
        if sb > start:
            self._link(start, sb - start)
        if start + length > sb + 1:
            self._link(sb + 1, start + length - sb - 1)

    def best_fit(self, nsb: int) -> int | None:
        """Start of the smallest run >= ``nsb`` (leftmost on ties) — the
        identical rule ``min((length, start))`` applied over drained runs
        before this index existed, and the rule the device's suffix-min
        scan implements."""
        i = bisect.bisect_left(self._lens, nsb)
        if i == len(self._lens):
            _OBS_PLACE_MISS.inc()
            return None
        (_OBS_PLACE_EXACT if self._lens[i] == nsb
         else _OBS_PLACE_OVERFLOW).inc()
        return self._by_len[self._lens[i]][0]

    def claim(self, start: int, nsb: int) -> None:
        """Remove the first ``nsb`` members of the run starting at
        ``start``; the remainder re-enters the index as its own run."""
        length = self._unlink(start)
        assert length >= nsb, (start, length, nsb)
        for sb in range(start, start + nsb):
            del self._of_run[sb]
        if length > nsb:
            self._link(start + nsb, length - nsb)

    def runs(self) -> list[tuple[int, int]]:
        """All runs as sorted ``(start, length)`` — comparable with
        ``heap_recovery.free_superblock_runs`` / ``alloc.free_runs``."""
        return sorted(self._start_len.items())

    def clear(self) -> None:
        self.__init__()

    def rebuild(self, ids) -> None:
        """Reset to exactly the given free-set membership (recovery, or a
        drift resync from a fully drained stack)."""
        from .layout import contiguous_runs
        self.clear()
        for start, length in contiguous_runs(sorted(ids)):
            self._link(start, length)
