"""Atomic primitives and the simulated-NVM write-back layer.

Port of the reference's ``core/atomics.py`` plus a bulk path for the
checkpoint store: ``write_words`` (a word range), ``flush_range`` (every
line under a word range) and ``read_view`` (a word range, cache-coherent).
In fast mode with no tracer they are one slice assignment, one counter
add and a view of the image; in sim mode, or with a tracer attached, they
run the per-word ``write`` and per-line ``flush`` loops, so the eviction
RNG draws, the tracer sees and a crash keeps exactly what the reference's
word-at-a-time stores would give.  Either way the image and the
``n_flush`` count equal the reference's.

The paper's hardware model (§2.1): stores go through volatile caches; an
application controls durability with ``clwb`` (flush) + ``sfence`` (fence);
on a full-system crash every line that was not written back is lost, but
writes-back are never torn at cache-line granularity.

We reproduce that model in software so the recoverability protocol can be
*tested* rather than assumed:

  * ``NVMArray`` wraps a ``numpy.int64`` buffer ("the NVM image").
  * With ``sim=True`` all writes land in a per-line write-back cache;
    ``flush(addr)`` schedules the line, ``fence()`` makes scheduled lines
    durable.  ``crash()`` drops everything not yet durable.  A seeded RNG
    spontaneously evicts dirty lines (hardware may write back *any* dirty
    line at *any* time — correct protocols must tolerate both presence and
    absence of unflushed data).
  * With ``sim=False`` ("fast mode", used by the benchmarks) writes go
    straight to the buffer and flush/fence only bump counters, so the
    *cost model* of persistence (flush/fence counts per operation — the
    paper's key claim is that Ralloc needs almost none) is still measured.

CAS is emulated with a short critical section.  The Ralloc *algorithm*
remains nonblocking — the lock stands in for a single hardware CAS
instruction, never protects multi-word state, and is never held across
other operations.  (CPython cannot express a true lock-free CAS on shared
numpy memory; this is the standard emulation.)
"""

from __future__ import annotations

import threading

import numpy as np

CACHELINE_WORDS = 8


class NVMArray:
    """int64 word array with flush/fence semantics and crash injection."""

    def __init__(self, words: int, *, sim: bool = False, seed: int = 0,
                 evict_prob: float = 0.01, backing: np.ndarray | None = None,
                 flush_ns: int = 0, fence_ns: int = 0, tracer=None):
        if backing is not None:
            assert backing.dtype == np.int64 and backing.size >= words
            self.nvm = backing
        else:
            self.nvm = np.zeros(words, dtype=np.int64)
        self.sim = sim
        # Optional persist-event tracer (analysis.trace.PersistTracer):
        # every ordering-relevant call is reported *at entry*, before the
        # memory mutates, so a raising tracer models a crash just before
        # the event.  None (the default) costs one attribute test per op.
        self.tracer = tracer
        # Optional modeled Optane write-back latency (benchmarks only):
        # clwb issue + WPQ drain are ~100–300 ns on real hardware; a busy
        # wait injects that cost so persistence shows up in throughput.
        self.flush_ns = flush_ns
        self.fence_ns = fence_ns
        self._cas_lock = threading.Lock()
        # persistence cost counters (valid in both modes)
        self.n_flush = 0
        self.n_fence = 0
        self.n_cas = 0
        self.n_drain = 0
        # clwb issued since the last sfence/drain?  A fence with no
        # intervening flush commits nothing (nothing is scheduled), so
        # callers at persist boundaries may elide it when this is False.
        self._flushed_since_fence = False
        if sim:
            self._cache: dict[int, dict[int, int]] = {}   # line -> {word: value}
            self._scheduled: set[int] = set()             # flushed, await fence
            self._rng = np.random.default_rng(seed)
            self._evict_prob = evict_prob

    # -- addressing helpers --------------------------------------------------
    @staticmethod
    def _line(idx: int) -> int:
        return idx // CACHELINE_WORDS

    # -- reads / writes -------------------------------------------------------
    def read(self, idx: int) -> int:
        if self.sim:
            line = self._cache.get(self._line(idx))
            if line is not None and idx in line:
                return line[idx]
        return int(self.nvm[idx])

    def read_block(self, idx: int, n: int) -> np.ndarray:
        """Read ``n`` consecutive words (cache-coherent view)."""
        out = self.nvm[idx:idx + n].copy()
        if self.sim:
            for line_id in range(self._line(idx), self._line(idx + n - 1) + 1):
                line = self._cache.get(line_id)
                if line:
                    for w, v in line.items():
                        if idx <= w < idx + n:
                            out[w - idx] = v
        return out

    def write(self, idx: int, value: int) -> None:
        value = int(np.int64(np.uint64(value & ((1 << 64) - 1))))
        if self.tracer is not None:
            self.tracer.record("write", idx, value)
        if self.sim:
            self._cache.setdefault(self._line(idx), {})[idx] = value
            self._maybe_evict()
        else:
            self.nvm[idx] = value

    def write_block(self, idx: int, values) -> None:
        for k, v in enumerate(values):
            self.write(idx + k, int(v))

    @property
    def bulk(self) -> bool:
        """True iff stores and flushes may skip the per-word path: fast
        mode, no tracer, no modeled flush latency."""
        return not self.sim and self.tracer is None and not self.flush_ns

    def write_words(self, idx: int, values: np.ndarray) -> None:
        """Store the int64 ``values`` at words ``[idx, idx + len)``, in
        order: one slice assignment when ``bulk``, else ``write`` word by
        word (the eviction RNG draws once a store, as in the reference)."""
        if self.bulk:
            self.nvm[idx:idx + len(values)] = values
        else:
            for k, v in enumerate(values.tolist()):
                self.write(idx + k, v)

    def flush_range(self, idx: int, nwords: int) -> None:
        """clwb of every line under words ``[idx, idx + max(nwords, 1))``,
        in ascending order: when ``bulk`` only the count moves, by the
        number of lines the loop would flush."""
        first = self._line(idx)
        last = self._line(idx + max(nwords, 1) - 1)
        if self.bulk:
            self.n_flush += last - first + 1
            self._flushed_since_fence = True
            return
        for line in range(first, last + 1):
            self.flush(line * CACHELINE_WORDS)

    def byte_view(self, idx: int, nwords: int) -> np.ndarray:
        """The bytes of words ``[idx, idx + nwords)`` as a writable uint8
        view of the image, for a bulk store from another buffer (the
        checkpoint store copies a tensor there, from the card with no
        staging copy).  Only when ``bulk``: a store through it bypasses
        the write-back cache and the tracer."""
        if not self.bulk:
            raise RuntimeError("byte_view needs fast mode with no tracer")
        return self.nvm[idx:idx + nwords].view(np.uint8)

    def read_view(self, idx: int, n: int) -> np.ndarray:
        """Words ``[idx, idx + n)``, cache-coherent: a view of the image in
        fast mode (nothing is cached), ``read_block``'s copy in sim mode.
        Read only: a store through the view bypasses the tracer, and the
        view changes with later stores (copy what must outlive them)."""
        if self.sim:
            return self.read_block(idx, n)
        return self.nvm[idx:idx + n]

    # -- persistence ----------------------------------------------------------
    def flush(self, idx: int) -> None:
        """clwb: schedule the line containing ``idx`` for write-back."""
        if self.tracer is not None:
            self.tracer.record("flush", idx)
        self.n_flush += 1
        self._flushed_since_fence = True
        if self.sim:
            self._scheduled.add(self._line(idx))
        if self.flush_ns:
            self._spin(self.flush_ns)

    def fence(self) -> None:
        """sfence: all scheduled lines become durable."""
        if self.tracer is not None:
            self.tracer.record("fence")
        self.n_fence += 1
        self._flushed_since_fence = False
        if self.sim:
            for line_id in list(self._scheduled):
                self._writeback(line_id)
            self._scheduled.clear()
        if self.fence_ns:
            self._spin(self.fence_ns)

    @property
    def flush_pending(self) -> bool:
        """True iff a clwb was issued since the last sfence/drain/crash.
        When False, an sfence would commit nothing — the strict model
        has no scheduled lines — so a persist boundary may skip it."""
        return self._flushed_since_fence

    @staticmethod
    def _spin(ns: int) -> None:
        import time
        end = time.perf_counter_ns() + ns
        while time.perf_counter_ns() < end:
            pass

    def persist(self, idx: int, value: int) -> None:
        """write + flush + fence of one word (ordered durable store)."""
        self.write(idx, value)
        self.flush(idx)
        self.fence()

    def _writeback(self, line_id: int) -> None:
        line = self._cache.pop(line_id, None)
        if line:
            for w, v in line.items():
                self.nvm[w] = v

    def _maybe_evict(self) -> None:
        """Hardware may evict any dirty line at any time."""
        if self._cache and self._rng.random() < self._evict_prob:
            victim = list(self._cache.keys())[
                int(self._rng.integers(len(self._cache)))]
            self._writeback(victim)

    # -- crash ----------------------------------------------------------------
    def crash(self) -> None:
        """Full-system crash: every non-durable line is lost."""
        if self.tracer is not None:
            self.tracer.record("crash")
        self._flushed_since_fence = False
        if self.sim:
            self._cache.clear()
            self._scheduled.clear()

    def drain(self) -> None:
        """Clean shutdown: write back everything (implicit eventual WB)."""
        if self.tracer is not None:
            self.tracer.record("drain")
        self.n_drain += 1
        self._flushed_since_fence = False
        if self.sim:
            for line_id in list(self._cache.keys()):
                self._writeback(line_id)
            self._scheduled.clear()

    # -- atomics ---------------------------------------------------------------
    def cas(self, idx: int, expected: int, new: int) -> bool:
        """Single-word compare-and-swap (emulated hardware primitive)."""
        self.n_cas += 1
        with self._cas_lock:
            if self.read(idx) == int(np.int64(np.uint64(expected & ((1 << 64) - 1)))):
                self.write(idx, new)      # the store reaches the tracer here
                if self.tracer is not None:
                    self.tracer.record("cas", idx, new, info={"ok": True})
                return True
            if self.tracer is not None:
                self.tracer.record("cas", idx, info={"ok": False})
            return False

    def faa(self, idx: int, delta: int) -> int:
        """Fetch-and-add; returns the previous value."""
        with self._cas_lock:
            old = self.read(idx)
            self.write(idx, old + delta)
            return old

    def reset_counters(self) -> None:
        self.n_flush = self.n_fence = self.n_cas = self.n_drain = 0

    # -- semantic trace markers ------------------------------------------------
    def note(self, label: str, **info) -> None:
        """Forward a semantic marker (``record_seal``, ``lease_release``,
        ``tail_free``, ...) to the attached tracer; no-op untraced.  The
        ordering rules in ``analysis.persist_lint`` trigger on these."""
        if self.tracer is not None:
            self.tracer.record("note", label=label, info=info)
