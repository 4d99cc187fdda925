"""Persistent heap segments (paper §2.1, §4.1–4.3).

Port of the reference's ``core/heap.py``, unchanged: the same file layout,
dirty-flag tri-state, roots and ``heap.*`` obs sources (the port's
registry).

A heap is a single file (standing in for a DAX segment) laid out as
``[metadata][descriptor region][superblock region]`` and mapped via
``numpy.memmap`` — i.e. loads/stores, no read()/write() syscalls, exactly
the DAX programming model.  Physical pages are consumed on first touch
(sparse file), matching the paper's observation that a segment can be
sized generously without committing memory.

``init()`` implements the fresh / clean-restart / dirty-restart
tri-state of paper Fig. 1: it returns True iff recovery is needed.  The
dirty indicator is a persisted word (the paper uses a robust pthread
mutex; a flag word + ordered stores is the moral equivalent for a
single-manager segment and is what we can express portably).
"""

from __future__ import annotations

import os

import numpy as np

from . import layout
from .. import obs
from ..analysis.faults import is_suppressed
from .atomics import CACHELINE_WORDS, NVMArray
from .layout import HeapConfig, MAGIC


class PersistentHeap:
    """mmap-backed three-region heap with a dirty-flag recovery protocol."""

    def __init__(self, path: str | None, config: HeapConfig,
                 backing: np.ndarray | None = None):
        """``backing`` overrides the storage array — crash-injection tests
        reopen a captured durable image in place of a file/fresh buffer."""
        self.path = path
        self.config = config
        self.existed = path is not None and os.path.exists(path)
        if backing is not None:
            assert path is None, "backing replaces file storage, not both"
            assert backing.dtype == np.int64
            assert backing.size >= config.total_words
        elif path is None:
            backing = np.zeros(config.total_words, dtype=np.int64)
        else:
            mode = "r+" if self.existed else "w+"
            backing = np.memmap(path, dtype=np.int64, mode=mode,
                                shape=(config.total_words,))
        self.mem = NVMArray(config.total_words, sim=config.sim_nvm,
                            seed=config.seed, backing=backing,
                            flush_ns=config.flush_ns, fence_ns=config.fence_ns)
        # Unify the persistence-cost counters behind the obs registry:
        # the newest heap owns the ``heap.*`` names, reads come straight
        # off the live NVMArray at snapshot time, and resets route
        # through ``obs.reset`` (which raises on a name no heap
        # registered — no more silent ``a.mem.reset_counters()`` skews).
        for attr, name in (("n_flush", "heap.flush"),
                           ("n_fence", "heap.fence"),
                           ("n_cas", "heap.cas"),
                           ("n_drain", "heap.drain")):
            obs.register_source(
                name,
                read=(lambda m=self.mem, a=attr: getattr(m, a)),
                reset=(lambda m=self.mem, a=attr: setattr(m, a, 0)))

    # ------------------------------------------------------------------ init
    def init(self) -> bool:
        """Create or remap the heap; True iff a dirty restart (recovery needed)."""
        m = self.mem
        fresh = m.read(layout.M_MAGIC) != MAGIC
        dirty = (not fresh) and m.read(layout.M_DIRTY) != 0
        if fresh:
            m.write(layout.M_MAGIC, MAGIC)
            m.write(layout.M_SB_REGION_WORDS, self.config.sb_region_words)
            m.write(layout.M_USED_SBS, 0)
            for i in range(layout.MAX_ROOTS):
                m.write(layout.M_ROOTS + i, 0)
            seen_lines = set()
            for w in (layout.M_MAGIC, layout.M_SB_REGION_WORDS,
                      layout.M_USED_SBS, layout.M_ROOTS):
                if w // CACHELINE_WORDS not in seen_lines:
                    seen_lines.add(w // CACHELINE_WORDS)
                    m.flush(w)
            m.fence()
        if fresh:
            # Transient list heads start empty on a fresh heap.  On a *clean*
            # restart they were implicitly written back at close() and are
            # reused as-is (paper: "allowing quick restart after a clean
            # shutdown"); on a *dirty* restart recovery rebuilds them.
            m.write(layout.M_FREE_HEAD, layout.pack_head(-1, 0))
            for c in range(layout.NUM_CLASSES):
                m.write(layout.M_PARTIAL_HEADS + c, layout.pack_head(-1, 0))
        # mark dirty until close() (any crash from here on needs recovery)
        m.persist(layout.M_DIRTY, 1)
        return dirty

    def close(self) -> None:
        """Clean shutdown: write everything back, clear the dirty flag."""
        self.mem.drain()
        self.mem.persist(layout.M_DIRTY, 0)
        self.mem.drain()
        if isinstance(self.mem.nvm, np.memmap):
            self.mem.nvm.flush()

    def crash(self) -> None:
        """Simulated full-system crash (drops non-durable lines)."""
        self.mem.crash()

    # ------------------------------------------------------------- addressing
    def desc_word(self, sb_idx: int, field: int) -> int:
        return self.config.desc_base + sb_idx * layout.DESC_WORDS + field

    def sb_word(self, sb_idx: int) -> int:
        return self.config.sb_base + sb_idx * layout.SB_WORDS

    def sb_of(self, block_word: int) -> int:
        """Descriptor index for a block address — pure bit manipulation."""
        return (block_word - self.config.sb_base) // layout.SB_WORDS

    def in_sb_region(self, word: int) -> bool:
        used = self.mem.read(layout.M_USED_SBS)
        return (self.config.sb_base <= word
                < self.config.sb_base + used * layout.SB_WORDS)

    # ----------------------------------------------------------------- roots
    def set_root(self, i: int, block_word: int | None) -> None:
        """Persist root ``i`` (region-based offset into the superblock region)."""
        assert 0 <= i < layout.MAX_ROOTS
        off = 0 if block_word is None else (block_word - self.config.sb_base + 1)
        self.mem.write(layout.M_ROOTS + i, off)
        if not is_suppressed("heap.set_root.persist"):
            self.mem.flush(layout.M_ROOTS + i)
            self.mem.fence()

    def set_roots(self, pairs) -> None:
        """Batched root swing: write and flush every ``(i, block_word)``
        pair, then ONE fence — the group-commit form of ``set_root``
        (NVTraverse: only the destination writes need ordering, and they
        can share it).  Atomicity is per slot: a crash mid-batch lands a
        prefix of the swings, each individually consistent."""
        for i, block_word in pairs:
            assert 0 <= i < layout.MAX_ROOTS
            off = (0 if block_word is None
                   else block_word - self.config.sb_base + 1)
            self.mem.write(layout.M_ROOTS + i, off)
        if not is_suppressed("heap.set_root.persist"):
            # one clwb per dirty *line*, not per slot — adjacent root
            # slots share cache lines and a second flush of an already
            # scheduled line is pure waste (persist-lint: redundant)
            seen_lines = set()
            for i, _ in pairs:
                w = layout.M_ROOTS + i
                if w // CACHELINE_WORDS not in seen_lines:
                    seen_lines.add(w // CACHELINE_WORDS)
                    self.mem.flush(w)
            self.mem.fence()

    def get_root(self, i: int) -> int | None:
        off = self.mem.read(layout.M_ROOTS + i)
        return None if off == 0 else self.config.sb_base + off - 1
