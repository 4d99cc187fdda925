"""Heap layout: regions, size classes, descriptor packing.

Port of the reference's ``core/layout.py``, unchanged.

Mirrors Ralloc (Cai et al., 2020) §4.2–4.3:

  * A heap comprises three contiguous regions — superblock, descriptor,
    metadata — all nominally resident in "NVM" (here: an mmap'd file that
    simulates a DAX segment, see ``core.heap``).
  * Superblocks are 64 KiB; every block in a superblock shares one size
    class.  Descriptors are 64 B, one per superblock, locatable from the
    block address by bit manipulation (and vice versa).
  * 39 small size classes spanning 8 B .. 14 KiB (LRMalloc geometry:
    8-byte steps up to 64 B, then four steps per power-of-two doubling),
    plus class 0 for large blocks.

Only the *persistent* fields (size_class, block_size, region ``used``,
roots, dirty flag) are ever flushed online; everything else is transient
and reconstructed by recovery GC.
"""

from __future__ import annotations

import dataclasses

WORD = 8                      # bytes per word; the heap is an int64 array
SB_SIZE = 64 * 1024           # superblock bytes (paper: 64 KB)
SB_WORDS = SB_SIZE // WORD
DESC_WORDS = 8                # descriptor = 64 B padded to a cache line
CACHELINE_WORDS = 8
MAX_ROOTS = 1024              # paper: metadata region contains 1024 roots
LARGE_CLASS = 0               # class 0 = blocks larger than any standard size
MAX_SMALL = 14336             # 14 KiB — largest small class (paper §4.2)


def _build_size_classes() -> tuple[int, ...]:
    """LRMalloc-style class geometry: 8..64 in 8 B steps, then 4 per doubling."""
    sizes = list(range(8, 64 + 1, 8))                      # 8..64   (8 classes)
    base = 64
    while sizes[-1] < MAX_SMALL:
        step = base // 4
        for k in range(1, 5):
            s = base + k * step
            if s > MAX_SMALL:
                break
            sizes.append(s)
        base *= 2
    return tuple(sizes)


SIZE_CLASSES = _build_size_classes()
NUM_CLASSES = len(SIZE_CLASSES) + 1   # +1 for the large class 0
assert len(SIZE_CLASSES) == 39, len(SIZE_CLASSES)   # paper: 39 standard classes


def size_to_class(size: int) -> int:
    """Map a request size to its class index (1-based; 0 = large)."""
    if size > MAX_SMALL:
        return LARGE_CLASS
    # binary search over the small-class table
    lo, hi = 0, len(SIZE_CLASSES) - 1
    while lo < hi:
        mid = (lo + hi) // 2
        if SIZE_CLASSES[mid] < size:
            lo = mid + 1
        else:
            hi = mid
    return lo + 1


def class_block_size(cls: int) -> int:
    assert cls != LARGE_CLASS
    return SIZE_CLASSES[cls - 1]


def blocks_per_sb(block_size: int) -> int:
    return SB_SIZE // block_size


def contiguous_runs(sorted_ids) -> list[tuple[int, int]]:
    """Group ascending, duplicate-free indices into maximal contiguous
    runs ``(start, length)``.

    Shared by the host run index (``spans.FreeRunIndex.rebuild`` — the
    structure behind ``ralloc._claim_free_run``'s best-fit placement),
    the host recovery introspection (``heap_recovery.free_superblock_runs``)
    and the device debug helper (``alloc.free_runs``) so they can
    never drift apart — the differential-fuzz suite asserts host/device
    placement equivalence over exactly these runs.
    """
    runs: list[tuple[int, int]] = []
    start = prev = None
    for i in sorted_ids:
        if start is None:
            start = prev = i
        elif i == prev + 1:
            prev = i
        else:
            runs.append((start, prev - start + 1))
            start = prev = i
    if start is not None:
        runs.append((start, prev - start + 1))
    return runs


# ---------------------------------------------------------------------------
# Anchor packing (descriptor word 0) — updated with a single CAS, paper §4.2.
#   state(2) | avail(20) | count(20) | tag(22)
# ``avail`` is the index of the first free block in the superblock free list,
# ``count`` the number of free blocks, ``tag`` an anti-ABA counter.
# ---------------------------------------------------------------------------
EMPTY, PARTIAL, FULL = 0, 1, 2

_AVAIL_SHIFT = 2
_COUNT_SHIFT = 22
_TAG_SHIFT = 42
_F20 = (1 << 20) - 1
_F22 = (1 << 22) - 1
ANCHOR_NIL_AVAIL = _F20       # sentinel: no free block


def pack_anchor(state: int, avail: int, count: int, tag: int) -> int:
    return (state
            | ((avail & _F20) << _AVAIL_SHIFT)
            | ((count & _F20) << _COUNT_SHIFT)
            | ((tag & _F22) << _TAG_SHIFT))


def unpack_anchor(a: int) -> tuple[int, int, int, int]:
    a = int(a) & ((1 << 64) - 1)
    return (a & 0b11,
            (a >> _AVAIL_SHIFT) & _F20,
            (a >> _COUNT_SHIFT) & _F20,
            (a >> _TAG_SHIFT) & _F22)


# ---------------------------------------------------------------------------
# List-head packing (free / partial Treiber stacks): descriptor index + ABA
# counter in one CAS-able word (paper §4.2: "34 bits devoted to a counter").
#   idx(30) | counter(34)       idx == _IDX_NIL means empty list
# ---------------------------------------------------------------------------
_IDX_BITS = 30
_IDX_NIL = (1 << _IDX_BITS) - 1
HEAD_NIL = _IDX_NIL           # empty list head with counter 0


def pack_head(idx: int, counter: int) -> int:
    if idx < 0:
        idx = _IDX_NIL
    return (idx & _IDX_NIL) | ((counter & ((1 << 34) - 1)) << _IDX_BITS)


def unpack_head(h: int) -> tuple[int, int]:
    h = int(h) & ((1 << 64) - 1)
    idx = h & _IDX_NIL
    return (-1 if idx == _IDX_NIL else idx), (h >> _IDX_BITS)


# ---------------------------------------------------------------------------
# Descriptor field offsets (in words, relative to the descriptor base).
# Persistent (bold in paper Fig. 2): SIZE_CLASS, BLOCK_SIZE.  The rest is
# transient — reconstructed by recovery.
# ---------------------------------------------------------------------------
D_ANCHOR = 0
D_SIZE_CLASS = 1      # persistent
D_BLOCK_SIZE = 2      # persistent (large blocks: total byte size; 0 = span cont.)
D_NEXT_FREE = 3       # transient: next node in superblock free list (desc idx)
D_NEXT_PARTIAL = 4    # transient: next node in a partial list (desc idx)

LARGE_CONT = -1       # size_class value marking a large-span continuation SB


# ---------------------------------------------------------------------------
# Metadata region layout (word offsets).
# ---------------------------------------------------------------------------
M_MAGIC = 0
M_DIRTY = 1           # persistent dirty indicator (paper: robust mutex)
M_SB_REGION_WORDS = 2  # max size of the superblock region (persistent, set at init)
M_USED_SBS = 3        # persistent watermark: number of superblocks in use
M_FREE_HEAD = 4       # transient: superblock free-list head (idx+counter)
M_PARTIAL_HEADS = 5   # transient: NUM_CLASSES partial-list heads
M_ROOTS = M_PARTIAL_HEADS + NUM_CLASSES      # persistent: MAX_ROOTS root words
M_END = M_ROOTS + MAX_ROOTS

MAGIC = 0x52414C4C4F43_01     # "RALLOC" v1


@dataclasses.dataclass(frozen=True)
class HeapConfig:
    """Static configuration for one persistent heap."""
    size: int                       # max superblock-region size in bytes
    initial_sbs: int = 16           # superblocks made available at init (paper: 1 GB)
    expand_sbs: int = 16            # expansion increment (paper: 1 GB)
    tcache_cap: int = 64            # thread-local cache capacity per class
    sim_nvm: bool = False           # write-back cache simulation (crash testing)
    seed: int = 0                   # RNG seed for simulated evictions
    flush_ns: int = 0               # modeled clwb latency (benchmarks)
    fence_ns: int = 0               # modeled sfence latency (benchmarks)

    @property
    def num_sbs(self) -> int:
        return self.size // SB_SIZE

    @property
    def desc_region_words(self) -> int:
        return self.num_sbs * DESC_WORDS

    @property
    def sb_region_words(self) -> int:
        return self.num_sbs * SB_WORDS

    # file layout: [metadata][descriptors][superblocks]
    @property
    def desc_base(self) -> int:
        return M_END

    @property
    def sb_base(self) -> int:
        return M_END + self.desc_region_words

    @property
    def total_words(self) -> int:
        return self.sb_base + self.sb_region_words
