"""Position-independent pointers (paper §4.6).

Port of the reference's ``core/pptr.py``, unchanged.

A ``pptr`` stores the 64-bit *self-relative* offset of its target: the
delta between the target's address and the address of the pointer word
itself ("off-holder", Chen et al. [8]).  Because the superblock region is
bounded (1 TiB in the paper; here: heap word count), the delta fits in 48
bits; the spare high bits hold an *uncommon tag pattern* that (a) lets
conservative GC reject most integer constants, and (b) provides counter
bits for the Treiber-stack heads (see ``layout.pack_head``).

All code in this repo — allocator metadata *and* the test/benchmark data
structures — stores heap references exclusively as pptrs or as region-based
offsets, so a heap image can be remapped at any address (ASLR-friendly) and,
on the device arena, resharded across a different mesh (offsets survive
relocation; raw addresses would not).

Addresses at this layer are *word indices* into the heap array; NULL is
encoded as delta == 0 (a pointer to itself is meaningless).
"""

from __future__ import annotations

import numpy as np

PPTR_TAG = 0xA5A5              # uncommon pattern, top 16 bits
_TAG_SHIFT = 48
_DELTA_MASK = (1 << _TAG_SHIFT) - 1
_SIGN_BIT = 1 << (_TAG_SHIFT - 1)
PPTR_NULL = PPTR_TAG << _TAG_SHIFT     # tag with zero delta == null


def encode(holder_idx: int, target_idx: int | None) -> int:
    """Encode a self-relative pptr stored at word ``holder_idx``."""
    if target_idx is None:
        delta = 0
    else:
        delta = int(target_idx) - int(holder_idx)
        assert delta != 0, "pptr cannot reference its own holder"
    raw = (PPTR_TAG << _TAG_SHIFT) | (delta & _DELTA_MASK)
    return int(np.int64(np.uint64(raw)))


def decode(holder_idx: int, stored: int) -> int | None:
    """Decode a pptr read from word ``holder_idx``; None if null/invalid."""
    raw = int(np.uint64(np.int64(stored)))
    if (raw >> _TAG_SHIFT) != PPTR_TAG:
        return None
    delta = raw & _DELTA_MASK
    if delta == 0:
        return None
    if delta & _SIGN_BIT:                      # sign-extend 48-bit delta
        delta -= 1 << _TAG_SHIFT
    return holder_idx + delta


def is_pptr(stored: int) -> bool:
    raw = int(np.uint64(np.int64(stored)))
    return (raw >> _TAG_SHIFT) == PPTR_TAG and (raw & _DELTA_MASK) != 0


def looks_like_pptr(stored: int) -> bool:
    """Conservative-GC test: tagged, regardless of whether delta is 0."""
    return (int(np.uint64(np.int64(stored))) >> _TAG_SHIFT) == PPTR_TAG
