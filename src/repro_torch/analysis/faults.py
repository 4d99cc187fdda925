"""Named fault-injection sites for the seeded flush/fence pairs.

Port of the reference's ``analysis/faults.py``, limited to the sites the
port's host heap guards (the reference's ``prefix_index`` and
``prefix_trie`` sites guard modules the port does not have).  Each site
guards exactly one flush/fence pair; a test suppresses a site to inject a
missing persist and checks what a crash then leaves.

This module is dependency-free: the guarded ``core`` modules import it.
"""

from __future__ import annotations

from contextlib import contextmanager

#: every seeded site (suppressing an unknown site is an error -- a typo
#: would silently test nothing)
SITES = frozenset({
    "heap.set_root.persist",                 # root swing flush+fence
    "ralloc.trim_tail.persist",              # trim's size-record shrink
    "ralloc.free_large.persist",             # span record clears before free
})

_suppressed: set[str] = set()


def is_suppressed(site: str) -> bool:
    """True iff a test disabled this flush/fence site."""
    return site in _suppressed


@contextmanager
def suppress(*sites: str):
    """Disable the named flush/fence sites for the duration of the block."""
    unknown = set(sites) - SITES
    if unknown:
        raise ValueError(f"unknown fault site(s): {sorted(unknown)}")
    added = set(sites) - _suppressed
    _suppressed.update(added)
    try:
        yield
    finally:
        _suppressed.difference_update(added)
