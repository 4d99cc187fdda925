"""Filter functions (paper §4.5.1).

Port of the reference's ``core/filters.py``: ``conservative_filter``, the
registry and the ``stack_node`` / ``tree_node`` stock filters.  The
reference's ``prefix_index`` and ``prefix_trie`` filters belong to
modules the port does not have (its serving keeps the prefix cache in the
device ``prefix_store``): a root typed with either name raises
:class:`NotPorted` where the reference would trace it, never falling back
to a silent conservative scan.

A filter function enumerates the references contained in a block of a
given type, replacing conservative scanning during trace-based recovery.
The registry maps a *type name* to ``fn(heap_reader, block_word, size_bytes)
-> iterable[(target_word, child_typename | None)]`` where ``heap_reader``
exposes ``read_word``.  Child type names let typed tracing recurse
precisely (paper Fig. 3: ``visit<T>`` pushes ``filter<T>`` thunks).

Filter functions are re-registered on every execution (function pointers
are never persisted — paper: "reestablished in each execution, avoiding
any complications due to recompilation or ASLR").

The default ``conservative_filter`` implements Boehm–Weiser-style scanning
specialized by the pptr tag: every aligned word whose top bits match the
uncommon pattern is treated as a potential self-relative reference
(paper §4.6: the pattern "serves to reduce the likelihood that
frequently-occurring integer constants will be mistaken for off-holders").
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from . import pptr as pp
from .layout import WORD

FilterFn = Callable[[object, int, int], Iterable[tuple[int, Optional[str]]]]


def conservative_filter(reader, block_word: int, size_bytes: int):
    """Scan every 64-bit-aligned word for tagged self-relative offsets."""
    nwords = max(1, size_bytes // WORD)
    for k in range(nwords):
        w = block_word + k
        v = reader.read_word(w)
        if pp.looks_like_pptr(v):
            tgt = pp.decode(w, v)
            if tgt is not None:
                yield tgt, None          # child type unknown → conservative


#: the reference's typed roots whose modules the port does not have
NOT_PORTED = ("prefix_index", "prefix_trie")


class NotPorted(NotImplementedError):
    """A root typed with a filter of a reference module the port lacks."""


def refuse_not_ported(typename: str | None) -> None:
    """Raise :class:`NotPorted` for a ``NOT_PORTED`` type name."""
    if typename in NOT_PORTED:
        raise NotPorted(
            f"the {typename!r} filter is not ported: core/{typename}.py has "
            f"no counterpart in repro_torch (ROADMAP A, 'Not ported')")


class FilterRegistry:
    def __init__(self):
        self._fns: dict[str, FilterFn] = {}

    def register(self, typename: str, fn: FilterFn) -> None:
        self._fns[typename] = fn

    def get(self, typename: str | None) -> FilterFn:
        if typename is None:
            return conservative_filter
        refuse_not_ported(typename)
        return self._fns.get(typename, conservative_filter)


# -- stock filters for the test/benchmark data structures --------------------

def stack_node_filter(reader, block_word, size_bytes):
    """Treiber-stack node: [next: pptr][value...]."""
    nxt = pp.decode(block_word, reader.read_word(block_word))
    if nxt is not None:
        yield nxt, "stack_node"


def tree_node_filter(reader, block_word, size_bytes):
    """BST node: [key][value][left: pptr][right: pptr] (paper Fig. 4)."""
    for slot in (2, 3):
        w = block_word + slot
        child = pp.decode(w, reader.read_word(w))
        if child is not None:
            yield child, "tree_node"


def register_stock_filters(reg: FilterRegistry) -> None:
    reg.register("stack_node", stack_node_filter)
    reg.register("tree_node", tree_node_filter)
