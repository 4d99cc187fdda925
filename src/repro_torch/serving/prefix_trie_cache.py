"""Serving-side prefix-trie cache: longest-prefix-match over published
prompts, replacing the flat exact-match ``PrefixCache`` in the engine
path.

Device mirror of the host trie (``core.prefix_trie``) with the same
node semantics: a node covers pages ``[start_page, end_page)`` of some
published prompt, its ``span`` backs the *entire* prefix ``[0,
end_page)`` at identity page offsets (the publisher's own reservation),
and its lease covers ``ceil(end_page * page / sb_words)`` superblocks —
so any hit at any node boundary leases exactly ONE span, and
``LaneStates.shared_spans`` keeps its single-span tuple shape.

The flat dict API (``entries`` / ``tokens`` / ``page_refs`` / ``lookup``
/ ``insert`` / ``add_page_ref`` / ``clear``) is preserved verbatim — an
exact whole-prompt hit is just the trie hit whose boundary equals the
prompt — and the trie adds:

  * :meth:`match_partial` — longest-prefix match at page granularity: a
    request matching ``k`` pages of a longer published prompt leases
    only those ``k`` pages' superblocks and decodes its suffix on its
    own lazily-allocated pages;
  * transient :class:`CacheNode` shape mirroring the durable
    ``PrefixStore`` records (``parent`` / ``start_page`` / ``rec_off``),
    rebuilt from the surviving records after ``crash_and_recover``.

Nodes published this process carry per-page cumulative hashes
(``page_keys``) and the exact prefix tokens, enabling mid-edge partial
matches and splits.  Recovered nodes carry neither — they match
all-or-nothing at node granularity, by full cumulative key *plus* the
durable token fingerprint (``F_FPRINT``), so even a recovered entry
verifies tokens cheaply before serving (a recovered entry never
matches by hash alone).
"""

from __future__ import annotations

import dataclasses

from .. import obs
from ..core.prefix_hash import fingerprint, hash_tokens, page_hashes

_M32 = 0xFFFFFFFF

# Prefix-cache metrics (cached at import; see repro_torch.obs conventions).
# ``trie.hit_depth_pages`` is the distribution of matched whole pages on
# partial hits — the depth a request actually leases.
_OBS_EXACT_HIT = obs.counter("trie.exact_hit")
_OBS_EXACT_MISS = obs.counter("trie.exact_miss")
_OBS_PARTIAL_HIT = obs.counter("trie.partial_hit")
_OBS_PARTIAL_MISS = obs.counter("trie.partial_miss")
_OBS_HIT_DEPTH = obs.histogram("trie.hit_depth_pages")


@dataclasses.dataclass
class CacheNode:
    """Transient mirror of one durable prefix-store record."""
    key: int                     # cumulative 48-bit hash of [0, end_page)
    span: int                    # span head offset (backs [0, end_page))
    start_page: int
    end_page: int
    lease_sbs: int
    next_tok: int                # sampled continuation at the boundary
    fprint: int                  # durable token fingerprint
    rec_off: int = -1            # durable record block (-1: queued only)
    parent: int = -1             # parent node's key (-1 = root child)
    children: list = dataclasses.field(default_factory=list)  # child keys
    page_keys: list | None = None    # cum. hash per edge page (in-process)
    tokens: tuple | None = None      # full prefix tokens (in-process)


class PrefixTrieCache:
    """Transient trie + flat-compat dicts for one serving engine."""

    def __init__(self, page: int):
        self.page = int(page)
        self.entries: dict[int, tuple] = {}      # key -> flat cache entry
        self.tokens: dict[int, tuple] = {}       # key -> exact prompt tokens
        self.page_refs: dict[int, int] = {}      # page -> sharer count
        self.nodes: dict[int, CacheNode] = {}    # key -> trie node
        self.roots: list[int] = []               # keys with start_page == 0

    # ------------------------------------------------------------ flat API
    def lookup(self, prompt):
        """Exact whole-prompt hit (flat semantics).  In-process entries
        verify the exact token tuple; recovered span entries verify the
        durable token fingerprint — hash alone never serves."""
        key = hash_tokens(prompt)
        hit = self.entries.get(key)
        if hit is None:
            _OBS_EXACT_MISS.inc()
            return None
        known = self.tokens.get(key)
        if known is not None:
            if known != tuple(prompt):
                _OBS_EXACT_MISS.inc()
                return None
            _OBS_EXACT_HIT.inc()
            return hit
        node = self.nodes.get(key)
        if node is not None and not self._fp_ok(node, prompt):
            _OBS_EXACT_MISS.inc()
            return None
        _OBS_EXACT_HIT.inc()
        return hit

    def insert(self, key: int, entry: tuple, tokens=None) -> None:
        self.entries[key] = entry
        if tokens is not None:
            self.tokens[key] = tuple(tokens)

    def add_page_ref(self, p: int) -> None:
        self.page_refs[p] = self.page_refs.get(p, 1) + 1

    def clear(self) -> None:
        """Forget entries, tokens and trie shape; ``page_refs`` is decode
        state, not cache state — untouched (same as the flat cache)."""
        self.entries.clear()
        self.tokens.clear()
        self.nodes.clear()
        self.roots.clear()

    # ------------------------------------------------------------ trie API
    def _fp_ok(self, node: CacheNode, tokens) -> bool:
        pg = self.page
        return node.fprint == fingerprint(tokens[node.start_page * pg],
                                          tokens[node.end_page * pg - 1])

    def match_partial(self, prompt) -> tuple[CacheNode | None, int]:
        """Longest-prefix match: ``(node, pages)`` where ``pages`` whole
        pages of ``prompt`` are covered and ``node`` contains the last
        matched page.  ``pages < node.end_page`` means the match ends
        mid-edge of an in-process node (the engine splits there);
        recovered nodes only ever match at their full boundary."""
        prompt = tuple(int(t) for t in prompt)
        n = len(prompt) // self.page
        if n == 0:
            _OBS_PARTIAL_MISS.inc()
            return None, 0
        hs = page_hashes(prompt, self.page)
        best: CacheNode | None = None
        depth = 0
        child_keys = self.roots
        while depth < n:
            stepped = False
            for ck in child_keys:
                c = self.nodes.get(ck)
                if c is None or c.start_page != depth:
                    continue
                if c.page_keys is not None:
                    edge = c.end_page - c.start_page
                    i = 0
                    while (i < edge and depth + i < n
                           and c.page_keys[i] == hs[depth + i]):
                        i += 1
                    if i == 0:
                        continue
                    a, b = depth * self.page, (depth + i) * self.page
                    if prompt[a:b] != c.tokens[a:b]:
                        continue          # page-hash collision reads as miss
                    if i < edge:
                        _OBS_PARTIAL_HIT.inc()
                        _OBS_HIT_DEPTH.observe(depth + i)
                        return c, depth + i
                    best, depth, stepped = c, depth + i, True
                    break
                if (n >= c.end_page and hs[c.end_page - 1] == c.key
                        and self._fp_ok(c, prompt)):
                    best, depth, stepped = c, c.end_page, True
                    break
            if not stepped:
                break
            child_keys = best.children
        if best is None:
            _OBS_PARTIAL_MISS.inc()
        else:
            _OBS_PARTIAL_HIT.inc()
            _OBS_HIT_DEPTH.observe(depth)
        return best, depth

    def deepest_boundary(self, node: CacheNode | None, k: int
                         ) -> tuple[CacheNode | None, int]:
        """Clamp a mid-edge match to the deepest full-node boundary ≤ k
        (used when a split cannot happen — e.g. no record blocks)."""
        while node is not None and node.end_page > k:
            node = self.nodes.get(node.parent) if node.parent >= 0 else None
        return node, (node.end_page if node is not None else 0)

    def insert_node(self, node: CacheNode) -> None:
        self.nodes[node.key] = node
        if node.parent >= 0 and node.parent in self.nodes:
            sibs = self.nodes[node.parent].children
            if node.key not in sibs:
                sibs.append(node.key)
        else:
            node.parent = -1
            if node.key not in self.roots:
                self.roots.append(node.key)

    def set_rec(self, key: int, rec_off: int) -> None:
        node = self.nodes.get(key)
        if node is not None:
            node.rec_off = int(rec_off)

    def split_transient(self, node: CacheNode, k: int) -> CacheNode:
        """Transient half of a split: node X ``[s, e)`` becomes M
        ``[s, k)`` (returned) with X' ``[k, e)`` as its only initial
        child; X's children re-parent to X'.  The caller mirrors the
        durable half (``PrefixStore.split``) and the lease churn."""
        assert node.page_keys is not None and node.tokens is not None
        pg = self.page
        cut = k - node.start_page
        m = CacheNode(
            key=node.page_keys[cut - 1], span=node.span,
            start_page=node.start_page, end_page=k,
            lease_sbs=0,                    # caller fills in
            next_tok=int(node.tokens[k * pg]),
            fprint=fingerprint(node.tokens[node.start_page * pg],
                               node.tokens[k * pg - 1]),
            parent=node.parent,
            tokens=node.tokens[:k * pg],
            page_keys=node.page_keys[:cut])
        # X' keeps its key (same full prefix) and durable lease length
        old_key = node.key
        node.start_page = k
        node.fprint = fingerprint(node.tokens[k * pg],
                                  node.tokens[node.end_page * pg - 1])
        node.page_keys = node.page_keys[cut:]
        node.parent = m.key
        m.children = [old_key]
        if m.parent >= 0 and m.parent in self.nodes:
            sibs = self.nodes[m.parent].children
            sibs[sibs.index(old_key)] = m.key
        else:
            self.roots[self.roots.index(old_key)] = m.key
        self.nodes[m.key] = m
        return m

    def rebuild_from_records(self, records) -> None:
        """Two-pass transient rebuild from surviving ``StoreRecord``s
        (post-crash): create every node token-less (all-or-nothing
        matching), then link parents by record offset with the same
        coverage fallback as the host ``PrefixTrie._rebuild``."""
        self.nodes.clear()
        self.roots.clear()
        by_off = {int(r.off): r for r in records}
        key_of = {off: int(r.key) for off, r in by_off.items()}
        for off, r in by_off.items():
            self.nodes[int(r.key)] = CacheNode(
                key=int(r.key), span=int(r.span), start_page=int(r.start_page),
                end_page=int(r.n_pages), lease_sbs=int(r.lease_sbs),
                next_tok=int(r.next_tok), fprint=int(r.fprint),
                rec_off=off)
        for off, r in by_off.items():
            nd = self.nodes[int(r.key)]
            par = int(r.parent)
            if (par in by_off and par != off
                    and by_off[par].n_pages == r.start_page):
                nd.parent = key_of[par]
            elif int(r.start_page) > 0:
                cover = next((o for o, q in by_off.items()
                              if q.n_pages == r.start_page and o != off),
                             None)
                nd.parent = key_of[cover] if cover is not None else -1
                if nd.parent < 0:
                    continue              # unservable orphan: unattached
            if nd.parent >= 0:
                self.nodes[nd.parent].children.append(nd.key)
            else:
                self.roots.append(nd.key)
