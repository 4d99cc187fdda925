"""Durable prefix store: the serving engine's device-side prefix index.

Device mirror of ``core.prefix_trie``.  The engine's prefix cache keyed
transient host objects by prompt tuple; everything in it died with a
crash, so recovery could only rebuild conservative full-extent span
leases and every published prompt had to be re-prefilled.  The store
persists the minimum that lets ``crash_and_recover`` rebuild the rest:

  * each published prefix-trie node owns one **record block** — an
    ordinary arena block (``PAGE_CLS``), so the record is
    reachable/traceable/sweepable exactly like a KV page;
  * the record *fields* live in a durable sidecar array (device
    consumers own typed arrays rather than a raw byte heap — see
    ``core.recovery``'s module docstring), indexed by the record's
    block offset:

        F_NEXT        next record block offset (-1 ends the chain)
        F_SPAN        published span head offset
        F_KEY         48-bit cumulative prefix hash up to F_PAGES
                      (``core.prefix_hash.hash_tokens``)
        F_PAGES       the node's end page — full prefix pages published
        F_SPAN_PAGES  pages the span backed at publish time
        F_TOK         the sampled continuation token at the prefix
                      boundary (part of the published prefix)
        F_LEASE       the cache lease's superblock count
        F_PARENT      parent node's record block offset (-1 = root
                      child) — the trie shape; excluded from the seal
                      because a split re-parents children in place
        F_START       the node's start page (the edge covers
                      [F_START, F_PAGES) of the prefix)
        F_FPRINT      token fingerprint (edge-first token low32 |
                      prefix-last token low16 << 32) — lets a recovered
                      record verify tokens cheaply before serving
        F_SEAL        16-bit checksum over the content fields (all but
                      F_NEXT / F_PARENT / F_SEAL), the device mirror of
                      the host record's word-2 seal: a record whose
                      fields tore mid-write fails the seal and
                      ``recovery.live_record_mask`` drops it

  * the chain head lives in a dedicated allocator root
    (``ServingEngine._index_root``), and the engine's ``ref_table`` adds
    one row per record — ``[next record, parent record, span head]`` —
    which is the record type's *filter function* in the vectorized
    recovery model: the mark pass traces records precisely, and
    ``span_ref_counts`` counts the record→span reference exactly like a
    lane root, so a published span survives a crash even when no lane
    roots it.

Durability ordering mirrors the host (``core.prefix_trie``): fields are
written (seal last) before the chain head swings, a split splices both
new halves before the old record clears, and removal unlinks before the
lease is released — a linked record always implies a live span.  After
recovery the engine prunes seal-mismatched and unrecoverable-orphan
records, walks the survivors (filtered through
``recovery.live_record_mask``), re-publishes each into the rebuilt
trie cache with zero re-prefill, and re-trims the record's
reconstructed full-extent lease to ``F_LEASE`` superblocks
(``trim_large``), freeing the decode-ahead tail immediately.
"""

from __future__ import annotations

import dataclasses

import numpy as np

(F_NEXT, F_SPAN, F_KEY, F_PAGES, F_SPAN_PAGES, F_TOK, F_LEASE, F_PARENT,
 F_START, F_FPRINT, F_SEAL) = range(11)
REC_FIELDS = 11

#: the seal covers exactly these fields, in this order (chain/shape
#: fields are rewritten in place by unlink/re-parent and must not stale
#: a live record's seal — same exclusion as host words 0 and 1)
_SEALED = (F_SPAN, F_KEY, F_PAGES, F_SPAN_PAGES, F_TOK, F_LEASE, F_START,
           F_FPRINT)

_M64 = 0xFFFFFFFFFFFFFFFF


def record_checksum(fields) -> int:
    """16-bit FNV fold over the sealed field values (host
    ``prefix_trie._record_checksum`` discipline: nonzero seed so an
    all-zero record never passes; -1 is never a valid seal, so the
    sidecar's fill value reads as torn)."""
    h = 0x9E3779B97F4A7C15
    for v in fields:
        h ^= int(v) & _M64
        h = (h * 0x100000001B3) & _M64
    return (h ^ (h >> 16) ^ (h >> 32) ^ (h >> 48)) & 0xFFFF


@dataclasses.dataclass(frozen=True)
class StoreRecord:
    """One decoded store record."""
    off: int                 # record block offset (the record id)
    key: int                 # 48-bit cumulative prefix hash
    span: int                # span head offset
    n_pages: int             # the node's end page (full prefix pages)
    span_pages: int          # pages the span backed at publish time
    next_tok: int            # sampled continuation at the prefix boundary
    lease_sbs: int           # the cache lease's superblock count
    parent: int = -1         # parent record offset (-1 = root child)
    start_page: int = 0      # edge covers [start_page, n_pages)
    fprint: int = 0          # token fingerprint (first low32 | last low16)


class PrefixStore:
    """Durable record table + chain heads for one device arena.

    ``words`` and ``heads`` are the durable state (they survive a crash
    like the decode state's block tables do); the engine mirrors every
    head into its own dedicated allocator root so the mark pass starts
    from all of them.  ``n_buckets > 1`` hash-buckets the chains by the
    48-bit key (device mirror of the host ``PrefixIndex`` bucketing):
    ``lookup``-style walks — ``remove``, the split predecessor search —
    touch O(records / n_buckets) rows, and each bucket's head swings
    independently.  The single-bucket default is the historical one-chain
    layout, bit-for-bit.
    """

    def __init__(self, num_slots: int, n_buckets: int = 1):
        if n_buckets < 1:
            raise ValueError(f"n_buckets {n_buckets} < 1")
        self.words = np.full((num_slots, REC_FIELDS), -1, np.int64)
        self.n_buckets = int(n_buckets)
        self.heads = [-1] * self.n_buckets

    def _bucket(self, key: int) -> int:
        return int(key) % self.n_buckets

    @property
    def head(self) -> int:
        """Bucket 0's chain head (the whole chain when unbucketed)."""
        return self.heads[0]

    @head.setter
    def head(self, rec: int) -> None:
        self.heads[0] = int(rec)

    # ---------------------------------------------------------------- reads
    def _decode(self, rec: int) -> StoreRecord:
        w = self.words[rec]
        return StoreRecord(
            off=rec, key=int(w[F_KEY]), span=int(w[F_SPAN]),
            n_pages=int(w[F_PAGES]), span_pages=int(w[F_SPAN_PAGES]),
            next_tok=int(w[F_TOK]), lease_sbs=int(w[F_LEASE]),
            parent=int(w[F_PARENT]), start_page=int(w[F_START]),
            fprint=int(w[F_FPRINT]))

    def _walk_bucket(self, b: int) -> list[StoreRecord]:
        out: list[StoreRecord] = []
        rec, seen = self.heads[b], set()
        while rec >= 0 and rec not in seen:
            seen.add(rec)
            out.append(self._decode(rec))
            rec = int(self.words[rec][F_NEXT])
        return out

    def walk(self) -> list[StoreRecord]:
        """Decode every chain, bucket 0 first (cycle-safe); torn records
        are still yielded — recovery prunes them by ``seal_ok`` mask."""
        return [r for b in range(self.n_buckets)
                for r in self._walk_bucket(b)]

    def seal_matches(self, rec_off: int) -> bool:
        """True iff the record's seal checksum matches its fields."""
        w = self.words[int(rec_off)]
        return int(w[F_SEAL]) == record_checksum(w[f] for f in _SEALED)

    def ref_rows(self) -> dict[int, list[int]]:
        """Per-record reference lists for the engine's ``ref_table`` —
        the record type's filter-function output: next record, parent
        record, and (only when the seal matches — a torn record must
        never re-lease its span) the span head."""
        rows: dict[int, list[int]] = {}
        for rec in self.walk():
            w = self.words[rec.off]
            tgts = [t for t in (int(w[F_NEXT]), int(w[F_PARENT])) if t >= 0]
            if rec.span >= 0 and self.seal_matches(rec.off):
                tgts.append(rec.span)
            rows[rec.off] = tgts
        return rows

    # --------------------------------------------------------------- writes
    def _fill(self, rec_off: int, nxt: int, p: dict) -> None:
        row = np.full(REC_FIELDS, -1, np.int64)
        row[F_NEXT] = nxt
        row[F_SPAN] = int(p["span"])
        row[F_KEY] = int(p["key"])
        row[F_PAGES] = int(p["n_pages"])
        row[F_SPAN_PAGES] = int(p["span_pages"])
        row[F_TOK] = int(p["next_tok"])
        row[F_LEASE] = int(p["lease_sbs"])
        row[F_PARENT] = int(p.get("parent", -1))
        row[F_START] = int(p.get("start_page", 0))
        row[F_FPRINT] = int(p.get("fprint", 0))
        row[F_SEAL] = record_checksum(row[f] for f in _SEALED)
        self.words[rec_off] = row

    def append(self, rec_off: int, *, key: int, span: int, n_pages: int,
               span_pages: int, next_tok: int, lease_sbs: int,
               parent: int = -1, start_page: int = 0,
               fprint: int = 0) -> None:
        """Link a freshly allocated record block at the chain head.

        Fields first (seal last within the row), head swing last — the
        durability ordering the host trie fences around; a crash between
        the two leaves the record unreachable and the sweep frees its
        block.
        """
        self.append_batch([dict(rec_off=rec_off, key=key, span=span,
                                n_pages=n_pages, span_pages=span_pages,
                                next_tok=next_tok, lease_sbs=lease_sbs,
                                parent=parent, start_page=start_page,
                                fprint=fprint)])

    def append_batch(self, payloads: list[dict]) -> None:
        """Group-commit append: link N freshly allocated record blocks as
        one chain segment with a single head swing.

        Device mirror of ``PrefixTrie._commit_new``: every record's
        fields are written first — the batch chained among itself, the
        last record pointing at the old head — and only then does
        ``head`` swing once to the first record.  A crash before the
        swing leaves the whole segment unreachable (the sweep frees all
        N blocks and their leases fall back to the roots); after it all
        N records are published.  Each payload dict carries the same
        keyword fields ``append`` takes.
        """
        if not payloads:
            return
        # partition by bucket; every record's fields land before any
        # head swings (the device analogue of the host's batched
        # ``set_roots`` swing after the shared seal fence)
        groups: dict[int, list[dict]] = {}
        for p in payloads:
            groups.setdefault(self._bucket(p["key"]), []).append(p)
        for b, grp in groups.items():
            offs = [int(p["rec_off"]) for p in grp]
            for i, p in enumerate(grp):
                nxt = offs[i + 1] if i + 1 < len(offs) else self.heads[b]
                self._fill(offs[i], nxt, p)
        for b, grp in groups.items():
            self.heads[b] = int(grp[0]["rec_off"])

    def split(self, old_off: int, m_payload: dict, x_payload: dict) -> None:
        """Replace record ``old_off`` with the pair M + X' in its chain
        position (device mirror of ``PrefixTrie.split``): M links to X',
        X' inherits the old record's next pointer, and ONE splice write
        (predecessor next-pointer or the head) swaps the pair in.  The
        old row clears only after the splice — the caller then releases
        the old record's lease and frees its block, mirroring the host's
        relink-before-free fence ordering.  Children of the old record
        re-parent via :meth:`reparent`.
        """
        old_off = int(old_off)
        m_off = int(m_payload["rec_off"])
        x_off = int(x_payload["rec_off"])
        ob = self._bucket(self.words[old_off][F_KEY])
        mb = self._bucket(m_payload["key"])
        xb = self._bucket(x_payload["key"])
        if ob == mb == xb:
            # all three share one chain (always true unbucketed): the
            # historical single-splice replacement in place
            old_next = int(self.words[old_off][F_NEXT])
            self._fill(x_off, old_next, x_payload)
            self._fill(m_off, x_off, m_payload)
            prev = self._pred_in_bucket(ob, old_off)
            if prev < 0:
                self.heads[ob] = m_off
            else:
                self.words[prev][F_NEXT] = m_off
            self.words[old_off] = -1
            return
        # the halves hash to other buckets: publish both at their own
        # bucket heads (fields before swing, X' before M so M fronts a
        # shared chain), then unlink the old record from its chain —
        # the predecessor search runs after the inserts, so a new head
        # in the old record's bucket is accounted for
        self._fill(x_off, self.heads[xb], x_payload)
        self.heads[xb] = x_off
        self._fill(m_off, self.heads[mb], m_payload)
        self.heads[mb] = m_off
        prev = self._pred_in_bucket(ob, old_off)
        old_next = int(self.words[old_off][F_NEXT])
        if prev < 0:
            self.heads[ob] = old_next
        else:
            self.words[prev][F_NEXT] = old_next
        self.words[old_off] = -1

    def _pred_in_bucket(self, b: int, target: int) -> int:
        """Chain predecessor of ``target`` in bucket ``b`` (-1 = head)."""
        prev, rec, seen = -1, self.heads[b], set()
        while rec >= 0 and rec not in seen and rec != target:
            seen.add(rec)
            prev, rec = rec, int(self.words[rec][F_NEXT])
        if rec != target:
            raise ValueError(f"split: record {target} not on the chain")
        return prev

    def reparent(self, child_off: int, new_parent: int) -> None:
        """Re-point a child record's parent field (unsealed, like host
        word 1) — used by split before the old record's block frees."""
        self.words[int(child_off)][F_PARENT] = int(new_parent)

    def remove(self, key: int) -> StoreRecord | None:
        """Unlink the record for ``key``; returns it (the caller releases
        the span lease and frees the record block *after* the unlink).
        Only the key's bucket chain is walked."""
        b = self._bucket(key)
        prev, rec, seen = -1, self.heads[b], set()
        while rec >= 0 and rec not in seen:
            seen.add(rec)
            w = self.words[rec]
            nxt = int(w[F_NEXT])
            if int(w[F_KEY]) == int(key):
                out = self._decode(rec)
                if prev < 0:
                    self.heads[b] = nxt
                else:
                    self.words[prev][F_NEXT] = nxt
                self.words[rec] = -1
                return out
            prev, rec = rec, nxt
        return None

    def prune(self, live_mask) -> list[StoreRecord]:
        """Drop records whose blocks the sweep did not mark (their root
        swing never became durable) or whose seal failed; returns the
        surviving records.

        ``live_mask`` is ``recovery.live_record_mask(cfg, marked,
        [r.off for r in walk()], seal_ok=...)`` — aligned with ``walk``
        order, i.e. bucket by bucket.  By construction an unreachable
        record can only sit at a chain head, but pruning the whole walk
        keeps a corrupt image from resurrecting stale entries.
        Surviving records whose parent was pruned keep their (now
        dangling) parent field; the engine's recoverability pass
        re-parents or drops them.
        """
        live = np.asarray(live_mask, bool)
        keep_all: list[StoreRecord] = []
        i = 0
        for b in range(self.n_buckets):
            recs = self._walk_bucket(b)
            flags = live[i:i + len(recs)]
            i += len(recs)
            keep = [r for r, ok in zip(recs, flags) if ok]
            for r, ok in zip(recs, flags):
                if not ok:
                    self.words[r.off] = -1
            self.heads[b] = keep[0].off if keep else -1
            for a, c in zip(keep, keep[1:]):
                self.words[a.off][F_NEXT] = c.off
            if keep:
                self.words[keep[-1].off][F_NEXT] = -1
            keep_all.extend(keep)
        return keep_all
