"""Continuous-batching serving engine over the Ralloc paged arena.

Port of the reference's ``serving/engine.py`` to one device, no mesh.
The engine owns the *mechanism*:

  * an ``AllocState`` (``core.alloc``) whose blocks are KV pages (1 block
    = 1 page, so the position-independent offsets the allocator returns
    *are* page ids);
  * the decode step of ``serving.decode`` (KV write and attention are the
    CUDA kernels on a CUDA device, their plain versions on the CPU);
  * per-lane transient state (``serving.lane_state``) and the shared
    prefix trie cache (``serving.prefix_trie_cache``).

Policy lives in ``serving.scheduler``.  Pages are allocated lazily: a
lane that crosses a page boundary gets a fresh page from one vectorized
``alloc`` over all lanes.  Group-commit publish: span-path publications
split into a transient half (``queue_publish``) and a durable half parked
until ``flush_publishes`` lands N records with ONE block allocation, one
chained ``PrefixStore.append_batch`` and ONE root swing.

Recoverability (paper §4.5 transplanted to inference): the persistent
allocator fields plus each session's block-table row survive a crash;
``crash_and_recover`` rebuilds every transient allocator structure with
the vectorized mark–sweep and the engine resumes mid-generation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import obs
from ..core import alloc as ta
from ..core import recovery as tr
from ..core.prefix_hash import fingerprint, hash_tokens, page_hashes
from ..device import resolve_device
from ..models.config import ModelConfig
from . import decode as dec
from .lane_state import LaneStates, Session, reset_lane
from .prefix_store import PrefixStore
from .prefix_trie_cache import CacheNode, PrefixTrieCache
from .scheduler import EngineBusy, PendingPublish

__all__ = ["ServingEngine", "Session", "EngineBusy", "PAGE_CLS"]

PAGE_CLS = 0

# Engine metrics (cached at import; see repro_torch.obs conventions).
_OBS_DEV_ALLOC = obs.counter("device.alloc_calls")
_OBS_DEV_ALLOC_LARGE = obs.counter("device.alloc_large_calls")
_OBS_DEV_TRIM = obs.counter("device.trim_calls")
_OBS_SPAN_RESERVE_FAIL = obs.counter("device.span_reserve_failed")
_OBS_PUB_QUEUED = obs.counter("engine.publish_queued")
_OBS_PUB_FLUSHES = obs.counter("engine.publish_flushes")
_OBS_PUB_DEPTH = obs.gauge("engine.publish_queue_depth")
_OBS_PUB_BATCH = obs.histogram("engine.publish_batch_size")


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of a device tensor (one device→host transfer)."""
    return t.detach().cpu().numpy()


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, lanes: int = 8,
                 max_seq: int = 512, pages_per_sb: int = 16,
                 prefix_buckets: int = 4, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.lanes = lanes
        self.max_seq = max_seq
        # arena sizing: a whole number of superblocks per lane, so that a
        # decode-ahead span (max_seq pages rounded UP to superblocks by
        # alloc_large) always fits for every lane at once
        per_lane_sbs = -(-(max_seq // cfg.page_size + 2) // pages_per_sb)
        num_sbs = lanes * per_lane_sbs + 1
        self.acfg = ta.ArenaConfig(num_sbs=num_sbs, sb_words=pages_per_sb,
                                   class_words=(1,),
                                   cache_cap=max(64, 2 * lanes))
        # root slots: one per lane (page tables) + one per hash bucket of
        # the durable prefix index's record chains — bucket b's chain head
        # mirrors into roots[lanes + b]
        self._index_root = lanes
        self.prefix_buckets = prefix_buckets
        self.astate = ta.init_state(self.acfg,
                                    max_roots=lanes + prefix_buckets,
                                    device=self.device)
        self._alloc = functools.partial(ta.alloc, cfg=self.acfg,
                                        cls=PAGE_CLS)
        self._free = functools.partial(ta.free, cfg=self.acfg, cls=PAGE_CLS)
        self._alloc_large = functools.partial(ta.alloc_large, cfg=self.acfg)
        self._free_large = functools.partial(ta.free_large, cfg=self.acfg)
        self._acquire_span = functools.partial(ta.acquire_span,
                                               cfg=self.acfg)
        self._trim_large = functools.partial(ta.trim_large, cfg=self.acfg)
        self.lane_states = LaneStates(lanes)
        self.dstate = dec.make_dstate(cfg, batch=lanes, max_seq=max_seq,
                                      pages_per_shard=int(num_sbs
                                                          * pages_per_sb) + 1,
                                      device=self.device)
        # prefix sharing: the trie cache keeps the flat exact-match dict
        # API and adds longest-prefix-match over published prompts
        self.prefix_cache = PrefixTrieCache(page=cfg.page_size)
        # durable prefix index: span-path entries additionally own one
        # record block reachable from roots[_index_root + b]
        self.prefix_store = PrefixStore(tr.num_slots(self.acfg),
                                        n_buckets=prefix_buckets)
        # group-commit queue of transiently-published span entries
        self._publish_queue: list[PendingPublish] = []
        self.publish_capacity = max(4, lanes)    # records per group commit

    def _mirror_index_roots(self) -> None:
        """Mirror every prefix-chain bucket head into its root slot
        (bucket b -> roots[lanes + b]); pure state update, no fence."""
        for b, head in enumerate(self.prefix_store.heads):
            self.astate = ta.set_root(self.astate, self._index_root + b,
                                      int(head))

    def _free_offsets(self, offsets) -> None:
        """Return arena blocks (page ids or record blocks) to the
        allocator in one vectorized ``free``."""
        offs = np.full((self.acfg.cache_cap,), -1, np.int32)
        offs[:len(offsets)] = offsets
        self.astate = self._free(
            state=self.astate,
            offs=torch.as_tensor(offs, device=self.device),
            mask=torch.as_tensor(offs >= 0, device=self.device))

    def _set_rows(self, name: str, lane: int, values) -> None:
        """Write the leading entries of one lane's row of a decode-state
        table (``block_table`` or ``kv_pos``)."""
        v = torch.as_tensor(np.asarray(values, np.int32),
                            device=self.device)
        self.dstate[name][lane, :v.shape[0]] = v

    # ------------------------------------------- component-state delegation
    @property
    def sessions(self) -> dict[int, Session]:
        return self.lane_states.sessions

    @property
    def free_lanes(self) -> list[int]:
        return self.lane_states.free_lanes

    @property
    def large_spans(self) -> dict[int, tuple[int, int]]:
        return self.lane_states.large_spans

    @property
    def shared_spans(self) -> dict[int, tuple[int, int, int]]:
        return self.lane_states.shared_spans

    @property
    def cur_tokens(self) -> np.ndarray:
        return self.lane_states.cur_tokens

    @property
    def _prefix_cache(self) -> dict[int, tuple]:
        return self.prefix_cache.entries

    @property
    def _prefix_tokens(self) -> dict[int, tuple]:
        return self.prefix_cache.tokens

    @property
    def page_refs(self) -> dict[int, int]:
        return self.prefix_cache.page_refs

    @page_refs.setter
    def page_refs(self, refs: dict[int, int]) -> None:
        self.prefix_cache.page_refs = refs

    # ------------------------------------------------------------- requests
    def add_request(self, prompt: list[int],
                    share_prefix: bool = False) -> int:
        lane = self.lane_states.acquire()
        if lane is None:
            raise EngineBusy(
                f"all {self.lanes} lanes are busy — queue admission through "
                f"serving.scheduler.Scheduler.submit")
        self.sessions[lane] = Session(lane=lane, tokens=list(prompt))
        # reset lane state (pos=0) and feed the prompt token by token
        self.dstate = reset_lane(self.dstate, lane)
        self.cur_tokens[lane] = prompt[0]
        # oversized prompt: reserve one contiguous multi-superblock span up
        # front, sized *decode-ahead* (every page the sequence can touch,
        # clamped to the page-table width).  A shared-prefix hit on a
        # published span skips the reservation and acquires that span.
        table_width = int(self.dstate["block_table"].shape[1])
        n_prompt_pages = min(-(-len(prompt) // self.cfg.page_size),
                             table_width)
        hit = self.prefix_cache.lookup(prompt) if share_prefix else None
        # longest-prefix match when the exact entry misses: a request
        # matching k whole pages leases only those pages' superblocks; a
        # mid-edge match first materializes the boundary as a trie split
        pnode, pk = None, 0
        if share_prefix and hit is None and self.cfg.attn_layers > 0:
            pnode, pk = self.prefix_cache.match_partial(prompt)
            if pnode is not None and pk * self.cfg.page_size >= len(prompt):
                pnode, pk = None, 0    # no suffix left: only the exact
                #                        entry may serve the whole prompt
            elif pnode is not None and pk < pnode.end_page:
                m = self._split_node(pnode, pk)
                if m is None:          # no record blocks: fall back to
                    #                    the deepest existing boundary
                    pnode, pk = self.prefix_cache.deepest_boundary(pnode, pk)
                else:
                    pnode = m
            if pnode is None:
                pk = 0
        if (self.cfg.attn_layers > 0 and hit is None and pnode is None
                and n_prompt_pages > self.acfg.sb_words):
            n_ahead = min(-(-self.max_seq // self.cfg.page_size), table_width)
            try:
                self._reserve_span(lane, max(n_prompt_pages, n_ahead))
            except MemoryError:
                # back out the admission completely: the lane must be
                # indistinguishable from never-admitted
                del self.sessions[lane]
                self.dstate = reset_lane(self.dstate, lane)
                self.cur_tokens[lane] = 0
                self.lane_states.release(lane)
                raise
        if hit is not None:
            if hit[0] == "span":
                # lease the published span's *prefix*: no copy, no fresh
                # reservation, no claim on the publisher's decode-ahead tail
                _, off, n_span, full, plen, kvp, next_tok, lease_sbs = hit
                self.astate, _ = self._acquire_span(
                    state=self.astate, off=off, n_sbs=lease_sbs)
                self.shared_spans[lane] = (off, full, lease_sbs)
                pages = off + np.arange(full, dtype=np.int32)
            else:
                _, pages, plen, kvp, next_tok = hit
                pages = np.asarray(pages, np.int32)
                for p in pages.tolist():
                    self.prefix_cache.add_page_ref(p)
            self._set_rows("block_table", lane, pages)
            self._set_rows("kv_pos", lane, kvp)
            self.dstate["pos"][lane] = plen
            # the model's continuation at the prompt boundary was sampled
            # by the publisher — it is part of the prefix
            self.sessions[lane].tokens = list(prompt) + [next_tok]
            self.cur_tokens[lane] = next_tok
        elif pnode is not None and pk > 0:
            # partial hit at a trie-node boundary: ONE acquire_span of the
            # node's lease makes this an ordinary shared-span lane; the
            # prompt suffix replays teacher-forced on its own pages
            off, lease_sbs = pnode.span, pnode.lease_sbs
            self.astate, _ = self._acquire_span(
                state=self.astate, off=off, n_sbs=lease_sbs)
            self.shared_spans[lane] = (off, pk, lease_sbs)
            self.lane_states.partial_hits[lane] = pk
            self._set_rows("block_table", lane,
                           off + np.arange(pk, dtype=np.int32))
            page = self.cfg.page_size
            self._set_rows("kv_pos", lane,
                           np.arange(pk * page,
                                     dtype=np.int32).reshape(pk, page))
            self.dstate["pos"][lane] = pk * page
            self.cur_tokens[lane] = prompt[pk * page]
        # the allocator root for this lane points at its page table
        self.astate = ta.set_root(self.astate, lane, lane)
        return lane

    def _reserve_span(self, lane: int, n_pages: int) -> None:
        """Back ``n_pages`` page-table slots of ``lane`` with one
        contiguous large-object span (page ids = span offsets).  Raises
        ``MemoryError`` with the lane untouched."""
        _OBS_DEV_ALLOC_LARGE.inc()
        self.astate, off = self._alloc_large(state=self.astate,
                                             nwords=n_pages)
        off = int(off)
        if off < 0:
            _OBS_SPAN_RESERVE_FAIL.inc()
            raise MemoryError(
                f"KV arena cannot reserve a contiguous {n_pages}-page span")
        self.large_spans[lane] = (off, n_pages)
        self._set_rows("block_table", lane,
                       off + np.arange(n_pages, dtype=np.int32))

    def _alloc_blocks(self, n: int) -> list[int]:
        """``n`` arena blocks (prefix-index record slots) in ONE
        vectorized alloc; -1 entries when the arena is full.  Record
        slots take ranks past the lane range, so they never collide with
        a lane's slot in the rank-indexed cache."""
        assert 0 < n <= self.publish_capacity
        need = np.zeros((self.lanes + self.publish_capacity,), bool)
        need[self.lanes:self.lanes + n] = True
        _OBS_DEV_ALLOC.inc()
        self.astate, offs = self._alloc(
            state=self.astate, need=torch.as_tensor(need, device=self.device))
        return [int(o) for o in _host(offs)[self.lanes:self.lanes + n]]

    def _split_node(self, node: CacheNode, k: int) -> CacheNode | None:
        """Materialize page boundary ``k`` inside in-process trie node
        ``node`` (X ``[s, e)`` → M ``[s, k)`` + X' ``[k, e)``, same
        span).  Returns M, or None when the arena cannot place the two
        record blocks a durable split needs.

        Ordering as the reference: both new records land, children
        re-parent, and only then does the old record's lease drop and its
        block free.  A node still parked in the publish queue has no
        record yet: its queue entry becomes two pending publishes."""
        if node.page_keys is None or node.tokens is None:
            return None                # recovered node: no page keys
        m_rec = x_rec = -1
        if node.rec_off >= 0:
            m_rec, x_rec = self._alloc_blocks(2)
            if m_rec < 0 or x_rec < 0:
                live = [o for o in (m_rec, x_rec) if o >= 0]
                if live:
                    self._free_offsets(live)
                return None
        m_lease = -(-k // self.acfg.sb_words)
        old_key, old_lease = node.key, node.lease_sbs
        old_rec = node.rec_off
        self.astate, _ = self._acquire_span(
            state=self.astate, off=node.span, n_sbs=m_lease)
        self.astate, _ = self._acquire_span(
            state=self.astate, off=node.span, n_sbs=node.lease_sbs)
        old_entry = self._prefix_cache.get(old_key)
        span_pages = old_entry[2] if old_entry is not None else node.end_page
        m = self.prefix_cache.split_transient(node, k)
        m.lease_sbs = m_lease
        m.rec_off = m_rec
        page = self.cfg.page_size
        kvp = np.arange(k * page, dtype=np.int32).reshape(k, page)
        self.prefix_cache.insert(
            m.key,
            ("span", node.span, span_pages, k, k * page, kvp, m.next_tok,
             m_lease),
            tokens=m.tokens)
        if old_rec >= 0:
            par = (self.prefix_cache.nodes[m.parent].rec_off
                   if m.parent >= 0 and m.parent in self.prefix_cache.nodes
                   else -1)
            self.prefix_store.split(
                old_rec,
                dict(rec_off=m_rec, key=m.key, span=node.span, n_pages=k,
                     span_pages=span_pages, next_tok=m.next_tok,
                     lease_sbs=m_lease, parent=par, start_page=m.start_page,
                     fprint=m.fprint),
                dict(rec_off=x_rec, key=node.key, span=node.span,
                     n_pages=node.end_page, span_pages=span_pages,
                     next_tok=node.next_tok, lease_sbs=node.lease_sbs,
                     parent=m_rec, start_page=k, fprint=node.fprint))
            node.rec_off = x_rec
            for ck in node.children:
                child = self.prefix_cache.nodes.get(ck)
                if child is not None and child.rec_off >= 0:
                    self.prefix_store.reparent(child.rec_off, x_rec)
            self._mirror_index_roots()
        else:
            # queued-only node: swap its parked publish for the pair (M
            # first — flush resolves X''s parent_key through it)
            for i, p in enumerate(self._publish_queue):
                if p.key == old_key:
                    self._publish_queue[i:i + 1] = [
                        PendingPublish(
                            key=m.key, span=node.span, n_pages=k,
                            span_pages=span_pages, next_tok=m.next_tok,
                            lease_sbs=m_lease, start_page=m.start_page,
                            parent_key=m.parent, fprint=m.fprint),
                        PendingPublish(
                            key=node.key, span=node.span,
                            n_pages=node.end_page, span_pages=span_pages,
                            next_tok=node.next_tok,
                            lease_sbs=node.lease_sbs, start_page=k,
                            parent_key=m.key, fprint=node.fprint)]
                    break
        # old record's lease drops last; its block frees after the relink
        self.astate = self._free_large(state=self.astate, off=node.span,
                                       n_sbs=old_lease)
        if old_rec >= 0:
            self._free_offsets([old_rec])
        return m

    # -------------------------------------------------------------- publish
    def queue_publish(self, lane: int) -> bool:
        """Register this lane's fully-processed prompt as a shared prefix.

        Only whole pages are shared.  A lane holding a span publishes the
        *span itself*: later matching requests acquire it instead of
        copying pages.  The transient half (cache entry + prefix lease)
        is immediate; the durable record append parks in the group-commit
        queue until ``flush_publishes``.  Page-path entries are
        transient-only and complete here.  Returns True when a new entry
        was created."""
        s = self.sessions[lane]
        pos = int(self.dstate["pos"][lane])
        page = self.cfg.page_size
        full = pos // page
        if full == 0:
            return False
        kv = _host(self.dstate["kv_pos"][lane])
        span = self.large_spans.get(lane)
        if span is None:
            shared = self.shared_spans.get(lane)  # sharers may re-publish
            if shared is not None:
                span = shared[:2]                 # (off, backed prefix pages)
        if span is not None:
            off, n_span = span
            # only span-backed pages can be published under the span
            # entry: clamp to the leading table slots the span backs
            bt_lane = _host(self.dstate["block_table"][lane])
            cover = 0
            while (cover < min(full, n_span, bt_lane.size)
                   and int(bt_lane[cover]) == off + cover):
                cover += 1
            full = min(full, cover)
            if full == 0:
                return False
            key = hash_tokens(s.tokens[:full * page])
            if self._prefix_cache.get(key) is not None:
                # already published (one cache reference per entry)
                return False
            # the cache holds one *prefix* lease — just the superblocks
            # the shared prompt pages occupy
            lease_sbs = -(-full // self.acfg.sb_words)
            self.astate, _ = self._acquire_span(
                state=self.astate, off=off, n_sbs=lease_sbs)
            # the prefix boundary token, NOT the lane's current token
            next_tok = int(s.tokens[full * page])
            self.prefix_cache.insert(
                key,
                ("span", off, n_span, full, full * page, kv[:full].copy(),
                 next_tok, lease_sbs),
                tokens=s.tokens[:full * page])
            # attach into the trie under the deepest existing boundary (a
            # mid-edge match materializes it as a split first)
            toks = tuple(int(t) for t in s.tokens[:full * page])
            parent, k = self.prefix_cache.match_partial(toks)
            if parent is not None and k < parent.end_page:
                m = self._split_node(parent, k)
                if m is None:
                    parent, k = self.prefix_cache.deepest_boundary(parent, k)
                else:
                    parent = m
            if parent is None:
                k = 0
            node = CacheNode(
                key=key, span=off, start_page=k, end_page=full,
                lease_sbs=lease_sbs, next_tok=next_tok,
                fprint=fingerprint(toks[k * page], toks[full * page - 1]),
                parent=(parent.key if parent is not None else -1),
                tokens=toks, page_keys=page_hashes(toks, page)[k:])
            self.prefix_cache.insert_node(node)
            # the durable index record parks in the group-commit queue
            self._publish_queue.append(PendingPublish(
                key=key, span=off, n_pages=full, span_pages=n_span,
                next_tok=next_tok, lease_sbs=lease_sbs,
                start_page=k, parent_key=node.parent, fprint=node.fprint))
            _OBS_PUB_QUEUED.inc()
            _OBS_PUB_DEPTH.set(len(self._publish_queue))
            return True
        bt = _host(self.dstate["block_table"][lane])
        if pos != full * page:
            # share only a fully-processed, page-aligned prompt
            return False
        pages = tuple(int(p) for p in bt[:full])
        for p in pages:
            # +1: the prefix cache itself holds a reference
            self.prefix_cache.add_page_ref(p)
        # page-path entries stay transient-only (they re-prefill after a
        # crash)
        pkey = hash_tokens(s.tokens[:full * page])
        self.prefix_cache.insert(
            pkey,
            ("pages", pages, full * page, kv[:full].copy(),
             int(self.cur_tokens[lane])),
            tokens=s.tokens[:full * page])
        return True

    def flush_publishes(self) -> int:
        """Land every parked publication durably: per batch of up to
        ``publish_capacity``, ONE vectorized record-block allocation, one
        chained ``append_batch`` and ONE root swing.  A full arena
        degrades safely (those publishes stay transient-only).  Returns
        the number of records appended."""
        appended = 0
        while self._publish_queue:
            batch = self._publish_queue[:self.publish_capacity]
            del self._publish_queue[:len(batch)]
            _OBS_PUB_FLUSHES.inc()
            _OBS_PUB_BATCH.observe(len(batch))
            recs = self._alloc_blocks(len(batch))
            rec_of: dict[int, int] = {}     # key -> record landed this batch
            payloads = []
            for rec, p in zip(recs, batch):
                if rec < 0:
                    continue
                # the parent landed earlier in this batch or owns a record
                # from a prior flush; a parent without one degrades to -1
                par = -1
                if p.parent_key >= 0:
                    par = rec_of.get(p.parent_key, -1)
                    if par < 0:
                        pn = self.prefix_cache.nodes.get(p.parent_key)
                        par = pn.rec_off if pn is not None else -1
                payloads.append(dict(
                    rec_off=rec, key=p.key, span=p.span,
                    n_pages=p.n_pages, span_pages=p.span_pages,
                    next_tok=p.next_tok, lease_sbs=p.lease_sbs,
                    parent=par, start_page=p.start_page, fprint=p.fprint))
                rec_of[p.key] = rec
            if payloads:
                self.prefix_store.append_batch(payloads)
                self._mirror_index_roots()
                for q in payloads:
                    self.prefix_cache.set_rec(q["key"], q["rec_off"])
                appended += len(payloads)
        _OBS_PUB_DEPTH.set(0)
        return appended

    @property
    def pending_publishes(self) -> int:
        return len(self._publish_queue)

    def publish_prefix(self, lane: int) -> None:
        """Immediate (ungrouped) publish: queue + flush in one call."""
        self.queue_publish(lane)
        self.flush_publishes()

    def drop_prefix_cache(self) -> None:
        """Release the cache's references; fully-unreferenced pages (and
        spans whose last holder was the cache) free."""
        for key, entry in list(self._prefix_cache.items()):
            if entry[0] == "span":
                # durable unlink FIRST, then the lease release, then the
                # record block frees
                rec = self.prefix_store.remove(key)
                if rec is not None:
                    self._mirror_index_roots()
                self.astate = self._free_large(state=self.astate,
                                               off=entry[1], n_sbs=entry[7])
                if rec is not None:
                    self._free_offsets([rec.off])
                continue
            stale = []
            for p in entry[1]:
                if p in self.page_refs:
                    self.page_refs[p] -= 1
                    if self.page_refs[p] <= 0:
                        stale.append(p)
                        del self.page_refs[p]
            if stale:
                self._free_offsets(stale)
        self.prefix_cache.clear()
        # parked appends for the just-dropped entries must never land
        self._publish_queue.clear()

    # ------------------------------------------------------------------ step
    def step(self) -> dict[int, int]:
        """One decode step for every active lane; returns emitted tokens."""
        active = self.lane_states.active()
        if not active.any():
            return {}
        # page-boundary lanes need a fresh page before the step — unless
        # the slot is already backed (prefix hit or a reserved span)
        pos = _host(self.dstate["pos"])
        page = self.cfg.page_size
        need = active & (pos % page == 0) & (self.cfg.attn_layers > 0)
        if need.any():
            # only boundary steps pay the block-table device→host copy
            bt_now = _host(self.dstate["block_table"])
            slot = np.clip(pos // page, 0, bt_now.shape[1] - 1)
            need &= bt_now[np.arange(self.lanes), slot] < 0
        if need.any():
            _OBS_DEV_ALLOC.inc()
            self.astate, offs = self._alloc(
                state=self.astate,
                need=torch.as_tensor(need, device=self.device))
            offs = _host(offs)
            bt = self.dstate["block_table"]
            for lane in np.nonzero(need)[0]:
                if offs[lane] < 0:
                    raise MemoryError("KV arena exhausted")
                bt[lane, pos[lane] // page] = int(offs[lane])

        self.dstate, toks = dec.decode_step(
            self.cfg, self.params, self.dstate,
            torch.as_tensor(self.cur_tokens, device=self.device))
        toks = _host(toks)
        out = {}
        for lane, s in list(self.sessions.items()):
            if s.done:
                continue
            t = int(pos[lane]) + 1
            if t < len(s.tokens):
                self.cur_tokens[lane] = s.tokens[t]       # teacher-forced
            else:
                s.tokens.append(int(toks[lane]))
                self.cur_tokens[lane] = int(toks[lane])
                out[lane] = int(toks[lane])
            if len(s.tokens) >= self.max_seq - 1:
                self.finish(lane)
        return out

    def finish(self, lane: int) -> None:
        """Evict a session: free its pages (shared pages only at ref 0,
        leased span ranges only when their last lease releases).  The
        lane's span records are popped before any release, so a second
        ``finish`` raises ``KeyError`` instead of releasing a span
        reallocated at the same offset."""
        s = self.sessions.pop(lane)
        s.done = True
        bt = _host(self.dstate["block_table"][lane])
        pages = bt[bt >= 0].astype(np.int32)
        span = self.large_spans.pop(lane, None)
        shared = self.shared_spans.pop(lane, None)
        self.lane_states.partial_hits.pop(lane, None)
        if span is not None:
            # the owner's full-extent lease drops; superblocks nobody else
            # leases (the decode-ahead tail) free now
            off, n_span = span
            self.astate = self._free_large(state=self.astate, off=off,
                                           n_sbs=-1)
            pages = pages[(pages < off) | (pages >= off + n_span)]
        elif shared is not None:
            # a sharer releases exactly the prefix range it leased
            off, n_backed, lease_sbs = shared
            self.astate = self._free_large(state=self.astate, off=off,
                                           n_sbs=lease_sbs)
            pages = pages[(pages < off) | (pages >= off + n_backed)]
        keep = []
        for p in pages.tolist():
            if p in self.page_refs:
                self.page_refs[p] -= 1
                if self.page_refs[p] > 0:
                    keep.append(p)          # still referenced elsewhere
                else:
                    del self.page_refs[p]
        if keep:
            pages = np.asarray([p for p in pages.tolist() if p not in keep],
                               np.int32)
        if pages.size:
            self._free_offsets(pages)
        self.dstate["block_table"][lane] = -1
        self.astate = ta.set_root(self.astate, lane, -1)
        self.lane_states.release(lane)

    # ------------------------------------------------------------- recovery
    def ref_table(self) -> np.ndarray:
        """Filter function output: each live session's root block (its
        first page) references the session's remaining pages; lanes
        sharing a span accumulate into the head page's row.  Prefix-index
        records add ``[next record, span head]`` rows, so the mark pass
        traces the chain and counts the record→span reference."""
        S = tr.num_slots(self.acfg)
        R = int(self.dstate["block_table"].shape[1])
        bt = _host(self.dstate["block_table"])
        rows: dict[int, list[int]] = {}
        for lane, s in self.sessions.items():
            if s.done:
                continue
            pages = bt[lane][bt[lane] >= 0]
            if pages.size == 0:
                continue
            rows.setdefault(int(pages[0]), []).extend(pages[1:].tolist())
        for rec_off, tgts in self.prefix_store.ref_rows().items():
            rows.setdefault(rec_off, []).extend(tgts)
        width = max([R] + [len(v) for v in rows.values()])
        refs = np.full((S, width), -1, np.int32)
        for root, tgts in rows.items():
            refs[root, :len(tgts)] = tgts
        return refs

    def crash_and_recover(self) -> dict:
        """Simulate losing all transient allocator state, then rebuild it
        from (persistent fields + session page tables + the durable
        prefix index) via vectorized GC.

        Per-page refcounts are recounted from live block tables; span
        leases come back inside ``recovery.recover`` as full-extent
        leases, one per root-reachable reference.  Surviving index
        records re-publish their entries (hittable without re-prefill)
        and re-trim their leases to the recorded superblock counts, as do
        live sharers, so the lease vector equals the pre-crash one."""
        phases: dict[str, dict] = {}

        def _phase(span):
            phases[span.name.split(".", 1)[1]] = {
                "seconds": span.seconds, "items": span.items}

        # torn / unrecoverable-orphan pre-prune, BEFORE the mark pass: a
        # torn record's span reference would otherwise phantom-lease the
        # span
        with obs.span("engine_recovery.prune_records") as sp:
            recs0 = self.prefix_store.walk()
            trie_pruned = 0
            if recs0:
                by_off = {r.off: r for r in recs0}
                keep = {r.off for r in recs0
                        if self.prefix_store.seal_matches(r.off)}
                # a node is servable iff kept records cover
                # [0, start_page) contiguously — fixpoint from boundary 0
                bounds, grew = {0}, True
                while grew:
                    grew = False
                    for off in keep:
                        r = by_off[off]
                        if r.start_page in bounds and r.n_pages not in bounds:
                            bounds.add(r.n_pages)
                            grew = True
                keep = {off for off in keep
                        if by_off[off].start_page in bounds}
                if len(keep) < len(recs0):
                    self.prefix_store.prune(
                        np.asarray([r.off in keep for r in recs0], bool))
                    trie_pruned = len(recs0) - len(keep)
                # survivors with dangling parents re-parent to ANY kept
                # record ending at their start page
                for r in self.prefix_store.walk():
                    if r.start_page == 0:
                        if r.parent != -1:
                            self.prefix_store.reparent(r.off, -1)
                        continue
                    if (r.parent in keep and r.parent != r.off
                            and by_off[r.parent].n_pages == r.start_page):
                        continue
                    cover = next((o for o in keep if o != r.off
                                  and by_off[o].n_pages == r.start_page),
                                 None)
                    self.prefix_store.reparent(
                        r.off, cover if cover is not None else -1)
            sp.add(trie_pruned)
        _phase(sp)
        with obs.span("engine_recovery.snapshot") as sp:
            persistent = ta.persistent_snapshot(self.astate)
            roots = np.full((self.lanes + self.prefix_buckets,), -1,
                            np.int32)
            bt = _host(self.dstate["block_table"])
            for lane, s in self.sessions.items():
                pages = bt[lane][bt[lane] >= 0]
                if pages.size:
                    roots[lane] = int(pages[0])
            for b, head in enumerate(self.prefix_store.heads):
                roots[self._index_root + b] = head
            persistent["roots"] = torch.as_tensor(roots, device=self.device)
            sp.add(int((roots >= 0).sum()))
        _phase(sp)
        with obs.span("engine_recovery.mark_sweep") as sp:
            new_state, marked = tr.recover(
                self.acfg, persistent,
                torch.as_tensor(self.ref_table(), device=self.device))
            live_before = ta.live_blocks(self.astate, self.acfg)[PAGE_CLS]
            self.astate = new_state
            live_after = ta.live_blocks(new_state, self.acfg)[PAGE_CLS]
            sp.add(int(marked.sum()))
        _phase(sp)
        # drop + recount the engine's transient sharing records.
        # Span-backed pages are excluded: their sharing is the span's
        # lease count (rebuilt inside recovery.recover)
        with obs.span("engine_recovery.recount_refs") as sp:
            self.prefix_cache.clear()
            # queued-but-unflushed appends die with the process too
            self._publish_queue.clear()
            spans = list(self.large_spans.values()) + \
                [(off, n_backed) for off, n_backed, _ in
                 self.shared_spans.values()]
            counts: dict[int, int] = {}
            for lane, s in self.sessions.items():
                if s.done:
                    continue
                for p in bt[lane][bt[lane] >= 0].tolist():
                    if any(off <= p < off + n for off, n in spans):
                        continue
                    counts[p] = counts.get(p, 0) + 1
            self.page_refs = {p: c for p, c in counts.items() if c > 1}
            sp.add(len(self.page_refs))
        _phase(sp)
        # re-publish surviving index records into the rebuilt cache and
        # re-trim each record's full-extent lease to its recorded count
        with obs.span("engine_recovery.republish") as sp:
            recs = self.prefix_store.walk()
            seal_ok = np.asarray([self.prefix_store.seal_matches(r.off)
                                  for r in recs] + [True], bool)
            live = tr.live_record_mask(
                self.acfg, marked,
                np.asarray([r.off for r in recs] + [-1], np.int32),
                seal_ok=seal_ok)
            survivors = self.prefix_store.prune(_host(live)[:len(recs)])
            page = self.cfg.page_size
            for rec in survivors:
                # a fully-processed prompt page p holds positions
                # p*page .. p*page+page-1
                kvp = np.arange(rec.n_pages * page,
                                dtype=np.int32).reshape(rec.n_pages, page)
                self._prefix_cache[rec.key] = (
                    "span", rec.span, rec.span_pages, rec.n_pages,
                    rec.n_pages * page, kvp, rec.next_tok, rec.lease_sbs)
                _OBS_DEV_TRIM.inc()
                self.astate, _ = self._trim_large(
                    state=self.astate, off=rec.span, n_keep=rec.lease_sbs,
                    n_held=-1)
            self._mirror_index_roots()
            # rebuild the trie shape from the surviving records
            # (token-less nodes match all-or-nothing)
            self.prefix_cache.rebuild_from_records(survivors)
            sp.add(len(survivors))
        _phase(sp)
        # live sharers' prefix leases were rebuilt full-extent too
        with obs.span("engine_recovery.retrim_shared") as sp:
            for lane, (off, _n_backed,
                       lease_sbs) in self.shared_spans.items():
                if lane in self.sessions and not self.sessions[lane].done:
                    _OBS_DEV_TRIM.inc()
                    self.astate, _ = self._trim_large(
                        state=self.astate, off=off, n_keep=lease_sbs,
                        n_held=-1)
                    sp.add(1)
        _phase(sp)
        return {"marked": int(marked.sum()),
                "live_before": live_before, "live_after": live_after,
                "index_records": len(survivors),
                "trie_pruned": trie_pruned,
                "phases": phases}
