"""Device Ralloc in PyTorch: the paper's allocator over a virtual arena.

Port of the reference's ``core/jax_alloc.py``.  The arena is a range of
block offsets; consumers (the paged KV cache, the prefix store) index
their own device tensors with the offsets handed out here, so every
reference is position independent.

Mapping from the paper, as in the reference:

  * superblocks with a single size class; descriptors are the
    structure-of-arrays ``sb_class`` / ``sb_free_count`` / ``free_bitmap``;
  * a *rank-indexed block cache* per size class stands in for thread
    caches: a vector of lanes pops at distinct ranks from a cumsum;
  * free/partial stacks are index stacks; PARTIAL→EMPTY superblocks
    retire on fetch;
  * only ``sb_class`` / ``sb_block_words`` / ``used_sbs`` / ``roots`` /
    ``dirty`` are persistent; everything else is rebuilt by
    ``core.recovery``.

Every state field is an ``int32`` (or ``bool``) tensor on one device and
every operation is a function ``(state, …) -> (state, …)`` that returns
fresh tensors.  Where the reference branches inside the trace
(``lax.cond`` / ``lax.switch`` / ``lax.while_loop``) the port branches
in Python on a scalar read back from the device.  Invalid lease ops are
masked no-ops, as on the reference device.  Index tensors stay ``int32``
and every gather index is clamped into range explicitly: JAX clamps
out-of-range gathers silently, torch raises.

Large objects take a contiguous run of superblocks (best fit over the
free-run index, else the watermark); the head is tagged ``LARGE_CLS``
with the object's word count in ``sb_block_words``, continuations
``LARGE_CONT``.  ``span_refs`` carries one transient lease count per
superblock.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..device import resolve_device

I32 = torch.int32

# ``sb_class`` sentinels.  -1 = uninitialized/free; the large markers sit
# below it so every small class keeps its index >= 0.
FREE_CLS = -1
LARGE_CLS = -2        # head superblock of a multi-superblock object
LARGE_CONT = -3       # continuation superblock of a large span

# Empty-bucket sentinel of the free-run index (``run_bucket_min``).
RUN_INF = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ArenaConfig:
    """Static geometry of one device arena."""
    num_sbs: int                       # superblocks in the arena
    sb_words: int                      # words per superblock
    class_words: tuple[int, ...]       # block size (words) per size class
    cache_cap: int = 1024              # rank-indexed block cache capacity
    expand_sbs: int = 8                # watermark expansion increment
    run_buckets: int = 16              # free-run index size buckets

    @property
    def num_classes(self) -> int:
        return len(self.class_words)

    def blocks_per_sb(self, cls: int) -> int:
        return self.sb_words // self.class_words[cls]

    @property
    def max_blocks(self) -> int:
        return max(self.blocks_per_sb(c) for c in range(self.num_classes))

    @property
    def total_words(self) -> int:
        return self.num_sbs * self.sb_words


class AllocState(NamedTuple):
    """Allocator state.  P = persistent fields, T = transient."""
    sb_class: torch.Tensor        # P i32[num_sbs]  (-1 = uninitialized)
    sb_block_words: torch.Tensor  # P i32[num_sbs]
    used_sbs: torch.Tensor        # P i32[]         watermark
    roots: torch.Tensor           # P i32[max_roots] block offsets, -1 = null
    dirty: torch.Tensor           # P i32[]
    free_bitmap: torch.Tensor     # T bool[num_sbs, max_blocks] True = free
    sb_free_count: torch.Tensor   # T i32[num_sbs]
    free_stack: torch.Tensor      # T i32[num_sbs + 1] (+1 dump slot)
    free_top: torch.Tensor        # T i32[]
    partial_stack: torch.Tensor   # T i32[num_classes, num_sbs + 1]
    partial_top: torch.Tensor     # T i32[num_classes]
    block_cache: torch.Tensor     # T i32[num_classes, cache_cap + 1]
    cache_top: torch.Tensor       # T i32[num_classes]
    alloc_count: torch.Tensor     # T i32[]  (statistics)
    free_count: torch.Tensor      # T i32[]
    span_refs: torch.Tensor       # T i32[num_sbs] per-superblock lease count
    run_len: torch.Tensor         # T i32[num_sbs] free-run length at each
    #                               run start, 0 elsewhere
    run_start: torch.Tensor       # T i32[num_sbs] start of each free
    #                               superblock's maximal run; -1 if not free
    run_bucket_min: torch.Tensor  # T i32[run_buckets] leftmost run start per
    #                               length bucket (exact 1..B-1, overflow
    #                               B-1 for >= B); RUN_INF = empty


def _ids(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=I32, device=device)


def _cumsum(mask: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(mask.to(I32), 0, dtype=I32)


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=I32)


def init_state(cfg: ArenaConfig, max_roots: int = 64,
               device=None) -> AllocState:
    dev = resolve_device(device)
    n, c = cfg.num_sbs, cfg.num_classes

    def full(shape, v):
        return torch.full(shape, v, dtype=I32, device=dev)

    return AllocState(
        sb_class=full((n,), -1),
        sb_block_words=full((n,), 0),
        used_sbs=full((), 0),
        roots=full((max_roots,), -1),
        dirty=full((), 1),
        free_bitmap=torch.zeros((n, cfg.max_blocks), dtype=torch.bool,
                                device=dev),
        sb_free_count=full((n,), 0),
        free_stack=full((n + 1,), -1),
        free_top=full((), 0),
        partial_stack=full((c, n + 1), -1),
        partial_top=full((c,), 0),
        block_cache=full((c, cfg.cache_cap + 1), -1),
        cache_top=full((c,), 0),
        alloc_count=full((), 0),
        free_count=full((), 0),
        span_refs=full((n,), 0),
        run_len=full((n,), 0),
        run_start=full((n,), -1),
        run_bucket_min=full((cfg.run_buckets,), RUN_INF),
    )


# ---------------------------------------------------------------------------
# free-run index (transient; a pure function of the persistent fields)
# ---------------------------------------------------------------------------
def free_run_table(free_mask: torch.Tensor, num_sbs: int):
    """Canonical run scan: ``(run_len, run_start)`` from a free mask.

    A suffix-min (``cummin`` over the flipped tensor) finds the first
    non-free index at or after every lane; a ``cummax`` propagates run
    starts to members."""
    free_mask = free_mask.to(torch.bool)
    ids = _ids(num_sbs, free_mask.device)
    nonfree_at = torch.where(free_mask, num_sbs, ids)
    next_nonfree = torch.flip(
        torch.cummin(torch.flip(nonfree_at, (0,)), 0).values, (0,))
    prev_free = torch.cat([torch.zeros((1,), dtype=torch.bool,
                                       device=free_mask.device),
                           free_mask[:-1]])
    is_start = free_mask & ~prev_free
    start_at = torch.cummax(torch.where(is_start, ids, -1), 0).values
    run_len = torch.where(is_start, next_nonfree - ids, 0)
    run_start = torch.where(free_mask, start_at, -1)
    return run_len, run_start


def _bucket_mins(cfg: ArenaConfig, run_len: torch.Tensor) -> torch.Tensor:
    """Leftmost run start per length bucket, in one scatter-min pass."""
    ids = _ids(cfg.num_sbs, run_len.device)
    is_start = run_len > 0
    b = torch.where(is_start, torch.clamp(run_len, max=cfg.run_buckets) - 1,
                    cfg.run_buckets)
    mins = torch.full((cfg.run_buckets + 1,), RUN_INF, dtype=I32,
                      device=run_len.device)
    mins.scatter_reduce_(0, b.long(), torch.where(is_start, ids, RUN_INF),
                         reduce="amin")
    return mins[:cfg.run_buckets]


def _runs_add_range(cfg: ArenaConfig, rl, rs, a, b, enable):
    """Run-table update: contiguous ``[a, b)`` joins the free set, merging
    with the run ending at ``a-1`` and the run starting at ``b``.
    ``enable`` false (or an empty range) is a no-op."""
    n = cfg.num_sbs
    ids = _ids(n, rl.device)
    a = _i32(a, rl.device)
    b = _i32(b, rl.device)
    left = torch.where(a > 0, rs[torch.clamp(a - 1, 0, n - 1)], -1)
    start = torch.where(left >= 0, left, a)
    right_len = torch.where(b < n, rl[torch.clamp(b, 0, n - 1)], 0)
    end = b + right_len
    member = (ids >= start) & (ids < end)
    rl2 = torch.where(ids == start, end - start, torch.where(member, 0, rl))
    rs2 = torch.where(member, start, rs)
    enable = torch.as_tensor(enable, device=rl.device) & (b > a)
    return torch.where(enable, rl2, rl), torch.where(enable, rs2, rs)


def _runs_remove_range(cfg: ArenaConfig, rl, rs, a, b, enable):
    """Run-table update: ``[a, b)`` leaves the free set.  The range lies
    inside one maximal run; it splits into ``[start, a)`` and
    ``[b, end)`` remainders, either possibly empty."""
    n = cfg.num_sbs
    ids = _ids(n, rl.device)
    a = _i32(a, rl.device)
    b = _i32(b, rl.device)
    start = torch.clamp(rs[torch.clamp(a, 0, n - 1)], min=0)
    end = start + rl[torch.clamp(start, 0, n - 1)]
    member = (ids >= start) & (ids < end)
    rl2 = torch.where(ids == start, a - start,
                      torch.where(ids == b, end - b,
                                  torch.where(member, 0, rl)))
    rs2 = torch.where((ids >= a) & (ids < b), -1,
                      torch.where((ids >= b) & (ids < end), b, rs))
    enable = torch.as_tensor(enable, device=rl.device) & (b > a)
    return torch.where(enable, rl2, rl), torch.where(enable, rs2, rs)


def _with_runs(st: AllocState, cfg: ArenaConfig, rl, rs) -> AllocState:
    """Install updated run tables and refresh the bucket heads."""
    return st._replace(run_len=rl, run_start=rs,
                       run_bucket_min=_bucket_mins(cfg, rl))


def _free_sbs(state: AllocState, cfg: ArenaConfig) -> torch.Tensor:
    ids = _ids(cfg.num_sbs, state.sb_class.device)
    return (state.sb_class == FREE_CLS) & (ids < state.used_sbs)


def rebuild_run_index(state: AllocState, cfg: ArenaConfig) -> AllocState:
    """From-scratch index rebuild off the persistent class records (used
    by recovery's sweep and by a cache spill that retires superblocks)."""
    rl, rs = free_run_table(_free_sbs(state, cfg), cfg.num_sbs)
    return _with_runs(state, cfg, rl, rs)


def scan_best_fit(state: AllocState, cfg: ArenaConfig, nsb):
    """Test oracle: full-scan best fit.  Returns ``(has_run, best_len,
    best_first)`` — smallest free run holding ``nsb`` superblocks,
    leftmost on ties; ``alloc_large`` must place identically."""
    run_len, _ = free_run_table(_free_sbs(state, cfg), cfg.num_sbs)
    cand = (run_len > 0) & (run_len >= nsb)
    has_run = cand.any()
    best_len = torch.where(cand, run_len, cfg.num_sbs + 1).min()
    best_first = (cand & (run_len == best_len)).to(I32).argmax().to(I32)
    return has_run, best_len, best_first


# ---------------------------------------------------------------------------
# internal helpers
# ---------------------------------------------------------------------------
def _push_many(stack, top, ids, mask):
    """Vectorized multi-push: stack[top + rank(i)] = ids[i] for masked i.
    Unmasked lanes write the reserved dump slot, which is reset after."""
    ranks = _cumsum(mask) - 1
    dump = stack.shape[-1] - 1
    idx = torch.where(mask, top + ranks, dump)
    stack = stack.clone()
    stack[idx] = torch.where(mask, ids, stack[dump])
    stack[dump] = -1
    return stack, top + _count(mask)


def _push_one(stack, top, sb):
    """Push the single id ``sb`` (the reference's one-lane ``_push_many``)."""
    stack = stack.clone()
    stack[top] = sb
    stack[-1] = -1
    return stack, top + 1


def _expand(st: AllocState, cfg: ArenaConfig):
    """Advance the used watermark; push new superblocks onto the free
    stack.  Returns ``(state, grew)``."""
    dev = st.sb_class.device
    k = torch.clamp(cfg.num_sbs - st.used_sbs, max=cfg.expand_sbs)
    ids = st.used_sbs + _ids(cfg.num_sbs, dev)
    mask = _ids(cfg.num_sbs, dev) < k
    fs, ft = _push_many(st.free_stack, st.free_top,
                        torch.where(mask, ids, -1), mask)
    rl, rs = _runs_add_range(cfg, st.run_len, st.run_start,
                             st.used_sbs, st.used_sbs + k, k > 0)
    st = _with_runs(st, cfg, rl, rs)
    return st._replace(free_stack=fs, free_top=ft,
                       used_sbs=st.used_sbs + k), bool(k > 0)


def _harvest(st: AllocState, cfg: ArenaConfig, cls: int, sb: int):
    """Move up to (cache capacity − top) free blocks of ``sb`` into the
    cache; leftover free blocks send the superblock back to the partial
    stack (LRMalloc's "reserve all available blocks with one CAS")."""
    dev = st.sb_class.device
    bw = cfg.class_words[cls]
    total = cfg.blocks_per_sb(cls)
    room = cfg.cache_cap - st.cache_top[cls]
    blk = _ids(cfg.max_blocks, dev)
    bits = st.free_bitmap[sb] & (blk < total)
    order = _cumsum(bits)                        # 1-based among set bits
    sel = bits & (order <= room)
    t = _count(sel)
    offs = sb * cfg.sb_words + blk * bw
    cache = st.block_cache.clone()
    idx = torch.where(sel, st.cache_top[cls] + order - 1, cfg.cache_cap)
    cache[cls, idx] = torch.where(sel, offs, -1)
    bitmap = st.free_bitmap.clone()
    bitmap[sb] = st.free_bitmap[sb] & ~sel
    count = st.sb_free_count[sb] - t
    cache_top = st.cache_top.clone()
    cache_top[cls] += t
    free_count = st.sb_free_count.clone()
    free_count[sb] = count
    st = st._replace(block_cache=cache, cache_top=cache_top,
                     free_bitmap=bitmap, sb_free_count=free_count)
    if bool(count > 0):
        ps, pt = _push_one(st.partial_stack[cls], st.partial_top[cls], sb)
        pstack = st.partial_stack.clone()
        pstack[cls] = ps
        ptop = st.partial_top.clone()
        ptop[cls] = pt
        st = st._replace(partial_stack=pstack, partial_top=ptop)
    return st


def _refill_step(st: AllocState, cfg: ArenaConfig, cls: int):
    """One slow-path refill attempt: partial → free → expand (paper
    §4.4).  Returns ``(state, progressed)``."""
    dev = st.sb_class.device
    total = cfg.blocks_per_sb(cls)
    if bool(st.partial_top[cls] > 0):
        top = st.partial_top[cls]
        sb = int(st.partial_stack[cls, top - 1])
        ptop = st.partial_top.clone()
        ptop[cls] -= 1
        st = st._replace(partial_top=ptop)
        if bool(st.sb_free_count[sb] >= total):
            # retire-on-fetch: a PARTIAL→EMPTY superblock goes free
            fs, ft = _push_one(st.free_stack, st.free_top, sb)
            rl, rs = _runs_add_range(cfg, st.run_len, st.run_start,
                                     sb, sb + 1, True)
            st = _with_runs(st, cfg, rl, rs)
            sb_class = st.sb_class.clone()
            sb_class[sb] = -1
            return st._replace(free_stack=fs, free_top=ft,
                               sb_class=sb_class), True
        return _harvest(st, cfg, cls, sb), True
    if bool(st.free_top > 0):
        sb = int(st.free_stack[st.free_top - 1])
        st = st._replace(free_top=st.free_top - 1)
        rl, rs = _runs_remove_range(cfg, st.run_len, st.run_start,
                                    sb, sb + 1, True)
        st = _with_runs(st, cfg, rl, rs)
        # (re)initialize the superblock for this class — the persistent
        # fields (class, block size) change here and only here
        sb_class = st.sb_class.clone()
        sb_class[sb] = cls
        sbw = st.sb_block_words.clone()
        sbw[sb] = cfg.class_words[cls]
        bitmap = st.free_bitmap.clone()
        bitmap[sb] = _ids(cfg.max_blocks, dev) < total
        counts = st.sb_free_count.clone()
        counts[sb] = total
        st = st._replace(sb_class=sb_class, sb_block_words=sbw,
                         free_bitmap=bitmap, sb_free_count=counts)
        return _harvest(st, cfg, cls, sb), True
    return _expand(st, cfg)


def alloc(state: AllocState, cfg: ArenaConfig, cls: int, need):
    """Vectorized allocation: one block per lane where ``need`` is set.

    Returns ``(state, offsets i32[L])`` with -1 for unserved lanes
    (``need`` false or out of memory).  The fast path (a cache hit for
    every lane) touches only the cache row and its top."""
    need = torch.as_tensor(need, device=state.sb_class.device).to(torch.bool)
    m = int(_count(need))
    progress = True
    while progress and int(state.cache_top[cls]) < m:
        state, progress = _refill_step(state, cfg, cls)
    top = state.cache_top[cls]
    avail = torch.clamp(top, max=m)
    ranks = _cumsum(need) - 1
    served = need & (ranks < avail)
    pos = torch.clamp(top - 1 - ranks, min=0)
    offs = torch.where(served, state.block_cache[cls, pos], -1)
    cache_top = state.cache_top.clone()
    cache_top[cls] -= avail
    state = state._replace(cache_top=cache_top,
                           alloc_count=state.alloc_count + avail)
    return state, offs


def _spill(st: AllocState, cfg: ArenaConfig, cls: int) -> AllocState:
    """Flush the whole class cache back to superblock bitmaps (paper
    §4.4: an over-full cache is transferred in its entirety)."""
    dev = st.sb_class.device
    bw = cfg.class_words[cls]
    total = cfg.blocks_per_sb(cls)
    cap = cfg.cache_cap + 1                       # row includes the dump slot
    row = st.block_cache[cls]
    live = _ids(cap, dev) < st.cache_top[cls]
    sb = torch.where(live, row // cfg.sb_words, cfg.num_sbs)   # dump row
    blk = torch.where(live, (row % cfg.sb_words) // bw, 0)
    old_count = st.sb_free_count
    bitmap = torch.cat([st.free_bitmap,
                        torch.zeros((1, cfg.max_blocks), dtype=torch.bool,
                                    device=dev)])
    bitmap[sb, blk] = True
    delta = torch.zeros((cfg.num_sbs + 1,), dtype=I32, device=dev)
    delta.index_add_(0, sb, torch.ones_like(sb))
    new_count = old_count + delta[:-1]
    cache_top = st.cache_top.clone()
    cache_top[cls] = 0
    st = st._replace(free_bitmap=bitmap[:-1], sb_free_count=new_count,
                     cache_top=cache_top)
    touched = delta[:-1] > 0
    was_full = touched & (old_count == 0) & (st.sb_class == cls)
    to_free = was_full & (new_count >= total)
    to_partial = was_full & (new_count < total)
    ids = _ids(cfg.num_sbs, dev)
    ps, pt = _push_many(st.partial_stack[cls], st.partial_top[cls],
                        ids, to_partial)
    fs, ft = _push_many(st.free_stack, st.free_top, ids, to_free)
    pstack = st.partial_stack.clone()
    pstack[cls] = ps
    ptop = st.partial_top.clone()
    ptop[cls] = pt
    # FULL→EMPTY superblocks retire immediately (class reset)
    st = st._replace(partial_stack=pstack, partial_top=ptop,
                     free_stack=fs, free_top=ft,
                     sb_class=torch.where(to_free, -1, st.sb_class))
    # retired superblocks are an arbitrary scatter — rebuild the run index
    if bool(to_free.any()):
        st = rebuild_run_index(st, cfg)
    return st


def free(state: AllocState, cfg: ArenaConfig, cls: int, offs, mask):
    """Vectorized deallocation of one block per masked lane.  Lanes whose
    superblock is not initialized for ``cls`` are masked out (a double
    free of a large object, or a small free into a span, is a no-op)."""
    dev = state.sb_class.device
    offs = _i32(offs, dev)
    mask = torch.as_tensor(mask, device=dev).to(torch.bool) & (offs >= 0)
    sb = torch.clamp(offs // cfg.sb_words, 0, cfg.num_sbs - 1)
    mask = mask & (state.sb_class[sb] == cls)
    k = _count(mask)
    if int(state.cache_top[cls] + k) > cfg.cache_cap:
        state = _spill(state, cfg, cls)
    ranks = _cumsum(mask) - 1
    idx = torch.where(mask, state.cache_top[cls] + ranks, cfg.cache_cap)
    cache = state.block_cache.clone()
    cache[cls, idx] = torch.where(mask, offs, -1)
    cache_top = state.cache_top.clone()
    cache_top[cls] += k
    return state._replace(block_cache=cache, cache_top=cache_top,
                          free_count=state.free_count + k)


def span_sbs(cfg: ArenaConfig, nwords):
    """Superblocks needed for a large object of ``nwords`` words."""
    return (nwords + cfg.sb_words - 1) // cfg.sb_words


def alloc_large(state: AllocState, cfg: ArenaConfig, nwords):
    """Contiguous multi-superblock allocation (paper §4.4 large path).

    Best fit over freed contiguous runs — the smallest run holding the
    request, leftmost on ties, the host allocator's rule — read from the
    free-run index: the smallest eligible exact-length bucket is the best
    fit; an overflow hit or an oversized request falls back to one
    masked min-reduce over ``run_len``.  With no fitting run the span
    takes fresh watermark.  Returns ``(state, off)`` with the span's
    word offset, or -1 when neither placement fits."""
    dev = state.sb_class.device
    nwords = _i32(nwords, dev)
    nsb = span_sbs(cfg, nwords)
    ids = _ids(cfg.num_sbs, dev)
    nfit = cfg.num_sbs + 1

    bidx = _ids(cfg.run_buckets - 1, dev)
    exact = (bidx + 1 >= nsb) & \
        (state.run_bucket_min[:cfg.run_buckets - 1] < RUN_INF)
    best_exact_len = torch.where(exact, bidx + 1, nfit).min()
    if bool(best_exact_len <= cfg.num_sbs):
        best_len = best_exact_len
        best_first = state.run_bucket_min[
            torch.clamp(best_exact_len - 1, 0, cfg.run_buckets - 1)]
    else:
        fit = state.run_len >= nsb
        best_len = torch.where(fit, state.run_len, nfit).min()
        best_first = torch.where(fit & (state.run_len == best_len), ids,
                                 cfg.num_sbs).min()
    has_run = best_len <= cfg.num_sbs
    wm_ok = state.used_sbs + nsb <= cfg.num_sbs
    ok = (nwords > 0) & (has_run | wm_ok)
    first = torch.where(has_run, best_first, state.used_sbs)
    span = ok & (ids >= first) & (ids < first + nsb)
    head = span & (ids == first)
    cont = span & ~head
    # persistent records: class sentinel on every member, size on the head
    sb_class = torch.where(head, LARGE_CLS,
                           torch.where(cont, LARGE_CONT, state.sb_class))
    sb_block_words = torch.where(head, nwords,
                                 torch.where(cont, 0, state.sb_block_words))
    # claimed superblocks leave the free stack (order-preserving compact)
    stack = state.free_stack
    live = _ids(stack.shape[0], dev) < state.free_top
    claimed = ok & has_run & (stack >= first) & (stack < first + nsb)
    keep = live & ~claimed
    pos = _cumsum(keep) - 1
    dump = stack.shape[0] - 1
    new_stack = torch.full_like(stack, -1)
    new_stack[torch.where(keep, pos, dump)] = torch.where(keep, stack, -1)
    new_stack[dump] = -1
    rl, rs = _runs_remove_range(cfg, state.run_len, state.run_start,
                                first, first + nsb, ok & has_run)
    state = _with_runs(state, cfg, rl, rs)
    state = state._replace(
        sb_class=sb_class,
        sb_block_words=sb_block_words,
        # one full-extent owner lease: count 1 on every member superblock
        span_refs=torch.where(span, 1, state.span_refs),
        free_stack=new_stack,
        free_top=_count(keep),
        used_sbs=torch.where(ok & ~has_run, state.used_sbs + nsb,
                             state.used_sbs),
        alloc_count=state.alloc_count + ok.to(I32))
    return state, torch.where(ok, first * cfg.sb_words, -1)


def acquire_span(state: AllocState, cfg: ArenaConfig, off, n_sbs=-1):
    """Lease the ``n_sbs``-superblock prefix of the live span headed at
    ``off`` (``n_sbs < 0`` = the whole extent): one masked add over the
    lease vector.  Returns ``(state, ok)``; an invalid/dead/non-head
    ``off`` or an empty range is a masked no-op."""
    dev = state.sb_class.device
    off = _i32(off, dev)
    n_sbs = _i32(n_sbs, dev)
    sb = torch.clamp(off // cfg.sb_words, 0, cfg.num_sbs - 1)
    valid = (off >= 0) & (off % cfg.sb_words == 0) & \
        (state.sb_class[sb] == LARGE_CLS)
    ext = span_sbs(cfg, state.sb_block_words[sb])
    n = torch.where(n_sbs < 0, ext, torch.minimum(n_sbs, ext))
    valid = valid & (n >= 1)
    ids = _ids(cfg.num_sbs, dev)
    rng = valid & (ids >= sb) & (ids < sb + n)
    return state._replace(span_refs=state.span_refs + rng.to(I32)), valid


def _lease_release(state: AllocState, cfg: ArenaConfig, sb, a, b, valid):
    """Drop one lease on members ``[sb+a, sb+b)`` of the span headed at
    ``sb``; free whatever the decrement leaves unleased.

      * a range not fully leased invalidates the whole op (masked no-op);
      * the head reaching zero frees the whole remaining span;
      * otherwise the zero-count tail suffix frees and the head's
        ``sb_block_words`` shrinks to the kept prefix."""
    dev = state.sb_class.device
    ids = _ids(cfg.num_sbs, dev)
    ext = span_sbs(cfg, state.sb_block_words[sb])
    member = (ids >= sb) & (ids < sb + ext)
    rng = member & (ids >= sb + a) & (ids < sb + b)
    valid = valid & (b > a)
    valid = valid & ~(rng & (state.span_refs <= 0)).any()
    dec = valid & rng
    refs = state.span_refs - dec.to(I32)
    head_zero = valid & (refs[sb] <= 0)
    last_live = torch.where(member & (refs > 0), ids, -1).max()
    new_ext = torch.clamp(last_live + 1 - sb, min=0)
    freed = valid & member & (head_zero | (ids >= sb + new_ext))
    fs, ft = _push_many(state.free_stack, state.free_top, ids, freed)
    trimmed = valid & ~head_zero & (new_ext < ext)
    sbw = torch.where(freed, 0, state.sb_block_words)
    sbw[sb] = torch.where(trimmed,
                          torch.minimum(sbw[sb], new_ext * cfg.sb_words),
                          sbw[sb])
    # the freed range is contiguous: splice it into the free-run index
    fa = torch.where(freed, ids, cfg.num_sbs).min()
    fb = torch.where(freed, ids + 1, 0).max()
    rl, rs = _runs_add_range(cfg, state.run_len, state.run_start,
                             fa, fb, freed.any())
    state = _with_runs(state, cfg, rl, rs)
    return state._replace(
        sb_class=torch.where(freed, FREE_CLS, state.sb_class),
        sb_block_words=sbw,
        span_refs=torch.where(freed, 0, refs),
        free_stack=fs, free_top=ft), valid


def free_large(state: AllocState, cfg: ArenaConfig, off, n_sbs=-1):
    """Release one lease on the ``n_sbs``-superblock prefix of a large
    span (``n_sbs < 0`` = the whole extent); ranges nobody leases any
    more free.  A non-head/dead ``off`` or a release of a range not
    fully leased is a masked no-op (the host raises)."""
    dev = state.sb_class.device
    off = _i32(off, dev)
    n_sbs = _i32(n_sbs, dev)
    sb = torch.clamp(off // cfg.sb_words, 0, cfg.num_sbs - 1)
    valid = (off >= 0) & (state.sb_class[sb] == LARGE_CLS)
    ext = span_sbs(cfg, state.sb_block_words[sb])
    b = torch.where(n_sbs < 0, ext, torch.minimum(n_sbs, ext))
    state, valid = _lease_release(state, cfg, sb, _i32(0, dev), b, valid)
    return state._replace(free_count=state.free_count + valid.to(I32))


def trim_large(state: AllocState, cfg: ArenaConfig, off, n_keep, n_held=-1):
    """Shrink the caller's lease on the span headed at ``off`` from
    ``n_held`` superblocks (``< 0`` = the whole extent) to the
    ``n_keep``-superblock prefix; the suffix nobody else leases frees.
    Invalid targets are masked no-ops.  Returns ``(state, ok)``."""
    dev = state.sb_class.device
    off = _i32(off, dev)
    n_keep = _i32(n_keep, dev)
    n_held = _i32(n_held, dev)
    sb = torch.clamp(off // cfg.sb_words, 0, cfg.num_sbs - 1)
    valid = (off >= 0) & (off % cfg.sb_words == 0) & \
        (state.sb_class[sb] == LARGE_CLS)
    ext = span_sbs(cfg, state.sb_block_words[sb])
    b = torch.where(n_held < 0, ext, torch.minimum(n_held, ext))
    valid = valid & (n_keep >= 1) & (n_keep < b)
    return _lease_release(state, cfg, sb, n_keep, b, valid)


def set_root(state: AllocState, i: int, off) -> AllocState:
    roots = state.roots.clone()
    roots[i] = _i32(off, roots.device)
    return state._replace(roots=roots)


# ---------------------------------------------------------------------------
# persistence boundary
# ---------------------------------------------------------------------------
PERSISTENT_FIELDS = ("sb_class", "sb_block_words", "used_sbs", "roots",
                     "dirty")


def persistent_snapshot(state: AllocState) -> dict:
    """The only fields that must reach durable storage."""
    return {f: getattr(state, f) for f in PERSISTENT_FIELDS}


def free_runs(state: AllocState, cfg: ArenaConfig) -> list[tuple[int, int]]:
    """Debug/test helper: maximal contiguous runs ``(start, length)`` of
    free superblocks below the watermark."""
    run_len = free_run_table(_free_sbs(state, cfg), cfg.num_sbs)[0].cpu()
    starts = torch.nonzero(run_len > 0).flatten().tolist()
    return [(int(s), int(run_len[s])) for s in starts]


def live_blocks(state: AllocState, cfg: ArenaConfig) -> dict:
    """Debug/test helper: per-class count of blocks not free anywhere;
    ``"large"`` counts live multi-superblock objects."""
    out = {}
    in_use = _ids(cfg.num_sbs, state.sb_class.device) < state.used_sbs
    for c in range(cfg.num_classes):
        total = cfg.blocks_per_sb(c)
        sbs = (state.sb_class == c) & in_use
        in_sb = torch.where(sbs, total - state.sb_free_count, 0).sum()
        out[c] = int(in_sb - state.cache_top[c])
    out["large"] = int(((state.sb_class == LARGE_CLS) & in_use).sum())
    return out
