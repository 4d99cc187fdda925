"""Vectorized GC recovery for the device allocator.

Port of the reference's ``core/jax_recovery.py``.  Paper §4.5 recovers a
heap by tracing reachable blocks from the persistent roots, then sweeping
the superblocks to rebuild every transient structure; here both are
data-parallel:

  * **mark** — a fixed point: each step scatters every marked block's
    outgoing references (a *reference table* produced by the consumer's
    filter functions) into the mark bitmap, until nothing changes;
  * **sweep** — per-superblock free bitmaps from the marks, counts from
    popcounts, free/partial stacks from mask compaction (a sort).

Blocks are identified by *slots* — offset // min(class_words) — so one
mark bitmap covers all classes.
"""

from __future__ import annotations

import torch

from .alloc import (FREE_CLS, I32, LARGE_CLS, LARGE_CONT, AllocState,
                    ArenaConfig, _ids, init_state, rebuild_run_index,
                    span_sbs)

_I32_MAX = 2**31 - 1


def slot_of(cfg: ArenaConfig, off):
    return off // min(cfg.class_words)


def num_slots(cfg: ArenaConfig) -> int:
    return cfg.total_words // min(cfg.class_words)


def _targets(cfg: ArenaConfig, ref_table: torch.Tensor) -> torch.Tensor:
    S = num_slots(cfg)
    return torch.where(ref_table >= 0, slot_of(cfg, ref_table), S)


def mark(cfg: ArenaConfig, roots, ref_table, max_iter: int = 64):
    """Fixed-point reachability over the block-reference graph.

    roots:     i32[max_roots] block offsets (-1 = null)
    ref_table: i32[num_slots, R] outgoing references (-1 null)
    Returns bool[num_slots].  Like the reference's ``while_loop`` the
    iteration runs to the fixed point; ``max_iter`` is kept for the
    reference's signature and does not bound it."""
    S = num_slots(cfg)
    dev = roots.device
    root_slots = torch.where(roots >= 0, slot_of(cfg, roots), S)
    marked = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
    marked[root_slots] = True
    marked[S] = False
    tgt = _targets(cfg, ref_table)
    while True:
        contrib = marked[:S, None] & (tgt < S)
        new = torch.zeros((S + 1,), dtype=torch.bool, device=dev)
        new[torch.where(contrib, tgt, S)] = True
        new[S] = False
        merged = marked | new
        changed = bool((merged != marked).any())
        marked = merged
        if not changed:
            return marked[:S]


def span_ref_counts(cfg: ArenaConfig, roots, ref_table, marked):
    """Root-reachable references per slot: (# roots naming it) + (#
    reference-table entries of *marked* sources naming it).  For a live
    span head this is its transient lease count."""
    S = num_slots(cfg)
    dev = roots.device
    root_slots = torch.where(roots >= 0, slot_of(cfg, roots), S)
    counts = torch.zeros((S + 1,), dtype=I32, device=dev)
    counts.index_add_(0, root_slots, torch.ones_like(root_slots))
    counts[S] = 0
    tgt = _targets(cfg, ref_table)
    contrib = marked[:, None] & (tgt < S)
    counts.index_add_(0, torch.where(contrib, tgt, S).flatten(),
                      contrib.to(I32).flatten())
    return counts[:S]


def _compact(pred: torch.Tensor, n_plus_1: int):
    """Mask compaction: ids where ``pred``, ascending, padded with -1."""
    n = pred.shape[0]
    ids = _ids(n, pred.device)
    order = torch.sort(torch.where(pred, ids, _I32_MAX)).values
    cnt = pred.sum(dtype=I32)
    vals = torch.where(ids < cnt, order, -1)
    out = torch.full((n_plus_1,), -1, dtype=I32, device=pred.device)
    out[:n] = vals
    return out, cnt


def sweep(cfg: ArenaConfig, persistent: dict, marked,
          ref_counts=None) -> AllocState:
    """Rebuild every transient structure from (persistent fields, marks).

    Dead or orphaned large spans sweep back to ``FREE_CLS`` and onto the
    free stack.  ``ref_counts`` (from ``span_ref_counts``) rebuilds the
    lease vector: each live head's ``max(count, 1)`` is broadcast over the
    span's members (lease lengths were transient, so every reference
    becomes a full-extent lease)."""
    n = cfg.num_sbs
    sb_class = persistent["sb_class"]
    dev = sb_class.device
    sb_ids = _ids(n, dev)
    used = persistent["used_sbs"]
    in_use = sb_ids < used
    minw = min(cfg.class_words)

    free_bitmap = torch.zeros((n, cfg.max_blocks), dtype=torch.bool,
                              device=dev)
    counts = torch.zeros((n,), dtype=I32, device=dev)
    empty = in_use & (sb_class == FREE_CLS)      # never initialized → free
    partial_stacks, partial_tops = [], []
    Spad = num_slots(cfg)
    marked_pad = torch.cat([marked.to(torch.bool),
                            torch.zeros((1,), dtype=torch.bool, device=dev)])

    # large spans: live iff the head block is marked.  Each superblock
    # finds the nearest head at or before it (cummax) and checks that it
    # lies inside that head's recorded extent.
    is_head = in_use & (sb_class == LARGE_CLS)
    span_len = torch.where(is_head,
                           span_sbs(cfg, persistent["sb_block_words"]), 0)
    head_of = torch.cummax(torch.where(is_head, sb_ids, -1), 0).values
    reach = torch.where(head_of >= 0,
                        head_of + span_len[torch.clamp(head_of, min=0)], 0)
    in_span = in_use & (head_of >= 0) & (sb_ids < reach)
    head_slot = torch.where(in_span, (head_of * cfg.sb_words) // minw, Spad)
    head_marked = marked_pad[head_slot]
    is_large = in_use & ((sb_class == LARGE_CLS) | (sb_class == LARGE_CONT))
    live_large = is_large & in_span & head_marked
    empty = empty | (is_large & ~live_large)

    if ref_counts is None:
        head_counts = torch.ones((n,), dtype=I32, device=dev)
    else:
        rc_pad = torch.cat([torch.as_tensor(ref_counts, dtype=I32,
                                            device=dev),
                            torch.zeros((1,), dtype=I32, device=dev)])
        head_counts = rc_pad[head_slot]
    span_refs = torch.where(live_large, torch.clamp(head_counts, min=1), 0)

    new_class = sb_class
    blk = _ids(cfg.max_blocks, dev)
    for c in range(cfg.num_classes):
        cw = cfg.class_words[c]
        total = cfg.blocks_per_sb(c)
        sel = in_use & (sb_class == c)
        offs = sb_ids[:, None] * cfg.sb_words + blk[None, :] * cw
        valid = blk[None, :] < total
        slots = torch.where(valid, offs // minw, Spad)
        m = marked_pad[slots]                     # [n, max_blocks]
        bm_c = valid & ~m
        cnt_c = bm_c.sum(dim=1, dtype=I32)
        free_bitmap = torch.where(sel[:, None], bm_c, free_bitmap)
        counts = torch.where(sel, cnt_c, counts)
        now_empty = sel & (cnt_c >= total)
        empty = empty | now_empty
        new_class = torch.where(now_empty, -1, new_class)
        part = sel & (cnt_c > 0) & (cnt_c < total)
        stack_c, top_c = _compact(part, n + 1)
        partial_stacks.append(stack_c)
        partial_tops.append(top_c)

    # empty superblocks (incl. dead/orphaned spans): wipe and stack as free
    free_bitmap = torch.where(empty[:, None], False, free_bitmap)
    counts = torch.where(empty, 0, counts)
    new_class = torch.where(empty, FREE_CLS, new_class)
    free_stack, free_top = _compact(empty, n + 1)

    st = init_state(cfg, max_roots=persistent["roots"].shape[0], device=dev)
    st = st._replace(
        sb_class=new_class,
        sb_block_words=torch.where(empty, 0, persistent["sb_block_words"]),
        used_sbs=torch.as_tensor(used, dtype=I32, device=dev).clone(),
        roots=persistent["roots"].clone(),
        dirty=torch.ones((), dtype=I32, device=dev),
        free_bitmap=free_bitmap,
        sb_free_count=counts,
        free_stack=free_stack,
        free_top=free_top,
        partial_stack=torch.stack(partial_stacks),
        partial_top=torch.stack(partial_tops),
        span_refs=span_refs,
    )
    # the free-run index is a pure function of the recovered class records
    return rebuild_run_index(st, cfg)


def live_record_mask(cfg: ArenaConfig, marked, offs, seal_ok=None):
    """Which block offsets survived the sweep (their slots are marked),
    and — with ``seal_ok`` — whose sidecar seal verifies.  ``offs`` may
    hold -1 (null) entries; they come back False."""
    dev = marked.device
    offs = torch.as_tensor(offs, dtype=I32, device=dev)
    S = num_slots(cfg)
    slots = torch.where(offs >= 0, slot_of(cfg, offs), S)
    padded = torch.cat([marked.to(torch.bool),
                        torch.zeros((1,), dtype=torch.bool, device=dev)])
    live = (offs >= 0) & padded[slots]
    if seal_ok is not None:
        live = live & torch.as_tensor(seal_ok, dtype=torch.bool, device=dev)
    return live


def recover(cfg: ArenaConfig, persistent: dict, ref_table,
            max_iter: int = 64) -> tuple[AllocState, torch.Tensor]:
    """Full recovery: mark + span-refcount rebuild + sweep."""
    marked = mark(cfg, persistent["roots"], ref_table, max_iter)
    ref_counts = span_ref_counts(cfg, persistent["roots"], ref_table, marked)
    return sweep(cfg, persistent, marked, ref_counts), marked
