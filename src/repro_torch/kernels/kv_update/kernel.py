"""KV append: write one token's K and V per sequence into its page slot.

``kv_update`` launches the CUDA kernel ``csrc/kv_update.cu`` (the port of
the Pallas TPU kernel ``kernels/kv_update/kernel.py::kv_update`` of the
reference) on CUDA tensors and runs ``kv_update_plain`` on CPU tensors.
Both update the arenas IN PLACE.  A page id < 0 writes to the last page
(the reserved dump page), as the Pallas kernel does; a slot outside
``[0, page)`` is dropped.  (The reference's ``kv_update_ref`` drops
negative ids instead; the engine never reads the dump page.)
"""

from __future__ import annotations

import torch

from .. import build

launches = 0          # kernel launches since the caller last zeroed this


def kv_update_plain(arena_k, arena_v, k_new, v_new, page_ids, slots):
    """Plain PyTorch version of the kernel (same semantics, in place)."""
    npages, page = arena_k.shape[:2]
    pid = torch.where(page_ids >= 0, page_ids, npages - 1)
    ok = (slots >= 0) & (slots < page) & (pid < npages)
    pid, sl = pid[ok].long(), slots[ok].long()
    arena_k[pid, sl] = k_new[ok].to(arena_k.dtype)
    arena_v[pid, sl] = v_new[ok].to(arena_v.dtype)
    return arena_k, arena_v


def _check(arena_k, arena_v, k_new, v_new, page_ids, slots):
    if arena_k.dim() != 4 or arena_v.shape != arena_k.shape:
        raise ValueError("arenas must both be [pages, page, K, dh]")
    B = k_new.shape[0]
    if k_new.shape != (B,) + tuple(arena_k.shape[2:]) \
            or v_new.shape != k_new.shape:
        raise ValueError(f"k/v_new must be [B, K, dh], got "
                         f"{tuple(k_new.shape)} / {tuple(v_new.shape)}")
    if page_ids.shape != (B,) or slots.shape != (B,):
        raise ValueError("page_ids and slots must be [B]")
    for t in (arena_k, arena_v, k_new, v_new, page_ids, slots):
        if t.device != arena_k.device:
            raise ValueError("all tensors must be on one device")
    if page_ids.dtype != torch.int32 or slots.dtype != torch.int32:
        raise TypeError("page_ids and slots must be int32")


def kv_update(arena_k, arena_v, k_new, v_new, page_ids, slots):
    """arena_k/v: [pages, page, K, dh]; k/v_new: [B, K, dh]; page_ids,
    slots: int32 [B].  Updates the arenas in place and returns them."""
    global launches
    _check(arena_k, arena_v, k_new, v_new, page_ids, slots)
    if arena_k.device.type == "cpu":
        return kv_update_plain(arena_k, arena_v, k_new, v_new, page_ids,
                               slots)
    if arena_k.device.type != "cuda":
        raise ValueError(f"kv_update runs on cuda or cpu, not "
                         f"{arena_k.device}")
    if k_new.dtype != arena_k.dtype or v_new.dtype != arena_v.dtype:
        raise TypeError("k/v_new must have the arena's dtype")
    for t in (arena_k, arena_v, k_new, v_new, page_ids, slots):
        if not t.is_contiguous():
            raise ValueError("kv_update needs contiguous tensors")
    npages, page, K, dh = arena_k.shape
    lib = build.library()
    err = lib.kv_update_launch(
        arena_k.data_ptr(), arena_v.data_ptr(), k_new.data_ptr(),
        v_new.data_ptr(), page_ids.data_ptr(), slots.data_ptr(),
        k_new.shape[0], npages, page, K * dh * arena_k.element_size(),
        build.stream_ptr(arena_k.device))
    build.check(err, "kv_update")
    launches += 1
    return arena_k, arena_v
