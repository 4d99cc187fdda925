"""KV append: write one token's K and V per sequence into its page slot.

``kv_update`` launches the CUDA kernel ``csrc/kv_update.cu`` (the port of
the Pallas TPU kernel ``kernels/kv_update/kernel.py::kv_update`` of the
reference) on CUDA tensors and runs ``kv_update_plain`` on CPU tensors.
Both update the arenas IN PLACE.  A page id < 0 writes to the last page
(the reserved dump page), as the Pallas kernel does; a slot outside
``[0, page)`` is dropped.  (The reference's ``kv_update_ref`` drops
negative ids instead; the engine never reads the dump page.)

``rope_kv_append`` is kv_update redesigned for the decode layer: one
launch of ``csrc/kv_update.cu``'s ``rope_kv_append_launch`` does what the
layer does between its QKV matmuls and its paged attention (bias, RoPE on
q and k, the page/slot lookup of ``pos`` in the block table, the K/V
write) and returns the rotated q.  ``rope_kv_append_plain`` is that chain
in plain PyTorch, as the decode layer ran it before.

With ``scales=(ks, vs)`` the arenas are int8 and the K/V rows are
quantized on write, as the reference's int8 KV branch does (KIVI-style, a
scale per slot and KV head): each row, rounded to the model dtype, gets
``s = max|x| / 127 + 1e-9`` in fp32 and is stored as ``clamp(round(x /
s), -127, 127)`` (half to even) beside ``s`` in the fp32 scale arenas
[pages, page, K].  The CUDA side is ``rope_kv_append_int8_kernel`` in
``csrc/kv_update.cu``: a warp a row, the row in registers from its load
to its int8 store, so K * head_dim has no limit.

On a shard of a mesh (``slots=Slots(...)``) the arena holds ``page_loc``
slots of each global page, and sequence-parallel a run of the table's
columns: q and k are rotated at the global ``pos``, and only the rows the
shard holds are written; the others go to the dump page's slot 0, as the
reference's scatter sends them (``serving/tp_layers.py``
``attn_decode_tp``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import build
from ...layers.rope import apply_rope

launches = 0          # kv_update launches since the caller last zeroed this
rope_kv_append_launches = 0   # rope_kv_append launches, likewise
rope_kv_append_int8_launches = 0   # its int8 variant's launches, likewise

MAX_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the int8 scale is max|x| * (1 / 127) + 1e-9 rounded once: XLA turns the
# reference's ``/ 127.0`` into a multiply by the fp32 reciprocal and
# contracts the add into an FMA, and the kernel's ``__fmaf_rn`` does the same
INV_127 = float.fromhex("0x1.020408p-7")     # fp32(1 / 127)
SCALE_EPS = float.fromhex("0x1.12e0bep-30")  # fp32(1e-9)


class Slots(NamedTuple):
    """The slots of the global paged layout a shard's arena and table
    hold: each global page has ``page`` slots, of which the arena holds
    ``page_loc`` (its second dim) from ``slot0`` on; with ``seq`` the
    table's columns are global columns ``page0`` on (sequence
    parallelism), else all of them (``page0`` 0).  One device:
    ``Slots(page, 0, 0, False)``."""
    page: int
    slot0: int = 0
    page0: int = 0
    seq: bool = False


def locate(pos, block_table, page_loc: int, slots: Slots):
    """(page id int32 [B], slot int32 [B]) of each lane's write: the table
    entry of ``pos``'s column and ``pos``'s local slot where the shard
    holds the position (page id -1 past the table), else (-1, 0)."""
    P = block_table.shape[1]
    col = torch.div(pos, slots.page, rounding_mode="floor").long() \
        - slots.page0
    slot = (pos % slots.page).long() - slots.slot0
    in_table = (col >= 0) & (col < P)
    mine = (slot >= 0) & (slot < page_loc)
    if slots.seq:
        mine = mine & in_table
    pid = torch.gather(block_table, 1,
                       torch.clamp(col, 0, P - 1)[:, None])[:, 0]
    pid = torch.where(mine & in_table, pid, -1).to(torch.int32)
    return pid, torch.where(mine, slot, 0).to(torch.int32)


def kv_update_plain(arena_k, arena_v, k_new, v_new, page_ids, slots):
    """Plain PyTorch version of the kernel (same semantics, in place)."""
    npages, page = arena_k.shape[:2]
    pid = torch.where(page_ids >= 0, page_ids, npages - 1)
    ok = (slots >= 0) & (slots < page) & (pid < npages)
    pid, sl = pid[ok].long(), slots[ok].long()
    arena_k[pid, sl] = k_new[ok].to(arena_k.dtype)
    arena_v[pid, sl] = v_new[ok].to(arena_v.dtype)
    return arena_k, arena_v


def _fma_f32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once (an FMA), for fp32 ``a`` and fp32
    values ``b``, ``c``: the product is exact in fp64 and the sum's fp64
    rounding error is kept (TwoSum), so where the fp64 sum lies exactly
    half-way between two floats the exact sum picks the side."""
    p = a.double() * b
    d = p + c
    z = d - p
    err = (p - (d - z)) + (c - z)                  # d + err == p + c exactly
    f = d.float()
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    dn = torch.nextafter(f, torch.full_like(f, float("-inf")))
    f = torch.where(((f.double() + up.double()) / 2 == d) & (err > 0), up, f)
    return torch.where(((f.double() + dn.double()) / 2 == d) & (err < 0),
                       dn, f)


def quantize_rows(x: torch.Tensor):
    """int8 rows and their fp32 scales, as the reference's int8 KV branch
    makes them: ``s = max|x| / 127 + 1e-9`` over the last axis, then
    ``clamp(round(x / s), -127, 127)`` (half to even, a true division)."""
    xf = x.float()
    s = _fma_f32(xf.abs().amax(dim=-1), INV_127, SCALE_EPS)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


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


def rope_kv_append_plain(q, k, v, bq, bk, bv, freqs, pos, block_table,
                         arena_k, arena_v, scales=None, slots=None):
    """Plain PyTorch version of ``rope_kv_append`` (same arguments): the
    bias add, ``apply_rope`` on q and k, the page/slot lookup (``locate``)
    and ``kv_update_plain`` (with ``scales``, the rows quantized by
    ``quantize_rows`` and their scales written alike), op by op.  Returns
    q_rot [B, H, dh]."""
    B = q.shape[0]
    _, page, K, dh = arena_k.shape
    H = q.shape[1] // dh
    if bq is not None:
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(B, H, dh)
    k = k.reshape(B, K, dh)
    v = v.reshape(B, K, dh)
    if freqs is not None:
        q = apply_rope(q[:, None], pos[:, None], freqs=freqs)[:, 0]
        k = apply_rope(k[:, None], pos[:, None], freqs=freqs)[:, 0]
    pid, slot = locate(pos, block_table, page, slots or Slots(page))
    if scales is None:
        kv_update_plain(arena_k, arena_v, k.to(arena_k.dtype).contiguous(),
                        v.to(arena_v.dtype).contiguous(), pid, slot)
        return q
    (kq, k_s), (vq, v_s) = quantize_rows(k), quantize_rows(v)
    kv_update_plain(arena_k, arena_v, kq, vq, pid, slot)
    kv_update_plain(*scales, k_s, v_s, pid, slot)
    return q


def _check_rope(q, k, v, bq, bk, bv, freqs, pos, block_table, arena_k,
                arena_v, scales, slots):
    if arena_k.dim() != 4 or arena_v.shape != arena_k.shape:
        raise ValueError("arenas must both be [pages, page, K, dh]")
    _, page, K, dh = arena_k.shape
    if slots is not None and not (slots.slot0 >= 0 and slots.page0 >= 0
                                  and slots.slot0 + page <= slots.page):
        raise ValueError(f"{slots} does not hold {page} slots of a page")
    check_scales(arena_k, arena_v, scales)
    if dh % 2 or not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"rope_kv_append takes an even head_dim <= "
                         f"{MAX_HEAD_DIM}, not {dh}")
    if q.dim() != 2 or q.shape[1] % dh:
        raise ValueError(f"q must be [B, H * {dh}], got {tuple(q.shape)}")
    B, H = q.shape[0], q.shape[1] // dh
    if H == 0 or H % K:
        raise ValueError(f"{H} query heads do not group over {K} KV heads")
    if k.shape != (B, K * dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be [B, {K * dh}], got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    biases = (bq, bk, bv)
    if any(b is None for b in biases) and any(b is not None for b in biases):
        raise ValueError("give all three biases or none")
    if bq is not None and (bq.shape != (H * dh,) or bk.shape != (K * dh,)
                           or bv.shape != (K * dh,)):
        raise ValueError("the biases must be [H * dh], [K * dh], [K * dh]")
    if freqs is not None and (freqs.shape != (dh // 2,)
                              or freqs.dtype != torch.float32):
        raise ValueError(f"freqs must be float32 [{dh // 2}]")
    if pos.shape != (B,) or block_table.dim() != 2 \
            or block_table.shape[0] != B or block_table.shape[1] == 0:
        raise ValueError("pos must be [B] and block_table [B, P], P > 0")
    if pos.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise TypeError("pos and block_table must be int32")
    # (is_cuda, device index): far cheaper than comparing torch.device
    # objects, on a path that runs once a layer a decode step
    where = (arena_k.is_cuda, arena_k.get_device())
    for t in (q, k, v, *biases, freqs, pos, block_table, arena_v,
              *(scales or ())):
        if t is not None and (t.is_cuda, t.get_device()) != where:
            raise ValueError("all tensors must be on one device")


def check_scales(arena_k, arena_v, scales) -> None:
    """int8 arenas come with fp32 scale arenas [pages, page, K] and other
    arenas without; anything else raises."""
    int8 = arena_k.dtype == torch.int8 or arena_v.dtype == torch.int8
    if scales is None:
        if int8:
            raise TypeError("int8 arenas need their scales (ks, vs)")
        return
    if not (arena_k.dtype == arena_v.dtype == torch.int8):
        raise TypeError(f"scales go with int8 arenas, not "
                        f"{arena_k.dtype} / {arena_v.dtype}")
    if len(scales) != 2:
        raise ValueError("scales must be the pair (ks, vs)")
    for t in scales:
        if t.dtype != torch.float32 or t.shape != arena_k.shape[:3]:
            raise ValueError(f"scales must be float32 "
                             f"{list(arena_k.shape[:3])}, got {t.dtype} "
                             f"{list(t.shape)}")


def rope_kv_append(q, k, v, bq, bk, bv, freqs, pos, block_table, arena_k,
                   arena_v, scales=None, slots=None):
    """The decode layer's step between its QKV matmuls and its attention.

    q: [B, H * dh], k, v: [B, K * dh] (the matmul outputs); bq, bk, bv:
    the biases [H * dh], [K * dh], [K * dh] or all None; freqs: float32
    [dh / 2] (``layers.rope.rope_freqs``) or None for no RoPE; pos: int32
    [B] (>= 0); block_table: int32 [B, P]; arena_k/v: [pages, page, K,
    dh], updated IN PLACE: the rotated K row and the V row of lane b land
    in page ``block_table[b, pos // page]`` (-1 when ``pos // page >= P``;
    an id < 0 → the dump page, the last), slot ``pos % page``.  Returns
    the rotated q [B, H, dh].  With ``scales=(ks, vs)`` (fp32 [pages, page,
    K]) the arenas are int8, and the rows are quantized on write
    (``quantize_rows``) beside their scales.  On a shard of a mesh
    ``slots`` (``Slots``) says which slots and table columns of the global
    layout the arena holds: pos is global, the page and slot local, and a
    row the shard does not hold goes to the dump page's slot 0.  Refuses
    an odd head_dim, one above 256 and H % K != 0."""
    global rope_kv_append_launches, rope_kv_append_int8_launches
    _check_rope(q, k, v, bq, bk, bv, freqs, pos, block_table, arena_k,
                arena_v, scales, slots)
    dev = arena_k.device
    if dev.type == "cpu":
        return rope_kv_append_plain(q, k, v, bq, bk, bv, freqs, pos,
                                    block_table, arena_k, arena_v, scales,
                                    slots)
    if dev.type != "cuda":
        raise ValueError(f"rope_kv_append runs on cuda or cpu, not {dev}")
    dt = q.dtype if scales is not None else arena_k.dtype
    if dt not in _DTYPE_CODE:
        raise TypeError(f"rope_kv_append takes float32 or bfloat16, not "
                        f"{dt}")
    biases = (bq, bk, bv)
    for t in (q, k, v, *((arena_k, arena_v) if scales is None else ()),
              *biases):
        if t is not None and t.dtype != dt:
            raise TypeError("q, k, v, the biases and the arenas must share "
                            "one dtype")
    for t in (q, k, v, *biases, freqs, pos, block_table, arena_k, arena_v,
              *(scales or ())):
        if t is not None and not t.is_contiguous():
            raise ValueError("rope_kv_append needs contiguous tensors")
    npages, page, K, dh = arena_k.shape
    B, H = q.shape[0], q.shape[1] // dh
    q_out = torch.empty((B, H, dh), dtype=dt, device=dev)
    sl = slots or Slots(page)
    shape = (B, H, K, dh, block_table.shape[1], npages, page, sl.page,
             sl.slot0, sl.page0, int(sl.seq), _DTYPE_CODE[dt],
             build.stream_ptr(dev))

    def ptr(t):
        return None if t is None else t.data_ptr()

    if scales is not None:
        err = build.library().rope_kv_append_int8_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bq), ptr(bk),
            ptr(bv), ptr(freqs), pos.data_ptr(), block_table.data_ptr(),
            arena_k.data_ptr(), arena_v.data_ptr(), scales[0].data_ptr(),
            scales[1].data_ptr(), q_out.data_ptr(), *shape)
        build.check(err, "rope_kv_append (int8)")
        rope_kv_append_int8_launches += 1
        return q_out
    err = build.library().rope_kv_append_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bq), ptr(bk), ptr(bv),
        ptr(freqs), pos.data_ptr(), block_table.data_ptr(),
        arena_k.data_ptr(), arena_v.data_ptr(), q_out.data_ptr(), *shape)
    build.check(err, "rope_kv_append")
    rope_kv_append_launches += 1
    return q_out
