"""Paged decode attention: one query token per sequence over its pages.

``paged_attention`` launches the CUDA kernel ``csrc/paged_attention.cu``
(the port of the Pallas TPU kernel
``kernels/paged_attention/kernel.py::paged_attention`` of the reference)
on CUDA tensors and runs ``paged_attention_plain`` on CPU tensors.

Position ``p * page + t`` of block-table column ``p`` is valid iff it lies
in the lane's range ``[starts[b], lengths[b])`` and the column's page id
is ``>= 0``; without ``starts`` the range starts at ``lengths[b] -
window`` (0 without a window).  Pages fill contiguously (engine
contract).  Softmax in fp32; the output is ``acc / max(l, 1e-20)`` in q's
dtype, so a sequence with no valid position gets zeros.  With
``return_lse`` the output is fp32 and comes with each row's log-sum-exp of
its scaled scores (-inf where the lane has no valid position): what the
merge across a mesh's shards reads (``serving/tp_layers.py``).

On a shard of a mesh the arena holds ``page_loc`` slots of each page (the
model axis) and, sequence-parallel, a run of the table's columns (the
data axes): ``Slots`` names them, and ``local_count`` turns a lane's global
range into the one contiguous local range the kernel takes (global
position grows with local position), so the kernel knows nothing of the
mesh.

The kernel splits each (lane, KV head) over the block table: ``splits``
ranges of whole ``TILE``-position tiles, chosen by ``split_count`` from
(B, K, P, page) alone, so no call reads the device to decide.  The splits'
partials are merged in split order inside the same launch;
``paged_attention_split_plain`` is that decomposition in plain PyTorch.

With ``scales=(ks, vs)`` (fp32 [pages, page, K]) the arenas are int8 (the
reference's int8 KV branch): each gathered row is dequantized as
``(row.float() * scale).to(q.dtype)`` before the products.  On the card
that is the int8 variant of each kernel in ``csrc/paged_attention.cu``,
which gathers the int8 rows and their scales; the bf16 kernel converts
them in its mma fragments, the fp32 one a sub-tile in shared memory.
Nothing dequantizes the arena in PyTorch.
"""

from __future__ import annotations

import torch

from .. import build
from ..kv_update.kernel import Slots, check_scales

NEG_INF = -1e30
TILE = 64              # positions per tile of the kernel
MAX_GROUP = 64         # query heads per KV head: four 16-row mma tiles
MAX_HEAD_DIM = 256
MAX_SPLITS = 64
MERGE_CHUNK = 8        # the kernel merges at most this many partials a block
# the split: at least MIN_BLOCKS blocks (two per SM of an H100's 132); a
# split at most an eighth of the table (so a lane far shorter than the
# table still spreads over blocks) but at least MIN_TILES_PER_SPLIT tiles
# (both in flight at once), and at most MAX_TILES_PER_SPLIT tiles
MIN_BLOCKS = 2 * 132
MIN_TILES_PER_SPLIT = 2
MAX_TILES_PER_SPLIT = 16

launches = 0           # kernel launches since the caller last zeroed this
int8_launches = 0      # the int8 variant's launches, likewise

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_counters: dict = {}   # device index -> int32 zeros, one per (b, kh)


def gather_rows(arena, scale, bt, dtype):
    """The arena rows of table ``bt`` (page ids >= 0) as [B, P * page, K,
    dh] fp32; int8 rows dequantized as the reference does it,
    ``(row.float() * scale).to(dtype)``."""
    B, P = bt.shape
    _, page, K, dh = arena.shape
    rows = arena[bt].reshape(B, P * page, K, dh)
    if scale is None:
        return rows.float()
    s = scale[bt].reshape(B, P * page, K, 1)
    return (rows.float() * s).to(dtype).float()


def paged_attention_plain(q, arena_k, arena_v, block_table, lengths, *,
                          window: int = 0, scales=None, starts=None,
                          return_lse: bool = False):
    """Plain PyTorch version of the kernel: gather every table page
    (dequantized with ``scales``), mask, fp32 softmax, fp32 P.V."""
    B, H, dh = q.shape
    _, page, K, _ = arena_k.shape
    g = H // K
    bt = torch.clamp(block_table, min=0).long()
    ks, vs = scales if scales is not None else (None, None)
    k = gather_rows(arena_k, ks, bt, q.dtype)
    v = gather_rows(arena_v, vs, bt, q.dtype)
    qg = q.reshape(B, K, g, dh).float() * (dh ** -0.5)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    valid = valid_positions(block_table, lengths, page, window, starts)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.where(valid[:, None, None, :], torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", e, v) / torch.clamp(l, min=1e-20)
    if return_lse:
        lse = torch.where(l > 0, m + torch.log(l), -torch.inf)
        return o.reshape(B, H, dh), lse.reshape(B, H)
    return o.reshape(B, H, dh).to(q.dtype)


def valid_positions(block_table, lengths, page: int, window: int,
                    starts=None):
    """[B, P * page] bool: the positions the kernel attends over."""
    P = block_table.shape[1]
    pos = torch.arange(P * page, device=block_table.device)[None]
    valid = (pos < lengths[:, None]) & \
        torch.repeat_interleave(block_table >= 0, page, dim=1)
    if starts is not None:
        valid = valid & (pos >= starts[:, None])
    elif window:
        valid = valid & (pos > (lengths[:, None] - 1 - window))
    return valid


def local_count(x, slots: Slots, page_loc: int, P_loc: int):
    """How many of a shard's local positions (``P_loc`` table columns of
    ``page_loc`` slots) lie below global position ``x`` (a tensor): the
    local image of a global bound.  Local position ``c * page_loc + t``
    is global ``(page0 + c) * page + slot0 + t``, which grows with it, so
    a global range ``[lo, hi)`` is the local range ``[local_count(lo),
    local_count(hi))``."""
    y = x - slots.page0 * slots.page
    full = torch.div(y, slots.page, rounding_mode="floor")
    part = torch.clamp(y - full * slots.page - slots.slot0, 0, page_loc)
    return torch.clamp(full * page_loc + part, 0, P_loc * page_loc).to(
        torch.int32)


def split_count(B: int, K: int, P: int, page: int) -> tuple[int, int]:
    """(splits, tiles_per_split) for a call, by the rule above; at most
    MAX_SPLITS splits.  A function of the shapes alone: lengths and the
    table are never read, so the call needs no device-to-host sync."""
    tiles = -(-(P * page) // TILE)
    want = -(-MIN_BLOCKS // max(B * K, 1))
    cap = min(MAX_TILES_PER_SPLIT, max(MIN_TILES_PER_SPLIT, tiles // 8))
    per = max(min(-(-tiles // want), cap), -(-tiles // MAX_SPLITS))
    return -(-tiles // per), per


def paged_attention_split_plain(q, arena_k, arena_v, block_table, lengths,
                                *, window: int = 0, splits: int | None = None,
                                tile: int = TILE, scales=None, starts=None):
    """The kernel's decomposition in plain PyTorch: per split (a range of
    whole ``tile``-position tiles) the partial max m, sum l and unnormalised
    acc; an empty split gives (m = -1e30, l = 0); the partials merge in
    split order.  ``splits=None`` takes ``split_count``'s; another value is
    rounded as the kernel's host side rounds it (whole tiles a split).  P
    is rounded to q's dtype for P.V, as the kernel's bf16 path does.  (The
    kernel merges more than MERGE_CHUNK partials as a tree, chunk by chunk
    in the same order: equal up to fp32 rounding.)"""
    B, H, dh = q.shape
    _, page, K, _ = arena_k.shape
    P = block_table.shape[1]
    g = H // K
    tiles = -(-(P * page) // tile)
    if splits is None:
        splits, per = split_count(B, K, P, page)
        if tile != TILE:
            raise ValueError("split_count's split is in tiles of TILE")
    else:
        per = -(-tiles // max(1, min(splits, tiles)))
        splits = -(-tiles // per)
    bt = torch.clamp(block_table, min=0).long()
    ks, vs = scales if scales is not None else (None, None)
    k = gather_rows(arena_k, ks, bt, q.dtype)
    v = gather_rows(arena_v, vs, bt, q.dtype)
    qg = q.reshape(B, K, g, dh).float() * (dh ** -0.5)
    s_all = torch.einsum("bkgd,btkd->bkgt", qg, k)
    valid = valid_positions(block_table, lengths, page, window,
                            starts)[:, None, None, :]
    parts = []
    for sp in range(splits):
        lo, hi = sp * per * tile, min((sp + 1) * per * tile, P * page)
        ok = valid[..., lo:hi]
        s = torch.where(ok, s_all[..., lo:hi], NEG_INF)
        m = s.max(dim=-1).values                              # [B, K, g]
        e = torch.where(ok, torch.exp(s - m[..., None]), 0.0)
        l = e.sum(dim=-1)
        acc = torch.einsum("bkgt,btkd->bkgd", e.to(q.dtype).float(),
                           v[:, lo:hi])
        parts.append((torch.where(l > 0, m, NEG_INF), l, acc))
    M = torch.stack([torch.where(l > 0, m, -torch.inf)
                     for m, l, _ in parts]).max(dim=0).values
    M = torch.where(torch.isfinite(M), M, 0.0)
    num = torch.zeros((B, K, g, dh), dtype=torch.float32, device=q.device)
    den = torch.zeros((B, K, g), dtype=torch.float32, device=q.device)
    for m, l, acc in parts:                                   # split order
        w = torch.where(l > 0, torch.exp(m - M), 0.0)
        num = num + w[..., None] * acc
        den = den + w * l
    o = num / torch.clamp(den, min=1e-20)[..., None]
    return o.reshape(B, H, dh).to(q.dtype)


def _check(q, arena_k, arena_v, block_table, lengths, starts=None):
    if q.dim() != 3 or arena_k.dim() != 4 or arena_v.shape != arena_k.shape:
        raise ValueError("q must be [B, H, dh], arenas [pages, page, K, dh]")
    B, H, dh = q.shape
    K = arena_k.shape[2]
    if arena_k.shape[3] != dh or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit arena "
                         f"{tuple(arena_k.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,) or (starts is not None
                                         and starts.shape != (B,)):
        raise ValueError("block_table must be [B, P], lengths and starts "
                         "[B]")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or (starts is not None and starts.dtype != torch.int32):
        raise TypeError("block_table, lengths and starts must be int32")
    for t in (arena_k, arena_v, block_table, lengths,
              *(() if starts is None else (starts,))):
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")


def check_kernel_shape(dtype, H: int, K: int, dh: int) -> None:
    """Raise for what the kernel does not take: more than MAX_GROUP query
    heads per KV head, or a head_dim above MAX_HEAD_DIM or not a multiple
    of 16 (bf16) / 8 (fp32)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    step = 16 if dtype == torch.bfloat16 else 8
    if H // K > MAX_GROUP or dh > MAX_HEAD_DIM or dh % step or dh <= 0:
        raise ValueError(f"the kernel takes at most {MAX_GROUP} query heads "
                         f"per KV head and a head_dim <= {MAX_HEAD_DIM} that "
                         f"is a multiple of {step}, not {H // K} and {dh}")


def _counter_buffer(device, n: int):
    """The device's int32 ticket counters (one per (b, kh) and per chunk
    of its splits), at least ``n``; the kernel leaves them at zero.  Grown
    only outside a graph capture."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_attention: call once with this shape "
                               "before capturing it in a CUDA graph")
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[idx] = buf
    return buf


def paged_attention(q, arena_k, arena_v, block_table, lengths, *,
                    window: int = 0, scales=None, starts=None,
                    return_lse: bool = False):
    """q: [B, H, dh]; arena_k/v: [pages, page, K, dh]; block_table: int32
    [B, P] page ids (-1 unused); lengths: int32 [B], the end of each
    lane's range; starts: None or int32 [B], its start (without it,
    ``lengths - window``; give one or the other).  With ``scales=(ks,
    vs)`` (fp32 [pages, page, K]) the arenas are int8.  Returns [B, H, dh]
    in q's dtype, or with ``return_lse`` (out fp32 [B, H, dh], lse fp32
    [B, H])."""
    global launches, int8_launches
    _check(q, arena_k, arena_v, block_table, lengths, starts)
    check_scales(arena_k, arena_v, scales)
    if starts is not None and window:
        raise ValueError("give the lanes' starts or a window, not both")
    if scales is not None and any(s.device != q.device for s in scales):
        raise ValueError("all tensors must be on one device")
    if q.device.type == "cpu":
        return paged_attention_plain(q, arena_k, arena_v, block_table,
                                     lengths, window=window, scales=scales,
                                     starts=starts, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if scales is None and (arena_k.dtype != q.dtype
                           or arena_v.dtype != q.dtype):
        raise TypeError(f"paged_attention takes arenas of q's dtype or int8 "
                        f"arenas with scales, got {q.dtype}/{arena_k.dtype}")
    B, H, dh = q.shape
    _, page, K, _ = arena_k.shape
    P = block_table.shape[1]
    check_kernel_shape(q.dtype, H, K, dh)
    if window:                     # the range's start, from the window
        starts = torch.clamp(lengths - window, min=0)
    for t in (q, arena_k, arena_v, block_table, lengths, *(scales or ()),
              *(() if starts is None else (starts,))):
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous tensors")
    if q.data_ptr() % 16 or arena_k.data_ptr() % 16 \
            or arena_v.data_ptr() % 16:
        raise ValueError("the kernel reads rows in 16-byte copies: q and the "
                         "arenas must be 16-byte aligned")
    lse = None
    if return_lse:
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    else:
        out = torch.empty_like(q)
    splits, per = split_count(B, K, P, page)
    part_acc = part_ml = counters = 0
    if splits > 1 and B:
        g = H // K
        # slots for each split's partial and for the chunk results
        slots = B * K * (splits + MAX_SPLITS // MERGE_CHUNK) * g
        part = torch.empty(slots * (dh + 2), dtype=torch.float32,
                           device=q.device)
        part_acc = part.data_ptr()
        part_ml = part_acc + 4 * slots * dh
        counters = _counter_buffer(
            q.device, B * K * (1 + MAX_SPLITS // MERGE_CHUNK)).data_ptr()
    lib = build.library()
    args = (block_table.data_ptr(),
            None if starts is None else starts.data_ptr(),
            lengths.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), part_acc, part_ml,
            counters, B, H, K, dh, page, P, float(dh ** -0.5), splits, per,
            _DTYPE_CODE[q.dtype], build.stream_ptr(q.device))
    if scales is not None:
        err = lib.paged_attention_int8_launch(
            q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
            scales[0].data_ptr(), scales[1].data_ptr(), *args)
        build.check(err, "paged_attention (int8)")
        int8_launches += 1
    else:
        err = lib.paged_attention_launch(q.data_ptr(), arena_k.data_ptr(),
                                         arena_v.data_ptr(), *args)
        build.check(err, "paged_attention")
        launches += 1
    return (out, lse) if return_lse else out
