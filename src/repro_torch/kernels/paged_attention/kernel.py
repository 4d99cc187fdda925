"""Paged decode attention: one query token per sequence over its pages.

``paged_attention`` launches the CUDA kernel ``csrc/paged_attention.cu``
(the port of the Pallas TPU kernel
``kernels/paged_attention/kernel.py::paged_attention`` of the reference)
on CUDA tensors and runs ``paged_attention_plain`` on CPU tensors.

Position ``p * page + t`` of block-table column ``p`` is valid iff it is
``< lengths[b]``, the column's page id is ``>= 0`` and, with a window,
``> lengths[b] - 1 - window``; pages fill contiguously (engine contract).
Softmax in fp32; the output is ``acc / max(l, 1e-20)`` in q's dtype, so a
sequence with no valid position gets zeros.
"""

from __future__ import annotations

import torch

from .. import build

NEG_INF = -1e30
MAX_GROUP = 8          # query heads per KV head the kernel holds in registers
MAX_HEAD_DIM = 128     # one thread per head-dim column

launches = 0           # kernel launches since the caller last zeroed this

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, arena_k, arena_v, block_table, lengths, *,
                          window: int = 0):
    """Plain PyTorch version of the kernel: gather every table page, mask,
    fp32 softmax, fp32 P.V."""
    B, H, dh = q.shape
    _, page, K, _ = arena_k.shape
    P = block_table.shape[1]
    g = H // K
    bt = torch.clamp(block_table, min=0).long()
    k = arena_k[bt].reshape(B, P * page, K, dh).float()
    v = arena_v[bt].reshape(B, P * page, K, dh).float()
    qg = q.reshape(B, K, g, dh).float() * (dh ** -0.5)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    pos = torch.arange(P * page, device=q.device)[None]
    valid = (pos < lengths[:, None]) & \
        torch.repeat_interleave(block_table >= 0, page, dim=1)
    if window:
        valid = valid & (pos > (lengths[:, None] - 1 - window))
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.max(dim=-1, keepdim=True).values
    e = torch.where(valid[:, None, None, :], torch.exp(s - m), 0.0)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,btkd->bkgd", e, v) / torch.clamp(l, min=1e-20)
    return o.reshape(B, H, dh).to(q.dtype)


def _check(q, arena_k, arena_v, block_table, lengths):
    if q.dim() != 3 or arena_k.dim() != 4 or arena_v.shape != arena_k.shape:
        raise ValueError("q must be [B, H, dh], arenas [pages, page, K, dh]")
    B, H, dh = q.shape
    K = arena_k.shape[2]
    if arena_k.shape[3] != dh or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit arena "
                         f"{tuple(arena_k.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or lengths.shape != (B,):
        raise ValueError("block_table must be [B, P] and lengths [B]")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    for t in (arena_k, arena_v, block_table, lengths):
        if t.device != q.device:
            raise ValueError("all tensors must be on one device")


def paged_attention(q, arena_k, arena_v, block_table, lengths, *,
                    window: int = 0):
    """q: [B, H, dh]; arena_k/v: [pages, page, K, dh]; block_table: int32
    [B, P] page ids (-1 unused); lengths: int32 [B].  Returns [B, H, dh]
    in q's dtype."""
    global launches
    _check(q, arena_k, arena_v, block_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, arena_k, arena_v, block_table,
                                     lengths, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE or arena_k.dtype != q.dtype \
            or arena_v.dtype != q.dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"arenas of the same dtype, got {q.dtype}/"
                        f"{arena_k.dtype}")
    B, H, dh = q.shape
    _, page, K, _ = arena_k.shape
    if H // K > MAX_GROUP or dh > MAX_HEAD_DIM or dh % 8:
        raise ValueError(f"kernel holds at most {MAX_GROUP} query heads per "
                         f"KV head and a head_dim <= {MAX_HEAD_DIM} that is "
                         f"a multiple of 8")
    if arena_k.data_ptr() % 16 or arena_v.data_ptr() % 16:
        raise ValueError("kernel reads K rows in 16-byte loads: arenas must "
                         "be 16-byte aligned")
    for t in (q, arena_k, arena_v, block_table, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_attention needs contiguous tensors")
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.paged_attention_launch(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, K, dh, page, block_table.shape[1], int(window),
        float(dh ** -0.5), _DTYPE_CODE[q.dtype],
        build.stream_ptr(q.device))
    build.check(err, "paged_attention")
    launches += 1
    return out
