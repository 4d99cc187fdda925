"""Full-sequence attention (GQA, causal or not, sliding window) and its
gradient.

``flash_attention`` is an autograd Function.  On CUDA tensors its forward
launches the CUDA kernel ``csrc/flash_attention.cu`` (the port of the
Pallas TPU kernel ``kernels/flash_attention/kernel.py::flash_attention``
of the reference), which also writes each query row's log-sum-exp when an
input requires grad, and its backward launches ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd``; the reference has no Pallas backward: its
gradient is XLA's autodiff of ``chunked_attention``).  On CPU tensors the
Function runs the plain versions, ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain``.

q: [B, H, S, dh]; k/v: [B, K, S, dh] with H % K == 0 (query head h reads
KV head h // (H // K)).  Scores and softmax in fp32 with q scaled in fp32;
key t is visible to query s iff t <= s (causal) and t > s - window (with
a window); the output is acc / max(l, 1e-20) in q's dtype.  Any S is
taken: the kernel masks a partial last tile.  Three kernel variants, chosen
by dtype and head_dim only (``flash_variant``): bf16 at head_dim 64, 80,
128, 192 or 256 runs the Hopper kernel (``wgmma`` + TMA, warp-specialised;
hubert-xlarge's 80 in dh 128's layout with the columns past 80 read as
zeros; 64-key tiles above 128: nemotron-4-340b's 192, recurrentgemma-9b's
256), bf16 at the other multiples of 16 up to 240 the ``mma.sync`` kernel,
fp32 an FMA kernel (multiples of 16 up to 256); other head dims raise.  The
backward kernel takes the same head dims, in three variants chosen the same
way (``flash_bwd_variant``): bf16 at 64, 128, 192 or 256 the Hopper kernel
(``wgmma`` + TMA, dq by bulk reduce, the KV group's heads split over blocks
where the grid is small: ``bwd_split_count``; 128-key tiles up to 128, 64
above, where the two consumer groups split head_dim and a causal block
takes two key tiles: ``bwd_pair_key_tiles``), bf16 at the other
multiples of 16 up to 240 the ``mma.sync`` kernel (above 128 with each
warp's dK / dV columns split over two warps), fp32 the FMA kernel.
"""

from __future__ import annotations

import torch

from .. import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

launches = 0          # forward kernel launches since the caller zeroed this
bwd_launches = 0      # backward kernel launches, likewise
last_variant = None   # the variant the last forward launch ran
last_bwd_variant = None   # the variant the last backward launch ran
last_bwd_splits = None    # and its split of the KV group's heads
last_bwd_pair = None      # and whether its blocks paired causal key tiles

# the C entry points' ``variant`` codes (forward and backward alike)
VARIANTS = {"fma": 0, "mma_sync": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 80, 128, 192, 256)
# the backward's wgmma variant; other head dims run its mma.sync kernel
BWD_WGMMA_HEAD_DIMS = (64, 128, 192, 256)

# the backward's wgmma variant: a block per 128-key tile up to head_dim 128
# (BWD_KEY_TILE; ~194 KB of shared memory), per 64-key tile above it
# (BWD_WIDE_KEY_TILE; 162 / 210 KB at 192 / 256), 64 query rows a step
# (scratch rows padded to it), one block an SM.  A grid below the SM count
# splits each KV group's heads until it has BWD_SPLIT_BLOCKS blocks: causal
# key tiles differ in work up to S / 64 fold, and four blocks an SM let the
# longest-first order even out the tail (on an H100 80GB HBM3 at 700 W, at
# starcoder2-3b's 2 x 4096: split 6, 768 blocks, ran ~3 % faster than
# split 2, 256 blocks)
BWD_KEY_TILE = 128
BWD_WIDE_KEY_TILE = 64
BWD_QUERY_TILE = 64
BWD_SM_COUNT = 132        # an H100's SMs
BWD_SPLIT_BLOCKS = 4 * BWD_SM_COUNT


def flash_variant(dtype, head_dim: int) -> str:
    """The kernel variant for a dtype and head_dim: ``"wgmma"`` (bf16,
    head_dim 64, 80, 128, 192 or 256), ``"mma_sync"`` (bf16, another
    multiple of 16 up to 240) or ``"fma"`` (fp32, a multiple of 16 up to
    256).  Raises for what no variant takes."""
    _check_head_dim("flash_attention", dtype, head_dim)
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def _check_head_dim(name, dtype, head_dim: int) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {dtype}")
    if head_dim % 16 or not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"{name} takes a head_dim that is a multiple of 16 "
                         f"up to {MAX_HEAD_DIM}, not {head_dim}")


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, block_q: int = 1024):
    """Plain PyTorch version of the forward kernel: dense fp32 scores and
    softmax for ``block_q`` query rows at a time (bounds the score buffer).
    Returns (out in q's dtype, lse fp32 [B, H, S]): each row's
    log-sum-exp of its scaled scores, natural units."""
    B, H, S, dh = q.shape
    K = k.shape[1]
    g = H // K
    kf = k.float()[:, :, None]                       # [B, K, 1, S, dh]
    vf = v.float()[:, :, None]
    kpos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for s0 in range(0, S, block_q):
        s1 = min(S, s0 + block_q)
        qg = q[:, :, s0:s1].reshape(B, K, g, s1 - s0, dh).float() \
            * (dh ** -0.5)
        s = torch.matmul(qg, kf.transpose(-1, -2))  # [B, K, g, bq, S]
        mask = _mask(kpos, s0, s1, causal, window)
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        l = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-20)
        o = torch.matmul(e, vf) / l
        out[:, :, s0:s1] = o.reshape(B, H, s1 - s0, dh).to(q.dtype)
        lse[:, :, s0:s1] = (m + torch.log(l)).reshape(B, H, s1 - s0)
    return out, lse


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = 1024):
    """The forward's output alone (``flash_attention_fwd_plain``)."""
    return flash_attention_fwd_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q)[0]


def _mask(kpos, s0, s1, causal, window):
    """Visible keys of query rows s0 .. s1 - 1: bool [s1 - s0, S]."""
    qpos = kpos[s0:s1, None]
    mask = torch.ones((s1 - s0, kpos.shape[0]), dtype=torch.bool,
                      device=kpos.device)
    if causal:
        mask &= kpos[None] <= qpos
    if window:
        mask &= kpos[None] > qpos - window
    return mask


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, block_q: int = 1024):
    """Plain PyTorch version of the backward kernel: dense fp32 for
    ``block_q`` query rows at a time.  With s = scale q.k, P = exp(s -
    lse), D = rowsum(dO o): dV = P^T dO, dS = P (dO V^T - D), dQ = scale
    dS K, dK = scale dS^T Q; dk and dv sum the g query heads of their KV
    head.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, S, dh = q.shape
    K = k.shape[1]
    g = H // K
    scale = dh ** -0.5
    kf = k.float()[:, :, None]                       # [B, K, 1, S, dh]
    vf = v.float()[:, :, None]
    kpos = torch.arange(S, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for s0 in range(0, S, block_q):
        s1 = min(S, s0 + block_q)
        n = s1 - s0

        def grouped(t):
            return t[:, :, s0:s1].reshape(B, K, g, n, -1).float()
        qg = grouped(q) * scale
        dog = grouped(do)
        s = torch.matmul(qg, kf.transpose(-1, -2))  # [B, K, g, bq, S]
        mask = _mask(kpos, s0, s1, causal, window)
        p = torch.where(mask, torch.exp(s - grouped(lse[..., None])), 0.0)
        dv += torch.matmul(p.transpose(-1, -2), dog).sum(2)
        dp = torch.matmul(dog, vf.transpose(-1, -2))
        delta = (dog * grouped(o)).sum(-1, keepdim=True)
        ds = p * (dp - delta)
        dq[:, :, s0:s1] = (torch.matmul(ds, kf) * scale).reshape(B, H, n, dh)
        dk += torch.matmul(ds.transpose(-1, -2), qg).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# A bf16 output is held to the plain version row by row: the largest
# difference in a query row over that row's rms.  Rows shrink as they see
# more keys (about sqrt(e / i) at row i for unit-normal inputs), so a flat
# limit that fits the first rows says nothing of the late ones.  2^-4 is
# one bf16 ulp (2^-7 relative) at an element 8 times the row's rms.
BF16_ROW_TOL = 2.0 ** -4


# A gradient row can be exactly 0 where the output's is not (dq of a
# causal first row, whose one key takes all the weight): gradients are
# held with each row's rms floored at this fraction of the whole tensor's.
GRAD_ROW_FLOOR = 2.0 ** -10


def row_scaled_error(got, want, floor: float = 0.0) -> float:
    """Max over rows of max |got - want| / rms(want), both taken along
    head_dim; a row's rms is floored at ``floor`` x the tensor's rms."""
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt()
    low = floor * float(want.float().square().mean().sqrt())
    return float((diff / rms.clamp(min=max(low, 1e-30))).max())


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q must be [B, H, S, dh] and k/v [B, K, S, dh]")
    B, H, S, dh = q.shape
    if k.shape[0] != B or k.shape[2:] != (S, dh) or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
        if t.dtype != q.dtype:
            raise TypeError("q, k and v must have one dtype")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")


def _check_kernel_inputs(name, tensors):
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} reads 16-byte rows: tensors must be "
                             f"16-byte aligned")


def _launch_fwd(q, k, v, causal, window, with_lse):
    """The forward kernel: (out, lse or None)."""
    global launches, last_variant
    B, H, S, dh = q.shape
    variant = flash_variant(q.dtype, dh)
    _check_kernel_inputs("flash_attention", (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, B, H, k.shape[1], S, dh,
        int(causal), int(window), float(dh ** -0.5), VARIANTS[variant],
        build.stream_ptr(q.device))
    build.check(err, f"flash_attention ({variant})")
    launches += 1
    last_variant = variant
    return out, lse


def flash_bwd_variant(dtype, head_dim: int) -> str:
    """The backward kernel's variant for a dtype and head_dim: ``"wgmma"``
    (bf16, head_dim 64, 128, 192 or 256), ``"mma_sync"`` (bf16, another
    multiple of 16 up to 240) or ``"fma"`` (fp32, a multiple of 16 up to
    256).  Raises for what no variant takes."""
    _check_head_dim("flash_attention_bwd", dtype, head_dim)
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if head_dim in BWD_WGMMA_HEAD_DIMS else "mma_sync"


def bwd_key_tile(head_dim: int) -> int:
    """Keys a block of the wgmma backward: BWD_KEY_TILE up to head_dim
    128, BWD_WIDE_KEY_TILE above it."""
    return BWD_KEY_TILE if head_dim <= 128 else BWD_WIDE_KEY_TILE


def bwd_split_count(B: int, H: int, K: int, S: int,
                    head_dim: int = 128) -> int:
    """Parts into which the wgmma backward splits each KV group's g = H / K
    query heads: 1 where B * K * ceil(S / bwd_key_tile(head_dim)) blocks
    already reach BWD_SM_COUNT, else the least divisor of g that brings the
    grid to BWD_SPLIT_BLOCKS (g if none does).  A function of the shapes
    alone, so a call makes no device-to-host sync and stays capturable in a
    CUDA graph."""
    if K <= 0 or H % K:
        raise ValueError(f"H {H} is not a multiple of K {K}")
    g = H // K
    blocks = B * K * -(-S // bwd_key_tile(head_dim))
    if blocks >= BWD_SM_COUNT:
        return 1
    return next((d for d in range(1, g + 1)
                 if g % d == 0 and blocks * d >= BWD_SPLIT_BLOCKS), g)


def bwd_pair_key_tiles(B: int, H: int, K: int, S: int, head_dim: int,
                       causal: bool, window: int) -> bool:
    """Whether the wgmma backward above head_dim 128 gives each block two
    key tiles, j and n - 1 - j of n, one after the other: under a causal
    mask without a window, where the heads are not split
    (``bwd_split_count``) and the pairs still fill the card.  Every block
    is then as long, and the blocks in flight add into the same query
    tiles' dq, which stay in L2.  A function of the shapes alone, as the
    split is."""
    if head_dim <= 128 or not causal or window or \
            bwd_split_count(B, H, K, S, head_dim) > 1:
        return False
    return B * K * -(-S // (2 * BWD_WIDE_KEY_TILE)) >= BWD_SM_COUNT


def flash_attention_bwd_split_plain(q, k, v, o, lse, do, *, causal=True,
                                    window: int = 0, splits: int = 1,
                                    key_tile: int = BWD_KEY_TILE,
                                    query_tile: int = BWD_QUERY_TILE):
    """The wgmma backward's decomposition in plain fp32: for each key tile
    of ``key_tile`` keys and each of ``splits`` parts of a KV group's heads,
    a dk / dv partial summed over the part's heads and its query tiles; dq
    of each query tile summed from its per-key-tile partials; the parts'
    dk / dv summed after.  Nothing is rounded to bf16 (the kernel rounds P
    and dS for its products): this checks the sums, not the rounding.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, H, S, dh = q.shape
    K = k.shape[1]
    g = H // K
    if g % splits:
        raise ValueError(f"splits {splits} does not divide g {g}")
    gs = g // splits
    scale = dh ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    delta = (dof * of).sum(-1)                       # [B, H, S]
    pos = torch.arange(S, device=q.device)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_parts = torch.zeros((splits,) + tuple(k.shape), dtype=torch.float32,
                           device=q.device)
    dv_parts = torch.zeros_like(dk_parts)
    for t0 in range(0, S, key_tile):
        t1 = min(S, t0 + key_tile)
        q_begin = t0 if causal else 0
        q_end = min(S, t0 + key_tile - 1 + window) if window else S
        qt_begin = q_begin // query_tile * query_tile
        for part in range(splits):
            for hh in range(part * gs, (part + 1) * gs):
                heads = torch.arange(K, device=q.device) * g + hh
                for q0 in range(qt_begin, q_end, query_tile):
                    q1 = min(S, q0 + query_tile)
                    qs = qf[:, heads, q0:q1] * scale    # [B, K, n, dh]
                    dos = dof[:, heads, q0:q1]
                    s = torch.matmul(qs, kf[:, :, t0:t1].transpose(-1, -2))
                    mask = _mask(pos, q0, q1, causal, window)[:, t0:t1]
                    p = torch.where(
                        mask, torch.exp(s - lse[:, heads, q0:q1, None]), 0.0)
                    dp = torch.matmul(dos, vf[:, :, t0:t1].transpose(-1, -2))
                    ds = p * (dp - delta[:, heads, q0:q1, None])
                    dv_parts[part, :, :, t0:t1] += torch.matmul(
                        p.transpose(-1, -2), dos)
                    dk_parts[part, :, :, t0:t1] += torch.matmul(
                        ds.transpose(-1, -2), qs)
                    dq[:, heads, q0:q1] += torch.matmul(
                        ds, kf[:, :, t0:t1]) * scale
    return (dq.to(q.dtype), dk_parts.sum(0).to(k.dtype),
            dv_parts.sum(0).to(v.dtype))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0):
    """The backward kernel on CUDA tensors: (dq, dk, dv) in the inputs'
    dtypes from the forward's output ``o`` and log-sum-exp ``lse`` (fp32
    [B, H, S]) and the output's gradient ``do``."""
    global bwd_launches, last_bwd_variant, last_bwd_splits, last_bwd_pair
    _check(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda, not {q.device}")
    B, H, S, dh = q.shape
    K = k.shape[1]
    variant = flash_bwd_variant(q.dtype, dh)
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, H, S) or lse.dtype != torch.float32 or \
            o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("o and do must be like q, lse fp32 [B, H, S]")
    _check_kernel_inputs("flash_attention_bwd", (q, k, v, o, lse, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    # fp32 scratch: D = rowsum(dO o) and the dq accumulator; the wgmma
    # variant pads rows to its query tile, keeps lse in log2 units beside D,
    # and with a split sums the parts' dk / dv in an accumulator of their own
    wg = variant == "wgmma"
    splits = bwd_split_count(B, H, K, S, dh) if wg else 1
    pair = wg and bwd_pair_key_tiles(B, H, K, S, dh, causal, window)
    rows = -(-S // BWD_QUERY_TILE) * BWD_QUERY_TILE if wg else S
    keys = -(-S // bwd_key_tile(dh)) * bwd_key_tile(dh)

    def scratch(*shape):
        return torch.empty(shape, dtype=torch.float32, device=q.device)
    delta = scratch(B, H, rows)
    lse2 = scratch(B, H, rows) if wg else None
    dq_acc = scratch(B, H, rows, dh)
    dkv_acc = scratch(2, B, K, keys, dh) if splits > 1 else None
    err = build.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(),
        lse2.data_ptr() if wg else None, delta.data_ptr(),
        dq_acc.data_ptr(), dkv_acc.data_ptr() if splits > 1 else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, H, K, S, dh,
        int(causal), int(window), splits, int(pair), float(dh ** -0.5),
        VARIANTS[variant], build.stream_ptr(q.device))
    build.check(err, f"flash_attention_bwd ({variant})")
    bwd_launches += 1
    last_bwd_variant, last_bwd_splits, last_bwd_pair = variant, splits, pair
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the kernels' gradient: the forward keeps q, k, v,
    its output and the rows' log-sum-exp; the backward recomputes the
    weights from them.  CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        grad = any(ctx.needs_input_grad[:3])
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_plain(q, k, v, causal=causal,
                                                 window=window)
        else:
            out, lse = _launch_fwd(q, k, v, causal, window, with_lse=grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, do.contiguous(),
                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, H, S, dh]; k/v: [B, K, S, dh].  Returns [B, H, S, dh] in
    q's dtype, differentiable in q, k and v."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, causal, window)
