"""Full-sequence attention forward (GQA, causal or not, sliding window).

``flash_attention`` launches the CUDA kernel ``csrc/flash_attention.cu``
(the port of the Pallas TPU kernel
``kernels/flash_attention/kernel.py::flash_attention`` of the reference)
on CUDA tensors and runs ``flash_attention_plain`` on CPU tensors.

q: [B, H, S, dh]; k/v: [B, K, S, dh] with H % K == 0 (query head h reads
KV head h // (H // K)).  Scores and softmax in fp32 with q scaled in fp32;
key t is visible to query s iff t <= s (causal) and t > s - window (with
a window); the output is acc / max(l, 1e-20) in q's dtype.  Any S is
taken: the kernel masks a partial last tile.  Three kernel variants, chosen
by dtype and head_dim only (``flash_variant``): bf16 at head_dim 64 or 128
runs the Hopper kernel (``wgmma`` + TMA, warp-specialised), bf16 at the
other multiples of 16 up to 256 the ``mma.sync`` kernel (above 128 with Q
kept in shared memory: nemotron-4-340b's 192, recurrentgemma-9b's 256),
fp32 an FMA kernel (multiples of 16 up to 256); other head dims raise.
"""

from __future__ import annotations

import torch

from .. import build

NEG_INF = -1e30
MAX_HEAD_DIM = 256

launches = 0          # kernel launches since the caller last zeroed this
last_variant = None   # the variant the last launch ran

# the C entry point's ``variant`` codes
VARIANTS = {"fma": 0, "mma_sync": 1, "wgmma": 2}
WGMMA_HEAD_DIMS = (64, 128)


def flash_variant(dtype, head_dim: int) -> str:
    """The kernel variant for a dtype and head_dim: ``"wgmma"`` (bf16,
    head_dim 64 or 128), ``"mma_sync"`` (bf16, another multiple of 16 up
    to 256) or ``"fma"`` (fp32, a multiple of 16 up to 256).  Raises for what no variant takes."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{dtype}")
    if head_dim % 16 or not 0 < head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes a head_dim that is a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}, not {head_dim}")
    if dtype == torch.float32:
        return "fma"
    return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          block_q: int = 1024):
    """Plain PyTorch version of the kernel: dense fp32 scores and softmax
    for ``block_q`` query rows at a time (bounds the score buffer)."""
    B, H, S, dh = q.shape
    K = k.shape[1]
    g = H // K
    kf = k.float()[:, :, None]                       # [B, K, 1, S, dh]
    vf = v.float()[:, :, None]
    kpos = torch.arange(S, device=q.device)
    out = torch.empty_like(q)
    for s0 in range(0, S, block_q):
        s1 = min(S, s0 + block_q)
        qg = q[:, :, s0:s1].reshape(B, K, g, s1 - s0, dh).float() \
            * (dh ** -0.5)
        s = torch.matmul(qg, kf.transpose(-1, -2))  # [B, K, g, bq, S]
        qpos = kpos[s0:s1, None]
        mask = torch.ones((s1 - s0, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None] <= qpos
        if window:
            mask &= kpos[None] > qpos - window
        s = torch.where(mask, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        l = e.sum(dim=-1, keepdim=True)
        o = torch.matmul(e, vf) / torch.clamp(l, min=1e-20)
        out[:, :, s0:s1] = o.reshape(B, H, s1 - s0, dh).to(q.dtype)
    return out


# A bf16 output is held to the plain version row by row: the largest
# difference in a query row over that row's rms.  Rows shrink as they see
# more keys (about sqrt(e / i) at row i for unit-normal inputs), so a flat
# limit that fits the first rows says nothing of the late ones.  2^-4 is
# one bf16 ulp (2^-7 relative) at an element 8 times the row's rms.
BF16_ROW_TOL = 2.0 ** -4


def row_scaled_error(got, want) -> float:
    """Max over query rows of max |got - want| / rms(want), both taken
    along head_dim."""
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean(-1).sqrt()
    return float((diff / rms.clamp(min=1e-30)).max())


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
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention is forward-only: it has no "
                           "backward kernel")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, H, S, dh]; k/v: [B, K, S, dh].  Returns [B, H, S, dh] in
    q's dtype."""
    global launches, last_variant
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    B, H, S, dh = q.shape
    variant = flash_variant(q.dtype, dh)
    for t in (q, k, v):
        if not t.is_contiguous():
            raise ValueError("flash_attention needs contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("flash_attention reads 16-byte rows: tensors "
                             "must be 16-byte aligned")
    out = torch.empty_like(q)
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
        k.shape[1], S, dh, int(causal), int(window), float(dh ** -0.5),
        VARIANTS[variant], build.stream_ptr(q.device))
    build.check(err, f"flash_attention ({variant})")
    launches += 1
    last_variant = variant
    return out
