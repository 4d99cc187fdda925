"""Mamba-2 SSD chunked scan (forward) over pre-discretized inputs.

``ssd_scan`` launches the CUDA kernel ``csrc/ssd_scan.cu`` (the port of
the Pallas TPU kernel ``kernels/ssd_scan/kernel.py::ssd_scan`` of the
reference) on CUDA tensors and runs ``ssd_scan_plain`` on CPU tensors.

xdt: [Bz, H, S, P] (x * dt); loga: [Bz, H, S] (dt * A, the log-decay);
B/C: [Bz, S, N], shared across the heads.  Returns y [Bz, H, S, P] in
fp32 whatever the input dtype:

    h_t = exp(loga_t) h_{t-1} + xdt_t^T B_t      ([P, N] state per head)
    y_t = h_t C_t

computed chunk by chunk in the dual (quadratic) form.  The plain version
uses the reference kernel's chunk, ``min(128, S)``; the CUDA kernel's is
64 -- the same function up to rounding.  Any S is taken: a partial last
chunk is zero-padded.  The kernel takes P <= 64 and N <= 128, each a
multiple of 4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build

CHUNK = 128           # the plain version's chunk (the Pallas kernel's)
MAX_P, MAX_N = 64, 128

launches = 0          # kernel launches since the caller last zeroed this

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_scan_plain(xdt, loga, B, C, *, chunk: int = CHUNK):
    """Plain PyTorch version of the kernel: the Pallas kernel's per-chunk
    body in a loop over chunks, fp32 throughout."""
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    pad = -S % Q
    xdt, loga = xdt.float(), loga.float()
    Bf, Cf = B.float()[:, None], C.float()[:, None]          # [Bz, 1, S, N]
    if pad:              # zero steps: no decay, no input, no readout
        xdt = F.pad(xdt, (0, 0, 0, pad))
        loga = F.pad(loga, (0, pad))
        Bf = F.pad(Bf, (0, 0, 0, pad))
        Cf = F.pad(Cf, (0, 0, 0, pad))
    ii = torch.arange(Q, device=xdt.device)
    causal = ii[:, None] >= ii[None, :]
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=xdt.device)
    ys = []
    for c0 in range(0, S + pad, Q):
        x = xdt[:, :, c0:c0 + Q]                              # [Bz, H, Q, P]
        cums = torch.cumsum(loga[:, :, c0:c0 + Q], dim=-1)    # [Bz, H, Q]
        b, c = Bf[:, :, c0:c0 + Q], Cf[:, :, c0:c0 + Q]       # [Bz, 1, Q, N]
        G = torch.matmul(c, b.transpose(-1, -2))              # [Bz, 1, Q, Q]
        rel = cums[..., :, None] - cums[..., None, :]
        # exp only below the diagonal: above it rel >= 0 may overflow
        L = torch.exp(torch.where(causal, rel, 0.0)) * causal
        y = torch.matmul(G * L, x)
        y = y + torch.matmul(c, h.transpose(-1, -2)) * \
            torch.exp(cums)[..., None]
        ys.append(y)
        decay_out = torch.exp(cums[..., -1:] - cums)          # [Bz, H, Q]
        h = h * torch.exp(cums[..., -1])[..., None, None] + \
            torch.matmul((x * decay_out[..., None]).transpose(-1, -2), b)
    return torch.cat(ys, dim=2)[:, :, :S]


def _check(xdt, loga, B, C):
    if xdt.dim() != 4:
        raise ValueError("xdt must be [Bz, H, S, P]")
    Bz, H, S, P = xdt.shape
    if loga.shape != (Bz, H, S) or B.dim() != 3 or B.shape[:2] != (Bz, S) \
            or C.shape != B.shape:
        raise ValueError(f"shapes do not fit: xdt {tuple(xdt.shape)}, loga "
                         f"{tuple(loga.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}")
    for t in (loga, B, C):
        if t.device != xdt.device:
            raise ValueError("all tensors must be on one device")
    if any(t.requires_grad for t in (xdt, loga, B, C)):
        raise RuntimeError("ssd_scan is forward-only: it has no backward "
                           "kernel")


def ssd_scan(xdt, loga, B, C):
    """xdt: [Bz, H, S, P]; loga: [Bz, H, S]; B/C: [Bz, S, N].  Returns y
    [Bz, H, S, P] in fp32."""
    global launches
    _check(xdt, loga, B, C)
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, loga, B, C)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {xdt.device}")
    if xdt.dtype not in _DTYPE_CODE or any(t.dtype != xdt.dtype
                                           for t in (loga, B, C)):
        raise TypeError("ssd_scan takes float32 or bfloat16 inputs of one "
                        "dtype")
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    if P % 4 or N % 4 or P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"multiples of 4; got P={P}, N={N}")
    for t in (xdt, loga, B, C):
        if not t.is_contiguous():
            raise ValueError("ssd_scan needs contiguous tensors")
    y = torch.empty((Bz, H, S, P), dtype=torch.float32, device=xdt.device)
    err = build.library().ssd_scan_launch(
        xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), Bz, H, S, P, N, _DTYPE_CODE[xdt.dtype],
        build.stream_ptr(xdt.device))
    build.check(err, "ssd_scan")
    launches += 1
    return y
