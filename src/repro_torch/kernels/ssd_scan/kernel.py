"""Mamba-2 SSD chunked scan (forward) over pre-discretized inputs.

``ssd_scan`` launches the CUDA kernel ``csrc/ssd_scan.cu`` (the port of
the Pallas TPU kernel ``kernels/ssd_scan/kernel.py::ssd_scan`` of the
reference) on CUDA tensors and runs ``ssd_scan_plain`` on CPU tensors.

xdt: [Bz, H, S, P] (x * dt); loga: [Bz, H, S] (dt * A, the log-decay);
B/C: [Bz, S, N], shared across the heads.  Returns y [Bz, H, S, P] in
fp32 whatever the input dtype:

    h_t = exp(loga_t) h_{t-1} + xdt_t^T B_t      ([P, N] state per head)
    y_t = h_t C_t

computed chunk by chunk in the dual (quadratic) form, split the way the
CUDA kernel splits it (``ssd_phases``): chunk-local quantities for every
chunk at once (C B^T once per batch and chunk, the intra-chunk outputs,
each chunk's own state dH), then the state pass over the chunks in order,
then the outputs from the incoming states.  The chunk is 64, the layer's
``ssm_chunk`` and the kernel's (the Pallas kernel's is 128 -- the same
function up to rounding).  Any S is taken: a partial last chunk is
zero-padded.  The kernel takes P <= 64 and N <= 128, each a multiple of 8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import build

CHUNK = 64            # the kernel's chunk (kQ in csrc/ssd_scan.cu)
MAX_P, MAX_N = 64, 128

launches = 0          # kernel launches since the caller last zeroed this

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ssd_phases(xdt, loga, B, C, *, chunk: int = CHUNK, h0=None):
    """The scan in the kernel's three phases, plain PyTorch, fp32.

    xdt [Bz, H, S, P], loga [Bz, H, S], B/C [Bz, S, N]; ``h0`` [Bz, H, P,
    N] or None for zeros.  Returns (y [Bz, H, S, P], h_final [Bz, H, P,
    N]), both fp32.
    """
    Bz, H, S, P = xdt.shape
    N = B.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    # zero steps past S: no decay, no input, no readout
    x = F.pad(xdt.float(), (0, 0, 0, pad)).reshape(Bz, H, nc, Q, P)
    la = F.pad(loga.float(), (0, pad)).reshape(Bz, H, nc, Q)
    Bf = F.pad(B.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)
    Cf = F.pad(C.float(), (0, 0, 0, pad)).reshape(Bz, 1, nc, Q, N)

    # 1. chunk-local, every chunk at once (the kernel's chunk-parallel part)
    cums = torch.cumsum(la, dim=-1)                          # [Bz,H,nc,Q]
    G = torch.matmul(Cf, Bf.transpose(-1, -2))               # [Bz,1,nc,Q,Q]
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    rel = cums[..., :, None] - cums[..., None, :]
    # exp only below the diagonal: above it rel >= 0 may overflow
    L = torch.exp(torch.where(causal, rel, 0.0)) * causal
    y = torch.matmul(G * L, x)                               # y_intra
    decay_out = torch.exp(cums[..., -1:] - cums)             # [Bz,H,nc,Q]
    dH = torch.matmul((x * decay_out[..., None]).transpose(-1, -2), Bf)
    ecum = torch.exp(cums)

    # 2. the state pass, in chunk order (the kernel's sequential part)
    h = torch.zeros((Bz, H, P, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = h * ecum[:, :, c, -1, None, None] + dH[:, :, c]
    h_in = torch.stack(h_ins, dim=2)                         # [Bz,H,nc,P,N]

    # 3. the outputs from the incoming states
    y = y + torch.matmul(Cf, h_in.transpose(-1, -2)) * ecum[..., None]
    return y.reshape(Bz, H, nc * Q, P)[:, :, :S], h


def ssd_scan_plain(xdt, loga, B, C, *, chunk: int = CHUNK):
    """Plain PyTorch version of the kernel (``ssd_phases``), fp32."""
    return ssd_phases(xdt, loga, B, C, chunk=chunk)[0]


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
    if P % 8 or N % 8 or P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"multiples of 8; got P={P}, N={N}")
    for t in (xdt, loga, B, C):
        if not t.is_contiguous():
            raise ValueError("ssd_scan needs contiguous tensors")
    nc = -(-S // CHUNK)
    y = torch.empty((Bz, H, S, P), dtype=torch.float32, device=xdt.device)
    # scratch: each chunk's own state and exp(cums), written by the
    # chunk-parallel kernel and read once by the state pass
    dH = torch.empty((Bz, H, nc, P, N), dtype=torch.float32,
                     device=xdt.device)
    ecum = torch.empty((Bz, H, nc, CHUNK), dtype=torch.float32,
                       device=xdt.device)
    err = build.library().ssd_scan_launch(
        xdt.data_ptr(), loga.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), dH.data_ptr(), ecum.data_ptr(), Bz, H, S, P, N,
        _DTYPE_CODE[xdt.dtype], build.stream_ptr(xdt.device))
    build.check(err, "ssd_scan")
    launches += 1
    return y
