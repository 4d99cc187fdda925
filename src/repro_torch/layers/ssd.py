"""Mamba-2 (SSD, state-space duality) over a full sequence (forward).

Port of the reference's ``layers/ssd.py`` forward half: split input
projections (z | x | BC | dt), depthwise causal convolutions, the chunked
SSD scan, the D skip and the gated RMS norm.  On a CUDA tensor the scan
is the ``ssd_scan`` kernel; on a CPU tensor it is ``ssd_chunked``, the
reference's own chunked form (also the tests' oracle).  The one-token
decode half is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.kernel import ssd_scan


def d_inner(cfg):
    return cfg.expand * cfg.d_model


def n_heads(cfg):
    return d_inner(cfg) // cfg.ssm_head_dim


def _causal_conv(u, w, b):
    """Depthwise causal conv1d over [B, S, C]; SiLU in fp32."""
    W = w.shape[0]
    pad = F.pad(u, (0, 0, W - 1, 0))
    out = pad[:, 0:u.shape[1]] * w[0]
    for k in range(1, W):
        out = out + pad[:, k:k + u.shape[1]] * w[k]
    return F.silu((out + b).float()).to(u.dtype)


def _gated_norm(y, z, w, eps=1e-6):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    return y * w


def ssd_chunked(cfg, xdt, loga, Bc, Cc, h0=None):
    """Chunked SSD over pre-discretized inputs.

    xdt:  [B, nc, Q, H, P] (x * dt, fp32)
    loga: [B, nc, Q, H]    (dt * A, fp32 log-decay)
    Bc/Cc:[B, nc, Q, N]
    Returns (y [B, nc, Q, H, P], h_final [B, H, P, N]).
    """
    Bsz, nc, Q, H, P = xdt.shape
    N = Bc.shape[-1]
    cums = torch.cumsum(loga, dim=2)
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    rel = cums[:, :, :, None, :] - cums[:, :, None, :, :]
    ii = torch.arange(Q, device=xdt.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # exp only below the diagonal: above it rel >= 0 may overflow
    L = torch.exp(torch.where(causal, rel, 0.0)) * causal
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", G[..., None] * L, xdt)

    decay_out = torch.exp(cums[:, :, -1:, :] - cums)
    chunk_state = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, decay_out, xdt)
    chunk_decay = torch.exp(cums[:, :, -1, :])

    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                    device=xdt.device) if h0 is None else h0
    h_ins = []
    for c in range(nc):
        h_ins.append(h)
        h = h * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    h_ins = torch.stack(h_ins, dim=1)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, h_ins,
                           torch.exp(cums))
    return y_intra + y_inter, h


def mamba2_forward(cfg, p, x):
    """Full-sequence SSD.  x: [B, S, D] -> [B, S, D]."""
    Bsz, S, D = x.shape
    Di, N, H, P = d_inner(cfg), cfg.ssm_state, n_heads(cfg), cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q

    z = torch.matmul(x, p["in_z"])
    xs = torch.matmul(x, p["in_x"])
    bc = torch.matmul(x, p["in_bc"])
    dt = torch.matmul(x, p["in_dt"])
    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    Bm, Cm = bc[..., :N], bc[..., N:]

    dt = F.softplus(dt.float() + p["dt_bias"])               # [B, S, H]
    A = -torch.exp(p["A_log"])
    loga = dt * A
    xh = xs.reshape(Bsz, S, H, P).float()
    xdt = xh * dt[..., None]
    if x.device.type == "cuda":
        y = ssd_scan(xdt.transpose(1, 2).contiguous(),
                     loga.transpose(1, 2).contiguous(),
                     Bm.float().contiguous(), Cm.float().contiguous())
        y = y.transpose(1, 2)                                 # [B, S, H, P]
    else:
        y, _ = ssd_chunked(cfg, xdt.reshape(Bsz, nc, Q, H, P),
                           loga.reshape(Bsz, nc, Q, H),
                           Bm.reshape(Bsz, nc, Q, N).float(),
                           Cm.reshape(Bsz, nc, Q, N).float())
        y = y.reshape(Bsz, S, H, P)
    y = y + p["D"][None, None, :, None] * xh
    y = _gated_norm(y.reshape(Bsz, S, Di), z.float(), p["norm_w"])
    return torch.matmul(y.to(x.dtype), p["out_proj"])
