"""Mamba-2 (SSD, state-space duality) over a full sequence, and its decode.

Port of the reference's ``layers/ssd.py``: split input projections
(z | x | BC | dt), depthwise causal convolutions, the chunked SSD scan,
the D skip and the gated RMS norm.  The scan is ``ssd_scan``, an autograd
Function: on a CUDA tensor the ``ssd_scan`` kernel forward and the
``ssd_scan_bwd`` kernel backward (chunk 64); on a CPU tensor the plain
versions of both at ``cfg.ssm_chunk`` (``ssd_phases``, the reference's
``ssd_chunked`` computed in the kernel's phases, and
``ssd_scan_bwd_plain``).  The rest of the layer is plain PyTorch under
autograd, as the reference computes it outside any Pallas kernel.
``mamba2_decode`` is the one-token recurrent update of the layer (the
reference writes it in ``jnp``, no kernel); the decode step runs
``serving.tp_layers.mamba2_decode_tp``, which normalizes as the
reference's decode step does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan.kernel import ssd_scan
from .common import causal_conv, conv_step


def d_inner(cfg):
    return cfg.expand * cfg.d_model


def n_heads(cfg):
    return d_inner(cfg) // cfg.ssm_head_dim


def _causal_conv(u, w, b):
    """Depthwise causal conv1d over [B, S, C]; SiLU in fp32."""
    return F.silu(causal_conv(u, w, b).float()).to(u.dtype)


def _gated_norm(y, z, w, eps=1e-6):
    y = y * F.silu(z.float())
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + eps)
    return y * w


def mamba2_forward(cfg, p, x):
    """Full-sequence SSD.  x: [B, S, D] -> [B, S, D], differentiable."""
    Bsz, S, D = x.shape
    Di, N, H, P = d_inner(cfg), cfg.ssm_state, n_heads(cfg), cfg.ssm_head_dim
    Q = cfg.ssm_chunk
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")

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
    y = ssd_scan(xdt.transpose(1, 2).contiguous(),
                 loga.transpose(1, 2).contiguous(),
                 Bm.float().contiguous(), Cm.float().contiguous(), chunk=Q)
    y = y.transpose(1, 2)                                     # [B, S, H, P]
    y = y + p["D"][None, None, :, None] * xh
    y = _gated_norm(y.reshape(Bsz, S, Di), z.float(), p["norm_w"])
    return torch.matmul(y.to(x.dtype), p["out_proj"])


def mamba2_init_state(cfg, batch: int, device=None) -> dict:
    """Zero recurrent state, fp32: the SSM state h [B, H, P, N] and the
    last conv_width - 1 inputs of both convolutions."""
    Di, N, H, P = d_inner(cfg), cfg.ssm_state, n_heads(cfg), cfg.ssm_head_dim
    W = cfg.conv_width - 1
    f32 = torch.float32
    return {"h": torch.zeros((batch, H, P, N), dtype=f32, device=device),
            "conv_x": torch.zeros((batch, W, Di), dtype=f32, device=device),
            "conv_bc": torch.zeros((batch, W, 2 * N), dtype=f32,
                                   device=device)}


def mamba2_step(cfg, p, x, state):
    """The recurrence of one token, shared by the layer and the decode
    step: x [B, D] -> (y [B, Di] fp32 before the gated norm, z, the new
    state)."""
    Bsz = x.shape[0]
    N, H, P = cfg.ssm_state, n_heads(cfg), cfg.ssm_head_dim
    z = torch.matmul(x, p["in_z"])
    xs = torch.matmul(x, p["in_x"]).float()
    bc = torch.matmul(x, p["in_bc"]).float()
    dt = torch.matmul(x, p["in_dt"])
    hist_x = torch.cat([state["conv_x"], xs[:, None, :]], dim=1)
    hist_bc = torch.cat([state["conv_bc"], bc[:, None, :]], dim=1)
    cx = F.silu(conv_step(hist_x, p["conv_x_w"], p["conv_x_b"]))
    cbc = F.silu(conv_step(hist_bc, p["conv_bc_w"], p["conv_bc_b"]))
    Bm, Cm = cbc[:, :N], cbc[:, N:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = torch.exp(dt * -torch.exp(p["A_log"]))                   # [B, H]
    xh = cx.reshape(Bsz, H, P)
    h = (state["h"] * a[:, :, None, None]
         + (xh * dt[:, :, None])[..., None] * Bm[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", Cm, h) + p["D"][None, :, None] * xh
    return y.reshape(Bsz, -1), z, {"h": h, "conv_x": hist_x[:, 1:],
                                   "conv_bc": hist_bc[:, 1:]}


def mamba2_decode(cfg, p, x, state):
    """Single-token recurrent update.  x: [B, D] -> ([B, D], state')."""
    y, z, new = mamba2_step(cfg, p, x, state)
    y = _gated_norm(y, z.float(), p["norm_w"])
    return torch.matmul(y.to(x.dtype), p["out_proj"]), new
