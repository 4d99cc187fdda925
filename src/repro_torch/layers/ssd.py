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

from ..distributed.collectives import copy_to_model, model_part, \
    model_size, reduce_from_model, row_parallel, unit_ranges
from ..kernels.ssd_scan.kernel import ssd_scan
from .common import causal_conv, conv_step


def d_inner(cfg):
    return cfg.expand * cfg.d_model


def n_heads(cfg):
    return d_inner(cfg) // cfg.ssm_head_dim


def _causal_conv(u, w, b):
    """Depthwise causal conv1d over [B, S, C]; SiLU in fp32."""
    return F.silu(causal_conv(u, w, b).float()).to(u.dtype)


def _gated_norm(y, z, w, eps=1e-6, mesh=None, whole=None):
    """y * silu(z), RMS-normalised over d_inner, times w.  On a mesh, y is
    this rank's heads: its sum of squares is summed over ``model`` (and
    its cotangent too: the sum feeds every rank's heads) and divided by
    ``whole``, the whole d_inner (a rank's share times the ranks only
    where the heads split evenly)."""
    y = y * F.silu(z.float())
    if mesh is None:
        ms = (y * y).mean(dim=-1, keepdim=True)
    else:
        ssq = reduce_from_model(torch.sum(y * y, dim=-1, keepdim=True), mesh)
        ms = copy_to_model(ssq, mesh) / whole
    y = y * torch.rsqrt(ms + eps)
    return y * w


def mamba2_forward(cfg, p, x, mesh=None):
    """Full-sequence SSD.  x: [B, S, D] -> [B, S, D], differentiable.

    With ``mesh`` (a model axis of more than one rank) this rank's heads
    by the plan (``unit_ranges``, uneven where the heads do not divide):
    in_z / in_x / in_dt, conv_x, dt_bias, A_log, D and norm_w its ranges
    of them (``model_part``: its blocks, or the leaves gathered or
    replicated and sliced), in_bc and conv_bc replicated (B and C feed
    every head), the gated norm's sum of squares summed over ``model``
    and divided by the whole d_inner, out_proj its rows, row-parallel;
    the scan runs on the rank's heads."""
    Bsz, S, D = x.shape
    N, P, Q = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    H = n_heads(cfg)
    if mesh is not None:
        heads = unit_ranges(H, model_size(mesh))
        p = dict(p, **{k: model_part(p[k], -1, H * P, heads, P, mesh)
                       for k in ("in_z", "in_x", "conv_x_w", "conv_x_b",
                                 "norm_w")},
                 **{k: model_part(p[k], -1, H, heads, 1, mesh)
                    for k in ("in_dt", "dt_bias", "A_log", "D")},
                 out_proj=model_part(p["out_proj"], 0, H * P, heads, P,
                                     mesh))
        H = p["A_log"].shape[-1]
    Di = H * P

    h = x if mesh is None else copy_to_model(x, mesh)
    z = torch.matmul(h, p["in_z"])
    xs = torch.matmul(h, p["in_x"])
    bc = torch.matmul(x, p["in_bc"])
    dt = torch.matmul(h, p["in_dt"])
    xs = _causal_conv(xs, p["conv_x_w"], p["conv_x_b"])
    bc = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])
    if mesh is not None:
        bc = copy_to_model(bc, mesh)
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
    y = _gated_norm(y.reshape(Bsz, S, Di), z.float(), p["norm_w"],
                    mesh=mesh, whole=d_inner(cfg)).to(x.dtype)
    if mesh is None:
        return torch.matmul(y, p["out_proj"])
    return row_parallel(y, p["out_proj"], mesh)


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
    # the heads from the weights: a shard of a mesh holds some of them
    N, H, P = cfg.ssm_state, p["A_log"].shape[-1], cfg.ssm_head_dim
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
