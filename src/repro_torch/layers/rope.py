"""Rotary position embeddings (RoPE), half-split rotation in fp32."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)            # [dh/2]
    ang = positions[..., None].float() * freqs         # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                 # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
