"""Rotary position embeddings (RoPE), half-split rotation in fp32."""

from __future__ import annotations

import torch

_freqs: dict = {}      # (head_dim, theta, device) -> the fp32 table


def rope_freqs(head_dim: int, theta: float = 1e4, device=None):
    """The fp32 frequencies [head_dim / 2], built once per (head_dim,
    theta, device) and cached; callers must not write to the table."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (head_dim, float(theta), dev)
    freqs = _freqs.get(key)
    if freqs is None:
        half = head_dim // 2
        freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                        device=dev) / half)
        _freqs[key] = freqs
    return freqs


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4, freqs: torch.Tensor | None = None):
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]; ``freqs``
    defaults to ``rope_freqs(Dh, theta)`` on x's device."""
    dh = x.shape[-1]
    if freqs is None:
        freqs = rope_freqs(dh, theta, x.device)        # [dh/2]
    ang = positions[..., None].float() * freqs         # [..., S, dh/2]
    cos = torch.cos(ang)[..., None, :]                 # [..., S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
