"""Gradient compression with error feedback (int8 per-leaf scaling).

Port of the reference's ``distributed/compression.py``: the codec runs as
a pre-optimizer transform, q = Q(g + r); r = (g + r) - q, with one fp32
scale a leaf (max |x| / 127) and round-half-to-even, so it gives the
reference's bits.  On a multi-device run the int8 payload is what an
all-reduce would carry (4x fewer bytes than fp32); here, on one device,
it quantizes at the gradient boundary, as the reference does.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


def _quantize(x: torch.Tensor):
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class Int8ErrorFeedback:
    """Stateful codec: residuals carry quantization error to the next step."""

    def __init__(self, params_like):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def __call__(self, grads):
        out, res = [], []
        for (_, g), (_, r) in zip(tree_leaves(grads),
                                  tree_leaves(self.residual)):
            x = g.float() + r
            dq = _dequantize(*_quantize(x))
            out.append(dq)
            res.append(x - dq)
        self.residual = tree_unflatten(self.residual, res)
        return tree_unflatten(grads, out)


def compression_ratio(params_like, from_dtype=torch.float32) -> float:
    bits_from = from_dtype.itemsize * 8
    return bits_from / 8.0
