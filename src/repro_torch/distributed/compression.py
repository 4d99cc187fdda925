"""Gradient compression with error feedback (int8 per-leaf scaling).

Port of the reference's ``distributed/compression.py``: the codec runs as
a pre-optimizer transform, q = Q(g + r); r = (g + r) - q, with one fp32
scale a leaf (max |x| / 127) and round-half-to-even, so it gives the
reference's bits.  On a multi-device run the int8 payload is what an
all-reduce would carry (4x fewer bytes than fp32); here, on one device,
it quantizes at the gradient boundary, as the reference does.

On a mesh (``Int8ErrorFeedback(blocks, mesh=)``) the gradients are this
rank's blocks; each leaf's scale comes from the leaf's global max (the
reference quantizes whole leaves): the blocks' maxima of every leaf are
maxed over the whole mesh in one collective (a block replicated over an
axis has the same maximum on each of its ranks).  The residual stays per
block.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten
from .mesh import axis_names, pmax


def _quantize(x: torch.Tensor, amax: torch.Tensor | None = None):
    """(q, scale) of x, the scale from ``amax`` (x's max |x| by
    default)."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    amax = amax + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class Int8ErrorFeedback:
    """Stateful codec: residuals carry quantization error to the next step."""

    def __init__(self, params_like, mesh=None):
        self.mesh = mesh
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def __call__(self, grads):
        out, res = [], []
        xs = [g.float() + r for (_, g), (_, r) in
              zip(tree_leaves(grads), tree_leaves(self.residual))]
        amax = [None] * len(xs)
        if self.mesh is not None:
            amax = pmax(torch.stack([torch.max(torch.abs(x)) for x in xs]),
                        self.mesh, axis_names(self.mesh)).unbind(0)
        for x, a in zip(xs, amax):
            dq = _dequantize(*_quantize(x, a))
            out.append(dq)
            res.append(x - dq)
        self.residual = tree_unflatten(self.residual, res)
        return tree_unflatten(grads, out)


def compression_ratio(params_like, from_dtype=torch.float32) -> float:
    bits_from = from_dtype.itemsize * 8
    return bits_from / 8.0
