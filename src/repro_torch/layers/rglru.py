"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Port of the reference's ``layers/rglru.py``: input and gate-branch
projections, a depthwise causal convolution, the recurrence and input
gates, the elementwise linear recurrence h_t = a_t * h_{t-1} + b_t, and
the GELU-gated output projection.

The reference runs the full-sequence recurrence as
``lax.associative_scan`` (log depth).  Here it is ``linear_scan``, a
doubling scan in plain PyTorch: ceil(log2 S) passes of
``b[t] += a[t] * b[t - d]``, ``a[t] *= a[t - d]`` for d = 1, 2, 4, ...,
each pass a few launches over the whole [B, S, W] tensor rather than one
launch a position.  It is not a Pallas kernel in the reference, so plain
PyTorch is its port.  ``rglru_decode`` is the one-token update of the
layer; the decode step runs ``serving.tp_layers.rglru_decode_tp``, which
rounds as the reference's decode step does.

On a mesh of the sharded train step (a ``model`` axis of more than one
rank) ``rglru_forward(..., mesh=)`` runs this rank's channels of the
width by the plan (``unit_ranges``; uneven where ``lru_width`` does not
divide): in_x / in_g their columns, conv_w / conv_b / lam their range,
the scan on those channels, ``out`` its rows, row-parallel.  The gates
read every channel of the convolved input: it is gathered over ``model``
(``gather_model`` by the plan's ranges) and multiplies wa / wx's columns
of the rank's channels.  The other way, wa / wx gathered and
row-parallel with the pre-activations summed (as the decode step does
for one token), moves more at a training step's length.  At
recurrentgemma-9b's width (W 4096) and 4096 tokens, a layer a step: the
two gate matrices are 64 MB in bf16, gathered twice under the remat, and
their fp32 gradients summed (128 MB), and the [B, S, 2W] fp32
pre-activations are summed twice forward and once back (128 MB each):
~640 MB.  The input is 32 MB in bf16, gathered twice, and its fp32
cotangent summed once (64 MB): ~128 MB.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.collectives import copy_to_model, gather_model, \
    model_part, model_size, row_parallel, unit_ranges
from .common import causal_conv, conv_step

C = 8.0   # Griffin's fixed exponent scale


def gate_coeffs(p, ga, gi, xf):
    """a_t and b_t (fp32) from the gate pre-activations ``ga`` / ``gi``
    and the fp32 input ``xf`` the input gate multiplies."""
    r = torch.sigmoid(ga.float())
    i = torch.sigmoid(gi.float())
    a = torch.exp(-C * r * F.softplus(p["lam"]))         # a_t in (0, 1)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _gates(p, x):
    return gate_coeffs(p, torch.matmul(x, p["wa"]), torch.matmul(x, p["wx"]),
                       x.float())


def linear_scan(a, b, dim: int = 1):
    """h_t = a_t * h_{t-1} + b_t along ``dim`` (h_{-1} = 0), by doubling:
    after the pass with stride d, (a[t], b[t]) composes the steps
    t - 2d + 1 .. t, so ceil(log2 S) passes leave b = h."""
    S = a.shape[dim]
    d = 1
    while d < S:
        a_hi, a_lo = a.narrow(dim, d, S - d), a.narrow(dim, 0, S - d)
        b_hi, b_lo = b.narrow(dim, d, S - d), b.narrow(dim, 0, S - d)
        b = torch.cat([b.narrow(dim, 0, d), b_hi + a_hi * b_lo], dim)
        if 2 * d < S:
            a = torch.cat([a.narrow(dim, 0, d), a_hi * a_lo], dim)
        d *= 2
    return b


def rglru_forward(cfg, p, x, mesh=None):
    """x: [B, S, D] -> [B, S, D].  With ``mesh``, this rank's channels
    (``rglru_tp``)."""
    if mesh is not None:
        return rglru_tp(cfg, p, x, mesh)
    xr = torch.matmul(x, p["in_x"])
    xg = torch.matmul(x, p["in_g"])
    xr = causal_conv(xr, p["conv_w"], p["conv_b"]).to(x.dtype)
    a, b = _gates(p, xr)
    h = linear_scan(a, b, dim=1)
    y = h * F.gelu(xg.float(), approximate="tanh")
    return torch.matmul(y.to(x.dtype), p["out"])


def rglru_tp(cfg, p, x, mesh):
    """This model rank's channels of the layer (see the module's
    docstring); ``p`` its leaves gathered over ``data``, ``x``
    replicated over ``model``."""
    W = cfg.lru_width
    ch = unit_ranges(W, model_size(mesh))
    loc = {k: model_part(p[k], -1, W, ch, 1, mesh)
           for k in ("in_x", "in_g", "conv_w", "conv_b", "lam", "wa", "wx")}
    out = model_part(p["out"], 0, W, ch, 1, mesh)
    h = copy_to_model(x, mesh)
    xr = torch.matmul(h, loc["in_x"])
    xg = torch.matmul(h, loc["in_g"])
    xr = causal_conv(xr, loc["conv_w"], loc["conv_b"]).to(x.dtype)
    whole = gather_model(xr, -1, mesh, ch)
    a, b = gate_coeffs(loc, torch.matmul(whole, loc["wa"]),
                       torch.matmul(whole, loc["wx"]), xr.float())
    h = linear_scan(a, b, dim=1)
    y = h * F.gelu(xg.float(), approximate="tanh")
    return row_parallel(y.to(x.dtype), out, mesh)


def rglru_init_state(cfg, batch: int, device=None) -> dict:
    """Zero recurrent state: h [B, W] and the last conv_width - 1 inputs
    [B, conv_width - 1, W], fp32."""
    W = cfg.lru_width
    return {"h": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, W),
                                dtype=torch.float32, device=device)}


def rglru_decode(cfg, p, x, state):
    """Single-token update.  x: [B, D] -> ([B, D], state')."""
    xr = torch.matmul(x, p["in_x"]).float()
    xg = torch.matmul(x, p["in_g"])
    hist = torch.cat([state["conv"], xr[:, None, :]], dim=1)
    conv = conv_step(hist, p["conv_w"], p["conv_b"]).to(x.dtype)
    a, b = _gates(p, conv)
    h = a * state["h"] + b
    y = h * F.gelu(xg.float(), approximate="tanh")
    out = torch.matmul(y.to(x.dtype), p["out"])
    return out, {"h": h, "conv": hist[:, 1:, :]}
