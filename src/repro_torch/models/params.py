"""Seeded parameter init for the dense attention + MLP stack, and the
numpy bridge that takes parameters built elsewhere.

``init_params`` builds the same tree as the reference's
``models.transformer.init_params`` for a dense ``("attn", "mlp")``
pattern — ``units/l0/{norm1, attn/{wq,wk,wv,wo[,bq,bk,bv]}, norm2,
ffn/{wi,wg,wo}}`` stacked over units, plus ``final_norm``, ``embed`` and
``unembed`` — with the same shapes, dtypes and scale rule (normal ×
fan_in^-0.5, embed/unembed d^-0.5, norms ones in fp32, biases zeros).
The numbers come from a ``torch.Generator`` and differ from JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .config import ModelConfig


def param(gen: torch.Generator, shape, dtype, device, scale=None,
          lead: int = 0) -> torch.Tensor:
    """One normal leaf × scale (default fan_in^-0.5); ``lead`` leading
    stack dims are excluded from the fan-in."""
    core = shape[lead:]
    fan_in = core[0] if len(core) >= 2 else max(core[-1], 1)
    s = scale if scale is not None else fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=device)
    # fill row blocks in fp32 so the temporary stays small at full width
    flat = out.view(-1, shape[-1])
    step = max(1, (1 << 26) // shape[-1])
    for i in range(0, flat.shape[0], step):
        n = min(step, flat.shape[0] - i)
        blk = torch.randn((n, shape[-1]), generator=gen, dtype=torch.float32,
                          device=device)
        flat[i:i + n] = (blk * s).to(dtype)
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0) -> dict:
    """Seeded random weights on ``device`` (``cuda`` unless told
    otherwise).  ``generator`` must live on that device; without one, a
    fresh generator seeded with ``seed`` is made there."""
    dev = resolve_device(device)
    if cfg.pattern != (("attn", "mlp"),) or cfg.tie_embeddings \
            or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.name}: the port builds dense untied attn+mlp stacks only")
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    U, d, h, k, dh, f = (cfg.full_units, cfg.d_model, cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim, cfg.d_ff)
    dt = cfg.dtype

    def w(*shape):
        return param(generator, (U,) + shape, dt, dev, lead=1)

    attn = {"wq": w(d, h * dh), "wk": w(d, k * dh), "wv": w(d, k * dh),
            "wo": w(h * dh, d)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", k * dh), ("bv", k * dh)):
            attn[name] = torch.zeros((U, n), dtype=dt, device=dev)
    ffn = {"wi": w(d, f), "wg": w(d, f), "wo": w(f, d)}
    if cfg.mlp != "swiglu":
        del ffn["wg"]
    unit = {"norm1": {"w": torch.ones((U, d), dtype=torch.float32,
                                      device=dev)},
            "attn": attn,
            "norm2": {"w": torch.ones((U, d), dtype=torch.float32,
                                      device=dev)},
            "ffn": ffn}
    emb_scale = 1.0 / (d ** 0.5)
    return {
        "units": {"l0": unit},
        "final_norm": {"w": torch.ones((d,), dtype=torch.float32,
                                       device=dev)},
        "embed": param(generator, (cfg.vocab_size, d), dt, dev,
                       scale=emb_scale),
        "unembed": param(generator, (cfg.vocab_size, d), dt, dev,
                         scale=emb_scale),
    }


def _leaf_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the bits (bit-exact)
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.uint16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def from_numpy_tree(tree, device="cpu"):
    """Nested dict of numpy arrays (bf16 included) → same tree of
    tensors on ``device``.  The caller turns its arrays into numpy."""
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree).to(device)

