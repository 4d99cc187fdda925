"""Seeded parameter init, and the numpy bridge that takes parameters
built elsewhere.

``init_params`` builds the same tree as the reference's
``models.transformer.init_params`` for any pattern of ``attn`` /
``local_attn`` / ``mamba2`` / ``rglru`` mixers with ``mlp`` / ``moe`` /
``none`` feed-forward: ``units/l{i}/{norm1, attn|ssd|rglru, norm2, ffn}``
stacked over the pattern's full units, ``tail/t{i}`` for the remainder,
``final_norm``, ``embed`` and ``unembed`` (absent when the embeddings are
tied) -- with the same shapes, dtypes and scale rule (normal x
fan_in^-0.5, embed/unembed d^-0.5, conv taps width^-0.5, norms ones in
fp32, biases zeros, the SSD ``A_log``/``D``/``dt_bias``/``norm_w``, the
RG-LRU ``lam`` (2.0) and the MoE ``router`` in fp32).  The numbers come
from a ``torch.Generator`` and differ from JAX's.
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


def _norm(cfg: ModelConfig, lead: tuple, dev) -> dict:
    d = cfg.d_model
    p = {"w": torch.ones(lead + (d,), dtype=torch.float32, device=dev)}
    if cfg.norm != "rmsnorm":
        p["b"] = torch.zeros(lead + (d,), dtype=torch.float32, device=dev)
    return p


def _init_layer(cfg: ModelConfig, spec, gen, lead: tuple, dev) -> dict:
    """One layer's parameters, each leaf with the leading dims ``lead``
    (the stacked units) excluded from its fan-in."""
    mixer, ffn = spec
    dt = cfg.dtype

    def w(*shape, scale=None):
        return param(gen, lead + shape, dt, dev, scale=scale,
                     lead=len(lead))

    def const(n, value, dtype):
        return torch.full(lead + (n,), value, dtype=dtype, device=dev)

    p = {"norm1": _norm(cfg, lead, dev)}
    if mixer in ("attn", "local_attn"):
        d, h, k, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
        a = {"wq": w(d, h * dh), "wk": w(d, k * dh), "wv": w(d, k * dh),
             "wo": w(h * dh, d)}
        if cfg.qkv_bias:
            for name, n in (("bq", h * dh), ("bk", k * dh), ("bv", k * dh)):
                a[name] = const(n, 0, dt)
        p["attn"] = a
    elif mixer == "mamba2":
        D, N, W = cfg.d_model, cfg.ssm_state, cfg.conv_width
        Di = cfg.expand * D
        H = Di // cfg.ssm_head_dim
        f32 = torch.float32
        p["ssd"] = {
            "in_z": w(D, Di), "in_x": w(D, Di), "in_bc": w(D, 2 * N),
            "in_dt": w(D, H),
            "conv_x_w": w(W, Di, scale=W ** -0.5),
            "conv_x_b": const(Di, 0, dt),
            "conv_bc_w": w(W, 2 * N, scale=W ** -0.5),
            "conv_bc_b": const(2 * N, 0, dt),
            "A_log": const(H, 0, f32), "D": const(H, 1, f32),
            "dt_bias": const(H, 0, f32), "norm_w": const(Di, 1, f32),
            "out_proj": w(Di, D),
        }
    elif mixer == "rglru":
        D, W, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
        p["rglru"] = {
            "in_x": w(D, W), "in_g": w(D, W),
            "conv_w": w(cw, W, scale=cw ** -0.5), "conv_b": const(W, 0, dt),
            "wa": w(W, W), "wx": w(W, W),
            "lam": const(W, 2.0, torch.float32), "out": w(W, D),
        }
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "mlp":
        d, f = cfg.d_model, cfg.d_ff
        p["norm2"] = _norm(cfg, lead, dev)
        p["ffn"] = {"wi": w(d, f), "wg": w(d, f), "wo": w(f, d)}
        if cfg.mlp != "swiglu":
            del p["ffn"]["wg"]
    elif ffn == "moe":
        # the reference's init_moe: its fan-in is shape[0], so the experts
        # are scaled by (E + pad)^-0.5, and the padded experts are random
        # too (ROADMAP C13)
        d, f = cfg.d_model, cfg.d_ff
        ep = cfg.num_experts + cfg.expert_pad
        p["norm2"] = _norm(cfg, lead, dev)
        moe = {"router": param(gen, lead + (d, cfg.num_experts),
                               torch.float32, dev, lead=len(lead)),
               "wi": w(ep, d, f)}
        if cfg.mlp == "swiglu":
            moe["wg"] = w(ep, d, f)
        moe["wo"] = w(ep, f, d)
        p["ffn"] = moe
    elif ffn != "none":
        raise ValueError(f"unknown feed-forward {ffn!r}")
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0) -> dict:
    """Seeded random weights on ``device`` (``cuda`` unless told
    otherwise).  ``generator`` must live on that device; without one, a
    fresh generator seeded with ``seed`` is made there."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    U, d = cfg.full_units, cfg.d_model
    units = {f"l{i}": _init_layer(cfg, spec, generator, (U,), dev)
             for i, spec in enumerate(cfg.pattern)}
    params = {"units": units}
    if cfg.tail_specs:
        params["tail"] = {f"t{i}": _init_layer(cfg, spec, generator, (), dev)
                          for i, spec in enumerate(cfg.tail_specs)}
    params["final_norm"] = _norm(cfg, (), dev)
    emb_scale = 1.0 / (d ** 0.5)
    params["embed"] = param(generator, (cfg.vocab_size, d), cfg.dtype, dev,
                            scale=emb_scale)
    if not cfg.tie_embeddings:
        params["unembed"] = param(generator, (cfg.vocab_size, d), cfg.dtype,
                                  dev, scale=emb_scale)
    return params


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

