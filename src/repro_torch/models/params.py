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
from a ``torch.Generator`` and differ from JAX's.  ``keep`` sees each
leaf as it is made, so a rank of a mesh keeps only its block of it
(``distributed/specs.py``) and never holds the whole tree.
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
    if out.is_meta:                    # shapes only: nothing to draw
        return out
    # fill row blocks in fp32 so the temporary stays small at full width
    flat = out.view(-1, shape[-1])
    step = max(1, (1 << 26) // shape[-1])
    for i in range(0, flat.shape[0], step):
        n = min(step, flat.shape[0] - i)
        blk = torch.randn((n, shape[-1]), generator=gen, dtype=torch.float32,
                          device=device)
        flat[i:i + n] = (blk * s).to(dtype)
    return out


def _norm(cfg: ModelConfig, lead: tuple, dev, keep, path: str) -> dict:
    d = cfg.d_model
    p = {"w": keep(f"{path}/w", torch.ones(lead + (d,), dtype=torch.float32,
                                           device=dev))}
    if cfg.norm != "rmsnorm":
        p["b"] = keep(f"{path}/b", torch.zeros(
            lead + (d,), dtype=torch.float32, device=dev))
    return p


def _init_layer(cfg: ModelConfig, spec, gen, lead: tuple, dev, keep=None,
                path: str = "") -> dict:
    """One layer's parameters, each leaf with the leading dims ``lead``
    (the stacked units) excluded from its fan-in, and passed through
    ``keep(path, leaf)`` as it is made."""
    mixer, ffn = spec
    dt = cfg.dtype
    keep = keep or _keep_all

    def w(name, *shape, scale=None, dtype=dt):
        return keep(f"{path}/{name}", param(gen, lead + shape, dtype, dev,
                                            scale=scale, lead=len(lead)))

    def const(name, n, value, dtype=dt):
        return keep(f"{path}/{name}", torch.full(lead + (n,), value,
                                                 dtype=dtype, device=dev))

    p = {"norm1": _norm(cfg, lead, dev, keep, f"{path}/norm1")}
    if mixer in ("attn", "local_attn"):
        d, h, k, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim)
        a = {"wq": w("attn/wq", d, h * dh), "wk": w("attn/wk", d, k * dh),
             "wv": w("attn/wv", d, k * dh), "wo": w("attn/wo", h * dh, d)}
        if cfg.qkv_bias:
            for name, n in (("bq", h * dh), ("bk", k * dh), ("bv", k * dh)):
                a[name] = const(f"attn/{name}", n, 0)
        p["attn"] = a
    elif mixer == "mamba2":
        D, N, W = cfg.d_model, cfg.ssm_state, cfg.conv_width
        Di = cfg.expand * D
        H = Di // cfg.ssm_head_dim
        f32 = torch.float32
        p["ssd"] = {
            "in_z": w("ssd/in_z", D, Di), "in_x": w("ssd/in_x", D, Di),
            "in_bc": w("ssd/in_bc", D, 2 * N), "in_dt": w("ssd/in_dt", D, H),
            "conv_x_w": w("ssd/conv_x_w", W, Di, scale=W ** -0.5),
            "conv_x_b": const("ssd/conv_x_b", Di, 0),
            "conv_bc_w": w("ssd/conv_bc_w", W, 2 * N, scale=W ** -0.5),
            "conv_bc_b": const("ssd/conv_bc_b", 2 * N, 0),
            "A_log": const("ssd/A_log", H, 0, f32),
            "D": const("ssd/D", H, 1, f32),
            "dt_bias": const("ssd/dt_bias", H, 0, f32),
            "norm_w": const("ssd/norm_w", Di, 1, f32),
            "out_proj": w("ssd/out_proj", Di, D),
        }
    elif mixer == "rglru":
        D, W, cw = cfg.d_model, cfg.lru_width, cfg.conv_width
        p["rglru"] = {
            "in_x": w("rglru/in_x", D, W), "in_g": w("rglru/in_g", D, W),
            "conv_w": w("rglru/conv_w", cw, W, scale=cw ** -0.5),
            "conv_b": const("rglru/conv_b", W, 0),
            "wa": w("rglru/wa", W, W), "wx": w("rglru/wx", W, W),
            "lam": const("rglru/lam", W, 2.0, torch.float32),
            "out": w("rglru/out", W, D),
        }
    else:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn == "mlp":
        d, f = cfg.d_model, cfg.d_ff
        p["norm2"] = _norm(cfg, lead, dev, keep, f"{path}/norm2")
        p["ffn"] = {"wi": w("ffn/wi", d, f)}
        if cfg.mlp == "swiglu":
            p["ffn"]["wg"] = w("ffn/wg", d, f)
        else:                      # drawn all the same: the same stream
            _ = param(gen, lead + (d, f), dt, dev, lead=len(lead))
        p["ffn"]["wo"] = w("ffn/wo", f, d)
    elif ffn == "moe":
        # the reference's init_moe: its fan-in is shape[0], so the experts
        # are scaled by (E + pad)^-0.5, and the padded experts are random
        # too (ROADMAP C13)
        d, f = cfg.d_model, cfg.d_ff
        ep = cfg.num_experts + cfg.expert_pad
        p["norm2"] = _norm(cfg, lead, dev, keep, f"{path}/norm2")
        moe = {"router": w("ffn/router", d, cfg.num_experts,
                           dtype=torch.float32),
               "wi": w("ffn/wi", ep, d, f)}
        if cfg.mlp == "swiglu":
            moe["wg"] = w("ffn/wg", ep, d, f)
        moe["wo"] = w("ffn/wo", ep, f, d)
        p["ffn"] = moe
    elif ffn != "none":
        raise ValueError(f"unknown feed-forward {ffn!r}")
    return p


def _keep_all(path: str, leaf: torch.Tensor) -> torch.Tensor:
    return leaf


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, seed: int = 0, keep=None) -> dict:
    """Seeded random weights on ``device`` (``cuda`` unless told
    otherwise).  ``generator`` must live on that device; without one, a
    fresh generator seeded with ``seed`` is made there.  ``keep(path,
    leaf)`` (path as ``"/units/l0/attn/wq"``) takes each leaf as it is
    made and returns what the tree holds (by default the leaf)."""
    dev = resolve_device(device)
    keep = keep or _keep_all
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    U, d = cfg.full_units, cfg.d_model
    units = {f"l{i}": _init_layer(cfg, spec, generator, (U,), dev, keep,
                                  f"/units/l{i}")
             for i, spec in enumerate(cfg.pattern)}
    params = {"units": units}
    if cfg.tail_specs:
        params["tail"] = {f"t{i}": _init_layer(cfg, spec, generator, (), dev,
                                               keep, f"/tail/t{i}")
                          for i, spec in enumerate(cfg.tail_specs)}
    params["final_norm"] = _norm(cfg, (), dev, keep, "/final_norm")
    emb_scale = 1.0 / (d ** 0.5)
    params["embed"] = keep("/embed", param(
        generator, (cfg.vocab_size, d), cfg.dtype, dev, scale=emb_scale))
    if not cfg.tie_embeddings:
        params["unembed"] = keep("/unembed", param(
            generator, (cfg.vocab_size, d), cfg.dtype, dev, scale=emb_scale))
    return params


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as meta tensors: shapes and dtypes,
    no storage and no random numbers drawn (the counterpart of
    ``jax.eval_shape`` of the init)."""
    return init_params(cfg, torch.Generator(), device="meta")


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

