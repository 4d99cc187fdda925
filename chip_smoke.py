#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at its path's shapes (and
times both), then drives the port's paths:

1. the kernels against their plain versions (serving shapes, the
   decode layer's fused bias + RoPE + K/V write ``rope_kv_append`` with a
   lane on the dump page and one past its table, the reference's sweep
   shapes, the edges of the kernels' tiles, qwen2.5-32b's
   prefill and mamba2-370m's scan; the flash rows name the variant that
   ran; paged_attention also at every head layout of the reference's
   configs, 8 x 32768 and 1 x 32768 positions, page and split edges and
   fp32, timed with the L2 cache cold and warm);
2. the serving engine on the card against the same engine on the CPU;
3. qwen2.5-32b served at full width (cut to 8 layers, random weights from
   a seed) through the paged engine: short prompts, a 300-token prompt on
   the span path, a published prefix with an exact and a partial hit, and
   a crash-and-recover mid-run; every layer of every step launches
   ``rope_kv_append`` and ``paged_attention`` once, the standalone
   ``kv_update`` never;
4. the full-sequence forward (logits, collected K/V, loss) of both
   architectures' smoke configurations on the card against the CPU;
5. qwen2.5-32b prefill at full width (the serve run's 8 layers and
   weights): ``forward(collect_kv=True)`` and ``loss_fn`` on 8192 tokens;
6. mamba2-370m scoring, all 48 layers: ``forward`` and ``loss_fn`` on
   8 x 4096 tokens.

Every phase that fails raises.  The last lines are the card, a JSON
``kernels`` line and ``{"ok": true, "device": {...}}``.  Needs CUDA and
this repo's ``src/``; exits non-zero without either.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
LANES, MAX_SEQ, PAGES_PER_SB = 8, 1024, 2
LONG_PROMPT = 300          # > pages_per_sb pages of 128: the span path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
FP32_FLOPS = 67e12         # fp32 outside the tensor cores, same source


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def event_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` between CUDA events (host
    launch overhead included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 50) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls
    captured in one CUDA graph and replayed, so host overhead drops out."""
    from repro_torch.launch.bench_paged import graph_ms as replay_ms
    return replay_ms(torch, [fn], iters)


# ---------------------------------------------------------------------------
# phase 1: the kernels at the serving path's shapes
# ---------------------------------------------------------------------------
def check_kernels(torch, cfg, dev) -> list[dict]:
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, K, dh, page = LANES, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, cfg.page_size
    P = MAX_SEQ // page
    per_lane_sbs = -(-(MAX_SEQ // page + 2) // PAGES_PER_SB)
    pages = (LANES * per_lane_sbs + 1) * PAGES_PER_SB + 1     # engine arena
    dt = cfg.dtype
    es = torch.empty((), dtype=dt).element_size()

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    ak, av = randn(pages, page, K, dh), randn(pages, page, K, dh)
    kn, vn = randn(B, K, dh), randn(B, K, dh)
    perm = torch.randperm(pages - 1, generator=g, device=dev)[:B]
    pids = perm.to(torch.int32)
    pids[B - 1] = -1                          # one lane onto the dump page
    slots = torch.randint(0, page, (B,), generator=g, device=dev,
                          dtype=torch.int32)

    # kv_update: bit-equal over the whole arena
    rk, rv = ak.clone(), av.clone()
    kvk.kv_update_plain(rk, rv, kn, vn, pids, slots)
    kvk.kv_update(ak, av, kn, vn, pids, slots)
    torch.cuda.synchronize()
    if not (torch.equal(ak, rk) and torch.equal(av, rv)):
        raise AssertionError("kv_update kernel differs from its plain version")
    kv_err = float(torch.maximum((ak.float() - rk.float()).abs().max(),
                                 (av.float() - rv.float()).abs().max()))
    lp, ls = pids.long(), slots.long()

    def kv_lib():
        ak.index_put_((lp, ls), kn)       # id -1 wraps to the dump page
        av.index_put_((lp, ls), vn)

    kv_bytes = 2 * 2 * B * K * dh * es + 2 * B * 4
    kv_row = {
        "name": "kv_update", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_update.cu",
        "replaces": "src/repro/kernels/kv_update/kernel.py:47",
        "max_abs_err": kv_err, "tolerance": 0.0,
        "ms": graph_ms(torch, lambda: kvk.kv_update(ak, av, kn, vn, pids,
                                                   slots)),
        "eager_ms": event_ms(torch, lambda: kvk.kv_update(ak, av, kn, vn,
                                                         pids, slots)),
        "plain_ms": event_ms(torch, lambda: kvk.kv_update_plain(
            ak, av, kn, vn, pids, slots)),
        "bound_ms": kv_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": event_ms(torch, kv_lib),
        "library_call": "Tensor.index_put_ on K and on V (int64 indices)",
        # the floor of a launch of its own: the same kernel at one lane
        "ms_one_lane": graph_ms(torch, lambda: kvk.kv_update(
            ak, av, kn[:1], vn[:1], pids[:1], slots[:1])),
        "shape": {"arena": [pages, page, K, dh], "new": [B, K, dh],
                  "dtype": str(dt)},
    }

    rope_row = check_rope_kv_append(torch, cfg, dev, pages)

    # paged_attention: within 3e-2 and BF16_ROW_TOL of a row's rms, window
    # off and on; lengths up to the serve run's longest sequence
    q = randn(B, H, dh)
    bt = torch.full((B, P), -1, dtype=torch.int32, device=dev)
    lens = torch.randint(1, LONG_PROMPT + 64, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[0] = LONG_PROMPT + 63
    pool = torch.randperm(pages - 1, generator=g, device=dev).to(torch.int32)
    cursor = 0
    for b in range(B):
        need = -(-int(lens[b]) // page)
        bt[b, :need] = pool[cursor:cursor + need]
        cursor += need
    rows = {}
    for window in (0, 256):
        want = pak.paged_attention_plain(q, ak, av, bt, lens, window=window)
        got = pak.paged_attention(q, ak, av, bt, lens, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        row_err = fak.row_scaled_error(got, want)
        if not (err < 3e-2 and row_err < fak.BF16_ROW_TOL):
            raise AssertionError(f"paged_attention (window {window}) differs "
                                 f"from its plain version by {err}, "
                                 f"{row_err} of a row's rms")
        tokens = torch.clamp(lens, max=window).sum() if window \
            else lens.sum()
        tokens = int(tokens)
        pa_bytes = (2 * B * H * dh * es + B * P * 4 + B * 4
                    + 2 * tokens * K * dh * es)
        pa_flops = 4 * H * dh * tokens
        t_bytes = pa_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = pa_flops / BF16_FLOPS * 1e3
        # yardstick: SDPA over K/V gathered beforehand (the gather is not
        # timed), so it is not the same inputs and not library_ms
        kg = ak[bt.clamp(min=0).long()].reshape(B, P * page, K, dh)
        vg = av[bt.clamp(min=0).long()].reshape(B, P * page, K, dh)
        kg = kg.transpose(1, 2).contiguous()
        vg = vg.transpose(1, 2).contiguous()
        pos = torch.arange(P * page, device=dev)[None]
        valid = (pos < lens[:, None]) & torch.repeat_interleave(
            bt >= 0, page, dim=1)
        if window:
            valid &= pos > (lens[:, None] - 1 - window)
        mask = valid[:, None, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        # ms: the L2 cache cold (copies of the inputs over 100 MB in turn,
        # as a decode step finds K/V after a layer's weights); warm: one
        # copy again and again
        times = bp.time_cold_warm(torch, pak.paged_attention,
                                  (q, ak, av, bt, lens), window=window)
        rows[window] = {
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:87",
            "max_abs_err": err, "row_scaled_err": row_err,
            "tolerance": {"abs": 3e-2, "row_scaled": fak.BF16_ROW_TOL},
            "splits": pak.split_count(B, K, P, page)[0],
            "ms": times["ms"], "ms_l2_warm": times["ms_l2_warm"],
            "cold_copies": times["cold_copies"],
            "eager_ms": event_ms(torch, lambda: pak.paged_attention(
                q, ak, av, bt, lens, window=window)),
            "plain_ms": event_ms(torch, lambda: pak.paged_attention_plain(
                q, ak, av, bt, lens, window=window)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "sdpa_pregathered_ms": event_ms(torch, lambda: sdpa(
                q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)),
            "shape": {"q": [B, H, dh], "arena": [pages, page, K, dh],
                      "block_table": [B, P], "valid_tokens": tokens,
                      "window": window, "dtype": str(dt)},
        }
    # the main path runs without a window; the windowed run rides along
    pa_row = rows[0]
    pa_row["window256"] = {k: rows[256][k] for k in (
        "max_abs_err", "row_scaled_err", "splits", "ms", "ms_l2_warm",
        "eager_ms", "plain_ms", "bound_ms", "sdpa_pregathered_ms", "shape")}
    pa_row["sweep"] = check_paged_sweep(torch, dev)
    return [kv_row, rope_row, pa_row]


def check_rope_kv_append(torch, cfg, dev, pages) -> dict:
    """rope_kv_append at the serve run's shape (8 lanes, 40/8 heads,
    head_dim 128, bf16, bias and RoPE on, the engine's arena), bit-equal to
    its plain version over q_rot and the whole arena; a lane on a -1 table
    column and a lane past the table write the dump page."""
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.layers.rope import rope_freqs

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    B, H, K, dh, page = LANES, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, cfg.page_size
    P = MAX_SEQ // page
    dt = cfg.dtype
    es = torch.empty((), dtype=dt).element_size()

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dt)

    pos = torch.randint(0, LONG_PROMPT + 64, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[B - 1] = P * page + 5                     # past the table
    table = torch.randperm(pages - 1, generator=g, device=dev)[:B * P]
    table = table.to(torch.int32).reshape(B, P)
    table[B - 2, int(pos[B - 2]) // page] = -1    # a -1 column: dump page
    if int(pos[B - 2]) % page == int(pos[B - 1]) % page:
        pos[B - 2] = (int(pos[B - 2]) // page) * page + \
            (int(pos[B - 1]) + 1) % page          # its own dump slot
    args = (randn(B, H * dh), randn(B, K * dh), randn(B, K * dh),
            randn(H * dh, scale=0.5), randn(K * dh, scale=0.5),
            randn(K * dh, scale=0.5), rope_freqs(dh, cfg.rope_theta, dev),
            pos, table)
    ak, av = randn(pages, page, K, dh), randn(pages, page, K, dh)
    rk, rv = ak.clone(), av.clone()
    want = kvk.rope_kv_append_plain(*args, rk, rv)
    got = kvk.rope_kv_append(*args, ak, av)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(ak, rk)
            and torch.equal(av, rv)):
        raise AssertionError("rope_kv_append kernel differs from its plain "
                             "version")
    err = max(float((got.float() - want.float()).abs().max()),
              float((ak.float() - rk.float()).abs().max()),
              float((av.float() - rv.float()).abs().max()))
    # bytes: q, k, v, the biases, freqs, pos and one table entry a lane
    # read; q_rot and the K and V rows written.  Operations: the angle, per
    # (lane, head, pair) four products and two sums, a bias add an element
    nbytes = (2 * B * H * dh + 4 * B * K * dh + (H + 2 * K) * dh) * es \
        + dh // 2 * 4 + 2 * B * 4
    ops = B * (dh // 2 + 3 * (H + K) * dh + (H + 2 * K) * dh)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {
        "name": "rope_kv_append", "route": "cuda",
        "source": "src/repro_torch/csrc/kv_update.cu",
        "replaces": "src/repro/kernels/kv_update/kernel.py:47",
        "max_abs_err": err, "tolerance": 0.0,
        "ms": graph_ms(torch, lambda: kvk.rope_kv_append(*args, ak, av)),
        "eager_ms": event_ms(torch, lambda: kvk.rope_kv_append(*args, ak,
                                                              av)),
        "plain_ms": event_ms(torch, lambda: kvk.rope_kv_append_plain(
            *args, ak, av)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_call": "none (no single PyTorch call adds the biases, "
                        "rotates q and k and writes the paged K/V rows)",
        "shape": {"q": [B, H * dh], "kv": [B, K * dh],
                  "arena": [pages, page, K, dh], "table": [B, P],
                  "dtype": str(dt)},
    }


# paged_attention beyond the serve run: the reference's head layouts, the
# 32768-token shapes, the edges of pages and splits, fp32; name, lanes,
# query heads, KV heads, head_dim, page, table columns, lengths, window,
# dtype, a lane whose pages are all unused (or None)
_LENS = [4096, 2500, 700, 129]
PAGED_SWEEP = [
    ("qwen2.5-32b 40/8", 4, 40, 8, 128, 128, 32, _LENS, 0, "bfloat16", None),
    ("granite-20b 48/1", 4, 48, 1, 128, 128, 32, _LENS, 0, "bfloat16", None),
    ("recurrentgemma-9b 16/1 dh256", 4, 16, 1, 256, 128, 32, _LENS, 0,
     "bfloat16", None),
    ("nemotron-4-340b 96/8 dh192", 4, 96, 8, 192, 128, 32, _LENS, 0,
     "bfloat16", None),
    ("starcoder2-3b 24/2", 4, 24, 2, 128, 128, 32, _LENS, 0, "bfloat16",
     None),
    ("long 8 x 32768", 8, 40, 8, 128, 128, 256, 32768, 0, "bfloat16", None),
    ("single 1 x 32768", 1, 40, 8, 128, 128, 256, 32768, 0, "bfloat16",
     None),
    ("page edges, a masked lane", 5, 40, 8, 128, 128, 8,
     [1, 127, 128, 129, 500], 0, "bfloat16", 4),
    # window start 3744 lies in the split [3584, 3840)
    ("window 256 across a split", 4, 40, 8, 128, 128, 32,
     [4000, 1000, 300, 2100], 256, "bfloat16", None),
    ("page 8", 4, 40, 8, 128, 8, 128, [1000, 33, 8, 9], 0, "bfloat16", None),
    ("fp32", 4, 40, 8, 128, 16, 64, [1000, 33, 700, 9], 0, "float32", None),
    ("fp32 window, a masked lane", 4, 8, 2, 64, 16, 64, [1000, 33, 700, 9],
     100, "float32", 1),
]


def check_paged_sweep(torch, dev) -> list[dict]:
    """Each case of PAGED_SWEEP against the plain version (bf16: 3e-2 and
    BF16_ROW_TOL of a row's rms; fp32: 1e-5; a masked lane exactly 0),
    timed with the L2 cache cold and warm."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp
    out = []
    for i, (name, B, H, K, dh, page, P, lens, window, dtn, masked) in \
            enumerate(PAGED_SWEEP):
        dt = getattr(torch, dtn)
        inputs = bp.make_inputs(torch, dev, B, H, K, dh, page, P, lens, dt,
                                SEED + 10 + i)
        if masked is not None:
            inputs[3][masked] = -1
        want = pak.paged_attention_plain(*inputs, window=window)
        got = pak.paged_attention(*inputs, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        live = [b for b in range(B) if b != masked]
        row_err = fak.row_scaled_error(got[live], want[live])
        tol = 3e-2 if dt == torch.bfloat16 else 1e-5
        bad = not err < tol or (dt == torch.bfloat16
                                and not row_err < fak.BF16_ROW_TOL)
        if masked is not None and bool((got[masked] != 0).any()):
            bad = True
        if bad:
            raise AssertionError(
                f"paged_attention sweep case {name!r} differs from its plain "
                f"version by {err} (tolerance {tol}), {row_err} of a row's "
                f"rms (tolerance {fak.BF16_ROW_TOL} in bf16), or its masked "
                f"lane is not 0")
        bound, tokens = bp.bytes_bound_ms(inputs, window)
        row = {"case": name, "shape": {
                   "lanes": B, "heads": [H, K], "head_dim": dh, "page": page,
                   "table": P, "window": window, "dtype": dtn,
                   "valid_tokens": tokens, "masked_lane": masked},
               "splits": pak.split_count(B, K, P, page)[0],
               "max_abs_err": err, "row_scaled_err": row_err,
               "bound_ms": bound}
        row.update(bp.time_cold_warm(torch, pak.paged_attention, inputs,
                                     window=window, iters=20))
        out.append(row)
        print(f"paged_attention {name}: splits {row['splits']}, err {err:.3g}"
              f" (row {row_err:.3g}), ms {row['ms']:.5f} cold, "
              f"{row['ms_l2_warm']:.5f} warm, bound {bound:.5f}", flush=True)
        del inputs, want, got
        torch.cuda.empty_cache()
    return out


# the reference's sweeps (tests/test_kernels.py) and the edges of the
# kernels' tiles; the main paths' shapes come from the forward runs
# (repro_torch.launch.profile_forward.RUNS)
FLASH_SWEEP = [  # B, H, K, S, dh, causal, window, dtype
    (1, 4, 2, 256, 64, True, 0, "float32"),
    (2, 4, 1, 256, 128, True, 0, "bfloat16"),
    (1, 8, 8, 128, 64, False, 0, "float32"),
    (1, 4, 2, 512, 64, True, 128, "float32"),
    (1, 16, 16, 128, 80, False, 0, "bfloat16"),       # mma.sync variant
    (1, 4, 2, 1000, 64, True, 0, "bfloat16"),         # partial 128-row tiles
    (1, 4, 2, 200, 128, True, 0, "bfloat16"),
    (1, 4, 2, 1000, 128, False, 0, "bfloat16"),
    (1, 4, 2, 512, 128, True, 48, "bfloat16"),        # window edge tiles
    (2, 40, 8, 1000, 128, True, 0, "bfloat16"),       # a tile at a head's end
]
SSD_SWEEP = [  # Bz, H, S, P, N, dtype, log-decay per step (None: random)
    (2, 2, 256, 64, 32, "float32", None),
    (1, 4, 128, 32, 64, "float32", None),
    (2, 1, 512, 64, 128, "float32", None),
    (2, 4, 64, 64, 128, "float32", None),             # one chunk
    (2, 3, 200, 64, 128, "float32", None),            # partial chunk; H 3
    (1, 2, 256, 64, 128, "bfloat16", None),
    (1, 3, 1024, 64, 128, "float32", -5.0),           # strong decay
]


def flash_bound(B, H, K, S, dh, causal, window, es) -> tuple[float, str]:
    """Least time for the attention: 4 dh flops per visible (query, key)
    pair (Q.K and P.V) at the dtype's peak, against q, k, v read once and
    the output written once."""
    import numpy as np
    qpos = np.arange(S)
    hi = qpos + 1 if causal else np.full(S, S)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, int)
    pairs = int((hi - lo).sum())
    flops = 4 * B * H * dh * pairs
    nbytes = es * (2 * B * H * S * dh + 2 * B * K * S * dh)
    peak = BF16_FLOPS if es == 2 else FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_bound(Bz, H, S, P, N, chunk=64) -> tuple[float, str]:
    """Least time for the chunked scan at the kernel's chunk, in fp32 FMAs:
    per (batch, chunk) the lower triangle of C B^T, once, as B and C are
    shared by the heads; per head and chunk that triangle's product with
    xdt, C h^T and the state update.  Against xdt, loga, B, C read once
    and y written once (fp32)."""
    nc = -(-S // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * Bz * nc * tri * N + \
        2 * Bz * H * nc * (tri * P + 2 * chunk * N * P)
    nbytes = 4 * (2 * Bz * H * S * P + Bz * H * S + 2 * Bz * S * N)
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_forward_kernels(torch, dev, flash_main, ssd_main) -> list[dict]:
    """flash_attention and ssd_scan against their plain versions on the
    reference's sweep shapes and the main paths' shapes (``flash_main``,
    ``ssd_main``); times at the main paths' shapes."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd_scan import kernel as ssk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    sweep, row = [], None
    for B, H, K, S, dh, causal, win, dtn in FLASH_SWEEP + [flash_main]:
        dt = getattr(torch, dtn)
        q, k, v = randn(B, H, S, dh, dt=dt), randn(B, K, S, dh, dt=dt), \
            randn(B, K, S, dh, dt=dt)
        want = fak.flash_attention_plain(q, k, v, causal=causal, window=win)
        got = fak.flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = 3e-2 if dt == torch.bfloat16 else 2e-5
        # bf16 is also held row by row: at S = 8192 the late rows' outputs
        # are far smaller than the flat 3e-2
        row_err = fak.row_scaled_error(got, want)
        if not err < tol or (dt == torch.bfloat16
                             and not row_err < fak.BF16_ROW_TOL):
            case = (B, H, K, S, dh, causal, win, dtn)
            raise AssertionError(
                f"flash_attention {case} differs from its plain version by "
                f"{err} (tolerance {tol}), {row_err} of a row's rms "
                f"(tolerance {fak.BF16_ROW_TOL} in bf16)")
        if dt == torch.bfloat16:
            tol = {"abs": tol, "row_scaled": fak.BF16_ROW_TOL}
        bound, by = flash_bound(B, H, K, S, dh, causal, win,
                                q.element_size())
        shape = {"q": [B, H, S, dh], "kv": [B, K, S, dh], "causal": causal,
                 "window": win, "dtype": dtn}

        variant = fak.last_variant
        if variant != fak.flash_variant(dt, dh):
            raise AssertionError(f"flash_attention ran {variant}, not "
                                 f"{fak.flash_variant(dt, dh)}")

        def run():
            return fak.flash_attention(q, k, v, causal=causal, window=win)
        main = (B, H, K, S, dh, causal, win, dtn) == flash_main
        ms = graph_ms(torch, run, iters=20 if main else 50)
        if not main:
            sweep.append({"shape": shape, "variant": variant,
                          "max_abs_err": err, "row_scaled_err": row_err,
                          "tolerance": tol, "ms": ms, "bound_ms": bound})
            continue
        row = {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:95",
            "variant": variant,
            "max_abs_err": err, "row_scaled_err": row_err,
            "tolerance": tol, "ms": ms,
            "eager_ms": event_ms(torch, run, iters=20),
            "plain_ms": event_ms(torch, lambda: fak.flash_attention_plain(
                q, k, v, causal=causal, window=win), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": event_ms(torch, lambda: sdpa(
                q, k, v, is_causal=True, enable_gqa=True), iters=20),
            "library_call": "F.scaled_dot_product_attention(is_causal=True, "
                            "enable_gqa=True) on the same q, k, v",
            "shape": shape, "sweep": sweep,
        }
    rows = [row]

    sweep = []
    for Bz, H, S, P, N, dtn, decay in SSD_SWEEP + [ssd_main]:
        dt = getattr(torch, dtn)
        xdt = randn(Bz, H, S, P, scale=0.1, dt=dt)
        loga = -randn(Bz, H, S, scale=0.1, dt=dt).abs() if decay is None \
            else torch.full((Bz, H, S), decay, dtype=dt, device=dev)
        Bm = randn(Bz, S, N, scale=0.3, dt=dt)
        Cm = randn(Bz, S, N, scale=0.3, dt=dt)
        want = ssk.ssd_scan_plain(xdt, loga, Bm, Cm)
        got = ssk.ssd_scan(xdt, loga, Bm, Cm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-9)
        if not rel < 1e-4:
            raise AssertionError(f"ssd_scan {(Bz, H, S, P, N, dtn, decay)} "
                                 f"differs from its plain version by {rel} "
                                 f"(relative; tolerance 1e-4)")
        bound, by = ssd_bound(Bz, H, S, P, N)
        shape = {"xdt": [Bz, H, S, P], "BC": [Bz, S, N], "dtype": dtn,
                 "log_decay": decay}

        def run():
            return ssk.ssd_scan(xdt, loga, Bm, Cm)
        main = (Bz, H, S, P, N, dtn, decay) == ssd_main
        ms = graph_ms(torch, run, iters=10 if main else 50)
        if not main:
            sweep.append({"shape": shape, "max_abs_err": err,
                          "rel_err": rel, "ms": ms, "bound_ms": bound})
            continue
        rows.append({
            "name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:82",
            "max_abs_err": err, "rel_err": rel,
            "tolerance": "1e-4 relative", "ms": ms,
            "eager_ms": event_ms(torch, run, iters=10),
            "plain_ms": event_ms(torch, lambda: ssk.ssd_scan_plain(
                xdt, loga, Bm, Cm), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_call": "none (no single PyTorch call computes the scan)",
            "shape": shape, "sweep": sweep,
        })
    return rows


# ---------------------------------------------------------------------------
# phase 2: the engine on the card against the engine on the CPU
# ---------------------------------------------------------------------------
def engine_script(eng, vocab: int) -> list:
    """A small serving script touching every engine path; returns what
    it observed, call by call."""
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    prompt = [int(t) for t in rng.integers(1, vocab, size=24)]
    seen = []
    a = eng.add_request(prompt, share_prefix=True)     # span path
    eng.add_request([5, 9, 3])                          # lazy pages
    for _ in range(len(prompt)):
        seen.append(eng.step())
    eng.publish_prefix(a)
    eng.add_request(prompt, share_prefix=True)          # exact hit
    eng.add_request(prompt[:8] + [int(t) for t in
                                  rng.integers(1, vocab, size=10)],
                    share_prefix=True)                  # partial hit, split
    for _ in range(10):
        seen.append(eng.step())
    stats = eng.crash_and_recover()
    stats["phases"] = {k: v["items"] for k, v in stats["phases"].items()}
    seen.append(stats)
    for _ in range(6):
        seen.append(eng.step())
    eng.finish(a)
    seen.append({f: getattr(eng.astate, f).cpu().tolist()
                 for f in eng.astate._fields})
    seen.append(eng.dstate["block_table"].cpu().tolist())
    seen.append(eng.prefix_store.words.tolist())
    return seen


def check_engine_vs_cpu(torch, dev) -> dict:
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine

    cfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                              dtype=torch.float32, page_size=8)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    runs = {}
    for d in ("cpu", dev):
        eng = ServingEngine(cfg, _to(cpu_params, d), lanes=4, max_seq=64,
                            pages_per_sb=2, device=d)
        runs[str(d)] = engine_script(eng, cfg.vocab_size)
    cpu, gpu = runs["cpu"], runs[str(dev)]
    if cpu != gpu:
        bad = next(i for i, (x, y) in enumerate(zip(cpu, gpu)) if x != y)
        raise AssertionError(f"engine on the card differs from the CPU at "
                             f"call {bad}: {gpu[bad]} vs {cpu[bad]}")
    emitted = sum(len(s) for s in cpu if isinstance(s, dict)
                  and all(isinstance(k, int) for k in s))
    return {"calls_compared": len(cpu), "tokens_emitted": emitted}


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------
def serve_full_width(torch, cfg, params, dev) -> dict:
    import numpy as np
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       _leaves(params))
    engine = ServingEngine(cfg, params, lanes=LANES, max_seq=MAX_SEQ,
                           pages_per_sb=PAGES_PER_SB, device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 3)
    V = cfg.vocab_size

    def toks(n):
        return [int(t) for t in rng.integers(1, V, size=n)]

    steps = emitted = positions = 0
    step_s: list[float] = []

    def run(n):
        nonlocal steps, emitted, positions
        for _ in range(n):
            positions += int(engine.lane_states.active().sum())
            t = time.perf_counter()
            out = engine.step()
            step_s.append(time.perf_counter() - t)
            steps += 1
            emitted += len(out)
            for tok in out.values():
                if not 0 <= tok < V:
                    raise AssertionError(f"token {tok} outside the vocab")

    # counts start at 0 here: everything below is the main path
    kvk.launches = 0
    kvk.rope_kv_append_launches = 0
    pak.launches = 0
    t_run = time.perf_counter()
    for _ in range(4):
        engine.add_request(toks(int(rng.integers(4, 17))))
    long_prompt = toks(LONG_PROMPT)
    owner = engine.add_request(long_prompt, share_prefix=True)
    if owner not in engine.large_spans:
        raise AssertionError("the long prompt did not take the span path")
    run(LONG_PROMPT)
    engine.publish_prefix(owner)
    exact = engine.add_request(long_prompt, share_prefix=True)
    if exact not in engine.shared_spans:
        raise AssertionError("no exact prefix hit")
    page = cfg.page_size
    partial = engine.add_request(long_prompt[:page] + toks(60),
                                 share_prefix=True)
    if engine.lane_states.partial_hits.get(partial) != 1:
        raise AssertionError("no partial prefix hit")
    run(24)
    before = {lane: list(s.tokens) for lane, s in engine.sessions.items()}
    pos_before = engine.dstate["pos"].cpu().clone()
    crash_step = steps
    stats = engine.crash_and_recover()
    after_crash = 24
    run(after_crash)
    pos_after = engine.dstate["pos"].cpu()
    for lane, toks_before in before.items():
        now = engine.sessions[lane].tokens
        if now[:len(toks_before)] != toks_before or \
                int(pos_after[lane]) != int(pos_before[lane]) + after_crash:
            raise AssertionError(f"lane {lane} did not resume after recovery")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = {"kv_update": kvk.launches,
              "rope_kv_append": kvk.rope_kv_append_launches,
              "paged_attention": pak.launches}
    want = cfg.num_layers * steps
    if counts["rope_kv_append"] != want or \
            counts["paged_attention"] != want or counts["kv_update"] != 0:
        raise AssertionError(f"launch counts {counts}: want layers x steps "
                             f"= {want} of rope_kv_append and "
                             f"paged_attention, 0 of kv_update")
    steady = sorted(step_s[5:])
    return {
        "model": cfg.name, "layers": cfg.num_layers,
        "cut": f"depth 64 -> {cfg.num_layers} layers; widths as published",
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": V,
        "dtype": str(cfg.dtype), "weight_gb": weight_bytes / 1e9,
        "lanes": LANES, "max_seq": MAX_SEQ, "pages_per_sb": PAGES_PER_SB,
        "arena_pages": int(engine.dstate["units"]["l0"]["k"].shape[1]),
        "setup_s": setup_s, "run_s": run_s, "steps": steps,
        "crash_at_step": crash_step, "recovery": stats,
        "ms_per_step_mean": 1e3 * sum(step_s) / len(step_s),
        "ms_per_step_median": 1e3 * steady[len(steady) // 2],
        "tokens_emitted": emitted,
        "tokens_per_s": emitted / sum(step_s),
        "positions_per_s": positions / sum(step_s),
        "launches": counts,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }


# ---------------------------------------------------------------------------
# phase 4: the full-sequence forward on the card against the CPU
# ---------------------------------------------------------------------------
def _to(tree, d):
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, d) for v in tree)
    return tree.to(d)


def check_forward_vs_cpu(torch, dev) -> dict:
    """Both architectures' smoke configurations in fp32, the same weights
    on both devices: logits, collected K/V and the loss within 1e-3."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    out = {}
    for arch in ("qwen2.5-32b", "mamba2-370m"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 64),
                             generator=torch.Generator().manual_seed(SEED + 6))
        batch = {"tokens": toks, "labels": toks}
        res = {}
        for d in ("cpu", dev):
            p, b = _to(params, d), _to(batch, d)
            logits, _, kv = T.forward(cfg, p, b, collect_kv=True)
            loss, _ = T.loss_fn(cfg, p, b)
            res[str(d)] = _to((logits, kv["units"], loss), "cpu")
        (lc, kc, sc), (lg, kg, sg) = res["cpu"], res[str(dev)]
        errs = {"logits": float((lc - lg).abs().max()),
                "loss": abs(float(sc) - float(sg))}
        for name, (k, v) in kc.items():
            errs[f"{name}.k"] = float((k - kg[name][0]).abs().max())
            errs[f"{name}.v"] = float((v - kg[name][1]).abs().max())
        bad = {k: e for k, e in errs.items() if not e < 1e-3}
        if bad or kc.keys() != kg.keys():
            raise AssertionError(f"{arch}: the forward on the card differs "
                                 f"from the CPU: {bad}")
        out[arch] = errs
    return out


# ---------------------------------------------------------------------------
# phases 5 and 6: the full-sequence forward at full width
# ---------------------------------------------------------------------------
def _ce_from_logits(torch, logits, tokens) -> float:
    """Mean next-token CE straight from full logits (a check of
    ``loss_fn``'s chunked CE)."""
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tokens[:, 1:, None].long())[..., 0]
    return float((lse - gold).mean())


def run_forward(torch, cfg, params, dev, run, kernel, collect_kv) -> dict:
    """One warm-up forward, then the counted run: ``forward`` (with
    ``collect_kv`` when asked) and ``loss_fn`` on the run's random batch,
    each timed between device synchronizations."""
    from repro_torch.launch.profile_forward import run_batch
    from repro_torch.models import transformer as T
    B, S = run.batch, run.seq
    batch = run_batch(cfg, run, dev)
    toks = batch["tokens"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    T.forward(cfg, params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats(dev)

    # counts start at 0 here: everything below is the path
    kernel.launches = 0
    t = time.perf_counter()
    out = T.forward(cfg, params, batch, collect_kv=collect_kv)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    t = time.perf_counter()
    loss, parts = T.loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_s = time.perf_counter() - t
    launches = kernel.launches

    logits = out[0]
    if logits.shape != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)} "
                             f"are not finite [B, S, V]")
    if launches != 2 * cfg.num_layers:
        raise AssertionError(f"{cfg.name}: {launches} kernel launches in "
                             f"forward + loss_fn, not 2 x {cfg.num_layers}")
    res = {"model": cfg.name, "layers": cfg.num_layers, "batch": B,
           "seq": S, "dtype": str(cfg.dtype)}
    if collect_kv:
        for name, (k, v) in out[2]["units"].items():
            want = (cfg.full_units, B, S, cfg.num_kv_heads, cfg.head_dim)
            finite = bool(torch.isfinite(k).all() & torch.isfinite(v).all())
            if k.shape != want or v.shape != want or not finite:
                raise AssertionError(f"{cfg.name}: collected K/V {name} "
                                     f"{tuple(k.shape)} != {want} or not "
                                     f"finite")
            res[f"kv_{name}"] = list(want)
    ce_full = _ce_from_logits(torch, logits, toks)
    ce = float(parts["ce"])
    if not abs(ce - ce_full) < 1e-3 * max(1.0, ce_full):
        raise AssertionError(f"{cfg.name}: loss_fn's CE {ce} != the CE of "
                             f"the forward's logits {ce_full}")
    del out, logits
    res.update({
        "first_forward_s": first_s,
        "ms_per_forward": 1e3 * fwd_s, "tokens_per_s": B * S / fwd_s,
        "ms_loss_fn": 1e3 * loss_s, "loss": float(loss), "ce_check": ce_full,
        "launches": launches, "launches_per_forward": launches // 2,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    })
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"{src}/repro_torch not found: run from a checkout")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.launch.bench_paged import card_line
    from repro_torch.launch.profile_forward import RUNS, run_config
    from repro_torch.layers.ssd import n_heads
    from repro_torch.models.params import init_params

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.build_info['library']})", flush=True)

    # the serve run and the prefill share the prefill run's depth cut
    qrun, mrun = RUNS["qwen2.5-32b"], RUNS["mamba2-370m"]
    cfg, mcfg = run_config("qwen2.5-32b"), run_config("mamba2-370m")
    flash_main = (qrun.batch, cfg.num_heads, cfg.num_kv_heads, qrun.seq,
                  cfg.head_dim, True, 0, "bfloat16")
    ssd_main = (mrun.batch, n_heads(mcfg), mrun.seq, mcfg.ssm_head_dim,
                mcfg.ssm_state, "float32", None)
    kernels = check_kernels(torch, cfg, dev) + check_forward_kernels(
        torch, dev, flash_main, ssd_main)
    for row in kernels:
        print(f"kernel {row['name']}: max_abs_err {row['max_abs_err']} "
              f"ms {row['ms']:.5f} eager {row['eager_ms']:.5f} "
              f"plain {row['plain_ms']:.5f} bound {row['bound_ms']:.5f}",
              flush=True)

    ref = check_engine_vs_cpu(torch, dev)
    print(f"engine on the card == engine on the CPU (fp32 smoke): {ref}",
          flush=True)

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    torch.cuda.synchronize()
    print(f"init {cfg.name} ({cfg.num_layers} layers): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    serve = serve_full_width(torch, cfg, params, dev)
    print(f"serve: {cfg.name} at full width, cut to {cfg.num_layers} "
          f"layers; {serve['steps']} steps, "
          f"{serve['ms_per_step_median']:.3f} ms/step (median), "
          f"{serve['tokens_per_s']:.1f} tokens/s on {card}", flush=True)
    print(f"[serve] crash at step {serve['crash_at_step']}; recovery: "
          f"{serve['recovery']}", flush=True)
    print(f"launches on the main path: {serve['launches']}", flush=True)
    print("serve detail: " + json.dumps(
        {k: v for k, v in serve.items() if k != "recovery"}, default=str),
        flush=True)
    torch.cuda.empty_cache()

    fwd_ref = check_forward_vs_cpu(torch, dev)
    print(f"forward on the card == forward on the CPU (fp32 smoke, 1e-3): "
          f"{fwd_ref}", flush=True)

    prefill = run_forward(torch, cfg, params, dev, qrun, fak,
                          collect_kv=True)
    print(f"prefill: {cfg.name} at full width, cut to {cfg.num_layers} "
          f"layers, {qrun.batch} x {qrun.seq} tokens: "
          f"{prefill['ms_per_forward']:.3f} ms/forward, "
          f"{prefill['tokens_per_s']:.1f} tokens/s, flash_attention "
          f"launches {prefill['launches_per_forward']} per forward on "
          f"{card}", flush=True)
    print("prefill detail: " + json.dumps(prefill), flush=True)
    del params
    torch.cuda.empty_cache()

    mparams = init_params(mcfg, torch.Generator(device=dev).manual_seed(SEED),
                          device=dev)
    score = run_forward(torch, mcfg, mparams, dev, mrun, ssk,
                        collect_kv=False)
    score["weight_gb"] = sum(t.numel() * t.element_size()
                             for t in _leaves(mparams)) / 1e9
    print(f"score: {mcfg.name}, all {mcfg.num_layers} layers, "
          f"{mrun.batch} x {mrun.seq} tokens: {score['ms_per_forward']:.3f} "
          f"ms/forward, {score['tokens_per_s']:.1f} tokens/s, ssd_scan "
          f"launches {score['launches_per_forward']} per forward on {card}",
          flush=True)
    print("score detail: " + json.dumps(score), flush=True)

    launches = dict(serve["launches"], flash_attention=prefill["launches"],
                    ssd_scan=score["launches"])
    line = [dict(row, launches=launches[row["name"]]) for row in kernels]
    print(card)
    print(json.dumps({"kernels": line}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
