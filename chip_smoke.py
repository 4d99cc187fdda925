#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's seven CUDA kernels and the int8 variants of two of them
from ``src/repro_torch/csrc``, holds each kernel against its plain
PyTorch version at its paths' shapes (and times both), then drives the
port's paths:

1. the kernels against their plain versions (the serve runs' shapes --
   qwen2.5-32b 40/8, granite-20b 48/1, recurrentgemma-9b 16/1 at head_dim
   256 with its window, granite-moe-3b-a800m 24/8 at head_dim 64,
   moonshot-v1-16b-a3b 16/16 -- for the decode layer's fused bias + RoPE
   + K/V write ``rope_kv_append`` (a lane on the dump page and one past
   its table) and ``paged_attention``, and for their int8 variants
   (``rope_kv_append_int8`` quantizing on write, ``paged_attention_int8``
   reading int8 rows and their fp32 scales; also at the sweep's 8 x
   32768, page-edge, windowed and fp32 cases); the reference's sweep
   shapes and
   the edges of the kernels' tiles, flash_attention at head_dim 80, 144,
   192 and 256 among them (the ``wgmma`` kernel's 64-key tiles at 192 /
   256, dh 128's layout at 80); the prefills of qwen2.5-32b,
   recurrentgemma-9b and granite-moe-3b-a800m, nemotron-4-340b's heads
   (96/8 at head_dim 192, S 4096), hubert-xlarge's encode (no causal mask,
   head_dim 80) and mamba2-370m's scan; the flash rows name the variant
   that ran, ``wgmma`` at every timed shape;
   paged_attention also at every head layout of the reference's configs,
   8 x 32768 and 1 x 32768 positions, page and split edges and fp32,
   timed with the L2 cache cold and warm);
2. the serving engine on the card against the same engine on the CPU, on
   the qwen2.5-32b (also with the int8 KV cache), mamba2-370m,
   recurrentgemma-9b and granite-moe-3b-a800m smoke configs, a lane
   reused at the end;
3. serve runs at full width through the paged engine (random weights from
   a seed): qwen2.5-32b cut to 8 layers (with bf16 and with int8 KV
   arenas, the same weights and script), granite-20b (all 52 layers),
   recurrentgemma-9b (all 38), mamba2-370m (all 48), granite-moe-3b-a800m
   (all 32) and moonshot-v1-16b-a3b (all 48, ~56 GB): short prompts, and
   where the model has attention a 300-token prompt on the span path and
   a published prefix with an exact and a partial hit; a
   crash-and-recover mid-run and a finished lane reused; every attention
   layer of every step launches ``rope_kv_append`` and
   ``paged_attention`` once (the int8 run their int8 variants), the
   standalone ``kv_update`` never;
4. the full-sequence forward (logits, collected K/V, aux, loss) of every
   architecture's smoke configuration on the card against the CPU (the
   front-end stubs fed frame / patch embeddings);
5. the prefills at full width, ``forward(collect_kv=True)`` and
   ``loss_fn``: qwen2.5-32b (the serve run's 8 layers and weights, 8192
   tokens), recurrentgemma-9b (all 38 layers, 8192 tokens: flash at
   head_dim 256, window 2048, and the RG-LRU scan) and
   granite-moe-3b-a800m (the serve run's weights, 4096 tokens: flash at
   24/8 heads of 64 and the per-row MoE dispatch);
6. mamba2-370m scoring, all 48 layers: ``forward`` and ``loss_fn`` on
   8 x 4096 tokens; hubert-xlarge's encode, all 48 layers: ``forward``
   and the frame loss on 8 x 2048 frame embeddings;
7. training: the flash backward kernel ``flash_attention_bwd`` against
   its plain version at starcoder2-3b's training shape (2 x 4096, 24/2
   heads of 128, causal), timed there, at nemotron-4-340b's heads (1 x
   4096, 96/8 at head_dim 192, causal) and at recurrentgemma-9b's training
   shape (1 x 8192, 16/1 at head_dim 256, window 2048), each beside SDPA's
   backward, all three on the ``wgmma`` kernel (64-key tiles above head_dim
   128); and at the other archs' head layouts, head_dim 144 / 192 / 256
   in bf16 and fp32, partial tiles, windows (and the forward's
   log-sum-exp against the plain version's, head_dim 192 and 256 among
   them); the scan's backward kernel ``ssd_scan_bwd`` against its plain
   version at mamba2-370m's training shape (8 x 2048, 32 heads of 64, N
   128, fp32), the scan's sweep shapes and the smoke widths, given the
   h_in the forward kernel stores (itself held to the plain version's
   h_in); one fp32
   train step of the starcoder2-3b and of the mamba2-370m smoke configs,
   and of the recurrentgemma-9b smoke config widened to head_dim 256 (2
   heads, 1 KV head, 3 layers), on the card against the CPU; the trainer
   learning a fixed pattern on the card; starcoder2-3b whole (30 layers,
   published widths) trained through ``Trainer`` for a warm step and five
   more at 2 x 4096 tokens (bf16, AdamW, remat per unit): 60 forward and
   30 backward flash launches a step; mamba2-370m whole (48 layers) the
   same way at 8 x 2048 tokens: 96 ``ssd_scan`` and 48 ``ssd_scan_bwd``
   launches a step; and recurrentgemma-9b cut to 3 of its 12 pattern units
   (9 layers: 6 RG-LRU, 3 local attention; published widths, 3.02 B
   parameters) the same way at 1 x 8192 tokens: 6 forward and 3 backward
   flash launches a step (head_dim 256, window 2048);
8. checkpoints on the host Ralloc heap: the starcoder2-3b smoke state
   (params and AdamW moments after a CPU step) saved from the card and
   from the CPU into two fast-mode heaps, equal word for word, and a save
   torn before its root swing, crashed, recovered: the first checkpoint
   comes back bit for bit on the card and the torn shards are swept.  Then
   the whole starcoder2-3b run of 7 saves its state (~30 GB) once after
   its last step into a RAM heap; the heap crashes and is recovered, a new
   ``Trainer`` resumes at step 6 with every leaf's checksum equal to the
   saved one and trains two more steps (60 forward and 30 backward flash
   launches a step): save, recover (by phase) and load seconds beside
   pinned copies of 4 GB each way.

9. the sharded decode step (``make_decode_step`` over a
   ``torch.distributed`` mesh): ``rope_kv_append`` and
   ``paged_attention`` (bf16, fp32, int8; the LSE output) against their
   plain versions at shard layouts of qwen2.5-32b's arenas (page_loc 64
   and 32, a sequence-parallel table offset, lanes with no slot on the
   shard, a window); then four ranks sharing the card over gloo (NCCL
   takes one rank a card) run qwen2.5-32b at full width (8 layers, 8
   lanes) on a (1, 4) and a (2, 2) mesh, going on from a state decoded on
   the card for 252 steps across the boundary of the lanes' third page
   (48 steps), its fp32 smoke config on (2, 2) from step 0, and
   recurrentgemma-9b (published widths, 5 of its 38 layers)
   sequence-parallel at batch 1 on (2, 2) from step 2016 across its 2048
   window (96 steps), each against ``decode_step`` on the card with the
   same seeded weights (the library is built here first; the ranks load
   it).  Its times are four ranks on one card, not a multi-card number.
10. the sharded train step (``make_train_step`` / ``Trainer`` with a
   ``mesh``): ``flash_attention``, ``flash_attention_bwd``, ``ssd_scan``
   and ``ssd_scan_bwd`` against their plain versions at the shapes one
   rank gives them (starcoder2-3b's 12/1 and 6/1 heads at 2 x 4096 / the
   data shards, qwen2.5-32b's smoke heads in fp32, mamba2-370m's 16
   heads at 4 x 2048; qwen2.5-32b's 13 and 14 heads on (1, 3), K / V
   repeated a query head, at 2 x 2048; recurrentgemma-9b's 4/1 at dh 256
   with the 2048 window; the scan at 11 of mamba2-370m's 32 heads, 8 x
   2048), timed beside their bounds and SDPA; then one start-up of four
   ranks sharing the card over gloo: qwen2.5-32b's smoke config in fp32
   for 3 steps on (2, 2) and (1, 4), and with 6 query heads on (1, 4),
   against ``make_train_step`` on the card (loss 1e-4, parameters 5e-4),
   starcoder2-3b (published widths, 2 of 30 layers, bf16) through
   ``Trainer`` at 2 x 4096 tokens on (2, 2) and (1, 4), mamba2-370m (12
   of 48 layers) at 8 x 2048 on (2, 2) and recurrentgemma-9b (3 of 38
   layers, the RG-LRU over ``model``) at 1 x 4096 on (1, 4), a warm step
   and 3 more, against the one-device ``Trainer`` on the card (loss
   3e-2, grad norm 5e-2), and the (2, 2) starcoder2-3b state saved to
   rank 0's heap and restored onto (1, 4), every leaf's checksum equal;
   then a start-up of three ranks: qwen2.5-32b (2 of 64 layers) at 2 x
   2048 on (1, 3), the same way.  Its times are ranks sharing one card,
   not a multi-card number.

Each run prints a ``... detail:`` line.  The launch counters are set to 0
just before each path and read just after it; the ``kernels`` line gives
every kernel's launches on every path.  Every phase that fails raises.
The last lines are the card, the JSON ``kernels`` line and
``{"ok": true, "device": {...}}``.  Needs CUDA and this repo's ``src/``;
exits non-zero without either.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
TF32_FLOPS = 495e12        # dense TF32 tensor-core peak, same source
TF32X3_FLOPS = TF32_FLOPS / 3  # fp32 products as three TF32 ones (3xTF32)


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
    pages, P = engine_shape(cfg)                              # engine arena
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
    rope8_row = check_rope_kv_append(torch, cfg, dev, pages, int8=True)
    rope8_row["unquantized_ms"] = rope_row["ms"]

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
    rows, rows8 = {}, {}
    for window in (0, 256):
        rows8[window] = check_paged_int8(torch, (q, ak, av, bt, lens),
                                         window)
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
    pa8_row = dict(PAGED_INT8_ROW, **rows8[0], window256=rows8[256])
    for r8, r in ((pa8_row, pa_row), (pa8_row["window256"],
                                      pa_row["window256"])):
        r8["unquantized_ms"] = r["ms"]
        r8["unquantized_bound_ms"] = r["bound_ms"]
    pa_row["sweep"], pa8_row["sweep"] = check_paged_sweep(torch, dev)
    return [kv_row, rope_row, pa_row, rope8_row, pa8_row]


PAGED_INT8_ROW = {
    "name": "paged_attention_int8", "route": "cuda",
    "source": "src/repro_torch/csrc/paged_attention.cu",
    "replaces": "src/repro/kernels/paged_attention/kernel.py:87",
    "library_ms": None,
    "library_call": "none (no PyTorch call reads int8 rows through a "
                    "block table)"}


def check_paged_int8(torch, inputs, window: int, masked=None,
                     iters: int = 60) -> dict:
    """paged_attention's int8 variant against its plain version over
    ``inputs`` (``make_inputs``' tuple) with the arenas quantized as the
    int8 cache stores them: bf16 within 3e-2 and BF16_ROW_TOL of a row's
    rms, fp32 within 1e-5; a masked lane exactly 0.  Timed with the L2
    cache cold and warm, eagerly and in its plain version, beside its
    bound (bytes: int8 rows and their fp32 scales)."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp
    inp = bp.int8_inputs(inputs)
    q, ak, _, bt, _ = inp[:5]
    B, H, dh = q.shape
    _, page, K, _ = ak.shape
    want = bp.paged_int8_plain(*inp, window=window)
    got = bp.paged_int8(*inp, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    live = [b for b in range(B) if b != masked]
    row_err = fak.row_scaled_error(got[live], want[live])
    bf16 = q.dtype == torch.bfloat16
    tol = 3e-2 if bf16 else 1e-5
    if not err < tol or (bf16 and not row_err < fak.BF16_ROW_TOL) or (
            masked is not None and bool(got[masked].any())):
        raise AssertionError(
            f"paged_attention (int8) differs from its plain version by "
            f"{err} (tolerance {tol}), {row_err} of a row's rms, or its "
            f"masked lane is not 0")
    t_bytes, tokens = bp.bytes_bound_ms(inp, window)
    # the products at the tensor-core (bf16) or FMA (fp32) peak, the
    # dequantization (a product an element) at the fp32 peak
    t_ops = 1e3 * (4 * H * dh * tokens / (BF16_FLOPS if bf16 else FP32_FLOPS)
                   + 2 * K * dh * tokens / FP32_FLOPS)
    return {
        "max_abs_err": err, "row_scaled_err": row_err,
        "tolerance": {"abs": tol, "row_scaled": fak.BF16_ROW_TOL if bf16
                      else None},
        "splits": pak.split_count(B, K, bt.shape[1], page)[0],
        **bp.time_cold_warm(torch, bp.paged_int8, inp, window=window,
                            iters=iters),
        "eager_ms": event_ms(torch, lambda: bp.paged_int8(*inp,
                                                          window=window)),
        "plain_ms": event_ms(torch, lambda: bp.paged_int8_plain(
            *inp, window=window)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"q": [B, H, dh], "arena": list(ak.shape),
                  "block_table": list(bt.shape), "valid_tokens": tokens,
                  "window": window, "dtype": str(q.dtype),
                  "arena_dtype": "int8 + fp32 scales"}}


def check_rope_kv_append(torch, cfg, dev, pages,
                         int8: bool = False) -> dict:
    """rope_kv_append at a serve run's shape (8 lanes, the config's heads,
    head_dim and biases, bf16, RoPE on, the engine's arena), bit-equal to
    its plain version over q_rot and the whole arena; a lane on a -1 table
    column and a lane past the table write the dump page.  With ``int8``
    the int8 variant (int8 arenas and their fp32 scale arenas, the rows
    quantized on write), bit-equal over the arenas and scales too."""
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
    bias = (randn(H * dh, scale=0.5), randn(K * dh, scale=0.5),
            randn(K * dh, scale=0.5)) if cfg.qkv_bias else (None,) * 3
    args = (randn(B, H * dh), randn(B, K * dh), randn(B, K * dh), *bias,
            rope_freqs(dh, cfg.rope_theta, dev), pos, table)
    if int8:    # arenas as earlier writes leave them: quantized rows
        ak, ks = kvk.quantize_rows(randn(pages, page, K, dh))
        av, vs = kvk.quantize_rows(randn(pages, page, K, dh))
        flat = [ak, av, ks, vs]
    else:
        flat = [randn(pages, page, K, dh), randn(pages, page, K, dh)]
    arenas = _nest(flat)
    ref = [t.clone() for t in flat]
    want = kvk.rope_kv_append_plain(*args, *_nest(ref))
    got = kvk.rope_kv_append(*args, *arenas)
    torch.cuda.synchronize()
    if not (torch.equal(got, want)
            and all(torch.equal(a, b) for a, b in zip(flat, ref))):
        raise AssertionError(f"rope_kv_append{' (int8)' * int8} kernel "
                             f"differs from its plain version")
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip([got] + flat, [want] + ref))
    # bytes: q, k, v, the biases, freqs, pos and one table entry a lane
    # read; q_rot and the K and V rows written (int8: a byte an element and
    # an fp32 scale a row).  Operations: the angle, per (lane, head, pair)
    # four products and two sums, a bias add an element (int8: per K / V
    # element its |x|, max, division and rounding)
    nb = (H + 2 * K) * dh if cfg.qkv_bias else 0     # bias elements
    rows = 2 * B * K * (dh + 4) if int8 else 2 * B * K * dh * es
    nbytes = (2 * B * H * dh + 2 * B * K * dh + nb) * es + rows \
        + dh // 2 * 4 + 2 * B * 4
    ops = B * (dh // 2 + 3 * (H + K) * dh + nb) + 8 * B * K * dh * int8
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {
        "name": "rope_kv_append_int8" if int8 else "rope_kv_append",
        "route": "cuda",
        "source": "src/repro_torch/csrc/kv_update.cu",
        "replaces": "src/repro/kernels/kv_update/kernel.py:47",
        "max_abs_err": err, "tolerance": 0.0,
        "ms": graph_ms(torch, lambda: kvk.rope_kv_append(*args, *arenas)),
        "eager_ms": event_ms(torch, lambda: kvk.rope_kv_append(*args,
                                                              *arenas)),
        "plain_ms": event_ms(torch, lambda: kvk.rope_kv_append_plain(
            *args, *arenas)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "library_call": "none (no single PyTorch call adds the biases, "
                        "rotates q and k and writes the paged K/V rows"
                        + (", quantized" if int8 else "") + ")",
        "shape": {"q": [B, H * dh], "kv": [B, K * dh],
                  "arena": [pages, page, K, dh], "table": [B, P],
                  "dtype": str(dt),
                  "arena_dtype": "int8 + fp32 scales" if int8 else str(dt)},
    }


def _nest(flat):
    """The arena arguments of rope_kv_append from [k, v] or [k, v, ks, vs]:
    (k, v) or (k, v, (ks, vs))."""
    return tuple(flat[:2]) + ((tuple(flat[2:]),) if len(flat) > 2 else ())


def engine_shape(cfg) -> tuple[int, int]:
    """(arena pages, table columns) of a serve run's engine: the arena
    ``ServingEngine`` sizes for LANES lanes, MAX_SEQ and PAGES_PER_SB, and
    the table ``make_dstate`` sizes (a window caps it)."""
    page = cfg.page_size
    per_lane_sbs = -(-(MAX_SEQ // page + 2) // PAGES_PER_SB)
    pages = (LANES * per_lane_sbs + 1) * PAGES_PER_SB + 1
    P = max(1, MAX_SEQ // page)
    if cfg.window:
        P = min(P, (cfg.window + page - 1) // page + 1)
    return pages, P


def check_serve_shape(torch, cfg, dev) -> dict:
    """rope_kv_append (bit-equal) and paged_attention (3e-2 and
    BF16_ROW_TOL of a row's rms, with the config's window) against their
    plain versions at a serve run's shape: its heads, head_dim, arena and
    table, lengths up to the run's longest sequence; their int8 variants
    alike.  Times, bounds and plain times of all four."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp

    pages, P = engine_shape(cfg)
    rope = check_rope_kv_append(torch, cfg, dev, pages)
    H, K, dh, page, window = cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim, cfg.page_size, cfg.window
    lens = bp.serve_lengths(LANES)
    inputs = bp.make_inputs(torch, dev, LANES, H, K, dh, page, P, lens,
                            cfg.dtype, SEED + 30, pages=pages)
    want = pak.paged_attention_plain(*inputs, window=window)
    got = pak.paged_attention(*inputs, window=window)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    row_err = fak.row_scaled_error(got, want)
    if not (err < 3e-2 and row_err < fak.BF16_ROW_TOL):
        raise AssertionError(f"paged_attention at {cfg.name}'s serve shape "
                             f"differs from its plain version by {err}, "
                             f"{row_err} of a row's rms")
    t_bytes, tokens = bp.bytes_bound_ms(inputs, window)
    t_ops = 4 * H * dh * tokens / BF16_FLOPS * 1e3
    paged = {
        "max_abs_err": err, "row_scaled_err": row_err,
        "splits": pak.split_count(LANES, K, P, page)[0],
        **bp.time_cold_warm(torch, pak.paged_attention, inputs,
                            window=window),
        "eager_ms": event_ms(torch, lambda: pak.paged_attention(
            *inputs, window=window)),
        "plain_ms": event_ms(torch, lambda: pak.paged_attention_plain(
            *inputs, window=window)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "shape": {"q": [LANES, H, dh], "arena": [pages, page, K, dh],
                  "block_table": [LANES, P], "valid_tokens": tokens,
                  "window": window, "dtype": str(cfg.dtype)}}
    keep = ("max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "shape")
    rope8 = check_rope_kv_append(torch, cfg, dev, pages, int8=True)
    rope8["unquantized_ms"] = rope["ms"]
    paged8 = check_paged_int8(torch, inputs, window)
    paged8["unquantized_ms"] = paged["ms"]
    paged8["unquantized_bound_ms"] = paged["bound_ms"]
    return {"rope_kv_append": {k: rope[k] for k in keep}, "paged_attention":
            paged, "rope_kv_append_int8": {k: rope8[k] for k in (
                *keep, "unquantized_ms")},
            "paged_attention_int8": paged8}


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
    ("granite-moe-3b-a800m 24/8 dh64", 4, 24, 8, 64, 128, 32, _LENS, 0,
     "bfloat16", None),
    ("moonshot-v1-16b-a3b 16/16", 4, 16, 16, 128, 128, 32, _LENS, 0,
     "bfloat16", None),
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
# the sweep cases the int8 variant runs too
PAGED_INT8_SWEEP = ("long 8 x 32768", "page edges, a masked lane",
                    "window 256 across a split", "fp32")


def check_paged_sweep(torch, dev) -> tuple[list[dict], list[dict]]:
    """Each case of PAGED_SWEEP against the plain version (bf16: 3e-2 and
    BF16_ROW_TOL of a row's rms; fp32: 1e-5; a masked lane exactly 0),
    timed with the L2 cache cold and warm; the cases of PAGED_INT8_SWEEP
    through the int8 variant too (``check_paged_int8``).  Returns both
    lists of rows."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.launch import bench_paged as bp
    out, out8 = [], []
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
        del want, got
        if name in PAGED_INT8_SWEEP:
            r8 = dict(case=name, **check_paged_int8(torch, inputs, window,
                                                    masked, iters=20))
            r8["unquantized_ms"], r8["unquantized_bound_ms"] = row["ms"], \
                bound
            out8.append(r8)
            print(f"paged_attention int8 {name}: err "
                  f"{r8['max_abs_err']:.3g} (row "
                  f"{r8['row_scaled_err']:.3g}), ms {r8['ms']:.5f} cold, "
                  f"{r8['ms_l2_warm']:.5f} warm, bound "
                  f"{r8['bound_ms']:.5f} (unquantized {row['ms']:.5f}, "
                  f"bound {bound:.5f})", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return out, out8


# the reference's sweeps (tests/test_kernels.py) and the edges of the
# kernels' tiles; the main paths' shapes come from the forward runs
# (repro_torch.launch.profile_forward.RUNS)
FLASH_SWEEP = [  # B, H, K, S, dh, causal, window, dtype
    (1, 4, 2, 256, 64, True, 0, "float32"),
    (2, 4, 1, 256, 128, True, 0, "bfloat16"),
    (1, 8, 8, 128, 64, False, 0, "float32"),
    (1, 4, 2, 512, 64, True, 128, "float32"),
    (1, 16, 16, 128, 80, False, 0, "bfloat16"),       # wgmma, dh 80
    (1, 4, 2, 1000, 64, True, 0, "bfloat16"),         # partial 128-row tiles
    (1, 4, 2, 200, 128, True, 0, "bfloat16"),
    (1, 4, 2, 1000, 128, False, 0, "bfloat16"),
    (1, 4, 2, 512, 128, True, 48, "bfloat16"),        # window edge tiles
    (2, 40, 8, 1000, 128, True, 0, "bfloat16"),       # a tile at a head's end
    (1, 96, 8, 1000, 192, True, 0, "bfloat16"),       # nemotron-4-340b
    (1, 16, 1, 1000, 256, True, 48, "bfloat16"),      # recurrentgemma-9b
    (1, 4, 1, 300, 256, True, 0, "float32"),
    (1, 24, 8, 1000, 64, True, 0, "bfloat16"),        # granite-moe-3b-a800m
    (2, 16, 16, 1000, 80, False, 0, "bfloat16"),      # hubert-xlarge
    # above head_dim 128: the wgmma kernel's 64-key tiles at 192 / 256
    # (S % 64 != 0, a window edge, a partial query tile), mma.sync at 144
    (1, 4, 2, 333, 192, True, 100, "bfloat16"),
    (2, 4, 1, 200, 256, False, 0, "bfloat16"),
    (1, 4, 2, 333, 144, True, 48, "bfloat16"),
    (1, 4, 2, 200, 192, True, 48, "float32"),
    (1, 4, 2, 333, 144, False, 0, "float32"),
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


def visible_pairs(S, causal, window) -> int:
    """(query, key) pairs a head's mask lets through."""
    import numpy as np
    qpos = np.arange(S)
    hi = qpos + 1 if causal else np.full(S, S)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(S, int)
    return int((hi - lo).sum())


def flash_bound(B, H, K, S, dh, causal, window, es) -> tuple[float, str]:
    """Least time for the attention: 4 dh flops per visible (query, key)
    pair (Q.K and P.V) at the dtype's peak, against q, k, v read once and
    the output written once."""
    flops = 4 * B * H * dh * visible_pairs(S, causal, window)
    nbytes = es * (2 * B * H * S * dh + 2 * B * K * S * dh)
    peak = BF16_FLOPS if es == 2 else FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_flops(Bz, H, S, P, N, chunk=64) -> int:
    """The chunked scan's least work at the kernel's chunk, in fp32 FMAs:
    per (batch, chunk) the lower triangle of C B^T, once, as B and C are
    shared by the heads; per head and chunk that triangle's product with
    xdt, C h^T and the state update."""
    nc = -(-S // chunk)
    tri = chunk * (chunk + 1) // 2
    return 2 * Bz * nc * tri * N + \
        2 * Bz * H * nc * (tri * P + 2 * chunk * N * P)


def ssd_bound(Bz, H, S, P, N, chunk=64) -> tuple[float, str]:
    """Least time for the chunked scan: ``ssd_flops`` against xdt, loga, B,
    C read once and y written once (fp32)."""
    flops = ssd_flops(Bz, H, S, P, N, chunk)
    nbytes = 4 * (2 * Bz * H * S * P + Bz * H * S + 2 * Bz * S * N)
    t_ops, t_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_bwd_bound(Bz, H, S, P, N, chunk=64,
                  peak=TF32X3_FLOPS) -> tuple[float, str]:
    """Least time for the scan's gradient: per head and chunk the
    triangles dy x^T and M^T dy, the reverse pass's (dy exp(cums))^T C, B
    g^T, (x dec) g and (dy exp(cums)) h_in; per (batch, chunk) C B^T, dG^T
    C and dG B on the lower triangle (the work of
    ``csrc/ssd_scan_bwd.cu``'s design, which reads h_in from the
    forward), at ``peak``: 3xTF32 by default, as the kernels run every
    product (``FP32_FLOPS`` gives the fp32 FMA figure).  Against xdt,
    loga, B, C, dy read once and dxdt, dloga, dB, dC written once."""
    nc = -(-S // chunk)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * Bz * nc * 3 * tri * N + \
        2 * Bz * H * nc * (2 * tri * P + 4 * chunk * P * N)
    nbytes = 4 * (4 * Bz * H * S * P + 2 * Bz * H * S + 4 * Bz * S * N)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def ssd_bwd_grads_bound(Bz, H, S, P, N, chunk=64, heads=8) -> dict:
    """The chunk-gradient kernel's own bound (kernel 3 of
    ``csrc/ssd_scan_bwd.cu``): per head and chunk the triangles dy x^T and
    M^T dy, B g^T, (x dec) g and (dy exp(cums)) h_in; per (batch, chunk,
    group of ``heads`` heads) C B^T, dG^T C and dG B on the lower
    triangle; against x, dy, loga, h_in, g, B, C read once and dx, dloga
    and the groups' dB / dC partials written once.  Its time at the fp32
    FMA peak and in 3xTF32 (three TF32 products a product, 495 / 3
    TFLOP/s), each the larger of the operations' and the bytes' time."""
    nc, groups = -(-S // chunk), -(-H // heads)
    tri = chunk * (chunk + 1) // 2
    flops = 2 * Bz * nc * (groups * 3 * tri * N +
                           H * (2 * tri * P + 3 * chunk * P * N))
    nbytes = 4 * (3 * Bz * H * S * P + 2 * Bz * H * S + 2 * Bz * S * N +
                  2 * Bz * H * nc * P * N + 2 * Bz * nc * groups * chunk * N)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_fma, t_tf32x3 = flops / FP32_FLOPS * 1e3, flops / TF32X3_FLOPS * 1e3
    return {"gflop": flops / 1e9, "gbytes": nbytes / 1e9,
            "bytes_ms": t_bytes, "fma_ops_ms": t_fma,
            "tf32x3_ops_ms": t_tf32x3, "fma_ms": max(t_fma, t_bytes),
            "tf32x3_ms": max(t_tf32x3, t_bytes)}


def ssd_bwd_reverse_bound(Bz, H, S, P, N, chunk=64) -> dict:
    """The reverse state pass's own bound (kernel 1 of
    ``csrc/ssd_scan_bwd.cu``): per head and chunk dS = (dy exp(cums))^T C
    (Q P N MACs) in 3xTF32, as the kernel runs it, against dy, C and loga
    read once and g [Bz, H, nc, P, N] written once; the larger of the two
    times.  ``fma_ops_ms`` is the same work at the fp32 FMA peak."""
    nc = -(-S // chunk)
    flops = 2 * Bz * H * nc * chunk * P * N
    nbytes = 4 * (Bz * H * S * P + Bz * S * N + Bz * H * S +
                  Bz * H * nc * P * N)
    t_ops = flops / TF32X3_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"gflop": flops / 1e9, "gbytes": nbytes / 1e9,
            "ops_ms": t_ops, "bytes_ms": t_bytes,
            "fma_ops_ms": flops / FP32_FLOPS * 1e3,
            "ms": max(t_ops, t_bytes),
            "by": "operations" if t_ops >= t_bytes else "bytes"}


def check_forward_kernels(torch, dev, flash_mains, ssd_mains) -> list[dict]:
    """flash_attention and ssd_scan against their plain versions on the
    reference's sweep shapes and the timed shapes (``flash_mains`` and
    ``ssd_mains``: the first the row's own, the others in its
    ``timed_shapes``), with full times at the timed shapes.  ssd_scan's
    first timed shape (scoring) is timed without the h_in store, the
    others (training, under grad) with it, each beside the other
    form."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd_scan import kernel as ssk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 4)

    def randn(*shape, dt=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    sweep, row, timed = [], None, []
    for B, H, K, S, dh, causal, win, dtn in FLASH_SWEEP + flash_mains:
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
        main = (B, H, K, S, dh, causal, win, dtn) in flash_mains
        if main and variant != "wgmma":
            raise AssertionError(f"flash_attention at the timed shape "
                                 f"{shape} ran {variant}, not wgmma")
        ms = graph_ms(torch, run, iters=20 if main else 50)
        if not main:
            sweep.append({"shape": shape, "variant": variant,
                          "max_abs_err": err, "row_scaled_err": row_err,
                          "tolerance": tol, "ms": ms, "bound_ms": bound})
            continue
        if win:       # the window as a mask: keys (s - win, s]
            pos = torch.arange(S, device=dev)
            mask = (pos[None] <= pos[:, None]) & \
                (pos[None] > pos[:, None] - win)

            def lib():
                return sdpa(q, k, v, attn_mask=mask, enable_gqa=True)
            call = ("F.scaled_dot_product_attention(attn_mask=<causal "
                    "window>, enable_gqa=True) on the same q, k, v")
        else:
            def lib():
                return sdpa(q, k, v, is_causal=causal, enable_gqa=True)
            call = (f"F.scaled_dot_product_attention(is_causal={causal}, "
                    "enable_gqa=True) on the same q, k, v")
        timed.append({
            "variant": variant,
            "max_abs_err": err, "row_scaled_err": row_err,
            "tolerance": tol, "ms": ms,
            "eager_ms": event_ms(torch, run, iters=20),
            "plain_ms": event_ms(torch, lambda: fak.flash_attention_plain(
                q, k, v, causal=causal, window=win), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": event_ms(torch, lib, iters=20),
            "library_call": call, "shape": shape})
        del q, k, v, want, got
    row = dict({"name": "flash_attention", "route": "cuda",
                "source": "src/repro_torch/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention/kernel.py:95"},
               **timed[0], timed_shapes=timed[1:], sweep=sweep)
    rows = [row]

    sweep, timed = [], []
    for Bz, H, S, P, N, dtn, decay in SSD_SWEEP + ssd_mains:
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
        main = (Bz, H, S, P, N, dtn, decay) in ssd_mains
        ms = graph_ms(torch, run, iters=10 if main else 50)
        if not main:
            sweep.append({"shape": shape, "max_abs_err": err,
                          "rel_err": rel, "ms": ms, "bound_ms": bound})
            continue
        # under grad (every timed shape but scoring's) the forward stores
        # h_in for the backward
        store = bool(timed)

        def run_h_in():
            return ssk._launch_fwd(xdt, loga, Bm, Cm, with_h_in=True)
        h_in_ms = graph_ms(torch, run_h_in, iters=10)
        timed.append({
            "max_abs_err": err, "rel_err": rel,
            "tolerance": "1e-4 relative", "ms": h_in_ms if store else ms,
            "h_in_store": store,
            "ms_without_store" if store else "ms_with_store":
                ms if store else h_in_ms,
            "eager_ms": event_ms(torch, run_h_in if store else run,
                                 iters=10),
            "plain_ms": event_ms(torch, lambda: ssk.ssd_scan_plain(
                xdt, loga, Bm, Cm), iters=3, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_call": "none (no single PyTorch call computes the scan)",
            "shape": shape})
        del xdt, loga, Bm, Cm, want, got
    rows.append(dict({"name": "ssd_scan", "route": "cuda",
                      "source": "src/repro_torch/csrc/ssd_scan.cu",
                      "replaces": "src/repro/kernels/ssd_scan/kernel.py:82"},
                     **timed[0], timed_shapes=timed[1:], sweep=sweep))
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
    seen.append(eng.add_request(prompt, share_prefix=True))  # exact hit
    seen.append(eng.add_request(
        prompt[:8] + [int(t) for t in rng.integers(1, vocab, size=10)],
        share_prefix=True))                              # partial hit, split
    for _ in range(10):
        seen.append(eng.step())
    stats = eng.crash_and_recover()
    stats["phases"] = {k: v["items"] for k, v in stats["phases"].items()}
    seen.append(stats)
    for _ in range(6):
        seen.append(eng.step())
    eng.finish(a)
    # the finished lane is reused: its recurrent state carries over
    # (ROADMAP C10), so the new sequence's tokens depend on it
    seen.append(eng.add_request([3, 1, 4, 1, 5]))
    for _ in range(6):
        seen.append(eng.step())
    seen.append({f: getattr(eng.astate, f).cpu().tolist()
                 for f in eng.astate._fields})
    seen.append(eng.dstate["block_table"].cpu().tolist())
    seen.append(eng.prefix_store.words.tolist())
    return seen


# (arch, config overrides): the MoE runs at capacity_factor 100, as the
# reference's MoE decode tests; qwen2.5-32b also with the int8 KV cache
ENGINE_ARCHS = (("qwen2.5-32b", {}), ("qwen2.5-32b", {"kv_dtype": "int8"}),
                ("mamba2-370m", {}), ("recurrentgemma-9b", {}),
                ("granite-moe-3b-a800m", {"capacity_factor": 100.0}))


def check_engine_vs_cpu(torch, dev) -> dict:
    """The engine script on the card and on the CPU, fp32 smoke configs
    (page 8), the same weights: every observation equal."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine

    out = {}
    for arch, kw in ENGINE_ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  dtype=torch.float32, page_size=8, **kw)
        cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu")
        runs = {}
        for d in ("cpu", dev):
            eng = ServingEngine(cfg, _to(cpu_params, d), lanes=4,
                                max_seq=64, pages_per_sb=2, device=d)
            runs[str(d)] = engine_script(eng, cfg.vocab_size)
        cpu, gpu = runs["cpu"], runs[str(dev)]
        name = f"{arch} int8" if cfg.kv_dtype == "int8" else arch
        if cpu != gpu:
            bad = next(i for i, (x, y) in enumerate(zip(cpu, gpu))
                       if x != y)
            raise AssertionError(f"{name}: engine on the card differs from "
                                 f"the CPU at call {bad}: {gpu[bad]} vs "
                                 f"{cpu[bad]}")
        emitted = sum(len(s) for s in cpu if isinstance(s, dict)
                      and all(isinstance(k, int) for k in s))
        out[name] = {"calls_compared": len(cpu), "tokens_emitted": emitted}
    return out


# ---------------------------------------------------------------------------
# phase 3: the serve runs at full width
# ---------------------------------------------------------------------------
KERNELS = ("kv_update", "rope_kv_append", "paged_attention",
           "flash_attention", "ssd_scan", "flash_attention_bwd",
           "ssd_scan_bwd", "rope_kv_append_int8", "paged_attention_int8")


def _counters():
    """Each kernel's (module, counter name)."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.kernels.ssd_scan import kernel as ssk
    return {"kv_update": (kvk, "launches"),
            "rope_kv_append": (kvk, "rope_kv_append_launches"),
            "paged_attention": (pak, "launches"),
            "flash_attention": (fak, "launches"),
            "ssd_scan": (ssk, "launches"),
            "flash_attention_bwd": (fak, "bwd_launches"),
            "ssd_scan_bwd": (ssk, "bwd_launches"),
            "rope_kv_append_int8": (kvk, "rope_kv_append_int8_launches"),
            "paged_attention_int8": (pak, "int8_launches")}


def zero_counts() -> None:
    for mod, name in _counters().values():
        setattr(mod, name, 0)


def read_counts() -> dict:
    return {k: getattr(mod, name) for k, (mod, name) in _counters().items()}


def serve_full_width(torch, cfg, params, dev) -> dict:
    """The paged engine at a serve run's shape: four short prompts, and
    where the model has attention a LONG_PROMPT-token prompt on the span
    path, published, with an exact and a partial hit; a crash-and-recover
    mid-run after which every lane resumes; a finished lane reused.
    Every attention layer of every step launches rope_kv_append and
    paged_attention once (their int8 variants with ``cfg.kv_dtype ==
    "int8"``), nothing else launches a kernel."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    nbytes = weight_bytes(params)
    engine = ServingEngine(cfg, params, lanes=LANES, max_seq=MAX_SEQ,
                           pages_per_sb=PAGES_PER_SB, device=dev)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 3)
    V = cfg.vocab_size
    attn = cfg.attn_layers > 0

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

    # counts start at 0 here: everything below is the path
    zero_counts()
    t_run = time.perf_counter()
    short = [engine.add_request(toks(int(rng.integers(4, 17))))
             for _ in range(4)]
    long_prompt = toks(LONG_PROMPT)
    owner = engine.add_request(long_prompt, share_prefix=True)
    if attn and owner not in engine.large_spans:
        raise AssertionError("the long prompt did not take the span path")
    run(LONG_PROMPT)
    if attn:
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
    engine.finish(short[0])
    if engine.add_request(toks(8)) != short[0]:
        raise AssertionError("the finished lane was not reused")
    run(12)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    counts = read_counts()
    want = cfg.attn_layers * steps
    pair = ("rope_kv_append_int8", "paged_attention_int8") \
        if cfg.kv_dtype == "int8" else ("rope_kv_append", "paged_attention")
    if counts != dict.fromkeys(KERNELS, 0) | dict.fromkeys(pair, want):
        raise AssertionError(f"launch counts {counts}: want attention "
                             f"layers x steps = {want} of {pair[0]} and "
                             f"{pair[1]}, 0 of the others")
    steady = sorted(step_s[5:])
    published = get_config(cfg.name).num_layers
    arena = next((st["k"] for st in engine.dstate["units"].values()
                  if "k" in st), None)
    arena_bytes = sum(t.numel() * t.element_size()
                      for part in ("units", "tail")
                      for st in engine.dstate[part].values()
                      for k, t in st.items() if k in ("k", "v", "ks", "vs"))
    return {
        "model": cfg.name, "layers": cfg.num_layers,
        "cut": (f"depth {published} -> {cfg.num_layers} layers; widths as "
                f"published" if cfg.num_layers < published else
                "none: every layer, widths as published"),
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
        "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": V,
        "pattern": [list(x) for x in cfg.pattern], "window": cfg.window,
        "dtype": str(cfg.dtype), "weight_gb": nbytes / 1e9,
        "kv_dtype": cfg.kv_dtype, "arena_gb": arena_bytes / 1e9,
        "lanes": LANES, "max_seq": MAX_SEQ, "pages_per_sb": PAGES_PER_SB,
        "arena_pages": int(arena.shape[1]) if arena is not None else 0,
        "setup_s": setup_s, "run_s": run_s, "steps": steps,
        "crash_at_step": crash_step, "recovery": stats,
        "floor_ms_per_step": nbytes / HBM_BYTES_PER_S * 1e3,
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
    """A copy on ``d`` (``.to`` alone returns the tensor itself when it is
    already there, and a train step updates its parameters in place)."""
    if isinstance(tree, dict):
        return {k: _to(v, d) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, d) for v in tree)
    return tree.to(d, copy=True)


def check_forward_vs_cpu(torch, dev) -> dict:
    """Every architecture's smoke configuration in fp32, the same weights
    on both devices: logits, collected K/V, aux and the loss within 1e-3
    (the front-end stubs fed random embeddings)."""
    from repro_torch.configs import ARCHS, get_smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
        params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
        g = torch.Generator().manual_seed(SEED + 6)
        toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
        batch = {"tokens": toks, "labels": toks}
        if cfg.frontend:
            batch = {"embeds": torch.randn((2, 64, cfg.d_model),
                                           generator=g), "labels": toks}
        res = {}
        for d in ("cpu", dev):
            p, b = _to(params, d), _to(batch, d)
            logits, aux, kv = T.forward(cfg, p, b, collect_kv=True)
            loss, _ = T.loss_fn(cfg, p, b)
            res[str(d)] = _to((logits, kv["units"], loss, aux), "cpu")
        (lc, kc, sc, ac), (lg, kg, sg, ag) = res["cpu"], res[str(dev)]
        errs = {"logits": float((lc - lg).abs().max()),
                "loss": abs(float(sc) - float(sg)),
                "aux": abs(float(ac) - float(ag))}
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
def _ce_from_logits(torch, logits, labels, causal: bool) -> float:
    """Mean CE straight from full logits (a check of ``loss_fn``'s chunked
    CE): next-token for a causal model, frame by frame for an encoder."""
    if causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return float((lse - gold).mean())


def run_forward(torch, cfg, params, dev, run, kernel, collect_kv) -> dict:
    """One warm-up forward, then the counted run: ``forward`` (with
    ``collect_kv`` when asked) and ``loss_fn`` on the run's random batch,
    each timed between device synchronizations.  ``kernel`` is the name of
    the port kernel on the path: once a layer of its mixer a pass, and
    no other kernel launches."""
    from repro_torch.launch.profile_forward import run_batch
    from repro_torch.models import transformer as T
    B, S = run.batch, run.seq
    batch = run_batch(cfg, run, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    T.forward(cfg, params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats(dev)

    # counts start at 0 here: everything below is the path
    zero_counts()
    t = time.perf_counter()
    out = T.forward(cfg, params, batch, collect_kv=collect_kv)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    t = time.perf_counter()
    with torch.no_grad():                  # scoring: no graph is kept
        loss, parts = T.loss_fn(cfg, params, batch)
    torch.cuda.synchronize()
    loss_s = time.perf_counter() - t
    counts = read_counts()
    launches = counts[kernel]

    logits = out[0]
    if logits.shape != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: logits {tuple(logits.shape)} "
                             f"are not finite [B, S, V]")
    mixers = {"flash_attention": ("attn", "local_attn"),
              "ssd_scan": ("mamba2",)}[kernel]
    n = sum(mx in mixers for mx, _ in cfg.layer_specs)
    if counts != dict.fromkeys(KERNELS, 0) | {kernel: 2 * n}:
        raise AssertionError(f"{cfg.name}: launches {counts} in forward + "
                             f"loss_fn, not 2 x {n} of {kernel} alone")
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
    ce_full = _ce_from_logits(torch, logits, batch["labels"], cfg.causal)
    ce = float(parts["ce"])
    if not abs(ce - ce_full) < 1e-3 * max(1.0, ce_full):
        raise AssertionError(f"{cfg.name}: loss_fn's CE {ce} != the CE of "
                             f"the forward's logits {ce_full}")
    del out, logits
    res.update({
        "first_forward_s": first_s,
        "ms_per_forward": 1e3 * fwd_s, "tokens_per_s": B * S / fwd_s,
        "ms_loss_fn": 1e3 * loss_s, "loss": float(loss), "ce_check": ce_full,
        "aux": float(parts["aux"]),
        "launches": counts, "launches_per_forward": launches // 2,
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    })
    return res


# ---------------------------------------------------------------------------
# phase 7: training -- the flash backward kernel, a step against the CPU,
# learning on the card, and starcoder2-3b whole
# ---------------------------------------------------------------------------
# the backward kernel's shapes: the other archs' head layouts, a partial
# tile, a window, fp32
FLASH_BWD_SWEEP = [  # B, H, K, S, dh, causal, window, dtype
    (1, 40, 8, 2048, 128, True, 0, "bfloat16"),       # qwen2.5-32b
    (1, 24, 8, 2048, 64, True, 0, "bfloat16"),        # granite-moe-3b-a800m
    (1, 48, 1, 1024, 128, True, 0, "bfloat16"),       # granite-20b
    (1, 16, 16, 2048, 128, True, 0, "bfloat16"),      # moonshot's MHA, g 1
    (1, 48, 1, 1000, 128, True, 0, "bfloat16"),       # split, S % 128 != 0
    (2, 16, 16, 1000, 80, False, 0, "bfloat16"),      # hubert-xlarge
    (1, 4, 2, 200, 128, True, 0, "bfloat16"),         # partial tile
    (1, 4, 2, 512, 128, True, 48, "bfloat16"),        # window 48
    (2, 6, 2, 333, 64, True, 100, "bfloat16"),        # window, dh 64
    (1, 4, 2, 200, 64, True, 0, "float32"),
    (1, 8, 2, 300, 128, False, 48, "float32"),        # fp32, window
    # above head_dim 128: wgmma with 64-key tiles at 192 / 256 (split here),
    # mma.sync with two warps a 16-key slice at 144, FMA with 8 keys a
    # block; windows, partial tiles, S % 64 != 0
    (1, 16, 1, 1000, 256, True, 48, "bfloat16"),      # recurrentgemma-9b
    (1, 96, 8, 333, 192, True, 0, "bfloat16"),        # nemotron-4-340b
    (1, 4, 2, 200, 144, False, 100, "bfloat16"),
    (1, 4, 1, 300, 256, True, 48, "float32"),
    (1, 8, 2, 333, 192, False, 0, "float32"),
    (1, 4, 2, 200, 144, True, 100, "float32"),
]
# the backward timed beside the training run's shape: nemotron-4-340b's
# heads (no card holds its training state at any depth, so a kernel check
# only) and recurrentgemma-9b's training run (1 x 8192, window 2048); both
# run the wgmma kernel's 64-key tiles
FLASH_BWD_TIMED = [
    (1, 96, 8, 4096, 192, True, 0, "bfloat16"),
    (1, 16, 1, 8192, 256, True, 2048, "bfloat16"),
]
TRAIN_ARCH = "starcoder2-3b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 6    # one warm step + 5
# mamba2-370m at the context of the Mamba-2 paper's Pile runs (arXiv
# 2405.21060), 8 sequences a step
SSD_TRAIN_ARCH = "mamba2-370m"
SSD_TRAIN_BATCH, SSD_TRAIN_SEQ = 8, 2048
# recurrentgemma-9b cut to 3 of its 12 pattern units (9 of 38 layers: 6
# RG-LRU, 3 local attention) at full width, 3.02 B parameters (~40 GB of
# bf16 weights and grads and fp32 AdamW moments; the whole model's ~122 GB
# fits no card), on 1 x 8192 tokens, its training length
HYBRID_TRAIN_ARCH = "recurrentgemma-9b"
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ = 9, 1, 8192
# its smoke config widened to the published head_dim (2 heads, 1 KV head,
# 3 layers): the train step on the card through both flash kernels at 256
HYBRID_WIDE_SMOKE = {"num_heads": 2, "num_kv_heads": 1, "head_dim": 256,
                     "num_layers": 3}
RESUME_STEPS = 2          # steps after the checkpoint's crash and recovery


def flash_bwd_flops(B, H, S, dh, causal, window) -> int:
    """Five products (S, dP, dV, dK, dQ) of 2 dh flops a visible pair."""
    return 10 * B * H * dh * visible_pairs(S, causal, window)


def check_flash_lse(torch, dev) -> dict:
    """The forward kernel's log-sum-exp against the plain version's, for
    each variant, with one query row scaled up so its max is large (the
    wgmma kernel keeps its running max in log2 units): within 1e-4 of
    max(1, |lse|)."""
    from repro_torch.kernels.flash_attention import kernel as fak
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    out = {}
    for B, H, K, S, dh, causal, win, dtn in [
            (1, 4, 2, 300, 128, True, 0, "bfloat16"),     # wgmma
            (1, 4, 2, 300, 192, True, 0, "bfloat16"),     # wgmma, 64-key tiles
            (1, 4, 1, 300, 256, True, 48, "bfloat16"),
            (1, 4, 2, 300, 80, False, 0, "bfloat16"),     # wgmma, dh 80
            (1, 4, 2, 300, 144, True, 0, "bfloat16"),     # mma.sync
            (1, 4, 2, 300, 64, True, 48, "float32"),      # fma
            (1, 4, 1, 300, 256, False, 0, "float32")]:
        dt = getattr(torch, dtn)
        q = torch.randn((B, H, S, dh), generator=g, device=dev)
        q[0, 1, 77] *= 30.0
        q = q.to(dt)
        k = torch.randn((B, K, S, dh), generator=g, device=dev).to(dt)
        v = torch.randn((B, K, S, dh), generator=g, device=dev).to(dt)
        _, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
        _, want = fak.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                window=win)
        torch.cuda.synchronize()
        err = float(((lse - want).abs() / want.abs().clamp(min=1.0)).max())
        if not err < 1e-4:
            raise AssertionError(f"flash_attention's lse ({fak.last_variant}"
                                 f") differs from the plain version's by "
                                 f"{err} of max(1, |lse|)")
        out[f"{fak.last_variant} dh {dh}"] = {
            "rel_err": err, "large_row_lse": float(want[0, 1, 77])}
    return out


def check_flash_bwd(torch, dev) -> dict:
    """The backward kernel against its plain version on the same inputs
    (o and lse from the forward kernel) at the training run's shape and at
    FLASH_BWD_SWEEP: bf16 dq, dk and dv each within BF16_ROW_TOL of a
    row's rms (the rms floored at GRAD_ROW_FLOOR of the tensor's), fp32
    within 1e-4 of max |plain|; the variant ``flash_bwd_variant`` names
    and, on the wgmma variant, ``bwd_split_count``'s split of the heads.
    Times at the training run's shape and at FLASH_BWD_TIMED; the library
    call is SDPA's forward + backward less its forward (the window as a
    mask)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fak
    sdpa = torch.nn.functional.scaled_dot_product_attention
    c = get_config(TRAIN_ARCH)
    main = (TRAIN_BATCH, c.num_heads, c.num_kv_heads, TRAIN_SEQ, c.head_dim,
            True, 0, "bfloat16")
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    sweep, timed = [], []
    for case in [main] + FLASH_BWD_TIMED + FLASH_BWD_SWEEP:
        B, H, K, S, dh, causal, win, dtn = case
        dt = getattr(torch, dtn)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v, do = randn(B, H, S, dh), randn(B, K, S, dh), \
            randn(B, K, S, dh), randn(B, H, S, dh)
        o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
        want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal, window=win)
        got = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=win)
        torch.cuda.synchronize()
        variant, splits = fak.last_bwd_variant, fak.last_bwd_splits
        pair = fak.last_bwd_pair
        want_split = fak.bwd_split_count(B, H, K, S, dh) \
            if variant == "wgmma" else 1
        timed_case = case == main or case in FLASH_BWD_TIMED
        if variant != fak.flash_bwd_variant(dt, dh) or \
                splits != want_split or (timed_case and variant != "wgmma"):
            raise AssertionError(
                f"flash_attention_bwd {case} ran {variant} split {splits}, "
                f"not {fak.flash_bwd_variant(dt, dh)} split {want_split}")
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if dt == torch.float32:
                e, unit = float((a - b).abs().max() / b.abs().max()), \
                    "of max |plain|"
                bad = not e < 1e-4
            else:
                e = fak.row_scaled_error(a, b, floor=fak.GRAD_ROW_FLOOR)
                unit, bad = "of a row's rms", not e < fak.BF16_ROW_TOL
            errs[name] = e
            if bad:
                raise AssertionError(
                    f"flash_attention_bwd {case}: {name} differs from the "
                    f"plain version by {e} {unit}")
        flops = flash_bwd_flops(B, H, S, dh, causal, win)
        es = q.element_size()
        nbytes = es * (3 * B * H * S * dh + 2 * B * K * S * dh
                       + 2 * B * H * S * dh + 2 * B * K * S * dh) \
            + 4 * B * H * S
        peak = BF16_FLOPS if es == 2 else FP32_FLOPS
        t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)

        def run():
            return fak.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=win)
        shape = {"q": [B, H, S, dh], "kv": [B, K, S, dh], "causal": causal,
                 "window": win, "dtype": dtn}
        tol = "1e-4 of max |plain|" if dt == torch.float32 else \
            {"row_scaled": fak.BF16_ROW_TOL, "floor": fak.GRAD_ROW_FLOOR}
        if case != main and case not in FLASH_BWD_TIMED:
            sweep.append({"shape": shape, "variant": variant,
                          "splits": splits, "pair": pair, "errors": errs,
                          "tolerance": tol,
                          "ms": graph_ms(torch, run, iters=10),
                          "bound_ms": bound})
            print(f"flash_attention_bwd {case} ({variant}, split {splits}): "
                  f"{errs}", flush=True)
            continue
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        if win:       # the window as a mask: keys (s - win, s]
            pos = torch.arange(S, device=dev)
            mask = (pos[None] <= pos[:, None]) & \
                (pos[None] > pos[:, None] - win)
            kw = {"attn_mask": mask}
            call = "attn_mask=<causal window>"
        else:
            kw = {"is_causal": True}
            call = "is_causal=True"

        def lib_fwd_bwd():
            sdpa(qr, kr, vr, enable_gqa=True, **kw).backward(do)
        lib = event_ms(torch, lib_fwd_bwd, iters=10) - event_ms(
            torch, lambda: sdpa(q, k, v, enable_gqa=True, **kw), iters=10)
        timed.append({
            "variant": variant, "splits": splits, "pair": pair,
            "max_abs_err": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)),
            "row_scaled_err": errs, "tolerance": tol,
            "ms": graph_ms(torch, run, iters=10),
            "eager_ms": event_ms(torch, run, iters=10),
            "plain_ms": event_ms(torch, lambda: fak.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, window=win), iters=2,
                warmup=1),
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib,
            "library_call": f"F.scaled_dot_product_attention({call}, "
                            "enable_gqa=True) forward + backward, less its "
                            "forward, on the same q, k, v, dO",
            "shape": shape})
        print(f"flash_attention_bwd {case} ({variant}, split {splits}, "
              f"pair {pair}): {errs}, {timed[-1]['ms']:.4f} ms (SDPA "
              f"{lib:.4f})",
              flush=True)
        del qr, kr, vr
    del q, k, v, do, o, lse, want, got
    torch.cuda.empty_cache()
    return dict({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
                 "replaces": "none: the reference's gradient is XLA's "
                             "autodiff of src/repro/layers/attention.py:80 "
                             "(chunked_attention); its Pallas kernel "
                             "(src/repro/kernels/flash_attention/kernel.py:"
                             "95) is forward-only"},
                **timed[0], timed_shapes=timed[1:], sweep=sweep)


def check_ssd_bwd(torch, dev) -> dict:
    """The scan's backward kernel against its plain version run on the
    card on the same inputs, at mamba2-370m's training shape (8 x 2048, 32
    heads of 64, N 128, fp32), at SSD_SWEEP's fp32 shapes and at the smoke
    widths: dxdt, dloga, dB and dC each within 1e-4 of max |plain|, and a
    second call bit-equal (no float atomics), given the h_in the forward
    kernel stores (within 1e-4 of max |plain| of ``ssd_phases``' h_in).
    Times at the training shape, the whole call and each of its three
    kernels (``parts_ms``), beside the reverse pass's and the
    chunk-gradient kernel's own bounds; no PyTorch call computes the
    scan's gradient."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.launch.bench_ssd_bwd import kernel_parts_ms, ptxas_lines
    from repro_torch.layers.ssd import n_heads
    c, sc = get_config(SSD_TRAIN_ARCH), get_smoke_config(SSD_TRAIN_ARCH)
    main = (SSD_TRAIN_BATCH, n_heads(c), SSD_TRAIN_SEQ, c.ssm_head_dim,
            c.ssm_state, None)
    smoke = (2, n_heads(sc), 64, sc.ssm_head_dim, sc.ssm_state, None)
    cases = [main] + [(Bz, H, S, P, N, decay)
                      for Bz, H, S, P, N, dtn, decay in SSD_SWEEP
                      if dtn == "float32"] + [smoke]
    g = torch.Generator(device=dev).manual_seed(SEED + 43)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    sweep, row = [], None
    for case in cases:
        Bz, H, S, P, N, decay = case
        xdt = randn(Bz, H, S, P, scale=0.1)
        loga = -randn(Bz, H, S, scale=0.1).abs() if decay is None \
            else torch.full((Bz, H, S), decay, device=dev)
        Bm, Cm = randn(Bz, S, N, scale=0.3), randn(Bz, S, N, scale=0.3)
        dy = randn(Bz, H, S, P)
        h_in, h_err = forward_h_in(torch, ssk, xdt, loga, Bm, Cm, case)
        want = ssk.ssd_scan_bwd_plain(xdt, loga, Bm, Cm, dy)
        got = ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        again = ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        torch.cuda.synchronize()
        errs = {name: float((a - b).abs().max() / b.abs().max())
                for name, a, b in zip(("dxdt", "dloga", "dB", "dC"), got,
                                      want)}
        bad = {k: e for k, e in errs.items() if not e < 1e-4}
        if bad or not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(
                f"ssd_scan_bwd {case}: differs from the plain version by "
                f"{bad} of max |plain| (tolerance 1e-4), or from itself")
        errs["h_in"] = h_err
        bound, by = ssd_bwd_bound(Bz, H, S, P, N)

        def run():
            return ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        shape = {"xdt": [Bz, H, S, P], "BC": [Bz, S, N], "dtype": "float32",
                 "log_decay": decay}
        if case != main:
            sweep.append({"shape": shape, "rel_err": errs,
                          "ms": graph_ms(torch, run, iters=20),
                          "bound_ms": bound})
            print(f"ssd_scan_bwd {case}: {errs}", flush=True)
            continue
        parts = kernel_parts_ms(torch, run)
        grads = ssd_bwd_grads_bound(Bz, H, S, P, N)
        reverse = ssd_bwd_reverse_bound(Bz, H, S, P, N)
        log = build.build_info.get("log", "")
        ptxas = ptxas_lines(log, "ssd_bwd_chunk_grads")
        ptxas_rev = ptxas_lines(log, "ssd_bwd_reverse_pass")
        print(f"ssd_scan_bwd parts at {case}: {parts} ms; the reverse "
              f"pass's bound {reverse}, the chunk-gradient kernel's "
              f"{grads}; ptxas {ptxas_rev} {ptxas}", flush=True)
        row = {
            "name": "ssd_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
            "replaces": "none: the reference's gradient is XLA's autodiff "
                        "of src/repro/layers/ssd.py:68 (ssd_chunked); its "
                        "Pallas kernel (src/repro/kernels/ssd_scan/"
                        "kernel.py:82) is forward-only",
            "max_abs_err": max(float((a - b).abs().max())
                               for a, b in zip(got, want)),
            "rel_err": errs, "tolerance": "1e-4 of max |plain|",
            "ms": graph_ms(torch, run, iters=10),
            "eager_ms": event_ms(torch, run, iters=10),
            "plain_ms": event_ms(torch, lambda: ssk.ssd_scan_bwd_plain(
                xdt, loga, Bm, Cm, dy), iters=2, warmup=1),
            "bound_ms": bound, "bound_by": by,
            # h_in comes from the forward: the design's work is the least
            "design_bound_ms": bound,
            # the same work at the fp32 FMA peak, not the kernels' rate
            "fma_bound_ms": ssd_bwd_bound(Bz, H, S, P, N,
                                          peak=FP32_FLOPS)[0],
            # each of the three kernels' device ms (torch.profiler), and
            # the reverse pass's and the chunk-gradient kernel's own
            # bounds and ptxas reports
            "parts_ms": parts, "reverse_bound": reverse,
            "reverse_ptxas": ptxas_rev, "grads_bound": grads,
            "grads_ptxas": ptxas,
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the SSD scan's "
                            "gradient (autograd through the plain version "
                            "is not one call)",
            "shape": shape}
    del xdt, loga, Bm, Cm, dy, want, got, again, h_in
    torch.cuda.empty_cache()
    row["sweep"] = sweep
    return row


def forward_h_in(torch, ssk, xdt, loga, Bm, Cm, where):
    """The h_in the forward kernel stores (``_launch_fwd(...,
    with_h_in=True)``) against the plain version's (``ssd_phases``), within
    1e-4 of its max |plain|: (h_in, that relative error)."""
    h_in = ssk._launch_fwd(xdt, loga, Bm, Cm, with_h_in=True)[1]
    want = ssk.ssd_phases(xdt, loga, Bm, Cm, with_h_in=True)[2]
    torch.cuda.synchronize()
    # with one chunk h_in is h_0 = 0 alone, on both sides
    err = float((h_in - want).abs().max() / want.abs().max().clamp(
        min=1e-30))
    if not err < 1e-4:
        raise AssertionError(f"ssd_scan's h_in at {where} differs from the "
                             f"plain version's by {err} of max |plain|")
    return h_in, err


def check_train_vs_cpu(torch, dev, arch: str = TRAIN_ARCH,
                       overrides: dict | None = None) -> dict:
    """One train step of ``arch``'s smoke configuration (with
    ``overrides`` of its fields) in fp32 on the card and on the CPU from
    the same weights and batch: the loss, every gradient leaf and every
    parameter after the step within 1e-3 (the card runs both flash
    kernels, fp32 variants, or both ssd_scan kernels; the CPU the plain
    versions)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32,
                              **(overrides or {}))
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 42)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen)
    batch = {"tokens": toks, "labels": toks}
    res = {}
    for d in ("cpu", dev):
        p, b = _to(cpu, d), _to(batch, d)
        loss, grads = loss_and_grads(cfg, p, b)
        step = make_train_step(cfg, AdamWConfig(warmup_steps=1))
        p, _, m = step(p, init_opt_state(p), b)
        res[str(d)] = (float(loss), {k: g.detach().cpu() for k, g in
                                     tree_leaves(grads)},
                       {k: t.detach().cpu() for k, t in tree_leaves(p)},
                       float(m["grad_norm"]))
    (lc, gc, pc, nc), (lg, gg, pg, ng) = res["cpu"], res[str(dev)]
    errs = {"loss": abs(lc - lg), "grad_norm": abs(nc - ng),
            "grads": max(float((gc[k] - gg[k]).abs().max()) for k in gc),
            "params": max(float((pc[k] - pg[k]).abs().max()) for k in pc)}
    bad = {k: e for k, e in errs.items() if not e < 1e-3}
    if bad:
        raise AssertionError(f"{arch}: the train step on the card differs "
                             f"from the CPU: {bad}")
    return errs


def learn_fixed_pattern(torch, dev) -> dict:
    """The trainer on the card (starcoder2-3b smoke, 2 layers, vocab 64,
    bf16) on a repeated 7-token pattern: 30 steps, the last loss below 0.7
    of the first."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = dataclasses.replace(get_smoke_config(TRAIN_ARCH), num_layers=2,
                              vocab_size=64)
    tr = Trainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=5), device=dev)

    class Fixed:
        def batch_at(self, step):
            t = (np.arange(2 * 32).reshape(2, 32) % 7).astype(np.int32)
            return {"tokens": t, "labels": t}
    hist = tr.run(Fixed(), steps=30, log_every=1000)
    if not hist[-1] < 0.7 * hist[0]:
        raise AssertionError(f"the trainer on the card did not learn the "
                             f"pattern: loss {hist[0]} -> {hist[-1]}")
    return {"first_loss": hist[0], "last_loss": hist[-1], "steps": 30}


def train_full_width(torch, dev, arch: str = TRAIN_ARCH,
                     batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                     ckpt: bool = True,
                     layers: int | None = None) -> tuple[dict, dict]:
    """``arch`` at published widths (every layer, or the first ``layers``;
    random weights from the seed, bf16, AdamW, remat per unit) through
    ``Trainer`` on ``TokenStream`` batches of batch x seq: TRAIN_STEPS
    steps, the first a warm-up.  Losses and grad norms finite, the parameters moved, and per
    step 2 forward launches a layer of its mixer's kernel (the forward and
    the unit's recompute) and 1 backward, nothing else: flash for
    attention, ssd_scan for Mamba-2.

    With ``ckpt`` the trainer checkpoints to a ``CheckpointManager`` on a
    fast-mode RAM heap sized for one save of the whole state (plus 5 %)
    with ``ckpt_every=TRAIN_STEPS``: one save, after the last timed step.
    Just before it each leaf's checksum is taken on the card
    (``leaf_sums``).  Returns the run's numbers and what
    ``resume_full_width`` needs."""
    import math
    import statistics
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.layout import SB_SIZE
    from repro_torch.core.ralloc import Ralloc
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.layers.ssd import n_heads
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_config(arch)
    cut = "none: every layer, widths as published"
    if layers is not None and layers < cfg.num_layers:
        cut = (f"depth: {layers} of {cfg.num_layers} layers (the first "
               f"{layers // len(cfg.pattern)} pattern units), widths as "
               f"published")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    saved = {}
    if ckpt:
        saved["mem_available_gb"] = host_mem_available_gb()
    t = time.perf_counter()
    tr = Trainer(cfg, AdamWConfig(), seed=SEED, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    if ckpt:
        state = ckpt_state(tr)
        state_bytes = sum(x.numel() * x.element_size()
                          for x in _leaves(state))
        del state
        heap_size = -(-int(state_bytes * 1.05 + (64 << 20)) // SB_SIZE) * \
            SB_SIZE
        t = time.perf_counter()
        heap = Ralloc(None, heap_size)
        saved.update(heap=heap, heap_size=heap_size, state_bytes=state_bytes,
                     heap_open_s=time.perf_counter() - t)
        manager = CheckpointManager(heap)
        real_save = manager.save
        # the save's parts: block placement (descriptor writes) and the
        # shard copies into the heap
        parts = saved["save_parts_s"] = {"malloc": 0.0, "_store": 0.0}
        for obj, name in ((heap, "malloc"), (manager, "_store")):
            setattr(obj, name, _timed(getattr(obj, name), parts, name))

        def timed_save(tree, step):
            saved["leaf_sums"] = leaf_sums(torch, tree)
            saved["step"] = step
            t = time.perf_counter()
            real_save(tree, step)
            saved["save_s"] = time.perf_counter() - t
        manager.save = timed_save
        tr.ckpt, tr.ckpt_every = manager, TRAIN_STEPS
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=SEED)

    L = cfg.num_layers
    n_attn = sum(mx in ("attn", "local_attn") for mx, _ in cfg.layer_specs)
    n_ssd = sum(mx == "mamba2" for mx, _ in cfg.layer_specs)
    mixer, leaf = ("attn", "wq") if n_attn else ("ssd", "in_x")
    # the pattern's first layer with that mixer (a hybrid's is not the first)
    unit = "l%d" % next(i for i, (mx, _) in enumerate(cfg.pattern)
                        if mx in ("attn", "local_attn", "mamba2"))

    def probe():
        return {f"{mixer}.{leaf}": tr.params["units"][unit][mixer][leaf][0],
                "embed": tr.params["embed"][:256]}
    before = {k: t.detach().float().clone() for k, t in probe().items()}
    norms = []
    step_fn = tr.step_fn

    def recorded(*args):
        out = step_fn(*args)
        norms.append(float(out[2]["grad_norm"]))
        return out
    tr.step_fn = recorded
    torch.cuda.reset_peak_memory_stats(dev)

    # counts start at 0 here: everything below is the path
    zero_counts()
    losses = tr.run(stream, steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict.fromkeys(KERNELS, 0) | {
        "flash_attention": 2 * n_attn * TRAIN_STEPS,
        "flash_attention_bwd": n_attn * TRAIN_STEPS,
        "ssd_scan": 2 * n_ssd * TRAIN_STEPS,
        "ssd_scan_bwd": n_ssd * TRAIN_STEPS}
    if counts != want:
        raise AssertionError(f"train {arch}: launches {counts}, want {want}")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train {arch}: non-finite loss or grad norm: "
                             f"{losses} {norms}")
    moved = {k: float((t.detach().float() - before[k]).abs().max())
             for k, t in probe().items()}
    if not all(m > 0 for m in moved.values()):
        raise AssertionError(f"train {arch}: the parameters did not move: "
                             f"{moved}")
    step_ms = [1e3 * x for x in tr.step_times[1:]]
    ms = statistics.median(step_ms)
    T = batch * seq
    n_params = cfg.param_count()
    # the attention's forward over the pairs its mask lets through (a
    # local-attention layer's window, the causal triangle without one)
    attn_fwd = sum(4 * batch * cfg.num_heads * cfg.head_dim * visible_pairs(
        seq, cfg.causal, cfg.window if mx == "local_attn" else 0)
        for mx, _ in cfg.layer_specs if mx in ("attn", "local_attn"))
    scan_fwd = ssd_flops(batch, n_heads(cfg), seq, cfg.ssm_head_dim,
                         cfg.ssm_state) * n_ssd
    model_flops = 6 * n_params * T + 3 * (attn_fwd + scan_fwd)
    # what the step computes with the unit remat: one more forward
    remat_flops = model_flops + 2 * n_params * T + attn_fwd + scan_fwd
    shape = {"heads": [cfg.num_heads, cfg.num_kv_heads],
             "head_dim": cfg.head_dim, "window": cfg.window,
             "d_ff": cfg.d_ff} if n_attn else {
        "ssm_heads": n_heads(cfg), "ssm_head_dim": cfg.ssm_head_dim,
        "ssm_state": cfg.ssm_state, "expand": cfg.expand}
    return {
        "model": cfg.name, "layers": L, "d_model": cfg.d_model, **shape,
        "vocab": cfg.vocab_size, "dtype": str(cfg.dtype),
        "cut": cut,
        "params": n_params, "batch": batch, "seq": seq,
        "steps": TRAIN_STEPS, "setup_s": setup_s, "losses": losses,
        "grad_norms": norms, "moved": moved,
        "ms_per_step_median": ms, "ms_per_step": step_ms,
        "first_step_ms": 1e3 * tr.step_times[0],
        "tokens_per_s": T / (ms / 1e3),
        "model_flops_per_step": model_flops,
        "remat_flops_per_step": remat_flops,
        "model_flop_share": model_flops / (ms / 1e3) / BF16_FLOPS,
        "ideal_ms_at_peak": remat_flops / BF16_FLOPS * 1e3,
        "peak_mem_gb": peak, "launches": counts,
        "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
    }, saved


def _timed(fn, acc: dict, key: str):
    """``fn``, adding its seconds to ``acc[key]`` at every call."""
    def call(*args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[key] += time.perf_counter() - t
    return call


def host_mem_available_gb() -> float:
    """The host's ``MemAvailable`` (``/proc/meminfo``), GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024 / 1e9
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def ckpt_state(tr) -> dict:
    """The tree a ``Trainer`` checkpoints."""
    return {"p": tr.params, "o_m": tr.opt["m"], "o_v": tr.opt["v"]}


def leaf_sums(torch, tree) -> list[int]:
    """Per leaf, the int64 sum of its bits read as int16 / int32 (by its
    element size), computed where the leaf lies."""
    ints = {2: torch.int16, 4: torch.int32}
    return [int(x.detach().view(ints[x.element_size()]).sum(
        dtype=torch.int64)) for x in _leaves(tree)]


def _bits_equal(torch, a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def copy_gb_per_s(torch, dev, nbytes: int, to_device: bool) -> float:
    """GB/s of one ``nbytes`` copy between pinned host memory and the
    card (after a warm copy of 64 MB), the floor of a save or a load."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    src, dst = (host, card) if to_device else (card, host)
    dst[:64 << 20].copy_(src[:64 << 20])
    torch.cuda.synchronize()
    t = time.perf_counter()
    dst.copy_(src)
    torch.cuda.synchronize()
    return nbytes / (time.perf_counter() - t) / 1e9


def pageable_d2h_gb_per_s(torch, dev, nbytes: int) -> dict:
    """GB/s of an ``nbytes`` copy from the card into fresh pageable host
    memory from ``np.zeros`` (every page faulted in by the copy, as a
    save's heap is), again into the same, now resident, memory, and into
    fresh anonymous memory advised to use transparent huge pages."""
    import mmap
    import numpy as np
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    buf = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    buf.madvise(mmap.MADV_HUGEPAGE)
    zeros = torch.from_numpy(np.zeros(nbytes, np.uint8))
    out = {}
    for key, host in (("fresh", zeros), ("resident", zeros),
                      ("fresh_hugepage",
                       torch.from_numpy(np.frombuffer(buf, np.uint8)))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        host.copy_(card)
        torch.cuda.synchronize()
        out[key] = nbytes / (time.perf_counter() - t) / 1e9
    return out


def check_checkpoint_vs_cpu(torch, dev) -> dict:
    """Phase 8a: the starcoder2-3b smoke state (params and AdamW moments
    after one CPU train step) saved with ``CheckpointManager`` from CUDA
    tensors into one fast-mode heap and from the CPU tensors into another:
    the two images equal word for word.  Then a second save from the card
    torn between its fences and the root swing (``set_root`` raises once),
    a crash, a reopen over the same image and ``recover``: ``load_latest``
    gives the first checkpoint, bit-equal on the card, and the reachable
    blocks are exactly its shards and manifest (the torn save's swept)."""
    import numpy as np
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import layout
    from repro_torch.core.ralloc import Ralloc
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.tree import tree_map
    cfg = get_smoke_config(TRAIN_ARCH)
    tr = Trainer(cfg, AdamWConfig(warmup_steps=1), seed=SEED, device="cpu")
    tr.run(TokenStream(cfg.vocab_size, 2, 32, seed=SEED), steps=1,
           log_every=1000)
    cpu = ckpt_state(tr)
    card = _to(cpu, dev)
    size = 64 << 20
    heaps, mgrs = {}, {}
    for where, tree in (("cpu", cpu), ("cuda", card)):
        heaps[where] = Ralloc(None, size)
        mgrs[where] = CheckpointManager(heaps[where])
        mgrs[where].save(tree, step=1)
    used_sbs = int(heaps["cpu"].mem.read(layout.M_USED_SBS))
    if not np.array_equal(heaps["cpu"].mem.nvm, heaps["cuda"].mem.nvm):
        raise AssertionError("the heap saved from the card differs from the "
                             "heap saved from the CPU")
    heap = heaps["cuda"]
    real = heap.set_root

    def torn(*args, **kw):
        heap.set_root = real
        raise RuntimeError("crash before the root swing")
    heap.set_root = torn
    try:
        mgrs["cuda"].save(tree_map(lambda t: t + 1, card), step=2)
        raise AssertionError("the torn save committed")
    except RuntimeError as e:
        if "root swing" not in str(e):
            raise
    heap.heap.crash()
    heap2 = Ralloc(None, size, backing=heap.mem.nvm)
    mgr2 = CheckpointManager(heap2)
    for root in (0, 1):
        heap2.get_root(root, "ckpt_manifest")
    stats = heap2.recover()
    got, step = mgr2.load_latest(card)
    leaves = list(zip(_leaves(got), _leaves(card)))
    n = len(leaves)
    if step != 1 or not all(g.device == c.device and _bits_equal(torch, g, c)
                            for g, c in leaves):
        raise AssertionError(f"load_latest after the torn save: step {step},"
                             f" not the first checkpoint bit for bit")
    if stats["reachable_blocks"] != n + 1:
        raise AssertionError(f"reachable blocks {stats['reachable_blocks']}"
                             f", want {n} shards + the manifest")
    return {"leaves": n, "used_superblocks": used_sbs,
            "card_image_equals_cpu_image": True, "restored_step": step,
            "reachable_blocks": stats["reachable_blocks"],
            "free_superblocks": stats["free_superblocks"]}


def resume_full_width(torch, dev, saved: dict, stream_steps: int) -> dict:
    """Phase 8b after the timed run: a crash of the heap holding its one
    save, a reopen over the same image, ``recover`` (timed by phase, the
    conservative scan's bytes counted), a new ``Trainer`` with the same
    checkpoint store that starts at the saved step with every leaf's
    checksum equal to the saved one, and ``stream_steps`` more steps:
    finite losses and grad norms, 2 forward and 1 backward flash launches
    a layer a step.  Beside it, one 4 GB copy each way through pinned
    memory: the floors of the save and the load."""
    import gc
    import math
    from repro_torch import obs
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core.heap_recovery import PHASES
    from repro_torch.core.ralloc import Ralloc
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = get_config(TRAIN_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    d2h = copy_gb_per_s(torch, dev, 4 << 30, to_device=False)
    h2d = copy_gb_per_s(torch, dev, 4 << 30, to_device=True)
    pageable = pageable_d2h_gb_per_s(torch, dev, 4 << 30)
    torch.cuda.empty_cache()
    thp = Path("/sys/kernel/mm/transparent_hugepage/enabled")

    heap = saved.pop("heap")
    heap.heap.crash()
    image = heap.mem.nvm
    del heap
    scan = obs.counter("recovery.conservative_scan_bytes")
    scan0 = scan.value
    heap = Ralloc(None, saved["heap_size"], backing=image)
    if not heap.dirty_restart:
        raise AssertionError("the crashed heap reopened clean")
    ckpt = CheckpointManager(heap)
    for root in (0, 1):
        heap.get_root(root, "ckpt_manifest")
    t = time.perf_counter()
    stats = heap.recover()
    recover_s = time.perf_counter() - t

    real_load = ckpt.load_latest
    load = {}

    def timed_load(tree_like=None):
        t = time.perf_counter()
        out = real_load(tree_like)
        torch.cuda.synchronize()
        load["s"] = time.perf_counter() - t
        return out
    ckpt.load_latest = timed_load
    tr = Trainer(cfg, AdamWConfig(), seed=SEED, device=dev, ckpt=ckpt,
                 ckpt_every=saved["step"])
    if tr.start_step != saved["step"] or tr.opt["step"] != saved["step"]:
        raise AssertionError(f"resumed at {tr.start_step}, want "
                             f"{saved['step']}")
    sums = leaf_sums(torch, ckpt_state(tr))
    if sums != saved["leaf_sums"]:
        bad = [i for i, (a, b) in enumerate(zip(sums, saved["leaf_sums"]))
               if a != b]
        raise AssertionError(f"restored leaves {bad} differ from the saved")
    norms = []
    step_fn = tr.step_fn

    def recorded(*args):
        out = step_fn(*args)
        norms.append(float(out[2]["grad_norm"]))
        return out
    tr.step_fn = recorded
    stream = TokenStream(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ, seed=SEED)

    # counts start at 0 here: the resumed steps are the path
    zero_counts()
    losses = tr.run(stream, steps=tr.start_step + stream_steps, log_every=1)
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.num_layers
    want = dict.fromkeys(KERNELS, 0) | {
        "flash_attention": 2 * L * stream_steps,
        "flash_attention_bwd": L * stream_steps}
    if counts != want:
        raise AssertionError(f"resumed train launches {counts}, want {want}")
    if len(losses) != stream_steps or not all(
            math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"resumed losses {losses}, grad norms {norms}")
    gb = saved["state_bytes"] / 1e9
    return {
        "model": cfg.name, "layers": L,
        "cut": "none: every layer, widths as published",
        "state_gb": gb, "leaves": len(saved["leaf_sums"]),
        "heap_gb": saved["heap_size"] / 1e9,
        "heap_open_s": saved["heap_open_s"],
        "save_s": saved["save_s"], "save_gb_per_s": gb / saved["save_s"],
        "save_parts_s": saved["save_parts_s"],
        "d2h_pinned_4gb_gb_per_s": d2h,
        "d2h_pageable_4gb_gb_per_s": pageable,
        "host_transparent_hugepages": (thp.read_text().strip()
                                       if thp.exists() else None),
        "recover_s": recover_s,
        "recover_phases_s": {k: stats["phases"][k]["seconds"]
                             for k in PHASES},
        "conservative_scan_bytes": scan.value - scan0,
        "reachable_blocks": stats["reachable_blocks"],
        "large_blocks": stats["large_blocks"],
        "load_s": load["s"], "load_gb_per_s": gb / load["s"],
        "h2d_pinned_4gb_gb_per_s": h2d,
        "resumed_at_step": tr.start_step, "leaf_sums_equal": True,
        "resumed_losses": losses, "resumed_grad_norms": norms,
        "launches": counts,
        "mem_available_gb_at_start": saved["mem_available_gb"],
    }


# ---------------------------------------------------------------------------
# phase 9: the sharded decode step, ranks sharing the card over gloo
# ---------------------------------------------------------------------------
MESH_RANKS = 4
# Ranks that share one card take turns on it at every collective, so a
# mesh step costs ~4-8 ms a collective there: each mesh run goes on from
# a state decoded on one device (``to_mesh_layout``), across a page or a
# window.  qwen2.5-32b: 8 lanes decode 252 steps on one device, then 48
# on the mesh, across the boundary of their third page of 128
MESH_FROM, MESH_STEPS, MESH_MAX_SEQ = 252, 300, 512
MESH_KEEP = (0, 3, 4, 5, 24, 47)     # mesh steps whose logits are held
MESH_SMOKE_STEPS = 24                # the fp32 smoke config: from step 0
# recurrentgemma-9b sequence-parallel at batch 1: 2016 steps on one
# device, then 96 on the mesh, across its 2048 window (inside its
# 17-column table).  Depth cut to one pattern unit and the tail: the
# whole 38 layers take ~150 s here, and in bf16 the mesh's gap to one
# device grows with depth past the 3e-2 bound while fp32 stays within
# 5e-6 (launch/mesh_depth.py, PERF.md)
HYBRID_MESH_LAYERS = 5
HYBRID_MESH_FROM, HYBRID_MESH_STEPS = 2016, 2112
HYBRID_MESH_KEEP = (0, 31, 32, 33, 95)
# the shards of qwen2.5-32b's arenas (page 128) the kernels are held at:
# (name, tp, model coordinate, data shards splitting the table, data
# coordinate)
SHARD_LAYOUTS = (("tp 2, shard 1: page_loc 64", 2, 1, 1, 0),
                 ("tp 4, shard 0: page_loc 32", 4, 0, 1, 0),
                 ("tp 4, shard 3: page_loc 32", 4, 3, 1, 0),
                 ("seq-parallel dp 2 x tp 2, shard (1, 0)", 2, 0, 2, 1))


def check_shard_kernels(torch, dev) -> dict:
    """rope_kv_append (bf16, int8: bit-equal, q and the local arena but its
    dump page) and paged_attention (bf16 and int8 within 3e-2 and
    BF16_ROW_TOL of a row's rms, fp32 within 1e-5; the LSE output within 1e-4 of max(1,
    |lse|); a lane with no slot on the shard exactly 0 with lse -inf)
    against their plain versions at SHARD_LAYOUTS: 8 lanes of qwen2.5-32b's
    heads over a 1024-position table, the shard's slots and columns, lane
    ranges from ``local_count`` with and without a window.  Times of the
    kernels as the mesh path calls them (paged with the LSE).  Rows by
    kernel name."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.kv_update.kernel import Slots
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.layers.rope import rope_freqs

    B, H, K, dh, page, P = LANES, 40, 8, 128, 128, 8
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    out = {k: [] for k in ("rope_kv_append", "rope_kv_append_int8",
                           "paged_attention", "paged_attention_int8")}

    def randn(*shape, dt=torch.bfloat16, scale=1.0):
        return (scale * torch.randn(shape, generator=g, device=dev)).to(dt)

    for name, tp, r, dp, d in SHARD_LAYOUTS:
        pl, P_loc, seq = page // tp, P // dp, dp > 1
        sl = Slots(page, r * pl, d * P_loc if seq else 0, seq)
        pages = B * P_loc + 1
        table = torch.randperm(pages - 1, generator=g, device=dev)[
            :B * P_loc].to(torch.int32).reshape(B, P_loc)
        table[2, 0] = -1
        pos = torch.randint(0, P * page, (B,), generator=g, device=dev,
                            dtype=torch.int32)
        pos[0], pos[1] = 5, P * page + 3     # first slots; past the table
        held = int((kvk.locate(pos, table, pl, sl)[0] >= 0).sum())
        for int8 in (False, True):
            args = (randn(B, H * dh), randn(B, K * dh), randn(B, K * dh),
                    randn(H * dh, scale=0.5), randn(K * dh, scale=0.5),
                    randn(K * dh, scale=0.5),
                    rope_freqs(dh, 1e6, dev), pos, table)
            if int8:
                (ak, ks), (av, vs) = (kvk.quantize_rows(randn(
                    pages, pl, K, dh)) for _ in range(2))
                flat = [ak, av, ks, vs]
            else:
                flat = [randn(pages, pl, K, dh), randn(pages, pl, K, dh)]
            ref = [t.clone() for t in flat]
            want = kvk.rope_kv_append_plain(*args, *_nest(ref), slots=sl)
            got = kvk.rope_kv_append(*args, *_nest(flat), slots=sl)
            torch.cuda.synchronize()
            # the rows the shard does not hold all go to the dump page's
            # slot 0, in no set order: the dump page is left out
            if not (torch.equal(got, want) and all(
                    torch.equal(a[:-1], b[:-1]) for a, b in zip(flat, ref))):
                raise AssertionError(f"rope_kv_append{' (int8)' * int8} at "
                                     f"{name} differs from its plain version")
            es = 2
            rows = held * 2 * K * (dh + 4) if int8 else held * 2 * K * dh * es
            nbytes = (2 * B * H * dh + 2 * B * K * dh + (H + 2 * K) * dh) \
                * es + rows + dh // 2 * 4 + 2 * B * 4 + B * 4
            fn = (lambda: kvk.rope_kv_append(*args, *_nest(flat), slots=sl))
            out["rope_kv_append_int8" if int8 else "rope_kv_append"].append({
                "layout": name, "page_loc": pl, "slots": list(sl),
                "held_lanes": held, "max_abs_err": 0.0, "tolerance": 0.0,
                "ms": graph_ms(torch, fn), "eager_ms": event_ms(torch, fn),
                "plain_ms": event_ms(torch, lambda: kvk.rope_kv_append_plain(
                    *args, *_nest(flat), slots=sl)),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"})
        lens = torch.randint(1, P * page, (B,), generator=g, device=dev,
                             dtype=torch.int32)
        lens[0] = 6                          # on the first slots only
        for window in (0, 300):
            lo = torch.clamp(lens - window, min=0) if window else \
                torch.zeros_like(lens)
            starts = pak.local_count(lo, sl, pl, P_loc)
            ends = pak.local_count(lens, sl, pl, P_loc)
            for dtn, int8 in (("bfloat16", False), ("float32", False),
                              ("bfloat16", True)):
                dt = getattr(torch, dtn)
                q = randn(B, H, dh, dt=dt)
                if int8:
                    (ak, ks), (av, vs) = (kvk.quantize_rows(randn(
                        pages, pl, K, dh)) for _ in range(2))
                    scales = (ks, vs)
                else:
                    ak, av = randn(pages, pl, K, dh, dt=dt), randn(
                        pages, pl, K, dh, dt=dt)
                    scales = None
                call = (q, ak, av, table, ends)
                kw = dict(starts=starts, scales=scales)
                w_o, w_lse = pak.paged_attention_plain(*call, **kw,
                                                       return_lse=True)
                g_o, g_lse = pak.paged_attention(*call, **kw,
                                                 return_lse=True)
                g_q = pak.paged_attention(*call, **kw)
                w_q = pak.paged_attention_plain(*call, **kw)
                torch.cuda.synchronize()
                fin = torch.isfinite(w_lse)
                lse_err = float(((g_lse - w_lse).abs() / w_lse.abs().clamp(
                    min=1.0))[fin].max()) if bool(fin.any()) else 0.0
                err = max(float((g_o - w_o).abs().max()),
                          float((g_q.float() - w_q.float()).abs().max()))
                row_err = max(fak.row_scaled_error(g_o, w_o),
                              fak.row_scaled_error(g_q, w_q))
                tol = 1e-5 if dt == torch.float32 else 3e-2
                empty = ends <= starts
                if not (err < tol and lse_err < 1e-4
                        and torch.equal(torch.isfinite(g_lse), fin)
                        and (dt == torch.float32
                             or row_err < fak.BF16_ROW_TOL)
                        and not bool(g_o[empty].any())
                        and not bool(g_q[empty].any())):
                    raise AssertionError(
                        f"paged_attention {dtn}{' int8' * int8} at {name}, "
                        f"window {window}: {err} (tolerance {tol}), "
                        f"{row_err} of a row's rms, lse {lse_err}, or an "
                        f"empty lane not 0 / -inf")
                if dtn == "float32":
                    continue
                bound, tokens = bp_bound(torch, call, starts, scales)
                t_ops = 4 * H * dh * tokens / BF16_FLOPS * 1e3
                fn = (lambda: pak.paged_attention(*call, **kw,
                                                  return_lse=True))
                out["paged_attention_int8" if int8 else
                    "paged_attention"].append({
                        "layout": name, "page_loc": pl, "window": window,
                        "slots": list(sl), "table": [B, P_loc],
                        "valid_tokens": tokens, "empty_lanes": int(
                            empty.sum()), "max_abs_err": err,
                        "row_scaled_err": row_err, "lse_rel_err": lse_err,
                        "splits": pak.split_count(B, K, P_loc, pl)[0],
                        "ms": graph_ms(torch, fn),
                        "eager_ms": event_ms(torch, fn),
                        "plain_ms": event_ms(torch, lambda: (
                            pak.paged_attention_plain(*call, **kw,
                                                      return_lse=True))),
                        "bound_ms": max(bound, t_ops),
                        "bound_by": "bytes" if bound >= t_ops
                        else "operations", "library_ms": None})
    return out


def bp_bound(torch, call, starts, scales) -> tuple[float, int]:
    """(ms, valid local positions) of a paged call with lane ranges: q
    read and the fp32 output and LSE written once, the table and both
    range ends read once, each valid K and V row (and int8 scale) read
    once, over the card's memory rate."""
    q, ak, _, bt, ends = call
    B, H, dh = q.shape
    _, page, K, _ = ak.shape
    t = torch.arange(bt.shape[1] * page, device=q.device)[None]
    valid = (t >= starts[:, None]) & (t < ends[:, None]) & \
        torch.repeat_interleave(bt >= 0, page, dim=1)
    tokens = int(valid.sum())
    row = dh * ak.element_size() + (4 if scales is not None else 0)
    nbytes = (B * H * dh * (q.element_size() + 4) + B * H * 4
              + bt.numel() * 4 + 2 * B * 4 + 2 * tokens * K * row)
    return nbytes / HBM_BYTES_PER_S * 1e3, tokens


def check_mesh(torch, dev, card) -> tuple[dict, dict]:
    """The sharded decode step (``make_decode_step``) on MESH_RANKS ranks
    that share the card over gloo, each holding its blocks of the seeded
    weights (cut leaf by leaf), against ``decode_step`` on the card with
    the same weights: qwen2.5-32b at full width (the serve run's 8 layers,
    8 lanes) on a (1, 4) and a (2, 2) mesh, data shards with shard-local
    page ids, going on from the one-device state at MESH_FROM across a
    page boundary (bf16: logits within 3e-2 of the largest at MESH_KEEP);
    its smoke config in fp32 (page 8) on (2, 2) from step 0 (identical
    tokens, logits within 1e-4); recurrentgemma-9b (published widths,
    HYBRID_MESH_LAYERS layers) sequence-parallel at batch 1 on (2, 2)
    from HYBRID_MESH_FROM across its 2048 window (within 3e-2).  Returns
    the detail and each run's launches (summed over the ranks) by path."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh_decode import decode_jobs, \
        one_device_decode
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.launch.profile_forward import run_config

    qcfg = run_config("qwen2.5-32b")
    scfg = dataclasses.replace(get_smoke_config("qwen2.5-32b"),
                               dtype=torch.float32, vocab_size=128,
                               page_size=8)
    hcfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                               num_layers=HYBRID_MESH_LAYERS)
    rng = np.random.default_rng(SEED + 50)
    qtok = rng.integers(0, qcfg.vocab_size, (LANES, MESH_STEPS),
                        dtype=np.int32)
    stok = rng.integers(0, 128, (4, MESH_SMOKE_STEPS), dtype=np.int32)
    htok = rng.integers(0, hcfg.vocab_size, (1, HYBRID_MESH_STEPS),
                        dtype=np.int32)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    # name, config, mesh, sequence-parallel, tokens, first step, max_seq,
    # kept steps (of the mesh run)
    runs = [(f"{qcfg.name} (1, 4)", qcfg, (1, 4), False, qtok, MESH_FROM,
             MESH_MAX_SEQ, MESH_KEEP),
            (f"{qcfg.name} (2, 2)", qcfg, (2, 2), False, qtok, MESH_FROM,
             MESH_MAX_SEQ, MESH_KEEP),
            (f"{qcfg.name} smoke fp32 (2, 2)", scfg, (2, 2), False, stok, 0,
             64, tuple(range(MESH_SMOKE_STEPS))),
            (f"{hcfg.name} sequence-parallel (2, 2)", hcfg, (2, 2), True,
             htok, HYBRID_MESH_FROM, 4096, HYBRID_MESH_KEEP)]
    refs, paths, jobs = [], {}, []
    try:
        for i, (name, cfg, mesh, seq, tok, first, max_seq, keep) in \
                enumerate(runs):
            job = {"cfg": cfg, "mesh": (mesh, ("data", "model")),
                   "device": "cuda", "batch_sharded": not seq, "seed": SEED,
                   "max_seq": max_seq, "tokens": tok[:, first:],
                   "keep_steps": list(keep)}
            if first:
                job["state_file"] = str(tmp / f"state{i}.pt")
            jobs.append(job)
        # the one-device runs, each once for the meshes that go on from it
        for idx in ((0, 1), (2,), (3,)):
            name, cfg, _, seq, tok, first, max_seq, keep = runs[idx[0]]
            t = time.perf_counter()
            ref = one_device_decode(
                cfg, dev, tok, max_seq, [first + k for k in keep],
                (first, [(runs[i][2][0], not seq, jobs[i]["state_file"])
                         for i in idx]) if first else None, seed=SEED)
            ref["seconds"] = time.perf_counter() - t
            torch.cuda.empty_cache()      # the ranks need the card's memory
            paths[f"mesh one-device reference of {name}"] = dict(
                read_zero(), **ref["launches"])
            print(f"mesh one-device reference of {name}: "
                  f"{ref['ms_per_step_median']:.3f} ms/step, "
                  f"{ref['seconds']:.1f} s for {tok.shape[1]} steps",
                  flush=True)
            refs += [ref] * len(idx)
        t = time.perf_counter()
        res = run_ranks(decode_jobs, MESH_RANKS, jobs, device="cuda",
                        timeout=900)
        wall = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    detail = {"ranks": MESH_RANKS, "card": card, "wall_s": wall,
              "note": f"{MESH_RANKS} ranks on one H100 over gloo: not a "
                      f"multi-card number", "runs": {}}
    for i, (name, cfg, mesh, seq, tok, first, max_seq, keep) in \
            enumerate(runs):
        r0, ref = res[0][i], refs[i]
        scale = float(np.abs(ref["logits"]).max()) + 1e-9
        rel = float(np.abs(r0["logits"] - ref["logits"]).max()) / scale
        same = float((r0["tokens"] == ref["tokens"][first:]).mean())
        tol = 1e-4 if cfg.dtype == torch.float32 else 3e-2
        launches = {k: sum(rk[i]["launches"][k] for rk in res)
                    for k in res[0][i]["launches"]}
        steps = tok.shape[1] - first
        ms = 1e3 * float(np.median(r0["step_s"][2:]))
        detail["runs"][name] = {
            "mesh": list(mesh), "sequence_parallel": seq,
            "lanes": int(tok.shape[0]), "first_step": first, "steps": steps,
            "layers": cfg.num_layers, "logits_rel_err": rel,
            "tolerance": tol, "tokens_equal_share": same,
            "ms_per_step_median": ms,
            "one_device_ms_per_step_median": ref["ms_per_step_median"],
            "launches_by_rank": [rk[i]["launches"] for rk in res]}
        print(f"mesh {name}, steps {first}..{tok.shape[1] - 1}: logits "
              f"within {rel:.3g} of the one-device decode_step (tolerance "
              f"{tol}), tokens equal {same:.3f}; {ms:.3f} ms/step "
              f"({MESH_RANKS} ranks on one H100 over gloo: not a multi-card "
              f"number; one device {ref['ms_per_step_median']:.3f}) on "
              f"{card}", flush=True)
        if not rel < tol or (tol == 1e-4 and same != 1.0):
            raise AssertionError(f"mesh {name} differs from the one-device "
                                 f"decode step: {rel} (tolerance {tol}), "
                                 f"tokens equal {same}")
        want = cfg.attn_layers * steps * MESH_RANKS
        if launches["rope_kv_append"] != want or \
                launches["paged_attention"] != want:
            raise AssertionError(f"mesh {name}: launches {launches}, "
                                 f"expected {want} of both on the card")
        paths[f"mesh {name}"] = dict(read_zero(), **launches)
    return detail, paths


# ---------------------------------------------------------------------------
# phase 10: the sharded train step, ranks sharing the card over gloo
# ---------------------------------------------------------------------------
# the published widths cut in depth for the time limit: every rank's
# collectives go through gloo and the host, and the ranks take turns on
# the card (starcoder2-3b: 2 of 30 layers, cut from 4 for the time
# limit when the qwen2.5-32b and recurrentgemma-9b runs came in;
# mamba2-370m: 12 of 48; qwen2.5-32b: 2 of 64; recurrentgemma-9b: 3 of
# 38, its first (RG-LRU, RG-LRU, local attention) unit)
UNEVEN_ARCH = "qwen2.5-32b"
MESH_TRAIN_LAYERS = {TRAIN_ARCH: 2, SSD_TRAIN_ARCH: 12, UNEVEN_ARCH: 2,
                     HYBRID_TRAIN_ARCH: 3}
MESH_TRAIN_TOKENS = {TRAIN_ARCH: (TRAIN_BATCH, TRAIN_SEQ),
                     SSD_TRAIN_ARCH: (SSD_TRAIN_BATCH, SSD_TRAIN_SEQ),
                     UNEVEN_ARCH: (2, 2048), HYBRID_TRAIN_ARCH: (1, 4096)}
# qwen2.5-32b on 3 ranks: 40 query heads as 13 / 13 / 14 on 8 KV heads
# (unequal groups), wq / wk / wv / wo replicated (5120 does not divide 3);
# recurrentgemma-9b on 4: the RG-LRU at 1024 channels a rank
MESH_UNEVEN = {UNEVEN_ARCH: (1, 3), HYBRID_TRAIN_ARCH: (1, 4)}
MESH_TRAIN_STEPS = 4                     # a warm step and 3 more
# qwen2.5-32b's smoke config in fp32: 3 steps at 4 x 64 tokens
MESH_SMOKE_TRAIN = ("qwen2.5-32b", 4, 64, 3)
# ... and with 6 query heads on (1, 4): wq's 96 columns split, the heads
# not (1 / 2 / 1 / 2)
MESH_SMOKE_UNEVEN = {"num_heads": 6}
# ... and with 10 query heads on its 2 KV heads on (1, 3): wq's 160
# columns replicated (they do not divide), rank 1's heads 3, 4 read KV
# head 0 and head 5 KV head 1 (wk / wv's columns repeated a query head
# on the card's flash kernels), d_ff 256 as 85 / 85 / 86
MESH_SMOKE_GROUPS = {"num_heads": 10}
MESH_TRAIN_NAMES = ("data", "model")


def rank_heads(cfg, tp) -> list[tuple[int, int]]:
    """(query heads, KV heads as the flash kernels see them) of each model
    rank of ``tp`` in the sharded train step: K and V repeated a query
    head where the rank's heads read unequal parts of groups."""
    from repro_torch.distributed.collectives import unit_ranges
    from repro_torch.layers.attention import kv_heads_of_rank, \
        kv_map_of_rank
    H, K = cfg.num_heads, cfg.num_kv_heads
    out = []
    for r, (q0, q1) in enumerate(unit_ranges(H, tp)):
        k0, k1 = kv_heads_of_rank(H, K, tp, r)
        kl = k1 - k0 if kv_map_of_rank(H, K, tp, r) is None else q1 - q0
        out.append((q1 - q0, kl))
    return out


def train_shard_shapes() -> tuple[list, list]:
    """The shapes the mesh train runs give the flash kernels (a rank's
    batch shard and heads: B, H, K, S, dh, causal, window, dtype) and the
    scan (Bz, H, S, P, N), with the mesh each comes from; and the scan at
    mamba2-370m's heads over 3 ranks (no run: a kernel check)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.distributed.collectives import unit_ranges
    from repro_torch.layers.ssd import n_heads
    c, sc = get_config(TRAIN_ARCH), get_smoke_config(MESH_SMOKE_TRAIN[0])
    mc = get_config(SSD_TRAIN_ARCH)
    B, S = MESH_SMOKE_TRAIN[1:3]
    flash = [(f"{TRAIN_ARCH} (2, 2)", (TRAIN_BATCH // 2, c.num_heads // 2,
                                       1, TRAIN_SEQ, c.head_dim, True, 0,
                                       "bfloat16")),
             (f"{TRAIN_ARCH} (1, 4), the KV head shared",
              (TRAIN_BATCH, c.num_heads // 4, 1, TRAIN_SEQ, c.head_dim, True,
               0, "bfloat16")),
             (f"{sc.name} smoke fp32 (2, 2)", (B // 2, sc.num_heads // 2, 1,
                                              S, sc.head_dim, True, 0,
                                              "float32")),
             (f"{sc.name} smoke fp32 (1, 4)", (B, sc.num_heads // 4, 1, S,
                                              sc.head_dim, True, 0,
                                              "float32"))]
    for a, mesh in MESH_UNEVEN.items():
        u = get_config(a)
        Bu, Su = MESH_TRAIN_TOKENS[a]
        win = u.window if any(m == "local_attn" for m, _ in u.layer_specs) \
            else 0
        ranks: dict = {}               # a shape: the ranks that give it
        for r, (h, k) in enumerate(rank_heads(u, mesh[1])):
            ranks.setdefault((h, k), []).append(r)
        for (h, k), rs in ranks.items():
            kv = "K / V a query head" if k == h and k != u.num_kv_heads \
                else f"{k} KV head{'s' if k > 1 else ''}"
            flash.append((f"{a} {mesh} rank{'s' if len(rs) > 1 else ''} "
                          f"{', '.join(map(str, rs))}, {kv}",
                          (Bu // mesh[0], h, k, Su, u.head_dim, True, win,
                           "bfloat16")))
    ssd = [(f"{SSD_TRAIN_ARCH} (2, 2)", (SSD_TRAIN_BATCH // 2,
                                         n_heads(mc) // 2, SSD_TRAIN_SEQ,
                                         mc.ssm_head_dim, mc.ssm_state))]
    lo, hi = unit_ranges(n_heads(mc), 3)[-1]
    ssd.append((f"{SSD_TRAIN_ARCH} over model 3 (a rank's {hi - lo} of "
                f"{n_heads(mc)} heads; no run)",
                (SSD_TRAIN_BATCH, hi - lo, SSD_TRAIN_SEQ, mc.ssm_head_dim,
                 mc.ssm_state)))
    return flash, ssd


def flash_bwd_bound(B, H, K, S, dh, causal, window, es) -> tuple:
    """Least time for the attention's gradient: ``flash_bwd_flops`` at the
    dtype's peak, against q, k, v, o, dO read once (and the LSE) and dq,
    dk, dv written once."""
    flops = flash_bwd_flops(B, H, S, dh, causal, window)
    nbytes = es * (3 * B * H * S * dh + 2 * B * K * S * dh
                   + 2 * B * H * S * dh + 2 * B * K * S * dh) + 4 * B * H * S
    peak = BF16_FLOPS if es == 2 else FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_train_shard_kernels(torch, dev) -> dict:
    """``flash_attention``, ``flash_attention_bwd``, ``ssd_scan`` and
    ``ssd_scan_bwd`` at the shapes one rank of the mesh train runs gives
    them (``train_shard_shapes``), against their plain versions on the
    same inputs (the tolerances of phases 1 and 7), each timed (graph
    replay and eager) beside its plain version, its bound and, for flash,
    SDPA (the backward: SDPA's forward + backward less its forward).
    Returns {kernel: rows}."""
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.ssd_scan import kernel as ssk
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    flash, ssd = train_shard_shapes()
    out = {k: [] for k in ("flash_attention", "flash_attention_bwd",
                           "ssd_scan", "ssd_scan_bwd")}
    for where, (B, H, K, S, dh, causal, win, dtn) in flash:
        dt = getattr(torch, dtn)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)
        q, k, v, do = randn(B, H, S, dh), randn(B, K, S, dh), \
            randn(B, K, S, dh), randn(B, H, S, dh)
        shape = {"q": [B, H, S, dh], "kv": [B, K, S, dh], "causal": causal,
                 "window": win, "dtype": dtn}
        want = fak.flash_attention_plain(q, k, v, causal=causal, window=win)
        got = fak.flash_attention(q, k, v, causal=causal, window=win)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        row_err = fak.row_scaled_error(got, want)
        tol = 3e-2 if dt == torch.bfloat16 else 2e-5
        if not err < tol or (dt == torch.bfloat16
                             and not row_err < fak.BF16_ROW_TOL):
            raise AssertionError(f"flash_attention at {where} {shape} "
                                 f"differs from its plain version by {err} "
                                 f"({row_err} of a row's rms)")
        variant = fak.last_variant
        bound, by = flash_bound(B, H, K, S, dh, causal, win, q.element_size())
        if win:       # the window as a mask: keys (s - win, s]
            pos = torch.arange(S, device=dev)
            kw = {"attn_mask": (pos[None] <= pos[:, None])
                  & (pos[None] > pos[:, None] - win)}
            call = "attn_mask=<causal window>"
        else:
            kw, call = {"is_causal": causal}, f"is_causal={causal}"

        def fwd():
            return fak.flash_attention(q, k, v, causal=causal, window=win)

        def lib_fwd():
            return sdpa(q, k, v, enable_gqa=True, **kw)
        lib_f = event_ms(torch, lib_fwd, iters=10)
        out["flash_attention"].append({
            "where": where, "shape": shape, "variant": variant,
            "max_abs_err": err, "row_scaled_err": row_err, "tolerance": tol,
            "ms": graph_ms(torch, fwd, iters=10),
            "eager_ms": event_ms(torch, fwd, iters=10),
            "plain_ms": event_ms(torch, lambda: fak.flash_attention_plain(
                q, k, v, causal=causal, window=win), iters=2, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": lib_f,
            "library_call": f"F.scaled_dot_product_attention({call}, "
                            f"enable_gqa=True)"})
        o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)
        want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                             causal=causal, window=win)
        got = fak.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      window=win)
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if dt == torch.float32:
                e = float((a - b).abs().max() / b.abs().max())
                bad = not e < 1e-4
            else:
                e = fak.row_scaled_error(a, b, floor=fak.GRAD_ROW_FLOOR)
                bad = not e < fak.BF16_ROW_TOL
            errs[name] = e
            if bad:
                raise AssertionError(f"flash_attention_bwd at {where} "
                                     f"{shape}: {name} differs from the "
                                     f"plain version by {e}")
        variant, splits = fak.last_bwd_variant, fak.last_bwd_splits
        bound, by = flash_bwd_bound(B, H, K, S, dh, causal, win,
                                    q.element_size())
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

        def bwd():
            return fak.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=win)

        def lib_fwd_bwd():
            sdpa(qr, kr, vr, enable_gqa=True, **kw).backward(do)
        out["flash_attention_bwd"].append({
            "where": where, "shape": shape, "variant": variant,
            "splits": splits,
            "max_abs_err": max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)),
            "errors": errs, "tolerance": "1e-4 of max |plain|"
            if dt == torch.float32 else {"row_scaled": fak.BF16_ROW_TOL,
                                         "floor": fak.GRAD_ROW_FLOOR},
            "ms": graph_ms(torch, bwd, iters=10),
            "eager_ms": event_ms(torch, bwd, iters=10),
            "plain_ms": event_ms(torch, lambda: fak.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=causal, window=win), iters=2,
                warmup=1),
            "bound_ms": bound, "bound_by": by,
            "library_ms": event_ms(torch, lib_fwd_bwd, iters=10) - lib_f,
            "library_call": "F.scaled_dot_product_attention forward + "
                            "backward, less its forward"})
        del q, k, v, do, o, lse, want, got, qr, kr, vr, kw
    for where, (Bz, H, S, P, N) in ssd:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=g, device=dev) * scale
        xdt, loga = randn(Bz, H, S, P, scale=0.1), \
            -randn(Bz, H, S, scale=0.1).abs()
        Bm, Cm = randn(Bz, S, N, scale=0.3), randn(Bz, S, N, scale=0.3)
        dy = randn(Bz, H, S, P)
        shape = {"xdt": [Bz, H, S, P], "BC": [Bz, S, N], "dtype": "float32"}
        want = ssk.ssd_scan_plain(xdt, loga, Bm, Cm)
        got = ssk.ssd_scan(xdt, loga, Bm, Cm)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / (float(want.abs().max()) + 1e-9)
        if not rel < 1e-4:
            raise AssertionError(f"ssd_scan at {where} {shape} differs from "
                                 f"its plain version by {rel} (relative)")
        bound, by = ssd_bound(Bz, H, S, P, N)

        def fwd():
            return ssk.ssd_scan(xdt, loga, Bm, Cm)

        def fwd_h_in():                    # the forward under grad
            return ssk._launch_fwd(xdt, loga, Bm, Cm, with_h_in=True)
        none = "none (no single PyTorch call computes the scan)"
        out["ssd_scan"].append({
            "where": where, "shape": shape, "max_abs_err": err,
            "rel_err": rel, "tolerance": "1e-4 relative",
            "ms": graph_ms(torch, fwd_h_in, iters=10), "h_in_store": True,
            "ms_without_store": graph_ms(torch, fwd, iters=10),
            "eager_ms": event_ms(torch, fwd_h_in, iters=10),
            "plain_ms": event_ms(torch, lambda: ssk.ssd_scan_plain(
                xdt, loga, Bm, Cm), iters=2, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_call": none})
        h_in, h_err = forward_h_in(torch, ssk, xdt, loga, Bm, Cm, where)
        want = ssk.ssd_scan_bwd_plain(xdt, loga, Bm, Cm, dy)
        got = ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        again = ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        torch.cuda.synchronize()
        errs = {name: float((a - b).abs().max() / b.abs().max())
                for name, a, b in zip(("dxdt", "dloga", "dB", "dC"), got,
                                      want)}
        if not all(e < 1e-4 for e in errs.values()) or \
                not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssd_scan_bwd at {where} {shape} differs "
                                 f"from its plain version by {errs}, or "
                                 f"from itself")
        errs["h_in"] = h_err
        bound, by = ssd_bwd_bound(Bz, H, S, P, N)

        def bwd():
            return ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, h_in=h_in)
        out["ssd_scan_bwd"].append({
            "where": where, "shape": shape,
            "max_abs_err": max(float((a - b).abs().max())
                               for a, b in zip(got, want)),
            "rel_err": errs, "tolerance": "1e-4 of max |plain|",
            "ms": graph_ms(torch, bwd, iters=10),
            "eager_ms": event_ms(torch, bwd, iters=10),
            "plain_ms": event_ms(torch, lambda: ssk.ssd_scan_bwd_plain(
                xdt, loga, Bm, Cm, dy), iters=2, warmup=1),
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "library_call": none})
        del xdt, loga, Bm, Cm, dy, want, got, again, h_in
    torch.cuda.empty_cache()
    return out


def one_device_train(torch, dev, cfg, batch, seq, steps) -> dict:
    """``Trainer`` on the card over the mesh runs' ``TokenStream``: each
    step's loss and grad norm, the median step time (the warm step left
    out), peak memory and the kernels' launches."""
    import statistics
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optimizer import AdamWConfig
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, AdamWConfig(), seed=SEED, device=dev)
    norms, step_fn = [], tr.step_fn

    def recorded(*args):
        out = step_fn(*args)
        norms.append(float(out[2]["grad_norm"]))
        return out
    tr.step_fn = recorded
    torch.cuda.synchronize()
    zero_counts()
    losses = tr.run(TokenStream(cfg.vocab_size, batch, seq, seed=SEED),
                    steps=steps)
    torch.cuda.synchronize()
    out = {"losses": losses, "grad_norms": norms,
           "ms_per_step_median": 1e3 * statistics.median(tr.step_times[1:]),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "launches": read_counts()}
    del tr
    torch.cuda.empty_cache()
    return out


def state_bytes(cfg) -> int:
    """A train state's bytes: the parameters and two fp32 moments."""
    from repro_torch.models.params import param_shapes
    return sum(t.numel() * (t.element_size() + 8)
               for t in _leaves(param_shapes(cfg)))


def check_mesh_train(torch, dev, card) -> tuple[dict, dict]:
    """The sharded train step on ranks that share the card over gloo,
    against one device on the card with the same seeded weights and
    batches.  Through ``make_train_step``, three steps at 4 x 64 tokens:
    qwen2.5-32b's smoke config in fp32 on (2, 2) and (1, 4), with 6
    query heads on (1, 4), and with 10 query heads on its 2 KV heads on
    (1, 3) (unequal parts of groups on rank 1) (every step's loss within
    1e-4, every parameter after the last within 5e-4: the reference's own
    mesh bounds).
    Through ``Trainer`` at the published widths (``MESH_TRAIN_LAYERS``
    deep, bf16, ``MESH_TRAIN_TOKENS`` of ``TokenStream``), a warm step and
    3 more, each step's loss within 3e-2 and grad norm within 5e-2
    (relative) of one device's: starcoder2-3b on (2, 2) and on (1, 4)
    (its 2 KV heads shared at tp 4), mamba2-370m on (2, 2),
    recurrentgemma-9b on (1, 4) (the RG-LRU over ``model``), all on one
    start-up of MESH_RANKS ranks, then the 10-head smoke case and
    qwen2.5-32b on (1, 3) (heads, KV groups and wq / wk / wv / wo that do
    not split) on a start-up of 3;
    the (2, 2) starcoder2-3b state saved (whole arrays, to rank 0's RAM
    heap) and restored onto (1, 4), every leaf's checksum equal to the
    saved one.  Returns the detail and each run's launches (summed over
    the ranks) by path."""
    import numpy as np
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.layout import SB_SIZE
    from repro_torch.launch import mesh_train as mt
    from repro_torch.launch.ranks import run_ranks
    from repro_torch.models.params import init_params
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_leaves

    arch, B, S, steps = MESH_SMOKE_TRAIN
    smoke = {"smoke": dataclasses.replace(get_smoke_config(arch),
                                          dtype=torch.float32)}
    smoke["smoke h6"] = dataclasses.replace(smoke["smoke"],
                                            **MESH_SMOKE_UNEVEN)
    smoke["smoke h10"] = dataclasses.replace(smoke["smoke"],
                                             **MESH_SMOKE_GROUPS)
    rng = np.random.default_rng(SEED + 62)
    batches = []
    for _ in range(steps):
        t = rng.integers(0, smoke["smoke"].vocab_size, (B, S)).astype(
            np.int32)
        batches.append({"tokens": t, "labels": t})
    wide = {a: dataclasses.replace(get_config(a), num_layers=n)
            for a, n in MESH_TRAIN_LAYERS.items()}
    shapes = MESH_TRAIN_TOKENS

    # the one-device runs on the card, one after the other
    t = time.perf_counter()
    refs = {}
    for key, scfg in smoke.items():
        p = init_params(scfg, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        opt, step = init_opt_state(p), make_train_step(
            scfg, AdamWConfig(warmup_steps=1))
        zero_counts()
        metrics = []
        for b in batches:
            p, opt, m = step(p, opt, {k: torch.as_tensor(v, device=dev)
                                      for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        refs[key] = {"metrics": metrics, "params": mt.numpy_tree(p),
                     "launches": read_counts()}
        del p, opt
    for a, c in wide.items():
        refs[a] = one_device_train(torch, dev, c, *shapes[a],
                                   MESH_TRAIN_STEPS)
    ref_s = time.perf_counter() - t
    torch.cuda.empty_cache()          # the ranks need the card's memory

    heap = -(-int(state_bytes(wide[TRAIN_ARCH]) * 1.05 + (64 << 20))
             // SB_SIZE) * SB_SIZE

    def trainer(a, mesh, **kw):
        return dict({"kind": "trainer", "cfg": wide[a],
                     "mesh": (mesh, MESH_TRAIN_NAMES), "device": "cuda",
                     "seed": SEED, "stream": (wide[a].vocab_size, *shapes[a],
                                              SEED),
                     "steps": MESH_TRAIN_STEPS, "log_every": 1}, **kw)

    def stepper(key, mesh):
        return {"kind": "step", "cfg": smoke[key],
                "mesh": (mesh, MESH_TRAIN_NAMES), "device": "cuda",
                "seed": SEED, "batches": batches,
                "opt": {"warmup_steps": 1}}
    ckpt = {"key": TRAIN_ARCH, "size": heap}
    starts = [  # each start-up of the ranks: [(name, ref key, job)]
        [(f"{arch} smoke fp32 (2, 2)", "smoke", stepper("smoke", (2, 2))),
         (f"{arch} smoke fp32 (1, 4)", "smoke", stepper("smoke", (1, 4))),
         (f"{arch} smoke fp32 with 6 query heads (1, 4)", "smoke h6",
          stepper("smoke h6", (1, 4))),
         (f"{TRAIN_ARCH} (2, 2)", TRAIN_ARCH, trainer(
             TRAIN_ARCH, (2, 2), ckpt=ckpt, ckpt_every=MESH_TRAIN_STEPS,
             checksums=True)),
         (f"{TRAIN_ARCH} (1, 4)", TRAIN_ARCH, trainer(TRAIN_ARCH, (1, 4))),
         (f"{TRAIN_ARCH} restored onto (1, 4)", TRAIN_ARCH, trainer(
             TRAIN_ARCH, (1, 4), ckpt=ckpt, checksums=True)),
         (f"{SSD_TRAIN_ARCH} (2, 2)", SSD_TRAIN_ARCH,
          trainer(SSD_TRAIN_ARCH, (2, 2))),
         (f"{HYBRID_TRAIN_ARCH} {MESH_UNEVEN[HYBRID_TRAIN_ARCH]}",
          HYBRID_TRAIN_ARCH, trainer(HYBRID_TRAIN_ARCH,
                                     MESH_UNEVEN[HYBRID_TRAIN_ARCH]))],
        [(f"{arch} smoke fp32 with 10 query heads on 2 KV heads (1, 3)",
          "smoke h10", stepper("smoke h10", (1, 3))),
         (f"{UNEVEN_ARCH} {MESH_UNEVEN[UNEVEN_ARCH]}", UNEVEN_ARCH,
          trainer(UNEVEN_ARCH, MESH_UNEVEN[UNEVEN_ARCH]))]]
    t = time.perf_counter()
    results = []
    for runs in starts:
        world = math.prod(runs[0][2]["mesh"][0])
        results.append(run_ranks(mt.jobs, world, [job for *_, job in runs],
                                 device="cuda", timeout=900))
    wall = time.perf_counter() - t
    detail = {"ranks": [len(r) for r in results], "card": card,
              "wall_s": wall, "one_device_s": ref_s, "heap_bytes": heap,
              "layers": {
                  a: [n, get_config(a).num_layers]
                  for a, n in MESH_TRAIN_LAYERS.items()},
              "note": "ranks sharing one H100 over gloo: not a multi-card "
                      "number", "runs": {}}
    paths = {f"mesh train one-device reference of {arch} {key} fp32":
             refs[key]["launches"] for key in smoke}
    for a in wide:
        paths[f"mesh train one-device reference of {a}"] = \
            refs[a]["launches"]
    saved = None
    for runs, res in zip(starts, results):
        for i, (name, key, job) in enumerate(runs):
            row = check_mesh_train_run(
                np, tree_leaves, name, job, refs[key],
                [rk[i] for rk in res], saved, card)
            if "checksums_saved" in res[0][i] and res[0][i][
                    "checksums_saved"]:
                saved = res[0][i]["checksums_saved"]
            launches = {k: sum(rk[i]["launches"][k] for rk in res)
                        for k in res[0][i]["launches"]}
            detail["runs"][name] = row
            paths[f"mesh train {name}"] = dict(read_zero(), **launches)
    return detail, paths


def mesh_launches_expected(cfg, steps: int) -> dict:
    """Each training kernel's launches on one rank over ``steps`` steps:
    the forward twice a layer (remat) and the backward once."""
    attn = sum(m in ("attn", "local_attn") for m, _ in cfg.layer_specs)
    scan = sum(m == "mamba2" for m, _ in cfg.layer_specs)
    return {"flash_attention": 2 * attn * steps,
            "flash_attention_bwd": attn * steps,
            "ssd_scan": 2 * scan * steps, "ssd_scan_bwd": scan * steps}


def check_mesh_train_run(np, tree_leaves, name, job, ref, ranks, saved,
                         card) -> dict:
    """One mesh train run (``ranks``: each rank's result) held to its
    one-device reference ``ref`` (or, restored, to the checksums
    ``saved``): prints its line, raises where it is out of bounds, and
    returns its detail row."""
    r0, cfg = ranks[0], job["cfg"]
    by_rank = [rk["launches"] for rk in ranks]
    row = {"mesh": list(job["mesh"][0]), "launches_by_rank": by_rank,
           # all-reduces (calls, bytes) a rank made on the path; a run
           # that saves counts the save's gathers too
           "collectives_by_rank": [rk["collectives"] for rk in ranks]}
    if job["kind"] == "step":
        dl = max(abs(a[0] - b[0]) for a, b in zip(r0["metrics"],
                                                   ref["metrics"]))
        want = dict(tree_leaves(ref["params"]))
        dp = max(float(np.abs(x - want[path]).max())
                 for path, x in tree_leaves(r0["params"]))
        row.update(loss_max_abs_diff=dl, param_max_abs_diff=dp,
                   metrics=r0["metrics"], tolerance={"loss": 1e-4,
                                                     "params": 5e-4})
        print(f"mesh train {name}: loss within {dl:.3g}, parameters "
              f"within {dp:.3g} of make_train_step on one device "
              f"(tolerance 1e-4 / 5e-4)", flush=True)
        if not (dl < 1e-4 and dp < 5e-4):
            raise AssertionError(f"mesh train {name} differs from one "
                                 f"device: loss {dl}, params {dp}")
        steps = len(job["batches"])
    elif "restored" in name:
        same = [saved[-1][0] == MESH_TRAIN_STEPS,
                r0["start_step"] == MESH_TRAIN_STEPS,
                r0["checksums_at_start"] == saved[-1][1]]
        row.update(saved_at_step=saved[-1][0],
                   restored_at_step=r0["start_step"],
                   leaves=len(saved[-1][1]), checksums_equal=all(same),
                   restore_setup_s=r0["setup_s"])
        print(f"mesh train {name}: the (2, 2) state saved at step "
              f"{saved[-1][0]} ({len(saved[-1][1])} leaves, whole "
              f"arrays) restored at step {r0['start_step']}, every "
              f"leaf's checksum equal: {all(same)}", flush=True)
        if not all(same):
            raise AssertionError(f"mesh train {name}: {same}")
        return row
    else:
        dl = max(abs(x - y) for x, y in zip(r0["losses"], ref["losses"]))
        dg = max(abs(x - y) / y for x, y in zip(r0["grad_norms"],
                                                ref["grad_norms"]))
        ms = 1e3 * float(np.median(r0["step_s"][1:]))
        peaks = [rk["peak_gb"] for rk in ranks]
        coll = r0["collectives"]
        steps = job["steps"]
        B, S = job["stream"][1:3]
        row.update(losses=r0["losses"], grad_norms=r0["grad_norms"],
                   one_device_losses=ref["losses"],
                   one_device_grad_norms=ref["grad_norms"],
                   loss_max_abs_diff=dl, grad_norm_max_rel_diff=dg,
                   tolerance={"loss": 3e-2, "grad_norm": 5e-2},
                   tokens=[B, S], steps=steps, ms_per_step_median=ms,
                   one_device_ms_per_step_median=ref["ms_per_step_median"],
                   peak_gb_by_rank=peaks, one_device_peak_gb=ref["peak_gb"])
        print(f"mesh train {name}: {cfg.num_layers} layers, {B} x {S} "
              f"tokens; losses within {dl:.3g}, grad norms within "
              f"{dg:.3g} of one device (tolerance 3e-2 / 5e-2); "
              f"{ms:.1f} ms/step ({len(ranks)} ranks on one H100 over "
              f"gloo: not a multi-card number; one device "
              f"{ref['ms_per_step_median']:.1f}); rank 0's all-reduces "
              f"{coll['calls'] / steps:.0f} a step, "
              f"{coll['bytes'] / steps / 1e9:.3f} GB a step"
              f"{' (with the save)' if 'ckpt' in job else ''}; peak "
              f"GB by rank {[round(x, 2) for x in peaks]} (one device "
              f"{ref['peak_gb']:.2f}); launches by rank {by_rank} on "
              f"{card}", flush=True)
        if not (dl < 3e-2 and dg < 5e-2):
            raise AssertionError(f"mesh train {name} differs from one "
                                 f"device: loss {dl}, grad norm {dg}")
    want = mesh_launches_expected(cfg, steps)
    if any(rk[k] != v for rk in by_rank for k, v in want.items()):
        raise AssertionError(f"mesh train {name}: launches {by_rank}, "
                             f"expected {want} a rank")
    return row


def read_zero() -> dict:
    """Every kernel's count at 0: a path's row for kernels it never ran."""
    return {k: 0 for k in KERNELS}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def report_serve(serve: dict, card: str) -> None:
    name = serve["model"] + (" int8" if serve["kv_dtype"] == "int8" else "")
    print(f"serve: {name} at full width, {serve['layers']} layers "
          f"({serve['cut']}); {serve['steps']} steps, "
          f"{serve['ms_per_step_median']:.3f} ms/step (median), "
          f"{serve['tokens_per_s']:.1f} tokens/s on {card}", flush=True)
    print(f"[serve] {name} crash at step {serve['crash_at_step']}; "
          f"recovery: {serve['recovery']}", flush=True)
    print(f"serve {name} detail: " + json.dumps(
        {k: v for k, v in serve.items() if k != "recovery"}, default=str),
        flush=True)


def report_forward(kind: str, res: dict, card: str) -> None:
    print(f"{kind}: {res['model']}, {res['layers']} layers, {res['batch']} "
          f"x {res['seq']} tokens: {res['ms_per_forward']:.3f} ms/forward, "
          f"{res['tokens_per_s']:.1f} tokens/s, launches {res['launches']} "
          f"in forward + loss_fn on {card}", flush=True)
    print(f"{kind} {res['model']} detail: " + json.dumps(res), flush=True)


def report_train(res: dict, card: str) -> None:
    whole = "whole" if res["cut"].startswith("none") else "depth cut"
    print(f"train: {res['model']} {whole}, {res['layers']} layers, "
          f"{res['batch']} x {res['seq']} tokens: "
          f"{res['ms_per_step_median']:.3f} ms/step (median of "
          f"{res['steps'] - 1}), {res['tokens_per_s']:.1f} tokens/s, "
          f"model-FLOP share {res['model_flop_share']:.3f}, peak "
          f"{res['peak_mem_gb']:.2f} GB on {card}", flush=True)
    print(f"train {res['model']} detail: " + json.dumps(res), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        return fail(f"{src}/repro_torch not found: run from a checkout")
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.bench_paged import card_line
    from repro_torch.launch.profile_decode import serve_config
    from repro_torch.launch.profile_forward import RUNS, run_config
    from repro_torch.layers.ssd import n_heads
    from repro_torch.models.params import init_params

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    t_all = time.perf_counter()

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.build_info['library']})", flush=True)

    # the qwen2.5-32b serve run and prefill share the prefill's depth cut;
    # granite-moe-3b-a800m's serve run and prefill, its whole depth
    names = ("qwen2.5-32b", "mamba2-370m", "recurrentgemma-9b",
             "granite-moe-3b-a800m", "hubert-xlarge")
    qrun, mrun, rrun, gmrun, hrun = (RUNS[a] for a in names)
    cfg, mcfg, rcfg, gmcfg, hcfg = (run_config(a) for a in names)
    gcfg = serve_config("granite-20b")
    mscfg = serve_config("moonshot-v1-16b-a3b")

    def main_shape(run, c):
        return (run.batch, c.num_heads, c.num_kv_heads, run.seq, c.head_dim,
                c.causal, c.window, "bfloat16")
    tcfg = get_config(TRAIN_ARCH)
    flash_mains = [
        main_shape(qrun, cfg), main_shape(rrun, rcfg),
        (1, 96, 8, 4096, 192, True, 0, "bfloat16"),   # nemotron-4-340b heads
        main_shape(gmrun, gmcfg), main_shape(hrun, hcfg),
        # the training run's shape (its forward, without the LSE), so the
        # row has SDPA's forward there beside the backward's
        (TRAIN_BATCH, tcfg.num_heads, tcfg.num_kv_heads, TRAIN_SEQ,
         tcfg.head_dim, True, 0, "bfloat16")]
    # the scoring run's shape, then the training run's (its forward, under
    # grad twice a layer a step)
    ssd_mains = [(b, n_heads(mcfg), s, mcfg.ssm_head_dim, mcfg.ssm_state,
                  "float32", None)
                 for b, s in ((mrun.batch, mrun.seq),
                              (SSD_TRAIN_BATCH, SSD_TRAIN_SEQ))]
    kernels = check_kernels(torch, cfg, dev) + check_forward_kernels(
        torch, dev, flash_mains, ssd_mains)
    lse = check_flash_lse(torch, dev)
    print(f"flash_attention lse == plain lse (1e-4 of max(1, |lse|)): "
          f"{lse}", flush=True)
    kernels.append(check_flash_bwd(torch, dev))
    kernels.append(check_ssd_bwd(torch, dev))
    by_name = {row["name"]: row for row in kernels}
    by_name["flash_attention"]["lse_check"] = lse
    for c in (gcfg, rcfg, gmcfg, mscfg):
        shapes = check_serve_shape(torch, c, dev)
        for name, res in shapes.items():
            by_name[name].setdefault("serve_shapes", {})[c.name] = res
            print(f"kernel {name} at {c.name}'s serve shape: max_abs_err "
                  f"{res['max_abs_err']} ms {res['ms']:.5f} eager "
                  f"{res['eager_ms']:.5f} plain {res['plain_ms']:.5f} bound "
                  f"{res['bound_ms']:.5f}", flush=True)
    for row in kernels:
        print(f"kernel {row['name']} ({row.get('variant', '-')}): "
              f"max_abs_err {row['max_abs_err']} "
              f"ms {row['ms']:.5f} eager {row['eager_ms']:.5f} "
              f"plain {row['plain_ms']:.5f} bound {row['bound_ms']:.5f}",
              flush=True)
        for t in row.get("timed_shapes", []):
            print(f"kernel {row['name']} at {t['shape']} "
                  f"({t.get('variant', '-')}): max_abs_err "
                  f"{t['max_abs_err']} ms {t['ms']:.5f} eager "
                  f"{t['eager_ms']:.5f} plain {t['plain_ms']:.5f} bound "
                  f"{t['bound_ms']:.5f}", flush=True)

    ref = check_engine_vs_cpu(torch, dev)
    print(f"engine on the card == engine on the CPU (fp32 smoke): {ref}",
          flush=True)
    fwd_ref = check_forward_vs_cpu(torch, dev)
    print(f"forward on the card == forward on the CPU (fp32 smoke, 1e-3): "
          f"{fwd_ref}", flush=True)
    for arch, over in ((TRAIN_ARCH, None), (SSD_TRAIN_ARCH, None),
                       (HYBRID_TRAIN_ARCH, HYBRID_WIDE_SMOKE)):
        train_ref = check_train_vs_cpu(torch, dev, arch, over)
        print(f"train step on the card == train step on the CPU ({arch} "
              f"fp32 smoke{f' with {over}' if over else ''}, 1e-3): "
              f"{train_ref}", flush=True)
    ckpt_ref = check_checkpoint_vs_cpu(torch, dev)
    print(f"checkpoint saved from the card == saved from the CPU, word for "
          f"word; a torn save swept ({TRAIN_ARCH} smoke): {ckpt_ref}",
          flush=True)

    paths: dict[str, dict] = {}     # each path's launch counts

    # the sharded decode step: the kernels at shard layouts, then the mesh
    # runs (ranks sharing the card over gloo)
    t0 = time.perf_counter()
    for name, rows in check_shard_kernels(torch, dev).items():
        by_name[name]["shard_layouts"] = rows
        for r in rows:
            print(f"kernel {name} at {r['layout']}"
                  f"{', window %d' % r['window'] if 'window' in r else ''}: "
                  f"max_abs_err {r['max_abs_err']} ms {r['ms']:.5f} eager "
                  f"{r['eager_ms']:.5f} plain {r['plain_ms']:.5f} bound "
                  f"{r['bound_ms']:.5f}", flush=True)
    mesh, mesh_paths = check_mesh(torch, dev, card)
    paths.update(mesh_paths)
    mesh["seconds"] = time.perf_counter() - t0
    print("mesh detail: " + json.dumps(mesh), flush=True)
    torch.cuda.empty_cache()

    # the sharded train step: the kernels at a rank's shapes, then the
    # mesh train runs (ranks sharing the card over gloo)
    t0 = time.perf_counter()
    for name, rows in check_train_shard_kernels(torch, dev).items():
        by_name[name]["train_shard_shapes"] = rows
        for r in rows:
            print(f"kernel {name} at {r['where']} {r['shape']}: max_abs_err "
                  f"{r['max_abs_err']} ms {r['ms']:.5f} eager "
                  f"{r['eager_ms']:.5f} plain {r['plain_ms']:.5f} bound "
                  f"{r['bound_ms']:.5f} library {r['library_ms']}",
                  flush=True)
    mtrain, mtrain_paths = check_mesh_train(torch, dev, card)
    paths.update(mtrain_paths)
    mtrain["seconds"] = time.perf_counter() - t0
    print("mesh train detail: " + json.dumps(mtrain, default=str),
          flush=True)
    torch.cuda.empty_cache()

    def weights(c):
        t = time.perf_counter()
        p = init_params(c, torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        torch.cuda.synchronize()
        print(f"init {c.name} ({c.num_layers} layers): "
              f"{time.perf_counter() - t:.2f} s", flush=True)
        return p

    # qwen2.5-32b: serve, with the int8 KV cache, then the prefill with
    # the same weights
    params = weights(cfg)
    serve = serve_full_width(torch, cfg, params, dev)
    report_serve(serve, card)
    paths[f"serve {cfg.name}"] = serve["launches"]
    torch.cuda.empty_cache()
    serve8 = serve_full_width(torch, dataclasses.replace(
        cfg, kv_dtype="int8"), params, dev)
    report_serve(serve8, card)
    print(f"serve {cfg.name}: int8 KV {serve8['ms_per_step_median']:.3f} "
          f"ms/step, {serve8['tokens_per_s']:.1f} tokens/s, arena "
          f"{serve8['arena_gb']:.3f} GB; bf16 KV "
          f"{serve['ms_per_step_median']:.3f} ms/step, "
          f"{serve['tokens_per_s']:.1f} tokens/s, arena "
          f"{serve['arena_gb']:.3f} GB", flush=True)
    paths[f"serve {cfg.name} int8"] = serve8["launches"]
    torch.cuda.empty_cache()
    prefill = run_forward(torch, cfg, params, dev, qrun, "flash_attention",
                          collect_kv=True)
    report_forward("prefill", prefill, card)
    paths[f"prefill {cfg.name}"] = prefill["launches"]
    del params
    torch.cuda.empty_cache()

    # granite-20b: serve (MQA, 48 query heads on one KV head)
    params = weights(gcfg)
    gserve = serve_full_width(torch, gcfg, params, dev)
    report_serve(gserve, card)
    paths[f"serve {gcfg.name}"] = gserve["launches"]
    del params
    torch.cuda.empty_cache()

    # recurrentgemma-9b: serve (RG-LRU + windowed MQA at head_dim 256,
    # a tail), then the prefill with the same weights
    params = weights(rcfg)
    rserve = serve_full_width(torch, rcfg, params, dev)
    report_serve(rserve, card)
    paths[f"serve {rcfg.name}"] = rserve["launches"]
    rprefill = run_forward(torch, rcfg, params, dev, rrun,
                           "flash_attention", collect_kv=True)
    report_forward("prefill", rprefill, card)
    paths[f"prefill {rcfg.name}"] = rprefill["launches"]
    del params
    torch.cuda.empty_cache()

    # mamba2-370m: serve (attention-free), then scoring
    params = weights(mcfg)
    mserve = serve_full_width(torch, mcfg, params, dev)
    report_serve(mserve, card)
    paths[f"serve {mcfg.name}"] = mserve["launches"]
    score = run_forward(torch, mcfg, params, dev, mrun, "ssd_scan",
                        collect_kv=False)
    score["weight_gb"] = weight_bytes(params) / 1e9
    report_forward("score", score, card)
    paths[f"score {mcfg.name}"] = score["launches"]
    del params
    torch.cuda.empty_cache()

    # granite-moe-3b-a800m: serve (MoE decode over every expert, 24/8 heads
    # of 64), then the prefill with the same weights (per-row dispatch)
    params = weights(gmcfg)
    gmserve = serve_full_width(torch, gmcfg, params, dev)
    report_serve(gmserve, card)
    paths[f"serve {gmcfg.name}"] = gmserve["launches"]
    gmprefill = run_forward(torch, gmcfg, params, dev, gmrun,
                            "flash_attention", collect_kv=True)
    report_forward("prefill", gmprefill, card)
    paths[f"prefill {gmcfg.name}"] = gmprefill["launches"]
    del params
    torch.cuda.empty_cache()

    # moonshot-v1-16b-a3b: serve, 48 layers of 64 experts (~56 GB)
    params = weights(mscfg)
    msserve = serve_full_width(torch, mscfg, params, dev)
    report_serve(msserve, card)
    paths[f"serve {mscfg.name}"] = msserve["launches"]
    del params
    torch.cuda.empty_cache()

    # hubert-xlarge: encode frame embeddings, no causal mask
    params = weights(hcfg)
    encode = run_forward(torch, hcfg, params, dev, hrun, "flash_attention",
                         collect_kv=False)
    encode["weight_gb"] = weight_bytes(params) / 1e9
    report_forward("encode", encode, card)
    paths[f"encode {hcfg.name}"] = encode["launches"]
    del params
    torch.cuda.empty_cache()

    # training: learning on the card, mamba2-370m whole, recurrentgemma-9b
    # cut to 3 units, then starcoder2-3b whole (checkpointed)
    learned = learn_fixed_pattern(torch, dev)
    print(f"trainer on the card learns a fixed pattern: {learned}",
          flush=True)
    mtrain, _ = train_full_width(torch, dev, SSD_TRAIN_ARCH, SSD_TRAIN_BATCH,
                                 SSD_TRAIN_SEQ, ckpt=False)
    report_train(mtrain, card)
    paths[f"train {mtrain['model']}"] = mtrain["launches"]
    torch.cuda.empty_cache()
    htrain, _ = train_full_width(torch, dev, HYBRID_TRAIN_ARCH,
                                 HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ,
                                 ckpt=False, layers=HYBRID_TRAIN_LAYERS)
    report_train(htrain, card)
    paths[f"train {htrain['model']}"] = htrain["launches"]
    torch.cuda.empty_cache()
    train, saved = train_full_width(torch, dev)
    report_train(train, card)
    paths[f"train {train['model']}"] = train["launches"]
    resumed = resume_full_width(torch, dev, saved, RESUME_STEPS)
    resumed["card"] = card
    print(f"checkpoint: {resumed['model']} whole, {resumed['state_gb']:.2f} "
          f"GB of state: save {resumed['save_s']:.2f} s "
          f"({resumed['save_gb_per_s']:.2f} GB/s; pinned copy to the host "
          f"{resumed['d2h_pinned_4gb_gb_per_s']:.2f}), recover "
          f"{resumed['recover_s']:.2f} s, load {resumed['load_s']:.2f} s "
          f"({resumed['load_gb_per_s']:.2f} GB/s; pinned copy to the card "
          f"{resumed['h2d_pinned_4gb_gb_per_s']:.2f}); resumed at step "
          f"{resumed['resumed_at_step']} on {card}", flush=True)
    print(f"checkpoint {resumed['model']} detail: " + json.dumps(resumed),
          flush=True)
    paths[f"train {resumed['model']} resumed"] = resumed["launches"]
    torch.cuda.empty_cache()
    print(f"chip_smoke: {time.perf_counter() - t_all:.1f} s", flush=True)

    line = [dict(row, launches=sum(c[row["name"]] for c in paths.values()),
                 launches_by_path={p: c[row["name"]]
                                   for p, c in paths.items()})
            for row in kernels]
    print(card)
    print(json.dumps({"kernels": line}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
