#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the serving path's shapes
(and times both), checks the whole engine on the card against the same
engine on the CPU at a small size, then serves qwen2.5-32b at full width
(cut to 8 layers, random weights from a seed) through the paged engine:
short prompts, a 300-token prompt on the span path, a published prefix
with an exact and a partial hit, and a crash-and-recover mid-run.  Every
phase that fails raises.  The last lines are the card, a JSON ``kernels``
line and ``{"ok": true, "device": {...}}``.  Needs CUDA and this repo's
``src/``; exits non-zero without either.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SEED = 0
LAYERS = 8                 # depth cut of qwen2.5-32b (64 layers) for one card
LANES, MAX_SEQ, PAGES_PER_SB = 8, 1024, 2
LONG_PROMPT = 300          # > pages_per_sb pages of 128: the span path
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


# ---------------------------------------------------------------------------
# phase 1: the kernels at the serving path's shapes
# ---------------------------------------------------------------------------
def check_kernels(torch, cfg, dev) -> list[dict]:
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.paged_attention import kernel as pak

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
        "shape": {"arena": [pages, page, K, dh], "new": [B, K, dh],
                  "dtype": str(dt)},
    }

    # paged_attention: within 3e-2, window off and on; lengths up to the
    # serve run's longest sequence
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
        if not err < 3e-2:
            raise AssertionError(f"paged_attention (window {window}) differs "
                                 f"from its plain version by {err}")
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
        rows[window] = {
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:87",
            "max_abs_err": err, "tolerance": 3e-2,
            "ms": graph_ms(torch, lambda: pak.paged_attention(
                q, ak, av, bt, lens, window=window)),
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
        "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
        "sdpa_pregathered_ms", "shape")}
    return [kv_row, pa_row]


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

    def to(tree, d):
        if isinstance(tree, dict):
            return {k: to(v, d) for k, v in tree.items()}
        return tree.to(d)

    runs = {}
    for d in ("cpu", dev):
        eng = ServingEngine(cfg, to(cpu_params, d), lanes=4, max_seq=64,
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
def serve_full_width(torch, cfg, dev) -> dict:
    import numpy as np
    from repro_torch.kernels.kv_update import kernel as kvk
    from repro_torch.kernels.paged_attention import kernel as pak
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ServingEngine

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
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
    counts = {"kv_update": kvk.launches, "paged_attention": pak.launches}
    want = cfg.num_layers * steps
    if counts["kv_update"] != want or counts["paged_attention"] != want:
        raise AssertionError(f"launch counts {counts} != layers x steps "
                             f"= {want}")
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
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({build.build_info['library']})", flush=True)

    cfg = dataclasses.replace(get_config("qwen2.5-32b"), num_layers=LAYERS)
    kernels = check_kernels(torch, cfg, dev)
    for row in kernels:
        print(f"kernel {row['name']}: max_abs_err {row['max_abs_err']} "
              f"ms {row['ms']:.5f} eager {row['eager_ms']:.5f} "
              f"plain {row['plain_ms']:.5f} bound {row['bound_ms']:.5f}",
              flush=True)

    ref = check_engine_vs_cpu(torch, dev)
    print(f"engine on the card == engine on the CPU (fp32 smoke): {ref}",
          flush=True)

    serve = serve_full_width(torch, cfg, dev)
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

    line = [dict(row, launches=serve["launches"][row["name"]])
            for row in kernels]
    print(card)
    print(json.dumps({"kernels": line}, default=str))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
