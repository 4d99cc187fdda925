"""Time the flash attention kernels on the card, one tree or several in
turns.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash_bwd \
        [--trees DIR [DIR ...]] [--splits 2,6] [--profile] [--out compare_out]

Times ``flash_attention_bwd`` at starcoder2-3b's training shape (2 x 4096,
24/2 heads of 128, causal), at granite-20b's heads (1 x 1024, 48/1,
causal), at nemotron-4-340b's (1 x 4096, 96/8 at head_dim 192, causal) and
at recurrentgemma-9b's training shape (1 x 8192, 16/1 at head_dim 256,
causal, window 2048), bf16, on the forward kernel's output and
log-sum-exp: device ms per call, CUDA events around 20 calls after 3
warm-up calls (a tree whose backward refuses a head_dim shows "refused").
Beside it, in the same process and on the same inputs, SDPA's backward
(its forward + backward less its forward, ``enable_gqa=True``, a window as
a mask).  Then the forward kernel (``flash_attention`` without the LSE) at
the four shapes, at qwen2.5-32b's prefill (1 x 8192, 40/8 at head_dim 128,
causal) and at hubert-xlarge's encode (8 x 2048, 16/16 at head_dim 80, no
mask), beside SDPA's forward (no mask where the shape has none); each
row names the variant that ran.  ``--splits`` also times the
kernel at those splits of the KV group's heads where the tree has
``bwd_split_count`` (the wgmma variant); ``--profile`` adds the device
time of each kernel one call launches (``torch.profiler``).

With ``--trees``, the script runs itself once per tree, in the order given
(for example parent, change, change, parent), with that tree's ``src``
first on the path, so a copy of a tree edited by hand (under
``_chipcheck/``, which git ignores) is timed beside its original in one
call.  Writes ``bench_flash_bwd.json`` to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

BF16_FLOPS = 989e12           # H100 SXM dense bf16, NVIDIA data sheet
SEED = 0
# name: B, H, K, S, head_dim, causal, window (bf16)
SHAPES = {"train": (2, 24, 2, 4096, 128, True, 0),
          "granite": (1, 48, 1, 1024, 128, True, 0),
          "nemotron": (1, 96, 8, 4096, 192, True, 0),
          "recurrentgemma": (1, 16, 1, 8192, 256, True, 2048)}
FWD_SHAPES = dict(SHAPES, qwen_prefill=(1, 40, 8, 8192, 128, True, 0),
                  hubert=(8, 16, 16, 2048, 80, False, 0))


def pairs(S, window, causal=True) -> int:
    """The (query, key) pairs the mask lets through: keys up to the query
    (causal) or all S, within the window where there is one."""
    if not causal:
        return S * S if not window else sum(
            S - max(0, s - window + 1) for s in range(S))
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def bound_ms(B, H, S, dh, window=0, products=5, causal=True) -> float:
    """``products`` products of 2 dh flops over the visible (query, key)
    pairs at the bf16 peak (both kernels are bound by operations at these
    shapes): five for the backward, two for the forward."""
    return 2 * products * B * H * dh * pairs(S, window, causal) \
        / BF16_FLOPS * 1e3


def event_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def kernel_ms(torch, fn, calls: int = 10) -> dict:
    """Device ms per call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t:
            out[e.key[:80]] = t / calls / 1e3
    return out


def bench(torch, dev, splits, with_profile) -> dict:
    from repro_torch.kernels.flash_attention import kernel as fak
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res, fwd = {}, {}
    for name, (B, H, K, S, dh, causal, win) in FWD_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, k, v, do = randn(B, H, S, dh), randn(B, K, S, dh), \
            randn(B, K, S, dh), randn(B, H, S, dh)
        if win:       # the window as a mask: keys (s - win, s]
            pos = torch.arange(S, device=dev)
            mask = pos[None] > pos[:, None] - win
            if causal:
                mask &= pos[None] <= pos[:, None]
            kw = {"attn_mask": mask}
        else:
            kw = {"is_causal": causal}
        fwd[name] = {
            "shape": [B, H, K, S, dh, causal, win],
            "bound_ms": bound_ms(B, H, S, dh, win, products=2,
                                 causal=causal),
            "ms": event_ms(torch, lambda: fak._launch_fwd(
                q, k, v, causal, win, with_lse=False)),
            "variant": fak.last_variant,
            "sdpa_ms": event_ms(torch, lambda: sdpa(q, k, v, enable_gqa=True,
                                                    **kw))}
        if name not in SHAPES:
            continue
        o, lse = fak._launch_fwd(q, k, v, causal, win, with_lse=True)

        def run():
            return fak.flash_attention_bwd(q, k, v, o, lse, do,
                                           causal=causal, window=win)
        row = {"shape": [B, H, K, S, dh, causal, win],
               "bound_ms": bound_ms(B, H, S, dh, win, causal=causal)}
        try:
            run()
        except NotImplementedError as e:     # a tree without the head_dim
            row["ms"] = "refused"
            row["error"] = str(e)
        else:
            row["ms"] = event_ms(torch, run)
            row["variant"] = getattr(fak, "last_bwd_variant", None)
            row["splits"] = getattr(fak, "last_bwd_splits", None)
            row["pair"] = getattr(fak, "last_bwd_pair", None)
        if splits and row.get("variant") == "wgmma":
            rule = fak.bwd_split_count
            try:
                for sp in splits:
                    if (H // K) % sp == 0:
                        fak.bwd_split_count = lambda *a, sp=sp: sp
                        row[f"ms_split{sp}"] = event_ms(torch, run)
            finally:
                fak.bwd_split_count = rule
        if with_profile and row["ms"] != "refused":
            row["kernels"] = kernel_ms(torch, run)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        row["sdpa_backward_ms"] = event_ms(torch, lambda: sdpa(
            qr, kr, vr, enable_gqa=True, **kw).backward(do)) - \
            event_ms(torch, lambda: sdpa(q, k, v, enable_gqa=True, **kw))
        res[name] = row
        del o, lse, qr, kr, vr
        del q, k, v, do
        torch.cuda.empty_cache()
    return {"backward": res, "forward": fwd}


def run_one(splits, with_profile) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd needs a CUDA device")
    from repro_torch.launch.bench_paged import card_line
    res = bench(torch, torch.device("cuda", 0), splits, with_profile)
    print(json.dumps({"card": card_line(), **res}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--splits", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    splits = [int(x) for x in args.splits.split(",") if x]
    if not args.trees:
        return run_one(splits, args.profile)
    # each tree's src comes first on the path; this module is read from
    # this tree, so a tree without it can be timed too
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); "
            "from bench_flash_bwd import run_one; "
            "run_one(json.loads(sys.argv[3]), sys.argv[4] == '1')")
    here = str(Path(__file__).resolve().parent)
    runs = []
    for tree in args.trees:
        tree = tree.resolve()
        proc = subprocess.run(
            [sys.executable, "-c", code, here, str(tree / "src"),
             json.dumps(splits), "1" if args.profile else "0"],
            capture_output=True, text=True, timeout=900, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = str(tree)
        runs.append(res)
        print(json.dumps(res), flush=True)
    def ms(x):
        return x if isinstance(x, str) else f"{x:.4f}"
    print("flash_attention_bwd ms [variant] (SDPA backward ms), trees in "
          "order:")
    for name in SHAPES:
        cells = [f"{ms(r['backward'][name]['ms'])} "
                 f"[{r['backward'][name].get('variant')}] "
                 f"({ms(r['backward'][name]['sdpa_backward_ms'])})"
                 for r in runs]
        print(f"  {name}: " + ", ".join(cells))
    print("flash_attention ms [variant] (SDPA ms), trees in order:")
    for name in FWD_SHAPES:
        cells = [f"{ms(r['forward'][name]['ms'])} "
                 f"[{r['forward'][name]['variant']}] "
                 f"({ms(r['forward'][name]['sdpa_ms'])})" for r in runs]
        print(f"  {name}: " + ", ".join(cells))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "bench_flash_bwd.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
