"""Time the flash attention backward on the card, one tree or several in
turns.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash_bwd \
        [--trees DIR [DIR ...]] [--splits 2,6] [--profile] [--out compare_out]

Times ``flash_attention_bwd`` at starcoder2-3b's training shape (2 x 4096,
24/2 heads of 128, causal) and at granite-20b's heads (1 x 1024, 48/1),
bf16, on the forward kernel's output and log-sum-exp: device ms per call,
CUDA events around 20 calls after 3 warm-up calls.  Beside it, in the same
process and on the same inputs, SDPA's backward (its forward + backward
less its forward, ``enable_gqa=True``).  ``--splits`` also times the
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
# name: B, H, K, S, head_dim (causal, no window, bf16)
SHAPES = {"train": (2, 24, 2, 4096, 128), "granite": (1, 48, 1, 1024, 128)}


def bound_ms(B, H, S, dh) -> float:
    """Five products of 2 dh flops over the causal (query, key) pairs at
    the bf16 peak (the kernel is bound by operations at these shapes)."""
    return 10 * B * H * dh * (S * (S + 1) // 2) / BF16_FLOPS * 1e3


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
    res = {}
    for name, (B, H, K, S, dh) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(SEED)

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)
        q, k, v, do = randn(B, H, S, dh), randn(B, K, S, dh), \
            randn(B, K, S, dh), randn(B, H, S, dh)
        o, lse = fak._launch_fwd(q, k, v, True, 0, with_lse=True)

        def run():
            return fak.flash_attention_bwd(q, k, v, o, lse, do)
        row = {"shape": [B, H, K, S, dh], "bound_ms": bound_ms(B, H, S, dh),
               "ms": event_ms(torch, run),
               "variant": getattr(fak, "last_bwd_variant", None),
               "splits": getattr(fak, "last_bwd_splits", None)}
        if splits and hasattr(fak, "bwd_split_count"):
            rule = fak.bwd_split_count
            try:
                for sp in splits:
                    if (H // K) % sp == 0:
                        fak.bwd_split_count = lambda *a, sp=sp: sp
                        row[f"ms_split{sp}"] = event_ms(torch, run)
            finally:
                fak.bwd_split_count = rule
        if with_profile:
            row["kernels"] = kernel_ms(torch, run)
        qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
        row["sdpa_backward_ms"] = event_ms(torch, lambda: sdpa(
            qr, kr, vr, is_causal=True, enable_gqa=True).backward(do)) - \
            event_ms(torch, lambda: sdpa(q, k, v, is_causal=True,
                                         enable_gqa=True))
        res[name] = row
        del q, k, v, do, o, lse, qr, kr, vr
        torch.cuda.empty_cache()
    return res


def run_one(splits, with_profile) -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_bwd needs a CUDA device")
    from repro_torch.launch.bench_paged import card_line
    res = bench(torch, torch.device("cuda", 0), splits, with_profile)
    print(json.dumps({"card": card_line(), "shapes": res}))
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
    print("flash_attention_bwd ms (SDPA backward ms), trees in order:")
    for name in SHAPES:
        cells = [f"{r['shapes'][name]['ms']:.4f} "
                 f"({r['shapes'][name]['sdpa_backward_ms']:.4f})"
                 for r in runs]
        print(f"  {name}: " + ", ".join(cells))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "bench_flash_bwd.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
