"""Time the SSD scan's backward on the card, one tree or several in turns.

    PYTHONPATH=src python -m repro_torch.launch.bench_ssd_bwd \
        [--trees DIR [DIR ...]] [--out compare_out]

Times ``ssd_scan_bwd`` at mamba2-370m's training shape (8 x 2048, 32
heads of 64, N 128, fp32; inputs at ``chip_smoke.py``'s scales from a
seed), given the h_in the forward stores where the tree's backward takes
it: device ms per call by CUDA-graph replay, eager ms between CUDA
events, and the device time of each of its kernels (``torch.profiler``,
``parts_ms``, by kernel name: a tree of another design shows its own);
holds the result to the plain version (1e-4 of each gradient's max) and
prints ptxas's report for the kernels when this process built the
library.  Also times the forward ``ssd_scan`` kernel by graph replay at
the training shape, without the h_in store (``fwd_ms``) and with it
where the tree has it (``fwd_h_in_ms``: the forward under grad), and at
mamba2-370m's scoring shape, 8 x 4096, without it (``score_fwd_ms``).

With ``--trees``, the script runs itself once per tree, in the order given
(for example parent, change, change, parent), with that tree's ``src``
first on the path.  Writes ``bench_ssd_bwd.json`` to ``--out``.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import sys
from pathlib import Path

SEED = 0
SHAPE = (8, 32, 2048, 64, 128)        # Bz, H, S, P, N
SCORE_SEQ = 4096                      # the scoring run's, same Bz, H, P, N
PARTS = ("ssd_bwd_reverse_pass", "ssd_bwd_chunk_grads", "ssd_bwd_sum_groups")
_KERNEL = re.compile(r"ssd_bwd_[a-z_]+")


def kernel_parts_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each backward kernel (``ssd_bwd_*``; this
    tree's are ``PARTS``) that ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        name = _KERNEL.search(e.key)
        if t and name:
            out[name[0]] = out.get(name[0], 0.0) + t / calls / 1e3
    return out


def ptxas_lines(log: str, kernel: str) -> list[str]:
    """ptxas's report (stack, spills, registers) for each entry function
    whose mangled name holds ``kernel`` (each instantiation of a
    template), its name's line first."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            out.append(line.strip())
            for nxt in lines[i + 1:i + 6]:
                if "Compiling entry function" in nxt:
                    break
                out.append(nxt.strip())
    return out


def bench(torch, dev) -> dict:
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import kernel as ssk
    from repro_torch.launch.bench_paged import graph_ms
    Bz, H, S, P, N = SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale
    xdt = randn(Bz, H, S, P, scale=0.1)
    loga = -randn(Bz, H, S, scale=0.1).abs()
    Bm, Cm = randn(Bz, S, N, scale=0.3), randn(Bz, S, N, scale=0.3)
    dy = randn(Bz, H, S, P)
    # a tree whose backward reads the forward's h_in is handed it, as
    # training hands it over; an older tree rebuilds it inside
    hands_over = "h_in" in inspect.signature(ssk.ssd_scan_bwd).parameters
    kw = {"h_in": ssk._launch_fwd(xdt, loga, Bm, Cm, with_h_in=True)[1]} \
        if hands_over else {}

    def run():
        return ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy, **kw)
    got = run()
    want = ssk.ssd_scan_bwd_plain(xdt, loga, Bm, Cm, dy)
    errs = {name: float((a - b).abs().max() / b.abs().max())
            for name, a, b in zip(("dxdt", "dloga", "dB", "dC"), got, want)}
    del got, want
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    run()
    start.record()
    for _ in range(10):
        run()
    end.record()
    end.synchronize()
    log = build.build_info.get("log", "")
    res = {"shape": list(SHAPE), "rel_err": errs, "h_in_handed_over":
           hands_over, "ms": graph_ms(torch, [run], 10),
           "eager_ms": start.elapsed_time(end) / 10,
           "parts_ms": kernel_parts_ms(torch, run),
           "ptxas": {name: ptxas_lines(log, name)
                     for name in sorted(set(_KERNEL.findall(log)))}}
    kw.clear()
    res["fwd_ms"] = graph_ms(torch, [lambda: ssk._launch_fwd(
        xdt, loga, Bm, Cm)], 10)
    if hands_over:
        res["fwd_h_in_ms"] = graph_ms(torch, [lambda: ssk._launch_fwd(
            xdt, loga, Bm, Cm, with_h_in=True)], 10)
    del xdt, loga, Bm, Cm, dy
    S2 = SCORE_SEQ
    xs, las = randn(Bz, H, S2, P, scale=0.1), -randn(Bz, H, S2,
                                                     scale=0.1).abs()
    Bs, Cs = randn(Bz, S2, N, scale=0.3), randn(Bz, S2, N, scale=0.3)
    res["score_fwd_ms"] = graph_ms(torch, [lambda: ssk._launch_fwd(
        xs, las, Bs, Cs)], 10)
    return res


def run_one() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd_bwd needs a CUDA device")
    from repro_torch.launch.bench_paged import card_line
    return {"card": card_line(), **bench(torch, torch.device("cuda", 0))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    if not args.trees:
        print(json.dumps(run_one()))
        return 0
    from .compare_trees import run_trees
    runs = run_trees("bench_ssd_bwd", args.trees, timeout=600)
    print("ssd_scan_bwd ms (graph replay) [eager], then each kernel's "
          "device ms, trees in order:")
    print("  whole: " + ", ".join(f"{r['ms']:.4f} [{r['eager_ms']:.4f}]"
                                  for r in runs))
    for p in sorted({k for r in runs for k in r["parts_ms"]}):
        print(f"  {p}: " + ", ".join(
            f"{r['parts_ms'].get(p, float('nan')):.4f}" for r in runs))
    for key in ("fwd_ms", "fwd_h_in_ms", "score_fwd_ms"):
        print(f"  ssd_scan {key}: " + ", ".join(
            f"{r.get(key, float('nan')):.4f}" for r in runs))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "bench_ssd_bwd.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
