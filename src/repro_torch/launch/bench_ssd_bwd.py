"""Time the SSD scan's backward on the card, one tree or several in turns.

    PYTHONPATH=src python -m repro_torch.launch.bench_ssd_bwd \
        [--trees DIR [DIR ...]] [--out compare_out]

Times ``ssd_scan_bwd`` at mamba2-370m's training shape (8 x 2048, 32
heads of 64, N 128, fp32; inputs at ``chip_smoke.py``'s scales from a
seed): device ms per call by CUDA-graph replay, eager ms between CUDA
events, and the device time of each of its four kernels
(``torch.profiler``, ``parts_ms``); holds the result to the plain version
(1e-4 of each gradient's max) and prints ptxas's report for the kernels
when this process built the library.

With ``--trees``, the script runs itself once per tree, in the order given
(for example parent, change, change, parent), with that tree's ``src``
first on the path.  Writes ``bench_ssd_bwd.json`` to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
SHAPE = (8, 32, 2048, 64, 128)        # Bz, H, S, P, N
PARTS = ("ssd_bwd_chunk_states", "ssd_bwd_state_pass", "ssd_bwd_chunk_grads",
         "ssd_bwd_sum_groups")


def kernel_parts_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each of ``PARTS`` that ``fn`` launches."""
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
        name = next((p for p in PARTS if p in e.key), None)
        if t and name:
            out[name] = out.get(name, 0.0) + t / calls / 1e3
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

    def run():
        return ssk.ssd_scan_bwd(xdt, loga, Bm, Cm, dy)
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
    return {"shape": list(SHAPE), "rel_err": errs,
            "ms": graph_ms(torch, [run], 10),
            "eager_ms": start.elapsed_time(end) / 10,
            "parts_ms": kernel_parts_ms(torch, run),
            "ptxas": {p: ptxas_lines(log, p) for p in PARTS}}


def run_one() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_ssd_bwd needs a CUDA device")
    from repro_torch.launch.bench_paged import card_line
    res = bench(torch, torch.device("cuda", 0))
    print(json.dumps({"card": card_line(), **res}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", type=Path)
    ap.add_argument("--out", default="compare_out", type=Path)
    args = ap.parse_args(argv)
    if not args.trees:
        return run_one()
    # each tree's src comes first on the path; this module is read from
    # this tree, so a tree without it can be timed too
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "sys.path.insert(0, sys.argv[2]); "
            "from bench_ssd_bwd import run_one; run_one()")
    here = str(Path(__file__).resolve().parent)
    runs = []
    for tree in args.trees:
        tree = tree.resolve()
        proc = subprocess.run(
            [sys.executable, "-c", code, here, str(tree / "src")],
            capture_output=True, text=True, timeout=600, cwd=tree)
        if proc.returncode != 0:
            raise RuntimeError(f"{tree} failed:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = str(tree)
        runs.append(res)
        print(json.dumps(res), flush=True)
    print("ssd_scan_bwd ms (graph replay) [eager], then each kernel's "
          "device ms, trees in order:")
    print("  whole: " + ", ".join(f"{r['ms']:.4f} [{r['eager_ms']:.4f}]"
                                  for r in runs))
    for p in PARTS:
        print(f"  {p}: " + ", ".join(
            f"{r['parts_ms'].get(p, float('nan')):.4f}" for r in runs))
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "bench_ssd_bwd.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
