"""Where a decode step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--steps 8] [--out profile_out]

Builds the serving engine of ``chip_smoke.py``'s serve run (qwen2.5-32b
at full width cut to 8 layers, random weights from a seed; 8 lanes,
max_seq 1024), admits 8 requests (half with 300-token prompts on the
span path, half with short prompts on lazy pages), runs 300 steps so
every lane attends over 300 positions, then records ``--steps`` engine
steps under ``torch.profiler``.  Prints the wall time
per step, the device time per step by kernel (top entries), the share
of device time in the two port kernels and in matmuls, and the device's
busy share (kernel time over wall time).  Writes the Chrome trace and
the table to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.params import init_params
from ..serving.engine import ServingEngine

SEED, LAYERS, LANES, MAX_SEQ, PROMPT = 0, 8, 8, 1024, 300


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(get_config("qwen2.5-32b"), num_layers=LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    eng = ServingEngine(cfg, params, lanes=LANES, max_seq=MAX_SEQ,
                        pages_per_sb=2, device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    for i in range(LANES):               # half span-path, half lazy pages
        n = PROMPT if i % 2 == 0 else 4
        eng.add_request(torch.randint(1, cfg.vocab_size, (n,),
                                      generator=g).tolist())
    for _ in range(PROMPT):
        eng.step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    walls = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            t = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
    wall_ms = 1e3 * sum(walls) / len(walls)
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append((evt.key, us / args.steps / 1e3, evt.count
                         // args.steps))
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows)

    def share(pred):
        return sum(r[1] for r in rows if pred(r[0].lower())) / max(dev_ms,
                                                                  1e-12)

    summary = {
        "card": torch.cuda.get_device_name(0),
        "model": cfg.name, "layers": cfg.num_layers, "lanes": LANES,
        "positions": int(eng.dstate["pos"].max()),
        "wall_ms_per_step": wall_ms,
        "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "share_paged_attention": share(lambda k: "paged_attention" in k),
        "share_kv_update": share(lambda k: "kv_update" in k),
        "share_gemm": share(lambda k: any(w in k for w in (
            "gemm", "gemv", "cutlass", "nvjet", "sm90_xmma"))),
        "top": [{"kernel": k[:120], "ms_per_step": ms, "calls_per_step": n}
                for k, ms, n in rows[:15]],
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "profile_decode_trace.json"))
    (out / "profile_decode.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
