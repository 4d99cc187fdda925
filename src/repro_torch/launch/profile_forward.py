"""Where a full-sequence forward's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_forward \
        [--arch qwen2.5-32b mamba2-370m ...] [--out profile_out]

For each architecture, builds its run in ``RUNS`` at full width (random
weights from a seed): qwen2.5-32b cut to 8 layers on one 8192-token
prompt, mamba2-370m with all 48 layers on 8 x 4096 tokens,
recurrentgemma-9b with all 38 layers on one 8192-token prompt (flash at
head_dim 256 with its 2048-token window, and the RG-LRU scan),
granite-moe-3b-a800m with all 32 layers on one 4096-token prompt (its
context; flash at 24/8 heads of 64 and the per-row MoE dispatch) and
hubert-xlarge with all 48 layers on 8 x 2048 frame embeddings (~41 s of
audio each at 50 frames/s; flash without a causal mask at head_dim 80).
``chip_smoke.py`` times these same runs.  Runs one warm-up forward, then
records one ``forward`` under ``torch.profiler``.  Prints the wall time,
the device time by kernel (top entries), the shares of the port's kernel,
of matmuls and of the rest, and the device's busy share (kernel time over
wall time).  Writes the Chrome trace and the table of each architecture
to ``--out``.
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
from ..models import transformer as T
from ..models.params import init_params

SEED = 0


@dataclasses.dataclass(frozen=True)
class ForwardRun:
    """One full-width forward run: its depth, its batch, and the port
    kernel on its path (a word of the kernel's symbol)."""
    layers: int
    batch: int
    seq: int
    kernel: str


RUNS = {"qwen2.5-32b": ForwardRun(8, 1, 8192, "flash"),       # depth cut
        "mamba2-370m": ForwardRun(48, 8, 4096, "ssd"),        # whole model
        "recurrentgemma-9b": ForwardRun(38, 1, 8192, "flash"),  # whole
        "granite-moe-3b-a800m": ForwardRun(32, 1, 4096, "flash"),  # whole
        "hubert-xlarge": ForwardRun(48, 8, 2048, "flash")}    # whole


def run_config(arch: str):
    """The architecture's published configuration at the run's depth."""
    return dataclasses.replace(get_config(arch), num_layers=RUNS[arch].layers)


def run_batch(cfg, run: ForwardRun, dev) -> dict:
    """The run's random batch (from the seed): tokens, which are their
    own next-token labels, or, for a front-end stub, fp32 frame
    embeddings [B, S, D] with frame labels in the vocabulary."""
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    shape = (run.batch, run.seq)
    if cfg.frontend:
        return {"embeds": torch.randn(shape + (cfg.d_model,), generator=g,
                                      device=dev),
                "labels": torch.randint(0, cfg.vocab_size, shape,
                                        generator=g, device=dev)}
    toks = torch.randint(0, cfg.vocab_size, shape, generator=g, device=dev)
    return {"tokens": toks, "labels": toks}
GEMM_WORDS = ("gemm", "gemv", "cutlass", "nvjet", "sm90_xmma")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_rows(prof) -> list[tuple[str, float, int]]:
    """(kernel, device ms, calls) of a profile, longest first."""
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(evt)
        if us > 0:
            rows.append((evt.key, us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile(arch: str, out: Path, dev) -> dict:
    run = RUNS[arch]
    B, S, kernel = run.batch, run.seq, run.kernel
    cfg = run_config(arch)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    batch = run_batch(cfg, run, dev)
    T.forward(cfg, params, batch)                # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        T.forward(cfg, params, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = device_rows(prof)
    dev_ms = sum(r[1] for r in rows)

    def share(pred):
        return sum(r[1] for r in rows if pred(r[0].lower())) / max(dev_ms,
                                                                  1e-12)

    summary = {
        "card": torch.cuda.get_device_name(0), "model": cfg.name,
        "layers": cfg.num_layers, "batch": B, "seq": S,
        "dtype": str(cfg.dtype),
        "wall_ms_per_forward": wall_ms, "device_ms_per_forward": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "tokens_per_s_under_profiler": B * S / (wall_ms / 1e3),
        f"share_{kernel}": share(lambda k: kernel in k),
        "share_gemm": share(lambda k: any(w in k for w in GEMM_WORDS)),
        "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                for k, ms, n in rows[:20]],
    }
    stem = arch.replace(".", "_")
    prof.export_chrome_trace(str(out / f"profile_forward_{stem}_trace.json"))
    (out / f"profile_forward_{stem}.json").write_text(
        json.dumps(summary, indent=1))
    del params, batch
    torch.cuda.empty_cache()
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=list(RUNS),
                    choices=list(RUNS))
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for arch in args.arch:
        print(json.dumps(profile(arch, out, dev), indent=1), flush=True)


if __name__ == "__main__":
    main()
