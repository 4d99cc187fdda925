"""Where a train step's time goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch starcoder2-3b] [--batch 2] [--seq 4096] [--out profile_out]
    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        --arch mamba2-370m --batch 8 --seq 2048

Builds the trainer for the architecture's published configuration, whole
(random weights from a seed, bf16, AdamW), feeds it ``TokenStream``
batches, runs one warm-up step, then records one step under
``torch.profiler``.  Prints the wall time, the device time by kernel (top
entries), the shares of the flash and ssd_scan forward and backward
kernels, of matmuls and of the rest, and the device's busy share (kernel
time over wall time).  Writes the Chrome trace and the summary to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from ..configs import get_config
from ..data.pipeline import TokenStream
from ..device import resolve_device
from ..train.loop import Trainer
from ..train.optimizer import AdamWConfig
from .profile_forward import GEMM_WORDS, device_rows

FLASH_FWD_WORDS = ("flash_wgmma", "flash_bf16", "flash_f32")
# the backward's kernels: the mma.sync / FMA variants' prep and post, and
# the wgmma variant's, whose namespace is wgb
FLASH_BWD_WORDS = ("flash_bwd", "bwd_prep", "bwd_post", "::wgb::")
SSD_FWD_WORDS = ("ssd_chunk_kernel", "ssd_state_kernel")
SSD_BWD_WORDS = ("ssd_bwd_",)


def profile(arch: str, batch: int, seq: int, out: Path, dev) -> dict:
    cfg = get_config(arch)
    trainer = Trainer(cfg, AdamWConfig(), device=dev)
    stream = TokenStream(cfg.vocab_size, batch, seq, seed=0,
                         frontend_dim=cfg.d_model if cfg.frontend else 0)

    def step(i):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.batch_at(i).items()}
        trainer.params, trainer.opt, m = trainer.step_fn(
            trainer.params, trainer.opt, b)
        return float(m["loss"])

    step(0)                                      # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        loss = step(1)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = device_rows(prof)
    dev_ms = sum(r[1] for r in rows)

    def share(words):
        return sum(r[1] for r in rows
                   if any(w in r[0].lower() for w in words)) / max(dev_ms,
                                                                  1e-12)

    summary = {
        "card": torch.cuda.get_device_name(0), "model": cfg.name,
        "layers": cfg.num_layers, "batch": batch, "seq": seq,
        "dtype": str(cfg.dtype), "loss": loss,
        "wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
        "device_busy_share": dev_ms / wall_ms,
        "kernels_per_step": sum(r[2] for r in rows),
        "share_flash_fwd": share(FLASH_FWD_WORDS),
        "share_flash_bwd": share(FLASH_BWD_WORDS),
        "share_ssd_fwd": share(SSD_FWD_WORDS),
        "share_ssd_bwd": share(SSD_BWD_WORDS),
        "share_gemm": share(GEMM_WORDS),
        "top": [{"kernel": k[:120], "ms": ms, "calls": n}
                for k, ms, n in rows[:25]],
    }
    stem = arch.replace(".", "_")
    prof.export_chrome_trace(str(out / f"profile_train_{stem}_trace.json"))
    (out / f"profile_train_{stem}.json").write_text(
        json.dumps(summary, indent=1))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps(profile(args.arch, args.batch, args.seq, out, dev),
                     indent=1), flush=True)


if __name__ == "__main__":
    main()
