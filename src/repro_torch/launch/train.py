"""Training launcher.

On the CPU (smoke configuration), checkpointing to a heap file:
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --smoke --steps 50 --ckpt /tmp/train.heap --device cpu

On the card, the published configuration whole (``--device`` defaults to
``cuda`` and raises without it):
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --steps 6 --batch 2 --seq 4096

Port of the reference's ``launch/train.py``.  ``--ckpt PATH`` opens (or
creates) a 1 GiB Ralloc heap file at PATH, as the reference does, and
the trainer saves a checkpoint there every ``--ckpt-every`` steps; a run
over a heap that holds one resumes from its step.  The heap is closed
cleanly at the end.  1 GiB holds the smoke configurations; a full-width
state exhausts it (``MemoryError``, in the reference too: ROADMAP C).
Every arch trains on the CPU and, where its training state fits the
card's memory, on the card (recurrentgemma-9b whole needs ~122 GB;
``chip_smoke.py`` trains its first 9 layers); mamba2-370m trains through
the ssd_scan kernels:
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 6 --batch 8 --seq 2048

The last line of the output is one JSON object: each step's ms but the
first's, their median, least and most, the losses and, on the card, the
peak memory (``step_report``).  ``compare_trees --train`` reads it.
"""

from __future__ import annotations

import argparse
import json
import statistics

# absolute imports: ``compare_trees --train`` imports this file alone, on
# top of another tree's package
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.ralloc import Ralloc
from repro_torch.data.pipeline import TokenStream
from repro_torch.device import resolve_device
from repro_torch.distributed.compression import Int8ErrorFeedback
from repro_torch.train.loop import Trainer
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import make_train_step


def step_report(trainer, cfg, hist) -> dict:
    """The run's step times in ms (the first, which builds the kernels and
    warms the allocator, apart), their median, least and most, the losses
    and, on the card, the peak memory and the card."""
    ms = [1e3 * t for t in trainer.step_times]
    timed = ms[1:]
    rep = {"arch": cfg.name, "layers": cfg.num_layers, "losses": hist,
           "first_step_ms": ms[0] if ms else None, "ms_per_step": timed,
           "ms_per_step_median": statistics.median(timed) if timed else None,
           "ms_per_step_min": min(timed, default=None),
           "ms_per_step_max": max(timed, default=None)}
    if trainer.device.type == "cuda":
        import torch

        from repro_torch.launch.bench_paged import card_line
        rep["peak_mem_gb"] = torch.cuda.max_memory_allocated(
            trainer.device) / 1e9
        rep["card"] = card_line()
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    resolve_device(args.device)         # raise before a heap file is made
    ckpt = None
    if args.ckpt:
        heap = Ralloc(args.ckpt, 1 << 30)
        ckpt = CheckpointManager(heap)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0,
                         frontend_dim=cfg.d_model if cfg.frontend else 0)
    opt_cfg = AdamWConfig(lr=args.lr)
    trainer = Trainer(cfg, opt_cfg, ckpt=ckpt, ckpt_every=args.ckpt_every,
                      microbatches=args.microbatches, device=args.device)
    if trainer.start_step:
        print(f"[train] resumed from the checkpoint at step "
              f"{trainer.start_step}")
    if args.compress_grads:
        trainer.step_fn = make_train_step(
            cfg, opt_cfg, microbatches=args.microbatches,
            compressor=Int8ErrorFeedback(trainer.params))
    hist = trainer.run(stream, steps=args.steps)
    print(f"final loss {hist[-1]:.4f}; straggler events: "
          f"{trainer.straggler_events}")
    if ckpt:
        heap.close()
    print(json.dumps(step_report(trainer, cfg, hist)))
    return hist


if __name__ == "__main__":
    main()
