"""Training launcher.

On the CPU (smoke configuration):
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --smoke --steps 50 --device cpu

On the card, the published configuration whole (``--device`` defaults to
``cuda`` and raises without it):
  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b \
      --steps 6 --batch 2 --seq 4096

Port of the reference's ``launch/train.py``; ``--ckpt`` waits for the
checkpoint manager (ROADMAP A7b) and raises.  mamba2-370m raises at its
first step (no ssd_scan backward yet), as do archs with head_dim above 128
on the card (no flash backward there yet).
"""

from __future__ import annotations

import argparse

from ..configs import get_config, get_smoke_config
from ..data.pipeline import TokenStream
from ..distributed.compression import Int8ErrorFeedback
from ..train.loop import Trainer
from ..train.optimizer import AdamWConfig
from ..train.step import make_train_step


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

    if args.ckpt:
        raise NotImplementedError(
            "--ckpt needs the Ralloc-backed checkpoint manager, not ported "
            "yet (ROADMAP A7b)")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    stream = TokenStream(cfg.vocab_size, args.batch, args.seq, seed=0,
                         frontend_dim=cfg.d_model if cfg.frontend else 0)
    opt_cfg = AdamWConfig(lr=args.lr)
    trainer = Trainer(cfg, opt_cfg, ckpt_every=args.ckpt_every,
                      microbatches=args.microbatches, device=args.device)
    if args.compress_grads:
        trainer.step_fn = make_train_step(
            cfg, opt_cfg, microbatches=args.microbatches,
            compressor=Int8ErrorFeedback(trainer.params))
    hist = trainer.run(stream, steps=args.steps)
    print(f"final loss {hist[-1]:.4f}; straggler events: "
          f"{trainer.straggler_events}")
    return hist


if __name__ == "__main__":
    main()
