"""Serving launcher: paged continuous-batching generation on one device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-32b \
      --smoke --requests 4 --steps 32 [--crash-at 16] [--device cpu]

The reference CLI's flags plus ``--device`` (default ``cuda``).  Weights
are random from a fixed seed.  ``--crash-at N`` drops all transient
allocator state at step N and recovers through the vectorized GC before
continuing.
"""

import argparse

import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models.params import init_params
from ..serving.engine import ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=device)
    engine = ServingEngine(cfg, params, lanes=max(args.requests, 2),
                           max_seq=args.max_seq, device=device)
    lanes = [engine.add_request([1 + i, 2 + i]) for i in range(args.requests)]
    for step in range(args.steps):
        if step == args.crash_at:
            stats = engine.crash_and_recover()
            print(f"[serve] crash at step {step}; recovery: {stats}")
        engine.step()
    for lane in lanes:
        s = engine.sessions.get(lane)
        if s:
            print(f"lane {lane}: {len(s.tokens)} tokens: {s.tokens[:16]}")


if __name__ == "__main__":
    main()
