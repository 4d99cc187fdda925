"""The sharded decode step's gap to one device as the depth grows.

    python -m repro_torch.launch.mesh_depth [--cases bf16:5,bf16:11,...]

recurrentgemma-9b at its published widths, cut to each case's depth, in
that case's dtype: ``decode_step`` on the card decodes one lane
(seeded weights and tokens) for 2016 steps, then hands its state to a
(2, 2) mesh of four ranks sharing the card over gloo, sequence-parallel
(``launch/mesh_decode.py``), which decodes the next 96 steps across the
2048 window while the one-device step goes on alone.  Prints, a JSON line
a case, the largest gap of the mesh's logits to the one-device step's
over five of the 96 steps (relative to the largest logit), the share of
equal greedy tokens and the median ms a mesh step (four ranks on one
card: not a multi-card number), with the card's name and power limit.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

FIRST, TOTAL, KEEP = 2016, 2112, (0, 31, 32, 33, 95)


def main(argv=None) -> int:
    from ..configs import get_config
    from ..device import resolve_device
    from ..kernels import build
    from .bench_paged import card_line
    from .mesh_decode import decode_jobs, one_device_decode
    from .ranks import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="bf16:5,bf16:11,fp32:11,bf16:38")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = card_line()
    build.library()                    # once, before the ranks load it
    cases = [(c.split(":")[0], int(c.split(":")[1]))
             for c in args.cases.split(",")]
    tmp = Path(tempfile.mkdtemp(prefix="mesh_depth_"))
    jobs, refs = [], []
    try:
        for i, (dt, layers) in enumerate(cases):
            cfg = dataclasses.replace(
                get_config("recurrentgemma-9b"), num_layers=layers,
                dtype={"bf16": torch.bfloat16, "fp32": torch.float32}[dt])
            tok = np.random.default_rng(50).integers(
                0, cfg.vocab_size, (1, TOTAL), dtype=np.int32)
            path = str(tmp / f"state{i}.pt")
            refs.append(one_device_decode(
                cfg, dev, tok, 4096, [FIRST + k for k in KEEP],
                (FIRST, [(2, False, path)])))
            torch.cuda.empty_cache()
            jobs.append({"cfg": cfg, "mesh": ((2, 2), ("data", "model")),
                         "device": "cuda", "batch_sharded": False,
                         "seed": 0, "max_seq": 4096, "tokens": tok[:, FIRST:],
                         "keep_steps": list(KEEP), "state_file": path})
        res = run_ranks(decode_jobs, 4, jobs, device="cuda", timeout=1800)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for i, (dt, layers) in enumerate(cases):
        got, ref = res[0][i], refs[i]
        scale = float(np.abs(ref["logits"]).max())
        print(json.dumps({
            "dtype": dt, "layers": layers,
            "rel_err": float(np.abs(got["logits"] - ref["logits"]).max())
            / scale,
            "tokens_equal": float((got["tokens"]
                                   == ref["tokens"][FIRST:]).mean()),
            "mesh_ms_per_step": 1e3 * float(np.median(got["step_s"][2:])),
            "one_device_ms_per_step": ref["ms_per_step_median"],
            "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
