"""Fault-tolerant training loop.

Port of the reference's ``train/loop.py``: the step loop, the straggler
watchdog (a step longer than ``straggler_factor`` x the rolling median is
logged and counted) and the failure -> restore -> replay logic (a step
that raises, with a checkpoint store present, rebuilds the trainer from
the last checkpoint and replays from its step; the data stream is a pure
function of the step, so the replay sees the same batches).

``ckpt`` takes the reference's interface: ``save(tree, step)`` and
``load_latest(tree_like) -> (tree | None, step)``, the tree
{"p": params, "o_m": m, "o_v": v}.  The Ralloc-backed checkpoint manager
is not ported yet (ROADMAP A7b).  Unlike the reference, whose restore
drops ``microbatches``, ``compressor`` and ``seed``, the rebuilt trainer
keeps every setting it was made with (ROADMAP C15).  Parameters are built
on ``device`` (``cuda`` unless told otherwise) outside inference mode, so
autograd can save them.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.params import init_params
from ..tree import tree_map
from .optimizer import AdamWConfig, init_opt_state
from .step import make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                 ckpt=None, ckpt_every: int = 50, microbatches: int = 1,
                 compressor=None, straggler_factor: float = 3.0,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.microbatches = microbatches
        self.compressor = compressor
        self.straggler_factor = straggler_factor
        self.seed = seed
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=microbatches,
                                       compressor=compressor)
        self.params = init_params(
            cfg, torch.Generator(self.device).manual_seed(seed), self.device)
        self.opt = init_opt_state(self.params)
        self.start_step = 0
        self.step_times: list[float] = []
        self.straggler_events = 0
        if ckpt is not None:
            restored, step = ckpt.load_latest({"p": self.params,
                                               "o_m": self.opt["m"],
                                               "o_v": self.opt["v"]})
            if restored is not None:
                self.params = self._onto(restored["p"], self.params)
                self.opt["m"] = self._onto(restored["o_m"], self.opt["m"])
                self.opt["v"] = self._onto(restored["o_v"], self.opt["v"])
                self.opt["step"] = step
                self.start_step = step

    def _onto(self, tree, like):
        """A restored tree (numpy arrays or tensors) as tensors like
        ``like``."""
        return tree_map(lambda x, ref: torch.as_tensor(x).to(
            device=ref.device, dtype=ref.dtype), tree, like)

    def _maybe_checkpoint(self, step: int) -> None:
        if self.ckpt is not None and step % self.ckpt_every == 0 and step:
            self.ckpt.save({"p": self.params, "o_m": self.opt["m"],
                            "o_v": self.opt["v"]}, step=step)

    def run(self, batches, steps: int, log_every: int = 10):
        history = []
        step = self.start_step
        while step < steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batches.batch_at(step).items()}
            t0 = time.perf_counter()
            try:
                self.params, self.opt, metrics = self.step_fn(
                    self.params, self.opt, batch)
                loss = float(metrics["loss"])
            except Exception as e:                      # fault tolerance
                if self.ckpt is None:
                    raise
                print(f"[trainer] step {step} failed ({e!r}); "
                      f"restoring last checkpoint")
                self.__init__(self.cfg, self.opt_cfg, ckpt=self.ckpt,
                              ckpt_every=self.ckpt_every,
                              microbatches=self.microbatches,
                              compressor=self.compressor,
                              straggler_factor=self.straggler_factor,
                              seed=self.seed, device=self.device)
                step = self.start_step
                continue
            dt = time.perf_counter() - t0
            if len(self.step_times) >= 5:
                med = statistics.median(self.step_times[-20:])
                if dt > self.straggler_factor * med:
                    self.straggler_events += 1
                    print(f"[trainer] straggler: step {step} took "
                          f"{dt:.2f}s (median {med:.2f}s)")
            self.step_times.append(dt)
            history.append(loss)
            if step % log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            step += 1
            self._maybe_checkpoint(step)
        return history
