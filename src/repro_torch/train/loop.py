"""Fault-tolerant training loop.

Port of the reference's ``train/loop.py``: the step loop, the straggler
watchdog (a step longer than ``straggler_factor`` x the rolling median is
logged and counted) and the failure -> restore -> replay logic (a step
that raises, with a checkpoint store present, rebuilds the trainer from
the last checkpoint and replays from its step; the data stream is a pure
function of the step, so the replay sees the same batches).

``ckpt`` is a ``checkpoint.manager.CheckpointManager`` on a Ralloc heap
(or any store with its interface: ``save(tree, step)`` and
``load_latest(tree_like) -> (tree | None, step)``), the tree
{"p": params, "o_m": m, "o_v": v}.  Every ``ckpt_every`` steps the
trainer saves it; a trainer built over a store that holds a committed
checkpoint resumes from it: ``load_latest`` copies each leaf from the
heap straight to the parameter's device and dtype, and the step counter
and ``start_step`` take the checkpoint's step (a crash at any point
resumes from the last committed manifest root; half-written checkpoints
are GC'd by the heap's recovery, never read).  Unlike the reference,
whose restore drops ``microbatches``, ``compressor`` and ``seed``, the
rebuilt trainer keeps every setting it was made with (ROADMAP C15).
Parameters are built on ``device`` (``cuda`` unless told otherwise)
outside inference mode, so autograd can save them.

With ``mesh`` (a ``DeviceMesh`` of more than one rank, the training
layout of ``distributed/sharding.py``) every rank builds a ``Trainer``:
each makes its blocks of the seeded weights leaf by leaf
(``init_params(keep=)``, so no rank holds the whole tree) and its moments
at the blocks' shapes, and takes its shard of each batch.  A checkpoint
stores whole arrays, as the reference's does: rank 0 holds the store
(the other ranks pass ``ckpt=None``), and a save gathers each leaf to it.
A restore reads the whole arrays on rank 0, sends each leaf to every
rank and keeps its block under the mesh it has now, whatever mesh saved
it (the elastic restore).  A failed step raises on every rank together
(``step.py``), so all of them restore and replay together.
"""

from __future__ import annotations

import statistics
import time

import torch

import torch.distributed as dist

from ..device import resolve_device
from ..distributed.mesh import axis_size
from ..distributed.sharding import batch_spec, model_train_specs
from ..distributed.specs import gather_block, local_block
from ..models.config import ModelConfig
from ..models.params import init_params
from ..tree import tree_leaves, tree_map, tree_unflatten
from .optimizer import AdamWConfig, init_opt_state
from .step import make_train_step


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                 ckpt=None, ckpt_every: int = 50, microbatches: int = 1,
                 compressor=None, straggler_factor: float = 3.0,
                 seed: int = 0, device=None, mesh=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.microbatches = microbatches
        self.compressor = compressor
        self.straggler_factor = straggler_factor
        self.seed = seed
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None and mesh.size() > 1 else None
        self.step_fn = make_train_step(cfg, opt_cfg,
                                       microbatches=microbatches,
                                       compressor=compressor, mesh=self.mesh)
        self.specs, keep = None, None
        if self.mesh is not None:
            self.specs = model_train_specs(cfg, self.mesh)
            flat = dict(tree_leaves(self.specs))

            def keep(path, leaf):           # each leaf cut as it is made
                return local_block(leaf, flat[tuple(path[1:].split("/"))],
                                   self.mesh)
        self.params = init_params(
            cfg, torch.Generator(self.device).manual_seed(seed), self.device,
            keep=keep)
        self.opt = init_opt_state(self.params)
        self.start_step = 0
        self.step_times: list[float] = []
        self.straggler_events = 0
        self.rank0 = self.mesh is None or dist.get_rank() == 0
        if self.mesh is not None:
            self._restore_mesh()
        elif ckpt is not None:
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
        """A restored tree as tensors like ``like`` (no copy for a leaf
        already on its device in its dtype, as ``load_latest`` gives)."""
        return tree_map(lambda x, ref: torch.as_tensor(x).to(
            device=ref.device, dtype=ref.dtype), tree, like)

    @property
    def has_ckpt(self) -> bool:
        """Whether checkpoints are kept: on one device, whether a store is
        set (now: a caller may set ``ckpt`` after building the trainer);
        on a mesh, whether rank 0 held one when the trainer was built."""
        return self.ckpt is not None if self.mesh is None \
            else self._rank0_has_ckpt

    def _state(self):
        """The checkpointed tree and, on a mesh, its blocks' specs."""
        tree = {"p": self.params, "o_m": self.opt["m"], "o_v": self.opt["v"]}
        specs = {"p": self.specs, "o_m": self.specs, "o_v": self.specs}
        return tree, specs

    def _restore_mesh(self) -> None:
        """Rank 0 reads the newest checkpoint (whole arrays); every rank
        learns whether there is a store and a checkpoint, receives each
        leaf whole and keeps its block under this mesh."""
        leaves, step = None, -1
        if self.ckpt is not None:
            leaves, step = self.ckpt.load_latest()
        info = torch.tensor([float(self.ckpt is not None),
                             float(step if leaves is not None else -1)])
        dist.broadcast(info, src=0)
        self._rank0_has_ckpt, step = bool(info[0]), int(info[1])
        if step < 0:
            return
        tree, specs = self._state()
        for i, ((_, blk), (_, spec)) in enumerate(zip(tree_leaves(tree),
                                                      tree_leaves(specs))):
            shape = [n * (axis_size(self.mesh, e) if e else 1)
                     for n, e in zip(blk.shape, spec)]
            whole = leaves[i].to(self.device) if self.rank0 else \
                torch.empty(shape, dtype=blk.dtype, device=self.device)
            dist.broadcast(_bytes(whole), src=0)      # bit for bit
            blk.copy_(local_block(whole, spec, self.mesh))
            del whole
        self.opt["step"] = step
        self.start_step = step

    def whole_state(self):
        """The checkpointed tree {"p", "o_m", "o_v"} with whole leaves: on
        a mesh each leaf gathered bit for bit to rank 0's host, one at a
        time (every rank takes part; the others get None)."""
        tree, specs = self._state()
        if self.mesh is None:
            return tree
        whole = []
        for (_, blk), (_, spec) in zip(tree_leaves(tree), tree_leaves(specs)):
            g = gather_block(_bytes(blk), spec, self.mesh)
            whole.append(g.view(blk.dtype).cpu() if self.rank0 else None)
            del g
        return tree_unflatten(tree, whole) if self.rank0 else None

    def _maybe_checkpoint(self, step: int) -> None:
        if not (self.has_ckpt and step % self.ckpt_every == 0 and step):
            return
        tree = self.whole_state()
        if self.rank0:
            self.ckpt.save(tree, step=step)

    def run(self, batches, steps: int, log_every: int = 10):
        history = []
        step = self.start_step
        while step < steps:
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in batches.batch_at(step).items()}
            if self.mesh is not None:     # this rank's shard
                batch = {k: local_block(v, batch_spec(self.mesh), self.mesh)
                         for k, v in batch.items()}
            t0 = time.perf_counter()
            try:
                self.params, self.opt, metrics = self.step_fn(
                    self.params, self.opt, batch)
                loss = float(metrics["loss"])
            except Exception as e:                      # fault tolerance
                if not self.has_ckpt:
                    raise
                if self.rank0:
                    print(f"[trainer] step {step} failed ({e!r}); "
                          f"restoring last checkpoint")
                self.__init__(self.cfg, self.opt_cfg, ckpt=self.ckpt,
                              ckpt_every=self.ckpt_every,
                              microbatches=self.microbatches,
                              compressor=self.compressor,
                              straggler_factor=self.straggler_factor,
                              seed=self.seed, device=self.device,
                              mesh=self.mesh)
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
            if step % log_every == 0 and self.rank0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)")
            step += 1
            self._maybe_checkpoint(step)
        return history


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes (a uint8 view, the last dim times the item size): a
    collective on it moves the bits whatever the dtype (-0.0 kept)."""
    return t.view(torch.uint8)
