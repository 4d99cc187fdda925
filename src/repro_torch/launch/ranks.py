"""Start the ranks of a mesh: one process each, one gloo group.

``run_ranks(fn, world, job)`` starts ``world`` processes (the ``spawn``
start method), joins them into one ``torch.distributed`` gloo group over
a ``FileStore`` in a fresh temporary directory, calls ``fn(rank, world,
job)`` in each and returns the ranks' results in rank order; a rank that
raises or dies makes it raise, and it leaves no process behind.  The
ranks run on ``cuda`` unless the caller passes ``device="cpu"``, and
asking for ``cuda`` without it raises before any process starts.  On the
card every rank drives the one card (gloo carries the collectives: NCCL
takes one rank a device), so a timing there is N ranks sharing one H100,
not a multi-card number.  ``fn`` must be importable by the spawned child
(a module of the port, or a test module), and a script that calls
``run_ranks`` needs an ``if __name__ == "__main__":`` guard.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..device import resolve_device


def _rank_main(rank, world, store_path, fn, job_path, device, out):
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(0)
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        try:
            res = fn(rank, world, job)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except Exception:                  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, job, *, device: str = "cuda",
              timeout: float = 900.0) -> list:
    """``fn(rank, world, job)`` on ``world`` spawned ranks of one gloo
    group, each on ``device`` ("cpu": one thread a rank; "cuda": card 0);
    their results (picklable: numpy, not tensors) in rank order.  Raises
    with every failed rank's traceback."""
    device = resolve_device(device).type
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mesh_ranks_")
    # the job goes through a file: a large one in the processes' arguments
    # would block each start until that child had read it
    job_path = os.path.join(tmp, "job.pkl")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, os.path.join(tmp, "store"), fn, job_path, device, out))
        for r in range(world)]
    results, errors = {}, {}
    try:
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < world:
            try:
                rank, ok, res = out.get(timeout=1.0)
                (results if ok else errors)[rank] = res
            except queue.Empty:
                gone = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in results and r not in errors]
                if gone or time.monotonic() > deadline:
                    for r in gone:
                        errors[r] = f"exited with {procs[r].exitcode}"
                    if not gone:
                        errors[-1] = f"timed out after {timeout} s"
                    break
            if errors:
                break
        for p in procs:
            p.join(timeout=30 if not errors else 5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("mesh ranks failed:\n" + "\n".join(
            f"-- rank {r}:\n{e}" for r, e in sorted(errors.items())))
    return [results[r] for r in range(world)]
