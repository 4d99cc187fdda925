"""The sharded train step driven on a mesh of ranks.

The ranks are started by ``launch/ranks.py`` ``run_ranks``; ``jobs``
runs a list of jobs in one start-up, each a dict with a ``kind``:

  * ``"step"`` (``step_rank``): ``train/step.py`` ``make_train_step(...,
    mesh=)`` over given batches, from given weights (a numpy tree) or
    seeded ones, optionally with the first step's gradients gathered;
  * ``"trainer"`` (``trainer_rank``): ``train/loop.py`` ``Trainer(...,
    mesh=)`` over a ``TokenStream``, optionally checkpointing to a store
    that rank 0 holds (a heap file, or a RAM heap kept in rank 0's process
    for a later job of the same start-up: the elastic restore onto
    another mesh), optionally failing once on one rank.

Every rank returns its launch counts, its all-reduces (calls and bytes),
step times and peak memory; rank 0 also what the caller compares
(losses, grad norms, gathered trees).
"""

from __future__ import annotations

import math
import time

import torch

_RAM_HEAPS: dict = {}          # rank 0's RAM heaps, by key, across jobs


def _device(job) -> torch.device:
    return torch.device("cpu") if job.get("device", "cuda") == "cpu" \
        else torch.device("cuda", 0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def kernel_counts() -> dict:
    """The training kernels' launch counters in this process."""
    from ..kernels.flash_attention import kernel as fak
    from ..kernels.ssd_scan import kernel as ssk
    return {"flash_attention": fak.launches,
            "flash_attention_bwd": fak.bwd_launches,
            "ssd_scan": ssk.launches, "ssd_scan_bwd": ssk.bwd_launches}


def collective_counts() -> dict:
    """The mesh's all-reduces in this process and their bytes."""
    from ..distributed import mesh
    return {"calls": mesh.collective_calls, "bytes": mesh.collective_bytes}


def zero_kernel_counts() -> None:
    """The kernels' launch counters and the collectives' at 0."""
    from ..distributed import mesh
    from ..kernels.flash_attention import kernel as fak
    from ..kernels.ssd_scan import kernel as ssk
    fak.launches = fak.bwd_launches = ssk.launches = ssk.bwd_launches = 0
    mesh.collective_calls = mesh.collective_bytes = 0


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def leaf_checksums(tree) -> list[str]:
    """A digest of each leaf's bytes, in ``tree_leaves`` order."""
    import hashlib
    from ..tree import tree_leaves
    return [hashlib.sha256(t.detach().contiguous().cpu().view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for _, t in tree_leaves(tree)]


def _blocks(job, cfg, mesh, specs, dev):
    """This rank's blocks of the weights: cut from ``job["params"]`` (a
    global numpy tree) or made from ``job["seed"]`` leaf by leaf."""
    from ..distributed.specs import local_block, shard_tree
    from ..models.params import from_numpy_tree, init_params
    from ..tree import tree_leaves
    if "params" in job:
        return shard_tree(from_numpy_tree(job["params"], dev), specs, mesh)
    flat = dict(tree_leaves(specs))
    return init_params(cfg, torch.Generator(device=dev).manual_seed(
        job["seed"]), device=dev, keep=lambda path, leaf: local_block(
            leaf, flat[tuple(path[1:].split("/"))], mesh))


def step_rank(rank: int, world: int, job: dict) -> dict:
    """``make_train_step(..., mesh=)`` on this rank.  ``job``: ``cfg``,
    ``mesh`` (shape, names), ``device``, ``params`` (global numpy) or
    ``seed``, ``batches`` (global numpy dicts, one a step), ``opt``
    (AdamWConfig's fields), ``microbatches``, ``compress`` (the int8
    codec on the mesh; "record" also gathers what it returned at each
    step), ``grads`` (gather the first step's gradients before
    stepping).  Rank 0 returns the metrics of every step, the final
    parameters gathered and (with ``grads``) the gradients."""
    from ..distributed.compression import Int8ErrorFeedback
    from ..distributed.mesh import make_mesh
    from ..distributed.sharding import batch_spec, model_train_specs
    from ..distributed.specs import gather_tree, local_block
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.step import make_train_step, mesh_loss_and_grads

    cfg, dev = job["cfg"], _device(job)
    shape, names = job["mesh"]
    mesh = make_mesh(shape, names, dev.type)
    specs = model_train_specs(cfg, mesh)
    params = _blocks(job, cfg, mesh, specs, dev)
    opt = init_opt_state(params)
    codec, coded = None, []
    if job.get("compress"):
        int8 = Int8ErrorFeedback(params, mesh=mesh)

        def codec(grads):
            out = int8(grads)
            if job["compress"] == "record":
                coded.append(out)
            return out
    step = make_train_step(cfg, AdamWConfig(**job.get("opt", {})),
                           microbatches=job.get("microbatches", 1),
                           compressor=codec, mesh=mesh)

    def shard(b):
        return {k: local_block(torch.as_tensor(v, device=dev),
                               batch_spec(mesh), mesh) for k, v in b.items()}

    res = {"rank": rank}
    if job.get("grads"):
        _, g = mesh_loss_and_grads(cfg, params, shard(job["batches"][0]),
                                   mesh, specs)
        g = gather_tree(g, specs, mesh)
        if rank == 0:
            res["grads"] = numpy_tree(g)
        del g
    _sync(dev)
    zero_kernel_counts()
    metrics, times = [], []
    for b in job["batches"]:
        b = shard(b)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        _sync(dev)
        times.append(time.perf_counter() - t0)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    res.update(launches=kernel_counts(), collectives=collective_counts(),
               step_s=times)
    final = gather_tree(params, specs, mesh)
    coded = [gather_tree(c, specs, mesh) for c in coded]
    if rank == 0:
        res["metrics"] = metrics
        res["params"] = numpy_tree(final)
        res["codec_out"] = [numpy_tree(c) for c in coded]
    return res


def _store(job: dict, rank: int):
    """Rank 0's checkpoint store for ``job["ckpt"]`` ({"path"} a heap
    file, or {"key"} a RAM heap kept for later jobs; "size" bytes), and
    the heap to close after the job (None for a kept RAM heap)."""
    from ..checkpoint.manager import CheckpointManager
    from ..core.ralloc import Ralloc
    spec = job.get("ckpt")
    if spec is None or rank != 0:
        return None, None
    if spec.get("path"):
        heap = Ralloc(spec["path"], spec["size"])
        return CheckpointManager(heap), heap
    if spec["key"] not in _RAM_HEAPS:
        _RAM_HEAPS[spec["key"]] = CheckpointManager(
            Ralloc(None, spec["size"]))
    return _RAM_HEAPS[spec["key"]], None


class _Checksummed:
    """A checkpoint store that records each saved tree's leaf digests
    (as (step, digests)) before saving it."""

    def __init__(self, store, out: list):
        self.store, self.out = store, out

    def save(self, tree, step):
        self.out.append((step, leaf_checksums(tree)))
        self.store.save(tree, step)

    def load_latest(self, tree_like=None):
        return self.store.load_latest(tree_like)


def trainer_rank(rank: int, world: int, job: dict) -> dict:
    """``Trainer(..., mesh=)`` on this rank over ``TokenStream(vocab,
    batch, seq, seed)`` batches.  ``job``: ``cfg``, ``mesh``, ``device``,
    ``seed``, ``stream`` (vocab, batch, seq, seed), ``steps``, ``opt``,
    ``ckpt`` and ``ckpt_every`` (see ``_store``), ``fail_at`` ((rank,
    call): that rank's gradient phase raises once, after its collectives,
    at that call), ``gather`` ("params" or "state": the trees rank 0
    returns as numpy, after the last step), ``checksums`` (each leaf's
    digest of the whole state: of a restored state, gathered before the
    first step, and of every tree rank 0 saves, as it saves it).  Every rank returns its
    launches, step times, peak memory and start step; rank 0 also the
    losses and grad norms."""
    from ..data.pipeline import TokenStream
    from ..distributed.mesh import make_mesh
    from ..train import step as step_mod
    from ..train.loop import Trainer
    from ..train.optimizer import AdamWConfig

    cfg, dev = job["cfg"], _device(job)
    shape, names = job["mesh"]
    mesh = make_mesh(shape, names, dev.type)
    ckpt, heap = _store(job, rank)
    saved = []
    if ckpt is not None and job.get("checksums"):
        ckpt = _Checksummed(ckpt, saved)
    real = step_mod.mesh_loss_and_grads
    calls = [0]
    if job.get("fail_at") and job["fail_at"][0] == rank:
        def flaky(*args):
            out = real(*args)
            calls[0] += 1
            if calls[0] == job["fail_at"][1]:
                raise RuntimeError(f"injected fault on rank {rank}")
            return out
        step_mod.mesh_loss_and_grads = flaky
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        tr = Trainer(cfg, AdamWConfig(**job.get("opt", {})), ckpt=ckpt,
                     ckpt_every=job.get("ckpt_every", 50), seed=job["seed"],
                     device=dev, mesh=mesh)
        _sync(dev)
        setup_s = time.perf_counter() - t

        res = {"rank": rank, "start_step": tr.start_step,
               "setup_s": setup_s}
        if job.get("checksums") and tr.start_step:      # restored
            s = tr.whole_state()
            res["checksums_at_start"] = leaf_checksums(s) if rank == 0 \
                else None
            del s
        norms = []
        step_fn = tr.step_fn

        def recorded(*args):
            out = step_fn(*args)
            norms.append(float(out[2]["grad_norm"]))
            return out
        tr.step_fn = recorded
        _sync(dev)
        zero_kernel_counts()
        vocab, batch, seq, sseed = job["stream"]
        hist = tr.run(TokenStream(vocab, batch, seq, seed=sseed),
                      steps=job["steps"], log_every=job.get("log_every",
                                                            1000))
        _sync(dev)
        res.update(launches=kernel_counts(),
                   collectives=collective_counts(),
                   step_s=list(tr.step_times),
                   peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None),
                   restored_at=tr.start_step)
        if not all(math.isfinite(x) for x in hist + norms):
            raise AssertionError(f"non-finite loss or grad norm: {hist} "
                                 f"{norms}")
        if job.get("gather"):
            s = tr.whole_state()
            if rank == 0:
                res["state"] = numpy_tree(s if job["gather"] == "state"
                                          else s["p"])
            del s
        if rank == 0:
            res.update(losses=hist, grad_norms=norms, checksums_saved=saved)
        return res
    finally:
        step_mod.mesh_loss_and_grads = real
        if heap is not None:
            heap.close()


def jobs(rank: int, world: int, jobs: list) -> list:
    """Each job in turn (``kind`` "step" or "trainer"), in one start-up
    of the ranks; each job's tensors are freed before the next."""
    out = []
    for job in jobs:
        fn = step_rank if job["kind"] == "step" else trainer_rank
        out.append(fn(rank, world, job))
        if job.get("device", "cuda") != "cpu":
            torch.cuda.empty_cache()
    return out


def stream_batches(vocab: int, batch: int, seq: int, seed: int,
                   steps: int) -> list:
    """The ``TokenStream`` batches of steps 0 .. steps - 1 (numpy)."""
    from ..data.pipeline import TokenStream
    s = TokenStream(vocab, batch, seq, seed=seed)
    return [s.batch_at(i) for i in range(steps)]

