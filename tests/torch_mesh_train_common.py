"""Shared by the mesh train tests: the reference's one-device jitted train
step and the port's sharded one on gloo ranks, fed the same numpy
weights and batches, and the bounds of ``tests/test_torch_train.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.models import transformer as JT
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.optimizer import init_opt_state as j_init_opt
from repro.train.step import make_train_step as j_make_step
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.launch.mesh_train import jobs
from repro_torch.launch.ranks import run_ranks
from repro_torch.tree import tree_leaves

WARMUP = 2
STEPS = 3
LR_SUM = sum(min(s / WARMUP, 1.0) * 3e-4 for s in range(1, STEPS + 1))


def setup(arch, B=4, S=32, seed=1, **over):
    """fp32 configs of both packages, the reference's init as numpy (QKV
    biases made non-zero, so the sliced biases matter in the forward) and
    a numpy batch."""
    jcfg = dataclasses.replace(j_smoke(arch), dtype=jnp.float32, **over)
    tcfg = dataclasses.replace(t_smoke(arch), dtype=torch.float32, **over)
    jp = jax.tree.map(np.asarray, JT.init_params(jcfg,
                                                 jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    for unit in jp["units"].values():
        for b in ("bq", "bk", "bv"):
            if "attn" in unit and b in unit["attn"]:
                a = unit["attn"][b]
                unit["attn"][b] = (0.5 * rng.standard_normal(a.shape)
                                   ).astype(a.dtype)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    nb = {"tokens": toks, "labels": toks}
    if jcfg.frontend:
        nb = {"embeds": rng.standard_normal((B, S, jcfg.d_model)).astype(
            np.float32), "labels": toks}
    return jcfg, tcfg, jp, nb


def reference(jcfg, jp, nb, *, steps=STEPS, microbatches=1,
              compressor=None, jit=True):
    """The reference's first gradients (jitted), each step's (loss, grad
    norm) and the parameters after ``steps`` steps, all as numpy."""
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    params = jax.tree.map(jnp.asarray, jp)
    grads = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jcfg, p, b)[0]))(
        params, jb)
    step = j_make_step(jcfg, JAdamW(warmup_steps=WARMUP),
                       microbatches=microbatches, compressor=compressor)
    step = jax.jit(step) if jit else step
    opt, metrics = j_init_opt(params), []
    for _ in range(steps):
        params, opt, m = step(params, opt, jb)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return (jax.tree.map(lambda a: np.asarray(a, np.float32), grads),
            metrics, jax.tree.map(lambda a: np.asarray(a, np.float32),
                                  params))


def port(tcfg, jp, nb, mesh, *, steps=STEPS, timeout=900.0, **job):
    """The port's sharded step on ``prod(mesh)`` CPU ranks: rank 0's
    result (first gradients, metrics, final parameters, gathered).  The
    ranks' start-up fails after ``timeout`` seconds."""
    world = int(np.prod(mesh))
    res = run_ranks(jobs, world, [dict({
        "kind": "step", "cfg": tcfg, "mesh": (mesh, ("data", "model")),
        "device": "cpu", "params": jp, "batches": [nb] * steps,
        "opt": {"warmup_steps": WARMUP}, "grads": True}, **job)],
        device="cpu", timeout=timeout)
    return res[0][0]


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def check_against_reference(ref, got, loose=None):
    """``tests/test_torch_train.py``'s fp32 bounds: the first step's loss
    (1e-5 relative) and grad norm (1e-4 relative), every gradient leaf
    within 1e-4 of its leaf's max, every step's metrics likewise, and the
    parameters after the last step within 1e-5 -- or 2 x the summed
    learning rates where the reference's first gradient is below 1e-6 of
    its leaf's max (rounding noise, which AdamW's normalised step turns
    into +-lr), or where ``loose(path)`` marks an element."""
    grads, metrics, params = ref
    for path, want in tree_leaves(grads):
        g = get(got["grads"], path)
        assert g.shape == want.shape, path
        err = np.abs(g - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (path, err)
    for (lj, gj), (lt, gt) in zip(metrics, got["metrics"]):
        assert abs(lt - lj) <= 1e-5 * abs(lj), (lt, lj)
        assert abs(gt - gj) <= 1e-4 * abs(gj), (gt, gj)
    for path, want in tree_leaves(params):
        d = np.abs(get(got["params"], path) - want)
        g = np.abs(get(grads, path))
        noise = g < 1e-6 * g.max()
        if loose is not None:
            noise |= loose(path)
        assert (d[~noise] <= 1e-5).all(), (path, d[~noise].max())
        assert (d <= 2 * LR_SUM).all(), path
