"""AdamW with fp32 moments.

Port of the reference's ``train/optimizer.py``, op for op in fp32: the
linear warmup, the global-norm clip from the pre-clip norm, the bias
corrections ``1 - b ** step`` computed in fp32 (as JAX's weak-typed
``b1 ** step`` is), decoupled weight decay, and the new parameter cast to
its dtype.  The host computes the step's scalars (lr and the bias
corrections) in numpy float32; the norm and the clip scale stay on the
device.

Unlike the reference, which returns new trees, the update is in place
(under ``torch.no_grad()``): m and v are updated where they lie and each
parameter is overwritten, and a leaf stacked over the pattern units is
processed one unit's slice at a time, so no fp32 temporary is larger than
one unit's slice of a leaf (the full model's largest leaf, starcoder2-3b's
stacked MLP ``wi``, is 1.13 G elements: 4.5 GB a temporary in fp32).
``opt["step"]`` is a Python int.

On a mesh the leaves are this rank's blocks (``distributed/sharding.py``
``opt_state_specs``: the moments follow their parameters) and the update,
elementwise, runs on them unchanged; only the global norm needs the mesh
(``norm_sq_local``, summed over it by the caller).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.mesh import axis_index, axis_names
from ..distributed.specs import entry_axes
from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def init_opt_state(params) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": 0}


def _schedule(cfg: AdamWConfig, step: int) -> np.float32:
    warm = np.minimum(np.float32(step) / np.float32(max(cfg.warmup_steps,
                                                        1)),
                      np.float32(1.0))
    return np.float32(cfg.lr) * warm


def _global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's fp32 sum of squares."""
    total = None
    for _, g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def owns_replica(spec, mesh) -> bool:
    """Whether this rank adds a leaf's block to a sum over the mesh: a
    block replicated over some axes is added by the rank at coordinate 0
    of each of them, so that every element counts once."""
    used = {a for entry in spec for a in entry_axes(entry)}
    return all(axis_index(mesh, a) == 0 for a in axis_names(mesh)
               if a not in used)


def norm_sq_local(grads, specs, mesh) -> torch.Tensor:
    """This rank's part of the squared global norm of the gradient blocks
    ``grads`` (their ``specs`` on ``mesh``): each leaf's fp32 sum of
    squares where ``owns_replica``.  The sum over the whole mesh is the
    squared norm of the whole gradient."""
    total = None
    for (_, g), (_, spec) in zip(tree_leaves(grads), tree_leaves(specs)):
        sq = torch.sum(torch.square(g.float()))
        if not owns_replica(spec, mesh):
            sq = torch.zeros_like(sq)
        total = sq if total is None else total + sq
    return total


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, c1, c2) -> None:
    """One slice of the reference's ``upd``, m, v and p in place."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
    delta = (m / c1).div_((v / c2).sqrt_().add_(cfg.eps))
    pf = p.float()
    delta.add_(pf * cfg.weight_decay)
    p.copy_(pf - delta * lr)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, opt, grads, gnorm=None):
    """Returns (params, opt, gnorm): the same trees, updated in place, and
    the pre-clip global norm (a 0-d fp32 tensor on the device; given, on
    a mesh, where the caller summed it over the ranks)."""
    step = opt["step"] + 1
    lr = _schedule(cfg, step)
    c1 = np.float32(1.0) - np.power(np.float32(cfg.b1), np.float32(step))
    c2 = np.float32(1.0) - np.power(np.float32(cfg.b2), np.float32(step))
    if gnorm is None:
        gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(opt["m"]), tree_leaves(opt["v"]))
    for (path, p), (_, g), (_, m), (_, v) in leaves:
        slices = zip(p, g, m, v) if path[0] == "units" else [(p, g, m, v)]
        for ps, gs, ms, vs in slices:
            _update(cfg, ps, gs, ms, vs, scale, lr, c1, c2)
    opt["step"] = step
    return params, opt, gnorm
