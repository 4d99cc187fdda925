"""train_step: loss + grads + AdamW update, with optional microbatching
(gradient accumulation) and a gradient-compression hook.

Port of the reference's ``train/step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves (a leaf the loss does
not reach gets zeros, as ``jax.grad`` gives).  With ``microbatches`` the
batch is split along its first axis and the microbatches' grads are summed
in fp32 and divided by their count, as the reference's ``scan`` does.
There is no ``mesh`` argument: the step runs on the parameters' device
(multi-device is ROADMAP A8).  The update is in place
(``optimizer.apply_updates``).
"""

from __future__ import annotations

import torch

from ..models import transformer as T
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_unflatten
from .optimizer import AdamWConfig, apply_updates


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, grads): the loss a 0-d fp32 tensor, grads a tree like
    ``params`` in the parameters' dtypes."""
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = T.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, compressor=None):
    """Returns train_step(params, opt, batch) -> (params', opt', metrics),
    metrics {"loss", "grad_norm"} as 0-d fp32 tensors."""

    def train_step(params, opt, batch):
        if microbatches > 1:
            acc, lsum = None, None
            for i in range(microbatches):
                sl = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                                   *x.shape[1:])[i]
                      for k, x in batch.items()}
                lval, grads = loss_and_grads(cfg, params, sl)
                flat = [g.float() for _, g in tree_leaves(grads)]
                del grads
                if acc is None:
                    acc, lsum = flat, lval
                else:
                    acc = [a + g for a, g in zip(acc, flat)]
                    lsum = lsum + lval
            grads = tree_unflatten(params, [a / microbatches for a in acc])
            lval = lsum / microbatches
        else:
            lval, grads = loss_and_grads(cfg, params, batch)
        if compressor is not None:
            grads = compressor(grads)
        params, opt, gnorm = apply_updates(opt_cfg, params, opt, grads)
        return params, opt, {"loss": lval, "grad_norm": gnorm}

    return train_step
