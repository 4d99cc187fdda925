"""train_step: loss + grads + AdamW update, with optional microbatching
(gradient accumulation) and a gradient-compression hook.

Port of the reference's ``train/step.py``.  Gradients come from
``torch.autograd.grad`` over the parameter leaves (a leaf the loss does
not reach gets zeros, as ``jax.grad`` gives).  With ``microbatches`` the
batch is split along its first axis and the microbatches' grads are summed
in fp32 and divided by their count, as the reference's ``scan`` does.
The update is in place (``optimizer.apply_updates``).

With ``mesh`` (a ``DeviceMesh`` of the training layout) the step is one
rank's side of the reference's pjit step: ``params`` and the moments are
this rank's blocks (``distributed/sharding.py`` ``train_param_specs``),
``batch`` its shard over the data axes, and microbatches split that
shard.  ``mesh_loss_and_grads`` runs the sharded loss
(``models/transformer.py``) and its backward, whose collectives leave
every gradient block summed over the batch shards.  Then one all-reduce
over the whole mesh carries the squared global norm (each element counted
once, ``optimizer.norm_sq_local``), the loss (from the ranks at model
coordinate 0) and a failure flag: a rank whose gradient phase raised
joins it with its flag set, and every rank then raises before any
update is applied, so that the trainer restores all of them together.
(A rank that raises between two collectives of the gradient phase leaves
the others waiting in the next one; the flag covers failures after the
phase's last collective.)  A mesh of one rank, or none, takes the
one-device step.
"""

from __future__ import annotations

import torch

from ..distributed.collectives import model_index, psum_all
from ..distributed.sharding import model_train_specs
from ..models import transformer as T
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_unflatten
from .optimizer import AdamWConfig, apply_updates, norm_sq_local


def loss_and_grads(cfg: ModelConfig, params, batch, *, mesh=None,
                   specs=None):
    """(loss, grads): the loss a 0-d fp32 tensor, grads a tree like
    ``params`` in the parameters' dtypes.  With ``mesh``: this rank's
    share of the loss and its gradient blocks, summed over the batch
    shards (``mesh_loss_and_grads``)."""
    leaves = [t for _, t in tree_leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = T.loss_fn(cfg, params, batch, mesh=mesh, specs=specs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def mesh_loss_and_grads(cfg: ModelConfig, params, batch, mesh, specs):
    """The gradient phase of the sharded step: this rank's share of the
    loss and its gradient blocks."""
    return loss_and_grads(cfg, params, batch, mesh=mesh, specs=specs)


def _accumulate(grads_fn, params, batch, microbatches: int):
    """(loss, grads) over ``microbatches`` slices of ``batch``'s first
    axis: the grads summed in fp32 and divided by their count, the loss
    averaged."""
    acc, lsum = None, None
    for i in range(microbatches):
        sl = {k: x.reshape(microbatches, x.shape[0] // microbatches,
                           *x.shape[1:])[i]
              for k, x in batch.items()}
        lval, grads = grads_fn(params, sl)
        flat = [g.float() for _, g in tree_leaves(grads)]
        del grads
        if acc is None:
            acc, lsum = flat, lval
        else:
            acc = [a + g for a, g in zip(acc, flat)]
            lsum = lsum + lval
    return lsum / microbatches, tree_unflatten(params,
                                               [a / microbatches
                                                for a in acc])


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    microbatches: int = 1, compressor=None, mesh=None):
    """Returns train_step(params, opt, batch) -> (params', opt', metrics),
    metrics {"loss", "grad_norm"} as 0-d fp32 tensors (on a mesh, the
    global loss and norm on every rank)."""
    if mesh is not None and mesh.size() > 1:
        return _make_mesh_step(cfg, opt_cfg, microbatches, compressor, mesh)

    def grads_fn(params, batch):
        return loss_and_grads(cfg, params, batch)

    def train_step(params, opt, batch):
        if microbatches > 1:
            lval, grads = _accumulate(grads_fn, params, batch, microbatches)
        else:
            lval, grads = grads_fn(params, batch)
        if compressor is not None:
            grads = compressor(grads)
        params, opt, gnorm = apply_updates(opt_cfg, params, opt, grads)
        return params, opt, {"loss": lval, "grad_norm": gnorm}

    return train_step


def _make_mesh_step(cfg, opt_cfg, microbatches, compressor, mesh):
    T.check_mesh(cfg, mesh)
    specs = model_train_specs(cfg, mesh)
    first = model_index(mesh) == 0

    def grads_fn(params, batch):
        return mesh_loss_and_grads(cfg, params, batch, mesh, specs)

    def train_step(params, opt, batch):
        err = None
        try:
            if microbatches > 1:
                lval, grads = _accumulate(grads_fn, params, batch,
                                          microbatches)
            else:
                lval, grads = grads_fn(params, batch)
        except Exception as e:            # agreed on below, with the others
            err = e
            leaves = [t for _, t in tree_leaves(params)]
            lval = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            grads = tree_unflatten(params, [torch.zeros_like(t.detach())
                                            for t in leaves])
        if compressor is not None:
            grads = compressor(grads)
        sq = norm_sq_local(grads, specs, mesh)
        tot = psum_all(torch.stack([
            sq, lval.float() if first else torch.zeros_like(sq),
            torch.full_like(sq, float(err is not None))]), mesh)
        failed = int(tot[2])
        if failed:
            raise RuntimeError(f"train step failed on {failed} rank(s) of "
                               f"the mesh; no update applied") from err
        params, opt, gnorm = apply_updates(opt_cfg, params, opt, grads,
                                           gnorm=torch.sqrt(tot[0]))
        return params, opt, {"loss": tot[1], "grad_norm": gnorm}

    return train_step
