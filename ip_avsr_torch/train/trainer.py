"""The training step of an AdeNet.

Mirrors ``bench._make_train_step`` and the step of
ip_avsr_tpu/train/trainer.py::Trainer._build_steps without batch norm and
without gradient accumulation: the model's loss on a batch (per-step heads
through ``temporal_softmax_loss``, last-step heads through
``categorical_crossentropy_masked`` with all-pad rows weighted 0), its
gradients, and one Adam update.  The rest of the Trainer is not ported yet
(ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import torch

from ip_avsr_torch.device import tree_map
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops import losses
from ip_avsr_torch.train import optimizers as opt_lib


def loss_fn(params, cfg, streams, y, mask, generator=None) -> torch.Tensor:
    """The training loss (dropout on) of ``params`` on one batch: streams[i]
    (B, T, D_i), y (B,) int labels, mask (B, T)."""
    out = adenet.adenet_forward(params, cfg, streams, mask, train=True,
                                generator=generator)
    if out.dim() == 3:
        y2d = y[:, None].expand(-1, mask.shape[1])
        return losses.temporal_softmax_loss(out, y2d, mask)
    seq_weight = mask.sum(dim=1) > 0
    return losses.categorical_crossentropy_masked(out, y, seq_weight)


def loss_and_grads(params, cfg, streams, y, mask, generator=None):
    """``(loss, grads)``: the loss of :func:`loss_fn` and its gradient with
    respect to every leaf of ``params``, as a tree of the same structure (a
    leaf the loss does not reach gets zeros, as ``jax.grad`` gives)."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    tracked = tree_map(track, params)
    loss = loss_fn(tracked, cfg, streams, y, mask, generator)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad_of(p):
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return loss.detach(), tree_map(grad_of, params)


def make_train_step(cfg, lr=1e-4):
    """Returns ``(optimizer, train_step)`` with ``train_step(params,
    opt_state, streams, y, mask, generator) -> (params, opt_state, loss)``,
    one step of loss, gradients and Adam update."""
    optimizer = opt_lib.adam(lr)

    def train_step(params, opt_state, streams, y, mask, generator=None):
        loss, grads = loss_and_grads(params, cfg, streams, y, mask, generator)
        params, opt_state = optimizer.apply(params, grads, opt_state)
        return params, opt_state, loss

    return optimizer, train_step
