"""Objectives of the training step.

Mirrors ip_avsr_tpu/ops/losses.py:

* ``temporal_softmax_loss``: masked per-step cross entropy of a per-step
  head.  The reference feeds it the network's softmax *probabilities* and
  applies a second (max-subtracted) softmax inside; that double softmax is
  kept, because training dynamics depend on it.
* ``categorical_crossentropy``: the mean -log p[y] of a last-step head
  (Lasagne's ``categorical_crossentropy`` on a softmax layer);
* ``categorical_crossentropy_masked``: the weighted mean -log p[y] of a
  last-step head, with batch-pad rows weighted 0.
* ``squared_error`` and ``l2_regularization``: the autoencoders'
  reconstruction objective and its weight penalty (pretraining).
"""

from __future__ import annotations

import torch

from ip_avsr_torch.device import tree_map


def temporal_softmax_loss(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                          return_parts: bool = False):
    """x (N, T, V) scores (in practice probabilities), y (N, T) int labels,
    mask (N, T) 1 on valid frames -> the NLL averaged over valid frames.

    ``return_parts=True`` returns ``(weighted_nll_sum, frame_count)`` in
    place of their quotient: gradient accumulation sums the numerators over
    microbatches and divides once by the global count."""
    N, T, V = x.shape
    mask_flat = mask.reshape(N * T).to(x.dtype)
    log_probs = torch.log_softmax(x.reshape(N * T, V), dim=1)
    nll = -log_probs.gather(1, y.reshape(N * T, 1).long())[:, 0]
    num = (mask_flat * nll).sum()
    if return_parts:
        return num, mask_flat.sum()
    return num / mask_flat.sum()


def categorical_crossentropy(probs: torch.Tensor, y: torch.Tensor,
                             eps: float = 0.0) -> torch.Tensor:
    """Mean -log(probs[y]) over the batch, the picked probabilities clipped
    to [eps, 1] when ``eps`` is nonzero."""
    p = probs.gather(1, y[:, None].long())[:, 0]
    if eps:
        p = torch.clamp(p, eps, 1.0)
    return -torch.mean(torch.log(p))


def categorical_crossentropy_masked(probs: torch.Tensor, y: torch.Tensor,
                                    sample_weight: torch.Tensor, return_parts: bool = False):
    """Weighted mean -log(probs[y]) over the batch; ``sample_weight`` zeroes
    batch-pad rows.  Where the weight is 0 the picked probability is clamped
    to 1, so a pad row whose probability underflows to 0 gives no 0 * log 0
    NaN in the loss or its gradient.  ``return_parts`` as in
    :func:`temporal_softmax_loss`: ``(weighted sum, weight sum)``."""
    p = probs.gather(1, y[:, None].long())[:, 0]
    w = sample_weight.to(probs.dtype)
    p = torch.where(w > 0, p, torch.ones_like(p))
    num = -(w * torch.log(p)).sum()
    if return_parts:
        return num, w.sum()
    return num / torch.clamp(w.sum(), min=1.0)


def squared_error(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (Lasagne ``squared_error().mean()``)."""
    return ((pred - target) ** 2).mean()


def l2_regularization(params, scale: float) -> torch.Tensor:
    """``scale`` times the sum of squares of every leaf with ndim >= 2 of a
    nested dict/list parameter tree: weight matrices and kernels are
    penalised, biases are not (Lasagne ``regularize_network_params``)."""
    leaves = []
    tree_map(lambda leaf: leaves.append(leaf) if leaf.ndim >= 2 else None, params)
    return scale * sum((leaf ** 2).sum() for leaf in leaves)
