"""Majority voting over per-timestep predictions.

Mirrors ip_avsr_tpu/ops/voting.py:

* ``majority_voting_layer``: per-frame argmax, per-class vote counts over
  every frame (no mask, as the reference layer counts), softmax over the
  counts, on tensors;
* ``majority_voting_layer_masked``: per-frame argmax (ties go to the lower
  class), per-class vote counts over VALID frames only, softmax over the
  counts, on tensors;
* ``masked_majority_vote``: the evaluation rule of the reference runners,
  the argmax of those counts, on the host in numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def majority_voting_layer(probs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, T, C) -> (B, C) softmax of per-class argmax counts over every
    frame; ties go to the lower class, as ``jnp.argmax`` breaks them."""
    preds = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(preds, num_classes).to(probs.dtype)
    return torch.softmax(torch.sum(onehot, dim=1), dim=-1)


def majority_voting_layer_masked(probs: torch.Tensor, mask: torch.Tensor,
                                 num_classes: int) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C) softmax of masked argmax counts."""
    preds = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(preds, num_classes).to(probs.dtype)
    votes = torch.sum(onehot * mask[..., None].to(probs.dtype), dim=1)
    return torch.softmax(votes, dim=-1)


def masked_majority_vote(probs, mask) -> np.ndarray:
    """Per-sequence majority vote over valid frames (host-side evaluation).

    probs (B, T, C), mask (B, T), numpy: each valid frame's argmax casts a
    vote, ties break toward the lower class id."""
    probs = np.asarray(probs)
    mask = np.asarray(mask).astype(bool)
    preds = np.argmax(probs, axis=-1)
    B, T = preds.shape
    C = probs.shape[-1]
    votes = np.zeros((B, C), dtype=np.int64)
    rows = np.repeat(np.arange(B), T).reshape(B, T)
    np.add.at(votes, (rows[mask], preds[mask]), 1)
    return np.argmax(votes, axis=-1)
