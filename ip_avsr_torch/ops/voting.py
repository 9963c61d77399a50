"""Masked majority vote over per-timestep predictions.

Mirrors ip_avsr_tpu/ops/voting.majority_voting_layer_masked: per-frame
argmax (ties go to the lower class), per-class vote counts over VALID frames
only, softmax over the counts.
"""

from __future__ import annotations

import torch


def majority_voting_layer_masked(probs: torch.Tensor, mask: torch.Tensor,
                                 num_classes: int) -> torch.Tensor:
    """(B, T, C), (B, T) -> (B, C) softmax of masked argmax counts."""
    preds = torch.argmax(probs, dim=-1)
    onehot = torch.nn.functional.one_hot(preds, num_classes).to(probs.dtype)
    votes = torch.sum(onehot * mask[..., None].to(probs.dtype), dim=1)
    return torch.softmax(votes, dim=-1)
