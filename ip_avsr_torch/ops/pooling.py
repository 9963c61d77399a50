"""Pooling ops.

Mirrors ip_avsr_tpu/ops/pooling.py: ``masked_mean_pool`` is the mean over
the valid timesteps of a (B, T, D) sequence given its (B, T) mask (the
reference's MeanPoolLayer); an all-pad row pools to zeros.
"""

from __future__ import annotations

import torch


def masked_mean_pool(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T, D), (B, T) -> (B, D): the sum of valid frames over their
    count (at least 1)."""
    m = mask.to(x.dtype)[..., None]
    total = torch.sum(x * m, dim=1)
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return total / count
