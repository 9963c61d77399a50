"""On-device input pipeline: raw mouth-ROI batches -> model-ready streams.

Mirrors ip_avsr_tpu/ops/pipeline.py: a raw (B, T, D) ROI batch fans out to
(raw_norm, dct, diff_norm) on the device that holds it.
"""

from __future__ import annotations

import torch

from ip_avsr_torch.ops.dct import compute_dct_features_device


def samplewise_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-frame zero-mean / unit-std over the feature axis.

    The std is the population std (``correction=0``, as ``jnp.std``), and
    ``eps`` is added to the std so all-zero pad frames give 0, not NaN."""
    centered = x - torch.mean(x, dim=-1, keepdim=True)
    std = torch.std(centered, dim=-1, keepdim=True, correction=0)
    return centered / (std + eps)


def diff_images(x: torch.Tensor) -> torch.Tensor:
    """Temporal difference along axis -2, the first difference duplicated at
    t = 0."""
    d = x[..., 1:, :] - x[..., :-1, :]
    return torch.cat([d[..., :1, :], d], dim=-2)


def sequencewise_mean_subtract(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Subtract each sequence's masked mean frame from its valid frames; pad
    frames become 0."""
    m = mask.to(x.dtype)[..., None]
    total = torch.sum(x * m, dim=-2, keepdim=True)
    count = torch.clamp_min(torch.sum(m, dim=-2, keepdim=True), 1.0)
    return (x - total / count) * m


def featurewise_normalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Apply precomputed train-split feature statistics."""
    return (x - mean) / std


def trimodal_streams(raw: torch.Tensor, mask: torch.Tensor, image_shape,
                     dct_coeffs: int = 90, dct_mean=None, dct_std=None,
                     dct_basis=None) -> tuple:
    """Raw (B, T, D) float ROI batch -> (raw_norm, dct, diff_norm).

    ``dct_basis`` is the (D, dct_coeffs) basis to use (a module's buffer,
    which ``torch.export`` records as state), else the cached one."""
    B, T, D = raw.shape
    m = mask.to(raw.dtype)[..., None]
    diff = diff_images(raw)
    dct = compute_dct_features_device(raw.reshape(B * T, D), image_shape, dct_coeffs,
                                      basis=dct_basis).reshape(B, T, dct_coeffs)
    dct = sequencewise_mean_subtract(dct, mask)
    if dct_mean is not None:
        dct = featurewise_normalize(dct, dct_mean, dct_std) * m
    # zero every masked position BEFORE normalising: the first pad frame's
    # diff is -raw[T_valid - 1], which would otherwise be rescaled to unit std
    return (samplewise_normalize(raw * m) * m, dct,
            samplewise_normalize(diff * m) * m)
