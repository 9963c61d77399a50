"""LeCun local contrast normalization (LCN) through a Gaussian convolution.

Mirrors ip_avsr_tpu/ops/lcn.py: subtract a Gaussian-weighted local mean,
then divide by the local standard deviation floored at its per-image mean
and at ``threshold``.  ``gaussian_filter`` is a numpy copy of the JAX
package's; the two convolutions are ``F.conv2d`` on the input's device with
``kernel_shape // 2`` zero padding on each side.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_filter(kernel_shape: int, sigma: float = None) -> np.ndarray:
    """2D Gaussian kernel normalized to sum 1, float32."""
    sigma = sigma if sigma is not None else kernel_shape / 4.0
    mid = kernel_shape // 2
    ys, xs = np.mgrid[0:kernel_shape, 0:kernel_shape]
    g = np.exp(-((xs - mid) ** 2 + (ys - mid) ** 2) / (2.0 * sigma ** 2))
    g /= (2 * np.pi * sigma ** 2)
    return (g / g.sum()).astype(np.float32)


def lecun_lcn(x: torch.Tensor, kernel_shape: int = 9, threshold: float = 1e-4) -> torch.Tensor:
    """Local contrast normalization of (B, 1, H, W) images."""
    g = torch.as_tensor(gaussian_filter(kernel_shape), device=x.device,
                        dtype=x.dtype)[None, None]
    pad = kernel_shape // 2
    local_mean = F.conv2d(x, g, padding=pad)
    centered = x - local_mean
    local_var = F.conv2d(centered ** 2, g, padding=pad)
    local_std = torch.sqrt(torch.clamp(local_var, min=0.0))
    per_img_mean = torch.mean(local_std, dim=(2, 3), keepdim=True)
    divisor = torch.clamp(torch.maximum(local_std, per_img_mean), min=threshold)
    return centered / divisor


def make_lecun_lcn(kernel_shape: int = 9, threshold: float = 1e-4):
    """An LCN callable with its kernel size and threshold bound."""
    return functools.partial(lecun_lcn, kernel_shape=kernel_shape, threshold=threshold)
