"""The DeltaLayer: delta and acceleration coefficients on the time axis.

Mirrors ip_avsr_tpu/ops/delta.py:

    delta[t] = sum_{theta=1..W} (y[t+theta] - y[t-theta]) / (2*theta)

over a sequence edge-padded by W frames on each side (first/last frame
repeated); the acceleration is the same filter applied to the delta, with its
own edge padding; the output is [x, delta, accel] on the feature axis.

:func:`append_delta_coeff` is the plain version.  :func:`delta_layer` is what
the model calls: it goes through the kernel wrapper
(``ops/kernels/delta.append_delta``), which runs the CUDA kernel for a CUDA
tensor and this plain version for a CPU tensor.
"""

from __future__ import annotations

import torch


def _edge_pad_time(x: torch.Tensor, window: int) -> torch.Tensor:
    """Repeat the first/last frame ``window`` times along the time axis (-2)."""
    first = x[..., :1, :].expand(*x.shape[:-2], window, x.shape[-1])
    last = x[..., -1:, :].expand(*x.shape[:-2], window, x.shape[-1])
    return torch.cat([first, x, last], dim=-2)


def delta_coeff(x: torch.Tensor, window: int) -> torch.Tensor:
    """Single-order normalised delta along axis -2 of ``x`` (..., T, D)."""
    if window <= 0:
        return torch.zeros_like(x)
    padded = _edge_pad_time(x, window)
    T = x.shape[-2]
    out = torch.zeros_like(x)
    for theta in range(1, window + 1):
        fwd = padded[..., window + theta: window + theta + T, :]
        bwd = padded[..., window - theta: window - theta + T, :]
        out = out + (1.0 / (2.0 * theta)) * (fwd - bwd)
    return out


def append_delta_coeff(x: torch.Tensor, window: int) -> torch.Tensor:
    """[x, delta, accel] on the feature axis: (..., T, D) -> (..., T, 3D)."""
    d = delta_coeff(x, window)
    a = delta_coeff(d, window)
    return torch.cat([x, d, a], dim=-1)


def delta_layer(x: torch.Tensor, window: int) -> torch.Tensor:
    """DeltaLayer forward (B, T, D) -> (B, T, 3D) through the kernel wrapper."""
    from ip_avsr_torch.ops.kernels import delta as delta_kernel

    return delta_kernel.append_delta(x, window)
