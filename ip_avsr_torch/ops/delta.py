"""The DeltaLayer: delta and acceleration coefficients on the time axis.

Mirrors ip_avsr_tpu/ops/delta.py:

    delta[t] = sum_{theta=1..W} (y[t+theta] - y[t-theta]) / (2*theta)

over a sequence edge-padded by W frames on each side (first/last frame
repeated); the acceleration is the same filter applied to the delta, with its
own edge padding; the output is [x, delta, accel] on the feature axis.

:func:`append_delta_coeff` is the plain version.  :func:`delta_layer` is what
the model calls: it goes through the kernel wrapper
(``ops/kernels/delta.append_delta``), which runs the CUDA kernel for a CUDA
tensor and this plain version for a CPU tensor.  Its gradient is the FIR's
fixed transpose (ip_avsr_tpu/ops/pallas/delta_kernel.py::_append_delta_bwd),
which the JAX package leaves to XLA outside any kernel: here it is the
explicit (T, T) edge-clamped FIR matrix of :func:`fir_matrix`, applied on the
time axis by ``torch.matmul``.
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


def fir_matrix(T: int, window: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """The (T, T) matrix F with ``delta_coeff(x, window) == F @ x`` on the
    time axis: row t holds +1/(2*theta) at column min(t + theta, T - 1) and
    -1/(2*theta) at max(t - theta, 0), summed over theta = 1..window (the
    edge repeat clamps the column).  All zeros for ``window <= 0``."""
    F = torch.zeros((T, T), dtype=dtype, device=device)
    if window <= 0:
        return F
    t = torch.arange(T, device=device)[:, None]
    theta = torch.arange(1, window + 1, device=device)[None, :]
    coeff = (0.5 / theta.to(dtype)).expand(T, window)
    F.scatter_add_(1, torch.clamp(t + theta, max=T - 1), coeff)
    F.scatter_add_(1, torch.clamp(t - theta, min=0), -coeff)
    return F


class _DeltaLayer(torch.autograd.Function):
    """[x, delta, accel] through the kernel wrapper, with the FIR's transpose
    as its backward: out = [x, F x, F F x], so dx = g_x + F^T (g_d + F^T g_a)."""

    @staticmethod
    def forward(ctx, x, window):
        from ip_avsr_torch.ops.kernels import delta as delta_kernel

        ctx.window = window
        return delta_kernel.append_delta(x, window)

    @staticmethod
    def backward(ctx, g):
        D = g.shape[-1] // 3
        g_x, g_d, g_a = g[..., :D], g[..., D: 2 * D], g[..., 2 * D:]
        Ft = fir_matrix(g.shape[-2], ctx.window, g.device, g.dtype).T
        return g_x + torch.matmul(Ft, g_d + torch.matmul(Ft, g_a)), None


def delta_layer(x: torch.Tensor, window: int) -> torch.Tensor:
    """DeltaLayer forward (B, T, D) -> (B, T, 3D) through the kernel wrapper,
    differentiable."""
    return _DeltaLayer.apply(x, int(window))
