"""The DeltaLayer: delta and acceleration coefficients on the time axis.

Mirrors ip_avsr_tpu/ops/delta.py:

    delta[t] = sum_{theta=1..W} (y[t+theta] - y[t-theta]) / (2*theta)

over a sequence edge-padded by W frames on each side (first/last frame
repeated); the acceleration is the same filter applied to the delta, with its
own edge padding; the output is [x, delta, accel] on the feature axis.

:func:`append_delta_coeff` is the plain version; :func:`delta_filter_weights`
gives its taps as a numpy array.  :func:`delta_group` is what
the model calls, once over all its delta streams: it goes through the kernel
wrapper (``ops/kernels/delta.append_delta_group``), which runs one launch of
the CUDA kernel for CUDA tensors and this plain version for CPU tensors;
:func:`delta_layer` is a group of one.  The op is linear on the time axis,
[x, delta, accel] = S x with S the (3T, T) matrix of :func:`delta_matrix`, so
its gradient is the fixed transpose S^T g
(ip_avsr_tpu/ops/pallas/delta_kernel.py::_append_delta_bwd, which the JAX
package leaves to XLA outside any kernel): one ``torch.matmul`` per stream,
with S built once per (T, window, device, dtype) and cached.  Without a
gradient to take, :func:`delta_group` calls the wrapper (the operator
``ip_avsr::delta_group``) outside any autograd Function.
"""

from __future__ import annotations

import numpy as np
import torch


def _edge_pad_time(x: torch.Tensor, window: int) -> torch.Tensor:
    """Repeat the first/last frame ``window`` times along the time axis (-2)."""
    first = x[..., :1, :].expand(*x.shape[:-2], window, x.shape[-1])
    last = x[..., -1:, :].expand(*x.shape[:-2], window, x.shape[-1])
    return torch.cat([first, x, last], dim=-2)


def _tap(theta: int, normalized: bool) -> float:
    """The FIR tap at offset +theta: 1/(2 theta) (``normalized``, the
    DeltaLayer) or theta (the host-side feature deltas); offset -theta
    takes its negative."""
    return (1.0 / (2.0 * theta)) if normalized else float(theta)


def delta_filter_weights(window: int, normalized: bool = True) -> np.ndarray:
    """The float32 FIR taps for offsets -window..window (0 at offset 0)."""
    taps = [0.0] * (2 * window + 1)
    for theta in range(1, window + 1):
        taps[window + theta] = _tap(theta, normalized)
        taps[window - theta] = -_tap(theta, normalized)
    return np.asarray(taps, dtype=np.float32)


def delta_taps_from_padded(padded: torch.Tensor, window: int,
                           normalized: bool = True) -> torch.Tensor:
    """The delta FIR over an already extended (..., T + 2*window, D) tensor
    -> its (..., T, D) centre: taps 1/(2*theta) (``normalized``, the
    DeltaLayer) or theta (the host-side feature deltas).  Shared by
    :func:`delta_coeff` (edge padding) and sequence parallelism (frames
    from the neighbouring ranks, ``parallel/sequence.py``)."""
    T = padded.shape[-2] - 2 * window
    out = torch.zeros(padded.shape[:-2] + (T,) + padded.shape[-1:], dtype=padded.dtype,
                      device=padded.device)
    for theta in range(1, window + 1):
        coeff = _tap(theta, normalized)
        fwd = padded[..., window + theta: window + theta + T, :]
        bwd = padded[..., window - theta: window - theta + T, :]
        out = out + coeff * (fwd - bwd)
    return out


def delta_coeff(x: torch.Tensor, window: int, normalized: bool = True) -> torch.Tensor:
    """Single-order delta along axis -2 of ``x`` (..., T, D)."""
    if window <= 0:
        return torch.zeros_like(x)
    return delta_taps_from_padded(_edge_pad_time(x, window), window, normalized)


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


# built matrices, by (T, window, device, dtype)
_MATRICES: dict = {}


def delta_matrix(T: int, window: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """The (3T, T) matrix S with ``append_delta_coeff(x, window)`` equal to
    ``torch.matmul(S, x)`` viewed as (..., 3T, D): row 3t + k is row t of I,
    F and F F (F of :func:`fir_matrix`, F F formed in float64, then cast).
    Built once per (T, window, device, dtype) and cached; every build counts
    in ``delta_matrix.builds``.  Callers must not write to it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    key = (int(T), int(window), device, dtype)
    S = _MATRICES.get(key)
    if S is None:
        F = fir_matrix(T, window, dtype=torch.float64)
        S = torch.stack([torch.eye(T, dtype=torch.float64), F, F @ F], dim=1)
        S = S.reshape(3 * T, T).to(device=device, dtype=dtype)
        _MATRICES[key] = S
        delta_matrix.builds += 1
    return S


delta_matrix.builds = 0


class _DeltaGroup(torch.autograd.Function):
    """[x, delta, accel] of every stream of a group through one call of the
    kernel wrapper, with the transpose of the cached S as the backward of
    each stream that needs a gradient: dx = S^T g, g viewed as (B, 3T, D).
    A stream fed straight from the input (no encoder) needs none, and its
    output needs none either."""

    @staticmethod
    def forward(ctx, window, *xs):
        from ip_avsr_torch.ops.kernels import delta as delta_kernel

        ctx.window = window
        outs = tuple(delta_kernel.append_delta_group(xs, window))
        # a stream that needs no gradient gives an output that needs none, so
        # nothing downstream computes a gradient for it, and an output that
        # gets none reaches the backward as None, not as a filled zero tensor
        ctx.mark_non_differentiable(
            *(o for o, needed in zip(outs, ctx.needs_input_grad[1:]) if not needed))
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        grads = []
        for g, needed in zip(gs, ctx.needs_input_grad[1:]):
            if g is None or not needed:
                grads.append(None)
                continue
            B, T, D3 = g.shape
            S = delta_matrix(T, ctx.window, g.device, g.dtype)
            grads.append(torch.matmul(S.T, g.reshape(B, 3 * T, D3 // 3)))
        return (None, *grads)


def delta_group(xs, window: int) -> tuple:
    """DeltaLayer forward of each (B, T, D_i) tensor of ``xs`` (sharing B, T)
    -> (B, T, 3 D_i), one kernel launch for the group on CUDA,
    differentiable.  Where no gradient is wanted the operator is called
    straight, so an exported program holds it and no autograd Function."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return _DeltaGroup.apply(int(window), *xs)
    from ip_avsr_torch.ops.kernels import delta as delta_kernel

    return tuple(delta_kernel.append_delta_group(xs, int(window)))


def delta_layer(x: torch.Tensor, window: int) -> torch.Tensor:
    """DeltaLayer forward (B, T, D) -> (B, T, 3D) through the kernel wrapper,
    differentiable: a group of one."""
    return delta_group([x], window)[0]
