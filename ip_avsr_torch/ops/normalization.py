"""Normalization layers.

Mirrors ip_avsr_tpu/ops/normalization.py:

* ``znormalize``: a (B, T, D) input normalized by the minibatch's own
  per-feature mean and standard deviation over every leading row;
* batch norm as adenet_v1 uses it after its encoder: statistics over every
  (B*T) row (pad frames included, as in the JAX package), learned
  ``gamma``/``beta``, and running ``mean``/``var`` averaged with ``alpha``
  at each training step and used in evaluation.

``torch.var`` and ``torch.std`` divide by N - 1 unless told otherwise; the
JAX package's ``jnp.var``/``jnp.std`` divide by N, so every call here passes
``correction=0``.  The JAX package can sum training statistics over mesh
axes (``axis_name``); the port runs on one device, so any axis raises.
"""

from __future__ import annotations

import torch

SCALE_OUT = "ROADMAP Queue 1 item 10: scale-out"


def znormalize(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize by the per-feature mean and std (divided by N) of all
    leading rows pooled."""
    flat = x.reshape(-1, x.shape[-1])
    means = flat.mean(dim=0)
    stds = flat.std(dim=0, correction=0)
    return ((flat - means) / (stds + eps)).reshape(x.shape)


def init_batch_norm(dim: int, dtype=torch.float32) -> tuple:
    """``(params, state)``: gamma 1 and beta 0, running mean 0 and var 1."""
    params = {"gamma": torch.ones(dim, dtype=dtype), "beta": torch.zeros(dim, dtype=dtype)}
    state = {"mean": torch.zeros(dim, dtype=dtype), "var": torch.ones(dim, dtype=dtype)}
    return params, state


def batch_norm_forward(params: dict, state: dict, x: torch.Tensor, train: bool,
                       eps: float = 1e-4, alpha: float = 0.01, axis_name=None):
    """Batch norm over the last axis -> ``(y, new_state)``.

    Training normalizes with the batch's statistics over every row and
    returns the running averages moved by ``alpha`` towards them (detached:
    they are state, not parameters); evaluation normalizes with the running
    averages and returns ``state`` as it is."""
    if axis_name is not None:
        raise NotImplementedError(
            f"batch norm statistics over mesh axis {axis_name!r}: the port runs on "
            f"one device; {SCALE_OUT}")
    flat = x.reshape(-1, x.shape[-1])
    if train:
        mean = flat.mean(dim=0)
        var = flat.var(dim=0, correction=0)
        new_state = {"mean": ((1 - alpha) * state["mean"] + alpha * mean).detach(),
                     "var": ((1 - alpha) * state["var"] + alpha * var).detach()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (flat - mean) / torch.sqrt(var + eps) * params["gamma"] + params["beta"]
    return y.reshape(x.shape), new_state
