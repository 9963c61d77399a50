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
``correction=0``.  With ``axis_name`` (a mesh dim or a tuple of them) the
training statistics are synced over the ranks of those dims, in two passes
as the JAX package's: the counts and sums first, for the mean, then the
squared deviations from it (a one-pass E[x^2] - mean^2 cancels in float32
when |mean| >> std).  The sums go through ``parallel.collectives.
all_reduce_sum``, whose backward sums the cotangents over the ranks, so
gradients cross the shard boundaries.
"""

from __future__ import annotations

import torch

from ip_avsr_torch.parallel import collectives
from ip_avsr_torch.parallel import mesh as mesh_lib


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
                       eps: float = 1e-4, alpha: float = 0.01, axis_name=None, mesh=None):
    """Batch norm over the last axis -> ``(y, new_state)``.

    Training normalizes with the batch's statistics over every row and
    returns the running averages moved by ``alpha`` towards them (detached:
    they are state, not parameters); evaluation normalizes with the running
    averages and returns ``state`` as it is.  ``axis_name`` syncs the
    training statistics over the ranks of those dims of ``mesh`` (default:
    the 1-D ``data`` mesh of the process group), so every rank normalizes
    with the whole batch's moments; on the one-process mesh the sums are
    the local ones."""
    flat = x.reshape(-1, x.shape[-1])
    if train and axis_name is not None:
        group = mesh_lib.axis_group(axis_name, mesh)
        sums = collectives.all_reduce_sum(
            torch.cat([flat.sum(dim=0), flat.new_full((1,), flat.shape[0])]), group)
        count = sums[-1].detach()
        mean = sums[:-1] / count
        # the variance's gradient through the mean is -2/N sum(d) = 0
        # exactly; leaving that path out keeps float32 from summing terms
        # that cancel (the unsynced var's backward omits it too)
        d = flat - mean.detach()
        var = collectives.all_reduce_sum((d * d).sum(dim=0), group) / count
    elif train:
        mean = flat.mean(dim=0)
        var = flat.var(dim=0, correction=0)
    if train:
        new_state = {"mean": ((1 - alpha) * state["mean"] + alpha * mean).detach(),
                     "var": ((1 - alpha) * state["var"] + alpha * var).detach()}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (flat - mean) / torch.sqrt(var + eps) * params["gamma"] + params["beta"]
    return y.reshape(x.shape), new_state
