"""Sequence parallelism: the time axis split over a mesh dim; the port of
ip_avsr_tpu/parallel/sequence.py.

* The frame-parallel prefix (encoder, batch norm, delta, dropout) runs on
  this rank's block of the batch: rows split over ``data``, frames over
  ``seq``.  The delta's +-window neighbourhood comes from a halo exchange:
  each rank sends its ``window`` boundary frames to its neighbours on the
  ``seq`` dim (two non-wrapping exchanges, ``collectives.ppermute``) and the
  outermost ranks repeat their edge frame, which is the global edge padding
  exactly.  The acceleration exchanges a fresh halo of the deltas.  The tap
  formula is ``ops/delta.delta_taps_from_padded``, in torch ops, as the JAX
  package runs it in ``jnp`` there (not the delta kernel).
* Batch norm syncs its statistics over both dims (rows and frames are both
  split).
* The recurrence is sequential in time, so the features go from time
  blocks to row blocks with one all-to-all over ``seq``, and the head runs
  data-parallel over all ``data x seq`` ranks through the kernels.

Everything differentiates: the exchanges' backward is the reverse exchange,
the all-to-all's the inverse all-to-all.  The inputs are the global arrays,
every rank holding them as JAX's program does; each rank cuts its block.
Dropout draws each mask for the whole batch and keeps the rank's block
(``models/adenet.Block``), so a sharded training forward equals the
unsharded one bit for bit, where JAX's draws per shard.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops.delta import delta_taps_from_padded
from ip_avsr_torch.parallel import collectives


def halo_exchange_time(x: torch.Tensor, halo: int, axis_name: str, n_shards: int,
                       mesh=None) -> torch.Tensor:
    """This rank's (B, T_local, D) block of a (B, T, D) tensor split on time
    over ``axis_name`` of ``mesh``, extended by ``halo`` frames from each
    neighbour -> (B, T_local + 2*halo, D); the first and last ranks repeat
    their edge frame.  Needs ``T_local >= halo`` (one hop)."""
    if halo <= 0:
        return x
    T_local = x.shape[1]
    if T_local < halo:
        raise ValueError(
            f"sequence-parallel halo needs T_local >= window: {T_local} < {halo} "
            f"(use fewer 'seq' shards or a smaller delta window)")
    group = None if mesh is None else mesh.group(axis_name)
    idx = 0 if mesh is None else mesh.axis_index(axis_name)
    from_left = collectives.ppermute(x[:, -halo:, :], [(i, i + 1) for i in range(n_shards - 1)],
                                     group)
    from_right = collectives.ppermute(x[:, :halo, :], [(i + 1, i) for i in range(n_shards - 1)],
                                      group)
    first = x[:, :1, :].expand(x.shape[0], halo, x.shape[2])
    last = x[:, -1:, :].expand(x.shape[0], halo, x.shape[2])
    # both exchanges stay in the graph on every rank, so that every rank
    # joins their backward
    left = torch.where(torch.full((), idx == 0, device=x.device), first, from_left)
    right = torch.where(torch.full((), idx == n_shards - 1, device=x.device), last, from_right)
    return torch.cat([left, x, right], dim=1)


def append_delta_coeff_sp(x: torch.Tensor, window: int, axis_name: str, n_shards: int,
                          mesh=None) -> torch.Tensor:
    """[x, delta, accel] of a time-split block, each order from a fresh halo:
    this rank's block of ``ops/delta.append_delta_coeff`` of the whole."""
    d = delta_taps_from_padded(halo_exchange_time(x, window, axis_name, n_shards, mesh), window)
    a = delta_taps_from_padded(halo_exchange_time(d, window, axis_name, n_shards, mesh), window)
    return torch.cat([x, d, a], dim=-1)


def _check(config, B: int, T: int, n_data: int, n_seq: int, window: int):
    if T % n_seq != 0:
        raise ValueError(f"T={T} not divisible by seq axis {n_seq}")
    # only a delta stream exchanges a halo
    if any(s.use_delta for s in config.streams) and (T // n_seq) < window:
        raise ValueError(f"T_local={T // n_seq} < window={window}")
    if B % (n_data * n_seq) != 0:
        raise ValueError(f"B={B} not divisible by data*seq={n_data * n_seq}")


def forward_rows(params: dict, config: adenet.AdeNetConfig, inputs: Sequence[torch.Tensor],
                 mask: torch.Tensor, mesh, *, data_axis: str = "data", seq_axis: str = "seq",
                 train: bool = False, generator=None, window=None):
    """The sequence-parallel forward on this rank -> ``(out, rows, aux)``:
    the head's output for the global batch rows ``rows`` (this rank's
    chunk of the ``data x seq`` row split) and the batch-norm aux."""
    n_seq, n_data = mesh.shape[seq_axis], mesh.shape[data_axis]
    B, T = inputs[0].shape[0], inputs[0].shape[1]
    window = config.window if window is None else int(window)
    _check(config, B, T, n_data, n_seq, window)
    if train and generator is None:
        generator = torch.Generator(device=inputs[0].device).manual_seed(0)
    di, si = mesh.axis_index(data_axis), mesh.axis_index(seq_axis)
    Bd, Ts = B // n_data, T // n_seq
    rows, frames = slice(di * Bd, (di + 1) * Bd), slice(si * Ts, (si + 1) * Ts)
    feats, aux = adenet.stream_prefix(
        params, config, [x[rows, frames] for x in inputs], window, train, generator,
        return_aux=True, bn_axis=(data_axis, seq_axis), mesh=mesh,
        delta_fn=lambda x: append_delta_coeff_sp(x, window, seq_axis, n_seq, mesh),
        block=adenet.Block(B, rows, T, frames))
    # time blocks -> row blocks: one all-to-all over the seq ranks
    seq_group = mesh.group(seq_axis)
    feats = [collectives.all_to_all(f, 0, 1, seq_group) for f in feats]
    Bh = Bd // n_seq
    head = slice(di * Bd + si * Bh, di * Bd + (si + 1) * Bh)
    out = adenet.head_forward(params, config, feats, mask[head], train, generator,
                              block=adenet.Block(B, head))
    return out, head, aux


def adenet_forward_sp(params: dict, config: adenet.AdeNetConfig,
                      inputs: Sequence[torch.Tensor], mask: torch.Tensor, mesh, *,
                      data_axis: str = "data", seq_axis: str = "seq", train: bool = False,
                      generator=None, window=None, return_aux: bool = False):
    """``adenet_forward`` with a sequence-parallel prefix: the global
    (B, T) inputs in, the whole batch's output out on every rank (the
    ranks' row chunks all-gathered; its backward keeps each rank's chunk,
    so the sum over the ranks of their gradients is the gradient).  Equals
    ``adenet_forward``; under training its dropout masks too.  Checked: T
    divisible by the seq dim, T_local >= window where a delta stream
    exchanges a halo, B divisible by data*seq."""
    out, _, aux = forward_rows(params, config, inputs, mask, mesh, data_axis=data_axis,
                               seq_axis=seq_axis, train=train, generator=generator,
                               window=window)
    out = collectives.all_gather(out, 0, mesh.group((data_axis, seq_axis)))
    return (out, aux) if return_aux else out
