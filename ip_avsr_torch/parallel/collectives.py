"""The collectives of a mesh, differentiable where the model needs them.

PyTorch's counterparts of ``lax.psum``, ``lax.ppermute``, the all-gather
and the all-to-all that XLA inserts from shardings, as small
``torch.autograd.Function``s over ``torch.distributed``.  The objective
they are built for is the sum over the ranks of each rank's loss (every
trainer here sums its ranks' gradients), so:

* :func:`all_reduce_sum` (psum): the backward sums the cotangents over the
  group, since every rank's loss reads the sum;
* :func:`all_gather` along a dim: the backward is the rank's own slice of
  the cotangent, not a reduce-scatter, because what reads the gathered
  tensor is replicated over the group (tensor parallelism: every ``model``
  rank computes the same downstream loss, counted once);
* :func:`all_reduce_grad`: the identity, whose backward sums the cotangent
  over the group: the input of a column-split layer, which every rank reads
  whole but whose gradient each rank computes from its columns only
  (Megatron's "f"; JAX's partitioner inserts the same all-reduce);
* :func:`ppermute`: a non-wrapping exchange between pairs of ranks; the
  backward is the reverse exchange (JAX's transpose of ``ppermute``);
* :func:`all_to_all`: chunks of one dim sent to the group's ranks and
  joined on another; the backward is the inverse all-to-all.

A ``group`` of ``None`` is the one-process mesh (or an axis of size 1):
every collective is then the identity.  The flat helpers move a list of
tensors through one collective over one buffer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ip_avsr_torch.utils import spans


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum``: the sum of ``x`` over the ranks of ``group``."""
    return x if group is None else _AllReduceSum.apply(x, group)


class _AllReduceGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_grad(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` itself; its gradient summed over the ranks of ``group``."""
    if group is None or not x.requires_grad:
        return x
    return _AllReduceGrad.apply(x, group)


def _gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    # the parts laid out as the contiguous input every rank sends
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.width = dim, group, x.shape[dim]
        return _gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.width
        return g.narrow(ctx.dim, start, ctx.width), None, None


def all_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' ``x`` joined along ``dim`` in rank order; the backward
    hands each rank the slice of the cotangent its ``x`` became."""
    if group is None:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def _exchange(x: torch.Tensor, pairs, group) -> torch.Tensor:
    me = dist.get_rank(group)
    # gloo and nccl send and receive contiguous tensors only
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    for src, dst in pairs:
        if src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        if dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _exchange(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, tuple((d, s) for s, d in ctx.pairs), ctx.group), None, None


def ppermute(x: torch.Tensor, pairs, group=None) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of ``group`` sends ``x`` to ``dst``
    for each ``(src, dst)`` of ``pairs``; a rank that receives nothing gets
    zeros.  Every rank of the group must call it."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    if group is None:
        return x if (0, 0) in pairs else torch.zeros_like(x)
    return _PPermute.apply(x, pairs, group)


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal chunks")
    chunks = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    outs = [torch.empty_like(chunks[0]) for _ in range(n)]
    dist.all_to_all(outs, chunks, group=group)
    return torch.cat(outs, dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return _all_to_all(g, cat_dim, split_dim, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group=None) -> torch.Tensor:
    """Chunk ``k`` of ``x`` along ``split_dim`` goes to rank ``k`` of
    ``group``; what a rank receives is joined along ``cat_dim`` in rank
    order."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim % x.dim(), cat_dim % x.dim(), group)


# -- flat buffers: one collective for a list of tensors (no autograd) ------

def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(buf: torch.Tensor, like) -> list:
    out, at = [], 0
    for t in like:
        out.append(buf[at: at + t.numel()].view(t.shape))
        at += t.numel()
    return out


@torch.no_grad()
def flat_all_reduce(tensors, group=None) -> list:
    """The sum over ``group`` of each tensor (one dtype, one device), in one
    ``all_reduce`` of one buffer."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    buf = _flat(tensors)
    with spans.span("collective.all_reduce", device=False, nbytes=buf.nbytes):
        dist.all_reduce(buf, group=group)
    return _unflat(buf, tensors)


@torch.no_grad()
def flat_broadcast(tensors, group=None, src: int = 0) -> list:
    """Every tensor as group rank ``src`` holds it, in one broadcast per
    dtype."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    out = list(tensors)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        buf = _flat([tensors[i] for i in idx])
        dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
        for i, t in zip(idx, _unflat(buf, [tensors[i] for i in idx])):
            out[i] = t
    return out


@torch.no_grad()
def flat_all_gather(tensors, group=None) -> list:
    """For each tensor, the list of every rank's copy, by rank, through one
    ``all_gather`` of one buffer (every rank's tensors share shapes)."""
    tensors = list(tensors)
    if group is None:
        return [[t] for t in tensors]
    buf = _flat(tensors)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    with spans.span("collective.all_gather", device=False, nbytes=buf.nbytes):
        dist.all_gather(parts, buf, group=group)
    per_rank = [_unflat(p, tensors) for p in parts]
    return [[rank[i] for rank in per_rank] for i in range(len(tensors))]


def fold_seed(seed: int, index: int) -> int:
    """A seed for shard ``index`` drawn from ``seed``, as JAX folds a
    shard's index into its key: distinct per index, ``seed`` at index 0."""
    return (int(seed) ^ (int(index) * 0x9E3779B97F4A7C15)) % (2 ** 63)
