"""Wrapper of the multi-tensor Adam kernel (``csrc/adam.cu``).

Replaces no TPU kernel: the JAX package's Adam is three ``tree_map``s that
XLA fuses, which PyTorch runs eagerly as 12 kernels a leaf.  One launch
updates every leaf of a parameter tree, out of place, with the plain
version's float32 operations in its order (bit for bit; see the source's
header): :func:`adam_update`, whose plain version is :func:`plain`.  A tree
takes one launch while its leaves fit one table (:data:`CAPACITY`), else one
launch a table.  The launches are counted in ``adam_update.launches``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ip_avsr_torch.device import tree_map
from ip_avsr_torch.ops.kernels import _build

# values a block updates (a multiple of 4: each leaf starts at one); of 512
# to 16,384 on the H100, the fastest at the flagship's tree and within 0.6%
# of the fastest (512) at the 4-stream model's
CHUNK = 1024
# leaves a launch's table holds (csrc/adam.cu ``kLeaves``): 30.7 KB of
# kernel parameters, which needs CUDA 12.1+
CAPACITY = 384
# the oldest CUDA driver that takes such a table (cudaDriverGetVersion's 12.1)
MIN_DRIVER = 12010
# words of 8 bytes in a leaf's entry of the table (csrc/adam.cu ``Leaf``):
# seven pointers, start, count, then the float32 factor and the vector flag
LEAF_WORDS = 10


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch's share of a tree: the tree's leaves ``leaves`` (indices,
    in order), each starting at ``starts`` in the launch's flat index space
    (back to back, rounded up to a multiple of 4), with 16-byte loads and
    stores where ``vector``; ``blocks`` blocks of ``chunk`` values cover
    ``total``, the space's end."""
    leaves: tuple
    starts: tuple
    vector: tuple
    total: int
    chunk: int
    blocks: int


def launch_plan(numels, addresses, capacity: int, chunk: int = CHUNK) -> list:
    """The launches of a tree of leaves of ``numels`` values whose seven
    addresses (p, g, m, v, p', m', v') are ``addresses``: the non-empty
    leaves in order, ``capacity`` to a launch's table; a leaf's loads and
    stores are 16 bytes wide where all seven addresses are aligned to 16."""
    if capacity < 1 or chunk < 4 or chunk % 4:
        raise ValueError(f"adam launch_plan: capacity {capacity}, chunk {chunk}")
    live = [i for i, n in enumerate(numels) if n > 0]
    plans = []
    for first in range(0, len(live), capacity):
        leaves = tuple(live[first:first + capacity])
        starts, end = [], 0
        for i in leaves:
            starts.append(end)
            end = -(-(end + numels[i]) // 4) * 4
        total = starts[-1] + numels[leaves[-1]]
        plans.append(Launch(leaves, tuple(starts),
                            tuple(all(a % 16 == 0 for a in addresses[i]) for i in leaves),
                            total, chunk, -(-total // chunk)))
    return plans


def leaf_table(launch: Launch, numels, addresses, factors) -> np.ndarray:
    """The table of ``launch`` as the kernel reads it: one row of
    :data:`LEAF_WORDS` int64 words a leaf (the seven addresses, start,
    count, then the leaf's float32 factor in the low half of the last word
    and the vector flag in its high half)."""
    idx = list(launch.leaves)
    table = np.empty((len(idx), LEAF_WORDS), dtype=np.int64)
    table[:, :7] = np.array([addresses[i] for i in idx], dtype=np.uint64).view(np.int64)
    table[:, 7] = launch.starts
    table[:, 8] = [numels[i] for i in idx]
    bits = np.array([factors[i] for i in idx], dtype=np.float32).view(np.uint32)
    table[:, 9] = bits.astype(np.int64) | (np.array(launch.vector, dtype=np.int64) << 32)
    return table


@functools.cache
def _lib():
    lib = _build.load("adam")
    lib.adam_driver_version.argtypes = []
    lib.adam_driver_version.restype = ctypes.c_int
    driver = lib.adam_driver_version()
    if driver < MIN_DRIVER:
        raise RuntimeError(f"adam_update: the kernel's table of {CAPACITY} leaves needs a CUDA "
                           f"driver of 12.1 or later (R530+), this one reports {driver}")
    lib.adam_multi_update.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p] + [ctypes.c_float] * 5 + [
                                          ctypes.c_void_p]
    lib.adam_multi_update.restype = ctypes.c_int
    return lib


def plain(params, grads, m, v, step, beta1, beta2, epsilon, lr_map=None):
    """Adam's update of every leaf by PyTorch's eager operations, tree by
    tree: ``(params', m', v')``.  ``step`` is the 0-d step size (``a_t``),
    or with ``lr_map`` the correction each leaf's rate multiplies."""
    m = tree_map(lambda m, g: beta1 * m + (1.0 - beta1) * g, m, grads)
    v = tree_map(lambda v, g: beta2 * v + (1.0 - beta2) * g * g, v, grads)
    if lr_map is None:
        new = tree_map(lambda p, m, v: p - step * m / (torch.sqrt(v) + epsilon), params, m, v)
    else:
        new = tree_map(lambda p, m, v, lr: p - (lr * step) * m / (torch.sqrt(v) + epsilon),
                       params, m, v, lr_map)
    return new, m, v


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _rebuild(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _rows(params, *trees) -> list:
    """The leaves of ``params`` and of each of ``trees`` side by side, leaf
    by leaf of ``params``: the other trees are read by its keys and
    indices, as :func:`plain`'s ``tree_map``s read them, whatever their own
    order (a tree that lacks one raises)."""
    rows = []
    tree_map(lambda *leaf: rows.append(leaf), params, *trees)
    return rows


def _check(groups, step) -> None:
    """Raise unless every leaf of the four ``groups`` (p, g, m, v) and
    ``step`` are float32 on one CUDA device, the 0-d ``step`` among them,
    and a leaf's four tensors have one shape."""
    dev = step.device
    if step.dtype != torch.float32 or step.dim() != 0:
        raise TypeError(f"adam_update: the step must be a 0-d float32 tensor, got "
                        f"{step.dtype} of shape {tuple(step.shape)}")
    for group in groups:
        for t in group:
            if t.dtype != torch.float32:
                raise TypeError(f"adam_update takes float32 leaves, got {t.dtype}")
            if t.device != dev:
                raise ValueError(f"adam_update: every leaf on the step's device {dev}, "
                                 f"got one on {t.device}")
    for p, g, m, v in zip(*groups):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"adam_update: a leaf's p, g, m and v differ in shape: "
                             f"{[tuple(t.shape) for t in (p, g, m, v)]}")


def adam_update(params, grads, m, v, step, beta1, beta2, epsilon, lr_map=None):
    """``(params', m', v')``: Adam's update of every leaf of ``params`` by
    its gradient in ``grads`` and moments ``m`` and ``v`` (trees of the same
    structure), each step size ``step`` (a 0-d tensor) times the leaf's rate
    in ``lr_map`` where given.  The inputs are left as they were.

    CPU trees take :func:`plain`.  CUDA trees take the kernel, one launch a
    table of :data:`CAPACITY` leaves, or raise: every leaf float32 on the
    step's card (a non-contiguous leaf is copied first)."""
    rows = _rows(params, grads, m, v, *([] if lr_map is None else [lr_map]))
    if rows[0][0].device.type == "cpu":
        return plain(params, grads, m, v, step, beta1, beta2, epsilon, lr_map)
    groups = [list(group) for group in zip(*rows)]
    _check(groups[:4], step)
    factors = [1.0] * len(rows) if lr_map is None else [float(r) for r in groups[4]]
    dev = step.device
    # the launch acts on the host thread's current device, which need not be
    # the tensors' card
    with torch.cuda.device(dev):
        outs = _launch(groups[:4], step, factors, beta1, beta2, epsilon,
                       torch.cuda.current_stream(dev).cuda_stream)
    return tuple(_rebuild(params, leaves) for leaves in outs)


def _launch(groups, step, factors, beta1, beta2, epsilon, stream, chunk=CHUNK,
            capacity=CAPACITY) -> list:
    """The kernel's launches over the checked leaves ``groups`` (p, g, m,
    v) on ``stream``, ``chunk`` values a block and ``capacity`` leaves a
    table: the outputs p', m' and v', fresh, leaf by leaf."""
    ins = [[t.contiguous() for t in group] for group in groups]
    outs = [[torch.empty_like(t) for t in ins[0]] for _ in range(3)]
    numels = [t.numel() for t in ins[0]]
    addresses = [tuple(t.data_ptr() for t in leaf) for leaf in zip(*ins, *outs)]
    lib = _lib()
    consts = [ctypes.c_float(c) for c in (beta1, 1.0 - beta1, beta2, 1.0 - beta2, epsilon)]
    for launch in launch_plan(numels, addresses, capacity, chunk):
        table = leaf_table(launch, numels, addresses, factors)
        code = lib.adam_multi_update(table.ctypes.data, len(launch.leaves), launch.chunk,
                                     launch.blocks, step.data_ptr(), *consts, stream)
        if code < 0:
            _build.check(lib, "adam", -code)
        adam_update.launches += 1
    return outs


adam_update.launches = 0
