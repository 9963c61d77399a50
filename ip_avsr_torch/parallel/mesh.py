"""The device mesh as a torch.distributed process group: the port of
ip_avsr_tpu/parallel/mesh.py.

JAX names the devices of one program a ``Mesh``, annotates arrays with
``NamedSharding``s and lets XLA partition the program.  Here one process
drives one device: a :class:`Mesh` lays the ranks of the default process
group out over named dims (``data``, ``model``, ``seq``) with
``torch.distributed.device_mesh.init_device_mesh``, a sharding is only a
description (:class:`NamedSharding`: the JAX-style spec and the DTensor
placements it means), and each rank computes on plain local tensors, its
block, with explicit collectives (``parallel/collectives.py``), so the
kernels see plain tensors.

Without an initialised process group :func:`make_mesh` is the one-process
mesh, on which every collective is the identity, as on JAX's one-device
mesh.  Nothing here initialises a group.  A mesh spans every rank of the
group: with one process per device there is no rank outside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ip_avsr_torch.device import tree_map


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: per tensor dim, the mesh axis name (or tuple
    of names) it is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


class Mesh:
    """Named dims over the ranks of the default process group, row-major
    (rank ``r`` sits at ``np.unravel_index(r, shape)``), or the one-process
    mesh.  ``shape`` maps each dim's name to its size; ``devices`` is the
    array of ranks, as JAX's ``Mesh.devices`` is of devices."""

    def __init__(self, shape: dict, device_mesh=None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.device_mesh = device_mesh
        self.devices = np.arange(math.prod(self.shape.values())).reshape(
            tuple(self.shape.values()))

    def __repr__(self):
        return f"Mesh({self.shape})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _check(self, axes) -> tuple:
        axes = _axes(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"unbound axis name {a!r}: the mesh has {self.axis_names}")
        return axes

    def axis_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self._check(axes))

    def axis_index(self, axes) -> int:
        """This rank's coordinate along ``axes``, several dims flattened in
        the mesh's order (JAX's ``axis_index`` of a tuple of names)."""
        axes = self._check(axes)
        if self.device_mesh is None:
            return 0
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx

    def group(self, axes):
        """The process group over ``axes`` (one dim, or every dim of the
        mesh), or None when it holds one rank: its collectives are then the
        identity."""
        axes = self._check(axes)
        if self.axis_size(axes) == 1:
            return None
        if set(axes) == set(self.axis_names):
            return self.device_mesh.get_group() if len(self.axis_names) == 1 else dist.group.WORLD
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        raise ValueError(f"a group spans one mesh dim or all of them, not {axes} of "
                         f"{self.axis_names}")

    def barrier(self):
        if self.device_mesh is not None and self.size > 1:
            dist.barrier()


def _device_mesh(sizes, names):
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over every rank of the default group (the
    one-process mesh when no group is initialised)."""
    return make_mesh_nd({axis_name: n_devices})


def make_mesh_nd(shape: dict) -> Mesh:
    """Mesh from an ordered ``{axis_name: size}`` dict, e.g. ``{"data": 4,
    "model": 2}``; one size may be None (the rest of the ranks).  The sizes
    multiply to the group's size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    known = math.prod(int(s) for s in shape.values() if s is not None)
    sizes = {k: (int(v) if v is not None else max(world // max(known, 1), 1))
             for k, v in shape.items()}
    n = math.prod(sizes.values())
    if n > world:
        raise ValueError(f"mesh {sizes} needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh {sizes} covers {n} of the group's {world} ranks; a mesh "
                         f"spans every rank (one process per device)")
    if world == 1 and not dist.is_initialized():
        return Mesh(sizes)
    return Mesh(sizes, _device_mesh(sizes.values(), sizes.keys()))


def axis_group(axis_name, mesh: Optional[Mesh] = None):
    """The group of ``axis_name`` on ``mesh``; without a mesh, the 1-D
    ``data`` mesh over the default group (the world group, or None on one
    process), as JAX's default mesh."""
    if mesh is not None:
        return mesh.group(axis_name)
    for a in _axes(axis_name):
        if a != "data":
            raise ValueError(f"unbound axis name {a!r}: pass the mesh that has it")
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return dist.group.WORLD


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How a tensor is laid out over ``mesh``: JAX's spec (per tensor dim)
    and, equivalently, the DTensor placements (per mesh dim)."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor.placement_types import Replicate, Shard

        out = []
        for name in self.mesh.axis_names:
            dims = [d for d, a in enumerate(self.spec) if a is not None and name in _axes(a)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def local(self, x):
        """This rank's block of ``x`` (a tensor or an array) under this
        sharding; several dims of one tensor dim split in the mesh's
        order."""
        for d, a in enumerate(self.spec):
            if a is None:
                continue
            n = self.mesh.axis_size(a)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over "
                                 f"{a!r} ({n} ranks)")
            w = x.shape[d] // n
            i = self.mesh.axis_index(a)
            x = x[(slice(None),) * d + (slice(i * w, (i + 1) * w),)]
        return x


def adenet_param_rules(model_axis: str = "model"):
    """Tensor-parallel rules for AdeNet parameter trees: every encoder weight
    matrix is sharded on its output (hidden-unit) axis, ``P(None, model)``,
    its bias to match; everything else is replicated (the LSTMs and the head
    are small, and sharding them would put a collective in every step of
    the recurrence).  ``rule(path, leaf)`` takes the leaf's key path."""

    def rule(path, leaf) -> PartitionSpec:
        names = [str(k) for k in path]
        if "encoder" in names:
            if names[-1] == "w" and leaf.ndim == 2:
                return P(None, model_axis)
            if names[-1] == "b" and leaf.ndim == 1:
                return P(model_axis)
        return P()

    return rule


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple tree, ``path`` the
    tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_structure(tree):
    """The tree's skeleton (keys and nesting, leaves as None), for
    congruence tests."""
    return tree_map(lambda _: None, tree)


def param_shardings(params, mesh: Mesh, rules=None, model_axis: str = "model"):
    """A tree of :class:`NamedSharding` for a parameter tree under tensor
    parallelism (default rules :func:`adenet_param_rules`).  A rule naming
    an axis the mesh lacks, or splitting a dim its axes' size does not
    divide, is demoted to replicated."""
    rules = rules or adenet_param_rules(model_axis)

    def one(path, leaf):
        spec = rules(path, leaf)
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            axes = _axes(axis)
            if any(a not in mesh.shape for a in axes):
                spec = P()
                break
            if dim >= leaf.ndim or leaf.shape[dim] % mesh.axis_size(axes) != 0:
                spec = P()
                break
        return NamedSharding(mesh, spec)

    return tree_map_with_path(one, params)


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis_name: str = "data") -> NamedSharding:
    """The leading (batch) axis split over ``axis_name``."""
    return NamedSharding(mesh, P(axis_name))


def _opt_shardings(opt_state, params, mesh: Mesh, like_params):
    p_struct = tree_structure(params)
    rep = replicated_sharding(mesh)

    def one(entry):
        if tree_structure(entry) == p_struct:
            return like_params(entry)
        return tree_map(lambda _: rep, entry)

    if isinstance(opt_state, dict):
        return {k: one(v) for k, v in opt_state.items()}
    return tree_map(lambda _: rep, opt_state)


def opt_state_shardings(opt_state, params, param_sh, mesh: Mesh):
    """Shardings for an optimizer state: an entry congruent with ``params``
    (adam's m and v, adadelta's accumulators, momentum's velocity) mirrors
    ``param_sh``; anything else (step counters) is replicated."""
    return _opt_shardings(opt_state, params, mesh, lambda entry: param_sh)


def zero1_spec(leaf, size: int, axis_name: str = "data") -> PartitionSpec:
    """ZeRO-1 spec of one optimizer-moment leaf: its largest axis that
    ``size`` divides is sharded; a leaf with none is replicated."""
    if getattr(leaf, "ndim", 0) == 0:
        return P()
    dims = sorted(range(leaf.ndim), key=lambda d: -leaf.shape[d])
    for d in dims:
        if leaf.shape[d] % size == 0 and leaf.shape[d] >= size:
            spec = [None] * leaf.ndim
            spec[d] = axis_name
            return P(*spec)
    return P()


def zero1_opt_state_shardings(opt_state, params, mesh: Mesh, axis_name: str = "data"):
    """ZeRO-1 shardings of an optimizer state: each leaf of an entry
    congruent with ``params`` by :func:`zero1_spec` over ``axis_name``,
    everything else replicated."""
    size = mesh.shape[axis_name]
    return _opt_shardings(opt_state, params, mesh, lambda entry: tree_map(
        lambda leaf: NamedSharding(mesh, zero1_spec(leaf, size, axis_name)), entry))


def shard_batch(mesh: Mesh, tree, axis_name: str = "data"):
    """This rank's rows of every array or tensor of ``tree`` (the leading
    axis split over ``axis_name``)."""
    sharding = batch_sharding(mesh, axis_name)
    return tree_map(sharding.local, tree)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` as rank 0 holds it (one broadcast per
    dtype); the tree itself on the one-process mesh."""
    from ip_avsr_torch.parallel import collectives

    group = mesh.group(mesh.axis_names) if mesh.size > 1 else None
    leaves = []
    tree_map(leaves.append, tree)
    tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
    got = iter(collectives.flat_broadcast(tensors, group))
    return tree_map(lambda t: next(got) if isinstance(t, torch.Tensor) else t, tree)


def pad_batch_to_multiple(arrays: Sequence[np.ndarray], multiple: int):
    """Zero-pad the leading axis to a multiple of ``multiple`` (the mesh
    size) -> ``(padded_arrays, original_batch)``.  Pair with a zero mask or
    sample weight so pad rows add nothing to the loss."""
    b = arrays[0].shape[0]
    target = int(-(-b // multiple) * multiple)
    if target == b:
        return list(arrays), b
    out = []
    for a in arrays:
        pad = np.zeros((target - b,) + a.shape[1:], a.dtype)
        out.append(np.concatenate([a, pad], axis=0))
    return out, b
