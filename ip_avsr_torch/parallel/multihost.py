"""Multi-host input: the port of ip_avsr_tpu/parallel/multihost.py.

In JAX a process holds several devices, contributes its rows of the
global batch (``process_local_slice``), and
``jax.make_array_from_process_local_data`` assembles the global array from
the processes' rows.  Here a process is one rank of the group and holds
one device, so the global batch stays as the ranks' blocks and
"assembling" it hands over this rank's rows.  On one process both reduce
to the whole batch.  The Trainer does not call these: every rank builds
the whole padded batch and takes its block of it, with or without
``TrainOptions(multihost=True)``; they are kept with JAX's names for code
that loads each rank's rows itself.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ip_avsr_torch.device import tree_map


def _process(mesh=None, axis_name: str = "data"):
    if mesh is not None:
        return mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def process_local_slice(global_batch: int, mesh=None, axis_name: str = "data") -> slice:
    """The half-open row range this process loads: its share of the
    process count (the group's ranks; with ``mesh``, its coordinate along
    ``axis_name``, so ranks that differ only along another dim load the
    same rows).  The batch must divide evenly: pad it first
    (``mesh.pad_batch_to_multiple``)."""
    n_proc, idx = _process(mesh, axis_name)
    if global_batch % n_proc != 0:
        raise ValueError(
            f"global batch {global_batch} must be a multiple of the process "
            f"count {n_proc}; pad it first (mesh.pad_batch_to_multiple)")
    per = global_batch // n_proc
    return slice(idx * per, (idx + 1) * per)


def global_batch_from_local(mesh, local_arrays, global_batch: Optional[int] = None,
                            axis_name: str = "data"):
    """The global batch, split over ``axis_name``, from every process's rows:
    this rank's block is ``local_arrays`` (a tree of its rows, from
    :func:`process_local_slice`), as tensors (an array's on the CPU; the
    caller moves them to its device).  ``global_batch`` (default: the local
    rows times the axis size) must be the local rows times the axis size."""
    n = mesh.axis_size(axis_name)

    def assemble(x):
        rows = x.shape[0] * n
        if global_batch is not None and global_batch != rows:
            raise ValueError(f"global batch {global_batch} is not {x.shape[0]} local rows "
                             f"times {n} processes")
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))

    return tree_map(assemble, local_arrays)
