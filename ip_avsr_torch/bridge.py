"""Carry parameters from the JAX package into the port.

The caller turns each leaf of the JAX parameter pytree into a NumPy array
(``jax.tree_util.tree_map(np.asarray, params)``), so this module never
imports JAX.  Keys and layouts stay as they are: ``w_in (D, 4H)``,
``w_hid (H, 4H)`` with gate order i, f, c, o,
``streams/<name>/encoder/fc1..bottleneck/{w,b}``,
``aggregator[0]/{fwd,bwd}`` and ``output/{w,b}``.
"""

from __future__ import annotations

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device


def params_from_jax(tree, device=None):
    """NumPy pytree (dicts, lists, tuples of arrays) -> the same tree of
    tensors on ``device`` (default ``cuda``)."""
    device = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(v) for v in node)
        return torch.as_tensor(np.array(node), device=device)

    return convert(tree)
