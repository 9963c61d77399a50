"""Checkpoint and resume of the full training state.

Mirrors ip_avsr_tpu/train/checkpoints.py with ``torch.save`` in place of
orbax: one file ``step_<N>/state.pt`` under the checkpoint directory holding
``{"params", "opt_state", "extra", "step"}``.  Everything stored is a
tensor, a Python number or string, or a dict or list of them, so
``torch.load`` reads it back with ``weights_only=True``: numpy arrays in
``extra`` are stored as CPU tensors and numpy scalars as Python numbers.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

_FILE = "state.pt"


def _storable(node):
    """A tree of tensors, numpy arrays and numbers -> a tree of detached
    tensors and Python numbers."""
    if isinstance(node, dict):
        return {k: _storable(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_storable(v) for v in node)
    if isinstance(node, torch.Tensor):
        return node.detach()
    if isinstance(node, np.ndarray):
        return torch.from_numpy(np.array(node))
    if isinstance(node, np.generic):
        return node.item()
    return node


def save_train_state(directory: str, step: int, params, opt_state,
                     extra: Optional[dict] = None) -> str:
    """Write a step checkpoint under ``directory/step_<N>``; returns that
    path."""
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    state = {"params": params, "opt_state": opt_state, "extra": extra or {},
             "step": int(step)}
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_storable(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_train_state(directory: str, step: Optional[int] = None,
                        map_location=None) -> Optional[dict]:
    """Restore the given (or latest) checkpoint onto ``map_location``; None
    if there is none, for an explicit ``step`` too."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(os.path.abspath(directory), f"step_{step}", _FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
