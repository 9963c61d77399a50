"""Whole-model pickles, the port's copy of ip_avsr_tpu/io/matio.py:158-178.

A parameter file is a pickled tree of numpy arrays (dicts, lists, tuples),
the format the JAX package's ``save_model_params`` writes, so a file written
by either package loads in the other: in the port through
``bridge.params_from_jax(load_model_params(path), device)``.  The ``.mat``
readers and writers of that module come with the CLIs that need them
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

from ip_avsr_torch.device import tree_map


def save_model(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_model(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_model_params(params, path):
    """Pickle a parameter tree, every tensor as a numpy array on the host."""
    save_model(tree_map(lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                        else np.asarray(v), params), path)


def load_model_params(path):
    """The numpy parameter tree of a file :func:`save_model_params` (of
    either package) wrote."""
    return load_model(path)
