"""The ``.mat`` ABI and whole-model pickles: the port's copy of
ip_avsr_tpu/io/matio.py.

The reference treats ``.mat`` files as its ABI between MATLAB pretraining and
Python training:

  * dataset schema: ``dataMatrix (sum_T, D), targetsVec, subjectsVec,
    videoLengthVec[, iterVec, filenamesVec, dctFeatures]``
    (oulu/trimodal_with_val.py:292-305);
  * dense autoencoder checkpoints: keys ``w1..wN / b1..bN``
    (dbn/extractNN.m:86-105, modelzoo/autoencoder.py:11-37);
  * LSTM weight bundles: 12 keys per layer, ``{prefix}_{w,b}_{in,hid}_to_{gate}``
    (modelzoo/deltanet_majority_vote.py:158-196, custom/layers.py:28-52).

All three are read and written through ``scipy.io``, which returns the
storage dtypes in Fortran order, at least 2-D (the JAX package's fallback
and its native reader's contract), so a file written by either package
reads the same in the other.  The JAX package's native C++ reader is not
copied (ROADMAP Queue 1 item 9e).

A parameter file is a pickled tree of numpy arrays (dicts, lists, tuples),
the format the JAX package's ``save_model_params`` writes; in the port it
loads through ``bridge.params_from_jax(load_model_params(path), device)``.
"""

from __future__ import annotations

import pickle

import numpy as np
import scipy.io as sio
import torch

from ip_avsr_torch.device import tree_map


def read_data_split_file(path, sep=","):
    """Read a one-line separated list of subject ids (utils/io.py:11-15)."""
    with open(path) as f:
        return [int(s) for s in f.readline().split(sep)]


def load_mat_file(path):
    """Load a .mat file into a dict (utils/io.py:18-24)."""
    return sio.loadmat(path)


def load_mat_files(paths):
    """Load many .mat files, in input order."""
    return [load_mat_file(p) for p in paths]


def save_mat(d, path):
    """Save a dict to a .mat file (utils/io.py:27-29)."""
    sio.savemat(path, d)


# ---------------------------------------------------------------------------
# Dense encoder / autoencoder checkpoints (w1..wN / b1..bN)
# ---------------------------------------------------------------------------

def load_dbn_mat(path_or_dict, n_layers=8):
    """Load an unfolded DBN autoencoder checkpoint as ``(weights, biases)``
    lists of float32 arrays: ``w{i}`` (fan_in, fan_out), ``b{i}`` squeezed
    to 1-D (modelzoo/autoencoder.py:11-37 reads ``nn['b1'][0]``)."""
    nn = path_or_dict if isinstance(path_or_dict, dict) else load_mat_file(path_or_dict)
    weights, biases = [], []
    for i in range(1, n_layers + 1):
        weights.append(np.asarray(nn[f"w{i}"], dtype=np.float32))
        biases.append(np.asarray(nn[f"b{i}"], dtype=np.float32).reshape(-1))
    return weights, biases


def save_dbn_mat(weights, biases, path):
    """Write ``w1..wN / b1..bN`` keys, biases as (1, H) rows, MATLAB's
    ``save -v7`` layout that :func:`load_dbn_mat` reads back."""
    d = {}
    for i, (w, b) in enumerate(zip(weights, biases), 1):
        d[f"w{i}"] = np.asarray(w, dtype=np.float32)
        d[f"b{i}"] = np.asarray(b, dtype=np.float32).reshape(1, -1)
    save_mat(d, path)


def load_decoder(path_or_dict, shapes, nonlinearities, select_nonlinearity=None):
    """An encoder checkpoint with its config-declared architecture:
    ``(weights, biases, shapes, nonlinearities)``, ``shapes`` and
    ``nonlinearities`` given as comma-separated strings or lists
    (runners/4stream.py:34-43)."""
    if isinstance(shapes, str):
        shapes = [int(s) for s in shapes.split(",")]
    if isinstance(nonlinearities, str):
        nonlinearities = nonlinearities.split(",")
    if select_nonlinearity is not None:
        nonlinearities = [select_nonlinearity(n) for n in nonlinearities]
    weights, biases = load_dbn_mat(path_or_dict, n_layers=len(shapes))
    return weights, biases, shapes, nonlinearities


# ---------------------------------------------------------------------------
# LSTM weight bundles (12 keys per layer)
# ---------------------------------------------------------------------------

_GATES = ("ingate", "forgetgate", "cell", "outgate")


def _numpy(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def lstm_params_to_mat_dict(params: dict, prefix: str) -> dict:
    """One LSTM layer's parameters (``w_in (D, 4H)``, ``w_hid (H, 4H)``,
    ``b (4H,)`` stacked in gate order ingate, forgetgate, cell, outgate, as
    Lasagne stacks them; numpy arrays or tensors) as the reference's 12-key
    bundle."""
    w_in, w_hid, b = (_numpy(params[k]) for k in ("w_in", "w_hid", "b"))
    H = w_hid.shape[0]
    d = {}
    for g, gate in enumerate(_GATES):
        sl = slice(g * H, (g + 1) * H)
        d[f"{prefix}_w_in_to_{gate}"] = w_in[:, sl]
        d[f"{prefix}_w_hid_to_{gate}"] = w_hid[:, sl]
        d[f"{prefix}_b_{gate}"] = b[sl].reshape(1, -1)
    return d


def lstm_params_from_mat_dict(mat: dict, prefix: str) -> dict:
    """Inverse of :func:`lstm_params_to_mat_dict`: a reference bundle
    (custom/layers.py:40-51 key names) as stacked float32 arrays."""
    w_in = np.concatenate(
        [np.asarray(mat[f"{prefix}_w_in_to_{g}"], dtype=np.float32) for g in _GATES], axis=1)
    w_hid = np.concatenate(
        [np.asarray(mat[f"{prefix}_w_hid_to_{g}"], dtype=np.float32) for g in _GATES], axis=1)
    b = np.concatenate(
        [np.asarray(mat[f"{prefix}_b_{g}"], dtype=np.float32).reshape(-1) for g in _GATES])
    return {"w_in": w_in, "w_hid": w_hid, "b": b}


# ---------------------------------------------------------------------------
# Whole-model pickles (utils/io.py:32-48)
# ---------------------------------------------------------------------------

def save_model(obj, path):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_model(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def save_model_params(params, path):
    """Pickle a parameter tree, every tensor as a numpy array on the host."""
    save_model(tree_map(_numpy, params), path)


def load_model_params(path):
    """The numpy parameter tree of a file :func:`save_model_params` (of
    either package) wrote."""
    return load_model(path)
