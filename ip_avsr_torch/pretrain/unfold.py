"""Unfolding a trained DBN into an autoencoder or classifier network: the
port's copy of ip_avsr_tpu/pretrain/unfold.py (numpy only, held equal to
the original by the tests).

Parity:
  * ``unfold_dbn_to_ae`` — dbn/unfoldDBNtoAE.m:26-54: decoder weights are the
    encoder's transposed (mirrored in reverse order), decoder biases are the
    RBM visible biases, activation list is
    [encoder fns, reversed(encoder fns[:-1]), input fn].
  * ``unfold_dbn_to_clsf`` — dbn/unfoldDBNToClsf.m:72-83: appends a softmax
    layer initialized 0.1*randn.
  * ``unfold_dbn_to_nn`` — dbn/unfoldDBNtoNN.m:17-39 dispatcher.
  * ``extract_nn`` — dbn/extractNN.m:86-105: flatten to w1..wN/b1..bN — the
    checkpoint ABI consumed by the Python training side.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def unfold_dbn_to_ae(dbn: dict, hidden_layers: Sequence[int],
                     hidden_activations: Sequence[str], input_activation: str,
                     output_size: int):
    n = len(hidden_layers)
    input_size = dbn["W"][0].shape[0]
    if input_size != output_size:
        raise ValueError("Input size differs from output size; an AE needs them equal")
    weights = [np.asarray(w) for w in dbn["W"]]
    biases = [np.asarray(b).reshape(1, -1) for b in dbn["hidbiases"]]
    for i in range(n - 1, -1, -1):
        weights.append(np.asarray(dbn["W"][i]).T)
        biases.append(np.asarray(dbn["visbiases"][i]).reshape(1, -1))
    activations = (list(hidden_activations)
                   + list(reversed(list(hidden_activations)[:-1]))
                   + [input_activation])
    layers = (list(hidden_layers) + list(reversed(list(hidden_layers)[:-1]))
              + [output_size])
    return weights, biases, activations, layers


def unfold_dbn_to_clsf(dbn: dict, hidden_layers: Sequence[int],
                       hidden_activations: Sequence[str], output_size: int, rng=None):
    rng = np.random.RandomState(0) if rng is None else rng
    weights = [np.asarray(w) for w in dbn["W"]]
    biases = [np.asarray(b).reshape(1, -1) for b in dbn["hidbiases"]]
    weights.append(0.1 * rng.randn(hidden_layers[-1], output_size))
    biases.append(0.1 * rng.randn(1, output_size))
    activations = list(hidden_activations) + ["softmax"]
    layers = list(hidden_layers) + [output_size]
    return weights, biases, activations, layers


def unfold_dbn_to_nn(dbn: dict, dbn_type: int, hidden_layers, hidden_activations,
                     input_activation: str, output_size: int, rng=None) -> dict:
    if dbn_type == 1:
        w, b, act, layers = unfold_dbn_to_ae(dbn, hidden_layers, hidden_activations,
                                             input_activation, output_size)
    elif dbn_type == 2:
        w, b, act, layers = unfold_dbn_to_clsf(dbn, hidden_layers, hidden_activations,
                                               output_size, rng)
    else:
        raise ValueError("dbn_type must be 1 (AE) or 2 (classifier)")
    return {"W": w, "biases": b, "activationFunctions": act, "layers": layers,
            "pretraining": 1}


def extract_nn(nn: dict) -> dict:
    """Flatten to the w1..wN/b1..bN .mat ABI (dbn/extractNN.m:86-105)."""
    out = {}
    for i, (w, b) in enumerate(zip(nn["W"], nn["biases"]), 1):
        out[f"w{i}"] = np.asarray(w)
        out[f"b{i}"] = np.asarray(b).reshape(1, -1)
    return out
