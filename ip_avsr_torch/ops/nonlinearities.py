"""Nonlinearity registry (string -> tensor function).

Mirrors ip_avsr_tpu/ops/nonlinearities.py: ``very_leaky_rectify`` uses slope
1/3 and ``scaled_tanh`` defaults to scale_in=1, scale_out=1.
"""

from __future__ import annotations

import torch


def rectify(x):
    return torch.clamp_min(x, 0)


def sigmoid(x):
    return torch.sigmoid(x)


def leaky_rectify(x, leakiness=0.01):
    return torch.where(x > 0, x, leakiness * x)


def very_leaky_rectify(x):
    return leaky_rectify(x, 1.0 / 3.0)


def tanh(x):
    return torch.tanh(x)


def linear(x):
    return x


identity = linear


def softmax(x):
    return torch.softmax(x, dim=-1)


def softplus(x):
    return torch.nn.functional.softplus(x)


def elu(x):
    return torch.where(x > 0, x, torch.expm1(x))


def scaled_tanh(x, scale_in=1.0, scale_out=1.0):
    return scale_out * torch.tanh(scale_in * x)


def make_scaled_tanh(scale_in, scale_out):
    return lambda x: scaled_tanh(x, scale_in, scale_out)


_REGISTRY = {
    "rectify": rectify,
    "relu": rectify,
    "sigmoid": sigmoid,
    "sigm": sigmoid,
    "leaky_rectify": leaky_rectify,
    "very_leaky_rectify": very_leaky_rectify,
    "tanh": tanh,
    "linear": linear,
    "softmax": softmax,
    "softplus": softplus,
    "elu": elu,
    "scaled_tanh": scaled_tanh,
    "identity": identity,
}


def select_nonlinearity(name):
    """String -> activation function; a callable passes through."""
    if callable(name):
        return name
    return _REGISTRY[name]
