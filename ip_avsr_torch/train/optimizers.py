"""Optimizers with Lasagne-exact update rules, over parameter trees.

Mirrors ip_avsr_tpu/train/optimizers.py: ``opt = adam(lr); state =
opt.init(params); params, state = opt.apply(params, grads, state)``.  The
state tree is the JAX package's, ``{"m": tree, "v": tree, "t": scalar}``, so
a JAX optimizer state carries across through ``bridge.params_from_jax``.
Updates return new tensors and leave their inputs as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ip_avsr_torch.device import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[..., Any]  # (params, grads, state, **overrides) -> (params, state)


def adam(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8) -> Optimizer:
    """lasagne.updates.adam, the standard bias-corrected Adam; ``t`` is a
    float32 scalar on the parameters' device, as in the JAX package."""

    def init(params):
        devices = []
        tree_map(lambda p: devices.append(p.device), params)
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "t": torch.zeros((), dtype=torch.float32, device=devices[0])}

    @torch.no_grad()
    def apply(params, grads, state, learning_rate=learning_rate):
        t = state["t"] + 1.0
        a_t = learning_rate * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        m = tree_map(lambda m, g: beta1 * m + (1.0 - beta1) * g, state["m"], grads)
        v = tree_map(lambda v, g: beta2 * v + (1.0 - beta2) * g * g, state["v"], grads)
        new = tree_map(lambda p, m, v: p - a_t * m / (torch.sqrt(v) + epsilon),
                       params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, apply)
