"""Optimizers with Lasagne-exact update rules, over parameter trees.

Mirrors ip_avsr_tpu/train/optimizers.py: ``opt = adam(lr); state =
opt.init(params); params, state = opt.apply(params, grads, state)``, with an
optional ``learning_rate=`` override per call (the trainer's decay
schedule).  The state trees are the JAX package's (``{"m", "v", "t"}``,
``{"accu", "delta_accu"}``, ``{"velocity"}``), so a JAX optimizer state
carries across through ``bridge.params_from_jax``.  Updates return new
tensors and leave their inputs as they were.  Both Adams update every leaf
through ``ops/kernels/adam.adam_update``: on the card one multi-tensor
kernel launch for the whole tree, on the CPU its plain version, three
``tree_map``s of eager operations.

* ``adam``: lasagne.updates.adam, the standard bias-corrected Adam;
* ``adam_vlr``: Adam with a per-parameter learning-rate tree
  (``generate_lr_map``), scaled by ``learning_rate / base_lr`` when a
  schedule passes a rate;
* ``adadelta``: lasagne.updates.adadelta (the reference trimodal schedule);
* ``momentum`` / ``nesterov_momentum``: lasagne.updates.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Optional

import torch

from ip_avsr_torch.device import tree_map
from ip_avsr_torch.ops.kernels import adam as adam_kernel


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[..., Any]  # (params, grads, state, **overrides) -> (params, state)


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _step_counter(params) -> torch.Tensor:
    """Adam's ``t``: a float32 scalar on the parameters' device."""
    devices = []
    tree_map(lambda p: devices.append(p.device), params)
    return torch.zeros((), dtype=torch.float32, device=devices[0])


def adam(learning_rate=1e-4, beta1=0.9, beta2=0.999, epsilon=1e-8) -> Optimizer:
    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "t": _step_counter(params)}

    @torch.no_grad()
    def apply(params, grads, state, learning_rate=learning_rate):
        t = state["t"] + 1.0
        a_t = learning_rate * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        new, m, v = adam_kernel.adam_update(params, grads, state["m"], state["v"], a_t,
                                            beta1, beta2, epsilon)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, apply)


def _flat_names(tree, prefix=()):
    """``(path, leaf)`` pairs with the names ``jax.tree_util.
    tree_flatten_with_path`` gives: dict keys in sorted order, list and
    tuple entries by index, joined by '/'."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat_names(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flat_names(v, prefix + (str(i),)))
        return out
    return [("/".join(prefix), tree)]


def generate_lr_map(params, lr_config: dict, default) -> Any:
    """Tree of per-parameter learning rates, congruent with ``params``.

    ``lr_config`` maps path prefixes (keys joined by '/', list entries by
    index, so ``aggregator/0/fwd/w_in``) to rates; a parameter whose path
    starts with a configured prefix gets the first such rate, any other
    ``default``.  A prefix that matches no path is warned about."""
    names = [name for name, _ in _flat_names(params)]
    for prefix in lr_config:
        if not any(n.startswith(prefix) for n in names):
            warnings.warn(
                f"lr_map prefix {prefix!r} matches no parameter path "
                f"(paths look like {names[0]!r}); that rate is unused",
                stacklevel=2)

    def rate_for(path):
        for prefix, lr in lr_config.items():
            if path.startswith(prefix):
                return lr
        return default

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, prefix + (str(i),)) for i, v in enumerate(tree))
        return rate_for("/".join(prefix))

    return walk(params, ())


def adam_vlr(lr_map, beta1=0.9, beta2=0.999, epsilon=1e-8, base_lr=None) -> Optimizer:
    """Adam whose step size per parameter is ``lr_map`` (a tree congruent
    with the parameters).  A ``learning_rate`` passed to ``apply`` scales
    every rate by ``learning_rate / base_lr`` (when ``base_lr`` is set), so
    the map holds the ratios and a schedule moves the level."""

    def init(params):
        return {"m": _zeros(params), "v": _zeros(params), "t": _step_counter(params)}

    @torch.no_grad()
    def apply(params, grads, state, learning_rate=None):
        scale = learning_rate / base_lr if learning_rate is not None and base_lr else 1.0
        t = state["t"] + 1.0
        corr = scale * torch.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        new, m, v = adam_kernel.adam_update(params, grads, state["m"], state["v"], corr,
                                            beta1, beta2, epsilon, lr_map)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, apply)


def adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-6) -> Optimizer:
    def init(params):
        return {"accu": _zeros(params), "delta_accu": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, learning_rate=learning_rate):
        accu = tree_map(lambda a, g: rho * a + (1.0 - rho) * g * g, state["accu"], grads)
        update = tree_map(lambda g, a, d: g * torch.sqrt(d + epsilon) / torch.sqrt(a + epsilon),
                          grads, accu, state["delta_accu"])
        delta_accu = tree_map(lambda d, u: rho * d + (1.0 - rho) * u * u,
                              state["delta_accu"], update)
        new = tree_map(lambda p, u: p - learning_rate * u, params, update)
        return new, {"accu": accu, "delta_accu": delta_accu}

    return Optimizer(init, apply)


def momentum(learning_rate, momentum_coeff=0.9, nesterov=False) -> Optimizer:
    def init(params):
        return {"velocity": _zeros(params)}

    @torch.no_grad()
    def apply(params, grads, state, learning_rate=learning_rate):
        velocity = tree_map(lambda v, g: momentum_coeff * v - learning_rate * g,
                            state["velocity"], grads)
        if nesterov:
            new = tree_map(lambda p, v, g: p + momentum_coeff * v - learning_rate * g,
                           params, velocity, grads)
        else:
            new = tree_map(lambda p, v: p + v, params, velocity)
        return new, {"velocity": velocity}

    return Optimizer(init, apply)


def nesterov_momentum(learning_rate, momentum_coeff=0.9) -> Optimizer:
    return momentum(learning_rate, momentum_coeff, nesterov=True)


_REGISTRY = {
    "adam": adam,
    "adadelta": adadelta,
    "momentum": momentum,
    "nesterov": nesterov_momentum,
}


def select_optimizer(name: str, learning_rate: Optional[float] = None, **kw) -> Optimizer:
    fn = _REGISTRY[name]
    if learning_rate is None:
        return fn(**kw)
    return fn(learning_rate, **kw)
