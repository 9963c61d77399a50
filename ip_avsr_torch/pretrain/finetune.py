"""Autoencoder finetuning: the port of ip_avsr_tpu/pretrain/finetune.py.

* ``finetune_autoencoder``: parity with */ae_finetuner.py (e.g.
  avletters/ae_finetuner.py:32-146): a w1..wN unfolded AE minimises the
  squared reconstruction error + L2 (5e-3) with adadelta (or nesterov
  momentum) over batch-shuffled epochs; returns the updated (weights,
  biases).  The batch order comes from numpy's ``RandomState(seed)``, as in
  the JAX package, and nothing else is drawn, so the function is
  deterministic and equals JAX's.
* ``train_convae``: parity with avletters/avletters_convae.py:202-330:
  adadelta (lr 0.8), squared error, lr *= 0.9 from epoch 10, epochwise
  shuffled fixed-size batches; returns the conv-AE parameters.

The data goes to the device once; each batch is a device-side gather by the
epoch's permutation, and the loss is summed on the device and read once per
epoch.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device, tree_map, tree_to
from ip_avsr_torch.models import convae as convae_mod
from ip_avsr_torch.models import encoder as encoder_mod
from ip_avsr_torch.ops import losses
from ip_avsr_torch.train import optimizers as opt_lib


def value_and_grad(loss_of, params, *args):
    """``(loss, grads)``: ``loss_of(params, *args)`` detached and its
    gradient with respect to every leaf of ``params``, as a tree of the
    same structure."""
    leaves = []

    def track(p):
        leaf = p.detach().requires_grad_(True)
        leaves.append(leaf)
        return leaf

    loss = loss_of(tree_map(track, params), *args)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda p: next(grads), params)


def _fc_names(params):
    return sorted(params.keys(), key=lambda n: int(n[2:]))


def ae_params_from_lists(weights, biases, device=None) -> dict:
    """(w1..wN, b1..bN) lists -> parameter tree with fc{i} names, float32 on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return {
        f"fc{i + 1}": {"w": torch.as_tensor(np.asarray(w, np.float32), device=device),
                       "b": torch.as_tensor(np.asarray(b, np.float32), device=device)
                       .reshape(-1)}
        for i, (w, b) in enumerate(zip(weights, biases))
    }


def ae_params_to_lists(params: dict):
    """The fc{i} tree as (weights, biases) lists of numpy arrays."""
    names = _fc_names(params)
    weights = [params[n]["w"].detach().cpu().numpy() for n in names]
    biases = [params[n]["b"].detach().cpu().numpy() for n in names]
    return weights, biases


def ae_forward(params: dict, x, activations: Sequence[str]):
    return encoder_mod.encoder_forward(params, x, activations, names=_fc_names(params))


def _ae_loss(params, batch, activations, l2):
    recon = ae_forward(params, batch, activations)
    return losses.squared_error(recon, batch) + losses.l2_regularization(params, l2)


def finetune_autoencoder(
    weights,
    biases,
    activations: Sequence[str],
    train_X: np.ndarray,
    epochs: int = 30,
    batchsize: int = 128,
    optimizer: str = "adadelta",
    learning_rate: Optional[float] = None,
    l2: float = 0.005,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    device=None,
):
    """Finetune an unfolded AE on reconstruction on ``device`` (default
    ``cuda``); returns (weights, biases) as numpy lists."""
    device = resolve_device(device)
    params = ae_params_from_lists(weights, biases, device)
    opt = opt_lib.select_optimizer(optimizer, learning_rate)
    opt_state = opt.init(params)
    acts = tuple(activations)
    X = torch.as_tensor(np.asarray(train_X, np.float32)).to(device)
    rng = np.random.RandomState(seed)
    n = len(X)
    batchsize = min(batchsize, n)  # n < batchsize would otherwise run no batch
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        total, count = torch.zeros((), device=device), 0
        for start in range(0, n - batchsize + 1, batchsize):
            batch = X.index_select(0, order[start:start + batchsize])
            loss, grads = value_and_grad(_ae_loss, params, batch, acts, l2)
            params, opt_state = opt.apply(params, grads, opt_state)
            total += loss
            count += 1
        log_fn(f"AE finetune epoch {epoch + 1}: loss = {float(total) / max(count, 1):.6f}")
    return ae_params_to_lists(params)


def _convae_loss(params, batch, config, generator):
    recon = convae_mod.convae_forward(params, config, batch, train=config.use_dropout,
                                      generator=generator)
    return losses.squared_error(recon, batch)


def train_convae(
    train_X: np.ndarray,
    config: convae_mod.ConvAEConfig = convae_mod.ConvAEConfig(),
    epochs: int = 25,
    batchsize: int = 128,
    learning_rate: float = 0.8,
    decay_start: int = 10,
    decay_rate: float = 0.9,
    seed: int = 0,
    log_fn: Callable[[str], None] = print,
    stop_flag: Optional[Callable[[], bool]] = None,
    device=None,
):
    """Train the conv-AE end to end (avletters/avletters_convae.py:202-330)
    on ``device`` (default ``cuda``); returns (params on the device, the
    epochs' mean losses).  The initial parameters come from a CPU generator
    seeded ``seed``, the dropout masks from a device generator seeded
    ``seed + 1``.  ``stop_flag`` mirrors the reference's SIGINT-graceful
    stop (:204-209): when it returns True the loop ends after the epoch."""
    device = resolve_device(device)
    params = tree_to(convae_mod.init_convae_params(torch.Generator().manual_seed(seed),
                                                   config), device)
    opt = opt_lib.adadelta(learning_rate)
    opt_state = opt.init(params)
    X = torch.as_tensor(np.asarray(train_X, np.float32)).to(device)
    rng = np.random.RandomState(seed)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    lr = learning_rate
    n = len(X)
    batchsize = min(batchsize, n)  # n < batchsize would otherwise run no batch
    history = []
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        total, count = torch.zeros((), device=device), 0
        for start in range(0, n - batchsize + 1, batchsize):
            batch = X.index_select(0, order[start:start + batchsize])
            loss, grads = value_and_grad(_convae_loss, params, batch, config, generator)
            params, opt_state = opt.apply(params, grads, opt_state, learning_rate=lr)
            total += loss
            count += 1
        history.append(float(total) / max(count, 1))
        log_fn(f"conv-AE epoch {epoch + 1}: loss = {history[-1]:.6f} (lr={lr:.4f})")
        if epoch + 1 >= decay_start:
            lr *= decay_rate
        if stop_flag is not None and stop_flag():
            log_fn("stop requested; ending conv-AE training")
            break
    return params, history
