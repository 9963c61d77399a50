"""Stacked denoising autoencoder (SDE) pretraining: the port of
ip_avsr_tpu/pretrain/sde.py.

Parity with avletters/sde_autoencoder.py:40-69: each layer is a denoising AE
with Gaussian input corruption and a tied (W^T) linear decoder; hidden layers
use sigmoid encoders (sigma=0.5), the bottleneck layer is linear (sigma=0.3);
layers are trained greedily on the previous layer's clean codes with squared
error + adadelta, the batch order from numpy's ``RandomState(0)``.

Draws: the initial weights from a CPU ``torch.Generator`` seeded ``seed``
(:func:`init_layer`), the corruption on the data's device from a generator
of that device (:func:`draw_corruption`).  Both are module-level functions,
so a test can carry JAX's init and noise across.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device, tree_to
from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops import losses
from ip_avsr_torch.pretrain.finetune import value_and_grad
from ip_avsr_torch.train import optimizers as opt_lib


def init_layer(generator, num_dims: int, encode_size: int) -> dict:
    """A layer's parameters on the CPU: glorot-uniform ``w`` (num_dims,
    encode_size), zero ``b_enc`` and ``b_dec``."""
    return {"w": inits.glorot_uniform(generator, (num_dims, encode_size)),
            "b_enc": torch.zeros((encode_size,), dtype=torch.float32),
            "b_dec": torch.zeros((num_dims,), dtype=torch.float32)}


def draw_corruption(generator, shape, device) -> torch.Tensor:
    """A standard normal draw of ``shape`` on ``device``."""
    return torch.randn(tuple(shape), generator=generator, device=device)


def _layer_loss(params, batch, noise, sigma, nonlinearity):
    code = nonlinearity(torch.addmm(params["b_enc"], batch + sigma * noise, params["w"]))
    recon = torch.addmm(params["b_dec"], code, params["w"].T)
    return losses.squared_error(recon, batch)


def train_denoising_layer(
    seed: int,
    data,
    encode_size: int,
    sigma: float,
    encoder_nonlinearity: str,
    epochs: int = 20,
    batchsize: int = 128,
    log_fn: Callable[[str], None] = print,
    device=None,
):
    """Train one tied-weight denoising AE layer on ``data`` (n, d), a numpy
    array or a tensor, on ``device`` (default ``cuda``); returns (W, b_enc)
    as tensors on the device."""
    device = resolve_device(device)
    x = torch.as_tensor(data, dtype=torch.float32).to(device)
    n, d = x.shape
    batchsize = min(batchsize, n)  # n < batchsize would otherwise run no batch
    params = tree_to(init_layer(torch.Generator().manual_seed(seed), d, encode_size), device)
    opt = opt_lib.adadelta()
    opt_state = opt.init(params)
    nl = torch.sigmoid if encoder_nonlinearity == "sigmoid" else (lambda v: v)
    generator = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.RandomState(0)
    for epoch in range(epochs):
        order = torch.as_tensor(rng.permutation(n), device=device)
        total, count = torch.zeros((), device=device), 0
        for start in range(0, n - batchsize + 1, batchsize):
            batch = x.index_select(0, order[start:start + batchsize])
            noise = draw_corruption(generator, batch.shape, device)
            loss, grads = value_and_grad(_layer_loss, params, batch, noise, sigma, nl)
            params, opt_state = opt.apply(params, grads, opt_state)
            total += loss
            count += 1
        log_fn(f"SDE layer epoch {epoch + 1}: loss = {float(total) / max(count, 1):.6f}")
    return params["w"], params["b_enc"]


def train_sde(
    seed: int,
    data,
    layer_sizes: Sequence[int],
    epochs: int = 20,
    batchsize: int = 128,
    hidden_sigma: float = 0.5,
    bottleneck_sigma: float = 0.3,
    log_fn: Callable[[str], None] = print,
    device=None,
):
    """Greedy SDE stack on ``device`` (default ``cuda``); the last layer is
    the linear bottleneck, layer ``i`` (from 0) trains with the seed
    ``seed + i`` and the codes stay on the device as the next layer's data.

    Returns (weights, biases) as numpy lists: one (W, b) per encoder layer,
    ready for ``models.encoder.pretrained_encoder_params`` or the w1..wN
    export (a mirrored decoder can be appended as ``pretrain.unfold`` does
    for DBNs).
    """
    device = resolve_device(device)
    x = torch.as_tensor(data, dtype=torch.float32).to(device)
    weights: List[np.ndarray] = []
    biases: List[np.ndarray] = []
    for i, size in enumerate(layer_sizes):
        is_bottleneck = i == len(layer_sizes) - 1
        nl = "linear" if is_bottleneck else "sigmoid"
        sigma = bottleneck_sigma if is_bottleneck else hidden_sigma
        log_fn(f"SDE layer {i + 1}: {x.shape[1]} -> {size} ({nl}, sigma={sigma})")
        w, b = train_denoising_layer(seed + i, x, size, sigma, nl, epochs, batchsize, log_fn,
                                     device=device)
        weights.append(w.cpu().numpy())
        biases.append(b.cpu().numpy())
        with torch.no_grad():
            code = torch.addmm(b, x, w)
        x = code if is_bottleneck else torch.sigmoid(code)
    return weights, biases
