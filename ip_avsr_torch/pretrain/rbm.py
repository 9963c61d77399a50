"""RBM contrastive-divergence pretraining (CD-1): the port of
ip_avsr_tpu/pretrain/rbm.py.

Parity targets (the MATLAB DBN toolbox the reference depends on):
  * hyperparameters: dbn/dbnParamsInit.m:19-45: 10 epochs, batch 100,
    lr 0.1 (0.001 when either layer is linear or ReLU), L2 2e-4 on the
    weights, momentum 0.5 -> 0.9 after epoch 5, CD "type" 1 (Hinton: probs
    in the negative phase) or 2 (states);
  * update rule: dbn/trainRBM.m:54-166: momentum SGD on the CD-1 gradient
    estimate, divided by the *configured* batchsize even for the final,
    partial batch, the velocity added to the parameters; weights init
    0.1*randn (0.01 for ReLU), biases 0;
  * activations: dbn/computeActivations.m:15-48;
  * stochastic states: dbn/computeStates.m:18-33: sigm -> Bernoulli
    (``probs > u``), linear -> +N(0, 1), ReLU -> max(0, x + sigmoid(x)*n)
    (NReLU); other types are deterministic.

Random draws.  A torch generator cannot reproduce ``jax.random``, so:
  * the initial weights are drawn from a CPU ``torch.Generator`` seeded
    from ``seed`` and then moved (:func:`init_rbm`), as the port's other
    inits are, so a card run and a CPU run start equal;
  * the per-step sampling noise is drawn on the data's device from a
    generator of that device (:func:`draw_cd1_noise`): drawing on the host
    and uploading it every step would put the host in the loop;
  * :func:`cd1_step` takes its draws as tensors (``noise=``), and
    :func:`train_rbm` draws through the module-level :func:`draw_cd1_noise`,
    inits through :func:`init_rbm` and orders batches through
    :func:`batch_orders`, so a test can replace those three and feed JAX's
    exact draws.  The defaults give ``jax.random``'s distributions (uniform
    for Bernoulli states, standard normal otherwise), not its values.

Design: no autograd, the updates run in place under ``torch.no_grad()``.
A layer's data goes to the device once and each batch is a device-side
gather by the epoch's permutation; the last, partial batch is sliced to its
real rows (the JAX package pads it and masks the pad rows, which gives the
same result, tests/test_pretrain.py:77).  The negative-phase hidden
*states* are drawn by the JAX step and thrown away (XLA drops the draw);
they change no output, so the port draws none.  The errors are summed on
the device and read once per epoch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device, tree_to


@dataclasses.dataclass(frozen=True)
class RBMHyperParams:
    """dbn/dbnParamsInit.m:19-45 defaults."""

    epochs: int = 10
    batchsize: int = 100
    lr_w: float = 0.1
    lr_vb: float = 0.1
    lr_hb: float = 0.1
    lr_w_linear: float = 0.001
    lr_vb_linear: float = 0.001
    lr_hb_linear: float = 0.001
    weight_penalty_l2: float = 0.0002
    init_momentum: float = 0.5
    final_momentum: float = 0.9
    momentum_epoch_thres: int = 5
    cd_type: int = 1  # 1: probs in the negative phase (Hinton), 2: states

    def rates_for(self, vl_type: str, hl_type: str):
        types = (vl_type.lower(), hl_type.lower())
        if "linear" in types or "relu" in types:
            return self.lr_w_linear, self.lr_vb_linear, self.lr_hb_linear
        return self.lr_w, self.lr_vb, self.lr_hb


def compute_activations(layer_type: str, x: torch.Tensor) -> torch.Tensor:
    """dbn/computeActivations.m:15-48 (layer types are case-insensitive)."""
    lt = layer_type.lower()
    if lt == "sigm":
        return torch.sigmoid(x)
    if lt == "tanh":
        return torch.tanh(x)
    if lt == "linear":
        return x
    if lt == "relu":
        return torch.clamp_min(x, 0.0)
    if lt == "leakyrelu":
        return torch.maximum(0.01 * x, x)
    if lt == "softplus":
        return torch.log1p(torch.exp(x))
    if lt == "softsign":
        return x / (1.0 + torch.abs(x))
    if lt == "softmax":
        return torch.softmax(x, dim=1)
    raise ValueError(f"unknown layer type: {layer_type}")


def noise_kind(layer_type: str) -> Optional[str]:
    """The draw a layer's states need: "uniform" (sigm), "normal" (linear,
    relu) or None (the deterministic types)."""
    lt = layer_type.lower()
    if lt == "sigm":
        return "uniform"
    if lt in ("linear", "relu"):
        return "normal"
    return None


def draw_states_noise(generator, layer_type: str, shape, device) -> Optional[torch.Tensor]:
    """The draw :func:`compute_states` takes for ``layer_type`` (None for
    a deterministic type), from ``generator`` on ``device``."""
    kind = noise_kind(layer_type)
    if kind is None:
        return None
    draw = torch.rand if kind == "uniform" else torch.randn
    return draw(tuple(shape), generator=generator, device=device)


def compute_states(layer_type: str, probs: torch.Tensor, x: torch.Tensor,
                   noise: Optional[torch.Tensor]) -> torch.Tensor:
    """dbn/computeStates.m:18-33 from a draw of :func:`draw_states_noise`:
    sigm gives Bernoulli ``probs > u``, linear adds N(0, 1), relu gives
    NReLU ``max(0, x + sigmoid(x) * n)``; other types return ``probs``."""
    lt = layer_type.lower()
    if lt == "sigm":
        return (probs > noise).to(probs.dtype)
    if lt == "linear":
        return probs + noise
    if lt == "relu":
        return torch.clamp_min(x + torch.sigmoid(x) * noise, 0.0)
    return probs


def rbm_up(data, weights, hidbiases, hl_type, noise=None):
    """dbn/RBMup.m:24-35: ``(activations, states)``; the states need
    ``noise`` for a stochastic type and are None without it."""
    pre = torch.addmm(hidbiases, data, weights)
    probs = compute_activations(hl_type, pre)
    if noise is None and noise_kind(hl_type) is not None:
        return probs, None
    return probs, compute_states(hl_type, probs, pre, noise)


def rbm_down(states, weights, visbiases, vl_type, noise=None):
    """dbn/RBMdown.m:26-36: ``(activations, states)``, as :func:`rbm_up`."""
    pre = torch.addmm(visbiases, states, weights.T)
    probs = compute_activations(vl_type, pre)
    if noise is None and noise_kind(vl_type) is not None:
        return probs, None
    return probs, compute_states(vl_type, probs, pre, noise)


def init_rbm(generator, num_dims: int, num_hid: int, vl_type: str, hl_type: str) -> dict:
    """dbn/trainRBM.m:58-66 on the CPU: 0.1*randn weights (0.01 for ReLU),
    zero biases."""
    scale = 0.01 if "relu" in (vl_type.lower(), hl_type.lower()) else 0.1
    w = torch.empty((num_dims, num_hid), dtype=torch.float32).normal_(generator=generator)
    return {"weights": scale * w,
            "hidbiases": torch.zeros((1, num_hid), dtype=torch.float32),
            "visbiases": torch.zeros((1, num_dims), dtype=torch.float32)}


def draw_cd1_noise(generator, rows: int, num_dims: int, num_hid: int, vl_type: str,
                   hl_type: str, cd_type: int, device):
    """The draws of one CD-1 step of ``rows`` rows: ``(u_pos, n_neg_vis)``,
    the positive hidden states' draw and, with ``cd_type`` 2, the negative
    visible states' (None otherwise: type 1 uses the probs)."""
    u_pos = draw_states_noise(generator, hl_type, (rows, num_hid), device)
    n_neg = (draw_states_noise(generator, vl_type, (rows, num_dims), device)
             if cd_type == 2 else None)
    return u_pos, n_neg


@torch.no_grad()
def cd1_step(state, velocity, data, momentum, lrs, *, vl_type, hl_type, cd_type, batchsize,
             weight_penalty_l2=0.0002, noise):
    """One CD-1 minibatch update (dbn/trainRBM.m:95-158) of ``state`` and
    ``velocity`` in place; returns the batch's squared reconstruction error
    as a device scalar.  ``data`` holds the batch's real rows, the gradient
    is divided by the configured ``batchsize``, the L2 term goes on the
    weights only, and ``noise`` is :func:`draw_cd1_noise`'s pair."""
    u_pos, n_neg = noise
    w, hb, vb = state["weights"], state["hidbiases"], state["visbiases"]
    pos_probs, pos_states = rbm_up(data, w, hb, hl_type, u_pos)
    pos_hid = pos_probs if cd_type == 1 else pos_states
    neg_vis_probs, neg_vis_states = rbm_down(pos_states, w, vb, vl_type,
                                             n_neg if cd_type == 2 else None)
    neg_vis = neg_vis_probs if cd_type == 1 else neg_vis_states
    neg_hid_probs, _ = rbm_up(neg_vis, w, hb, hl_type)
    err = ((data - neg_vis) ** 2).sum()

    lr_w, lr_vb, lr_hb = lrs
    scale = lr_w / batchsize
    vw, vvb, vhb = velocity["weights"], velocity["visbiases"], velocity["hidbiases"]
    vw.mul_(momentum).addmm_(data.T, pos_hid, alpha=scale)
    vw.addmm_(neg_vis.T, neg_hid_probs, alpha=-scale).add_(w, alpha=-lr_w * weight_penalty_l2)
    vvb.mul_(momentum).add_(data.sum(0, keepdim=True) - neg_vis.sum(0, keepdim=True),
                            alpha=lr_vb / batchsize)
    vhb.mul_(momentum).add_(pos_hid.sum(0, keepdim=True) - neg_hid_probs.sum(0, keepdim=True),
                            alpha=lr_hb / batchsize)
    w.add_(vw)
    hb.add_(vhb)
    vb.add_(vvb)
    return err


@torch.no_grad()
def rbm_epoch(state, velocity, data, order, momentum, lrs, generator, *, vl_type, hl_type,
              cd_type, batchsize, weight_penalty_l2):
    """One epoch of CD-1 updates over ``data`` (n, d), on its device, in
    the batches ``order`` (an int64 permutation on the same device) cuts;
    returns the device scalar sum of the steps' errors."""
    n, d = data.shape
    num_hid = state["weights"].shape[1]
    err_sum = torch.zeros((), dtype=torch.float32, device=data.device)
    for start in range(0, n, batchsize):
        batch = data.index_select(0, order[start:start + batchsize])
        noise = draw_cd1_noise(generator, batch.shape[0], d, num_hid, vl_type, hl_type,
                               cd_type, data.device)
        err_sum += cd1_step(state, velocity, batch, momentum, lrs, vl_type=vl_type,
                            hl_type=hl_type, cd_type=cd_type, batchsize=batchsize,
                            weight_penalty_l2=weight_penalty_l2, noise=noise)
    return err_sum


def batch_orders(seed: int, n: int, epochs: int):
    """The epochs' batch orders: permutations of ``n`` rows from numpy's
    ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    return [rng.permutation(n) for _ in range(epochs)]


def train_rbm(seed: int, data, num_hid: int, vl_type: str, hl_type: str,
              hyper: RBMHyperParams = RBMHyperParams(), log_fn=print, device=None):
    """Train one RBM (dbn/trainRBM.m:72-169) on ``data`` (n, d), a numpy
    array or a tensor, on ``device`` (default ``cuda``).  Returns
    ``(state, errors)``: the state's tensors on the device, one mean
    squared error per sample for each epoch."""
    device = resolve_device(device)
    x = torch.as_tensor(data, dtype=torch.float32).to(device)
    n, d = x.shape
    lrs = hyper.rates_for(vl_type, hl_type)
    state = tree_to(init_rbm(torch.Generator().manual_seed(seed), d, num_hid, vl_type,
                             hl_type), device)
    velocity = {k: torch.zeros_like(v) for k, v in state.items()}
    generator = torch.Generator(device=device).manual_seed(seed)
    errors = []
    for epoch, order in enumerate(batch_orders(seed, n, hyper.epochs)):
        momentum = (hyper.final_momentum if epoch + 1 > hyper.momentum_epoch_thres
                    else hyper.init_momentum)
        err_sum = rbm_epoch(state, velocity, x, torch.as_tensor(order, device=device),
                            momentum, lrs, generator, vl_type=vl_type.lower(),
                            hl_type=hl_type.lower(), cd_type=hyper.cd_type,
                            batchsize=hyper.batchsize,
                            weight_penalty_l2=hyper.weight_penalty_l2)
        errors.append(float(err_sum) / n)
        log_fn(f"RBM epoch {epoch + 1}: mse/sample = {errors[-1]:.6f}")
    return state, errors


def normalise_data(tr_fcn: str, data: np.ndarray, ps: Optional[tuple] = None):
    """dbn/normaliseData.m:6-34: linear, featurewise mapstd (``ddof=1``, a
    std of 0 taken as 1); sigm, division by the maximum.  ``ps`` reuses the
    first call's statistics (the training split's) for later splits, for
    the 'sigm' branch too (the training max)."""
    if tr_fcn.lower() == "linear":
        if ps is None:
            mean = data.mean(axis=0)
            std = data.std(axis=0, ddof=1)
            std = np.where(std == 0, 1.0, std)
            ps = (mean, std)
        mean, std = ps
        return (data - mean) / std, ps
    if tr_fcn.lower() == "sigm":
        if ps is None:
            ps = (float(np.max(data)),)
        return data / ps[0], ps
    return data, ps
