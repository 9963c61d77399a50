"""Pure-NumPy reference forward pass for AdeNet models: the port's
independent oracle, a copy of ip_avsr_tpu/reference_impl.py.

Two purposes:
  1. an independent numerical cross-check for the port (same math, no
     shared code: this module imports numpy and nothing of the package, so
     a fault common to the CUDA kernels and their plain versions shows
     here), and
  2. the measured "reference CPU" throughput denominator: a CPU
     implementation equivalent to what Theano compiled, BLAS matmuls plus
     per-timestep recurrence loops.

Supports every composer topology in the zoo (encoders, batch norm, delta,
per-stream LSTMs, sum/concat/adasum fusion, uni/bi aggregator stacks,
per-step or last-step softmax) plus the tied-weight conv-AE.  Dropout is
never applied (train=True here means "batch-norm uses minibatch statistics",
for checking the BN training path against dropout-free configs).  The
inputs and the mask are cast to float32 and the parameters read through
``np.asarray``, so the oracle covers float32 models only: a bf16 model (or
``matmul_dtype="bfloat16"``) cannot go through it.  Parameters on the card
reach it through :func:`torch_tree_to_np`.  The configs (``AdeNetConfig``,
``ConvAEConfig``) are read through their fields only.
"""

from __future__ import annotations

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


_NONLIN = {
    "sigmoid": _sigmoid,
    "sigm": _sigmoid,
    "linear": lambda x: x,
    "rectify": lambda x: np.maximum(x, 0),
    "relu": lambda x: np.maximum(x, 0),
    "tanh": np.tanh,
}


def encoder_forward_np(enc_params: dict, x: np.ndarray, nonlinearities) -> np.ndarray:
    names = sorted(enc_params.keys(), key=lambda n: (
        {"fc1": 0, "fc2": 1, "fc3": 2, "bottleneck": 3}.get(n, 99),
        int("".join(c for c in n if c.isdigit()) or 0)))
    out = x
    for name, nl in zip(names, nonlinearities):
        out = _NONLIN[nl](out @ np.asarray(enc_params[name]["w"])
                          + np.asarray(enc_params[name]["b"]))
    return out


def delta_np(x: np.ndarray, window: int) -> np.ndarray:
    """In-graph delta semantics (utils/signal.py:59-80): sum (y[t+k]-y[t-k])/2k."""
    T = x.shape[-2]
    pad = np.concatenate([np.repeat(x[..., :1, :], window, axis=-2), x,
                          np.repeat(x[..., -1:, :], window, axis=-2)], axis=-2)
    out = np.zeros_like(x)
    for k in range(1, window + 1):
        out += (pad[..., window + k : window + k + T, :]
                - pad[..., window - k : window - k + T, :]) / (2.0 * k)
    return out


def append_delta_np(x: np.ndarray, window: int) -> np.ndarray:
    d = delta_np(x, window)
    a = delta_np(d, window)
    return np.concatenate([x, d, a], axis=-1)


def lstm_forward_np(p: dict, x: np.ndarray, mask: np.ndarray,
                    backwards: bool = False) -> np.ndarray:
    w_in = np.asarray(p["w_in"]); w_hid = np.asarray(p["w_hid"]); b = np.asarray(p["b"])
    B, T, D = x.shape
    H = w_hid.shape[0]
    peep = "w_cell_to_ingate" in p
    if backwards:
        x = x[:, ::-1]
        mask = mask[:, ::-1]
    x_proj = x.reshape(B * T, D) @ w_in
    x_proj = x_proj.reshape(B, T, 4 * H) + b
    cell = np.repeat(np.asarray(p["cell_init"]), B, 0)
    hid = np.repeat(np.asarray(p["hid_init"]), B, 0)
    outs = np.empty((B, T, H), dtype=x.dtype)
    for t in range(T):
        gates = x_proj[:, t] + hid @ w_hid
        i, f, c, o = np.split(gates, 4, axis=1)
        if peep:
            i = i + cell * np.asarray(p["w_cell_to_ingate"])
            f = f + cell * np.asarray(p["w_cell_to_forgetgate"])
        i, f, c = _sigmoid(i), _sigmoid(f), np.tanh(c)
        new_cell = f * cell + i * c
        if peep:
            o = o + new_cell * np.asarray(p["w_cell_to_outgate"])
        o = _sigmoid(o)
        new_hid = o * np.tanh(new_cell)
        m = mask[:, t : t + 1].astype(x.dtype)
        cell = m * new_cell + (1 - m) * cell
        hid = m * new_hid + (1 - m) * hid
        outs[:, t] = hid
    return outs[:, ::-1] if backwards else outs


def batch_norm_np(bn: dict, state: dict, x: np.ndarray, train: bool,
                  eps: float = 1e-4) -> np.ndarray:
    """ops/normalization.batch_norm_forward replica: normalize over all
    leading axes with minibatch stats (train) or the running averages."""
    feat = x.shape[-1]
    flat = x.reshape(-1, feat)
    if train:
        mean, var = flat.mean(axis=0), flat.var(axis=0)
    else:
        mean, var = np.asarray(state["mean"]), np.asarray(state["var"])
    y = ((flat - mean) / np.sqrt(var + eps) * np.asarray(bn["gamma"])
         + np.asarray(bn["beta"]))
    return y.reshape(x.shape)


def adenet_forward_np(params: dict, config, inputs, mask,
                      train: bool = False) -> np.ndarray:
    """NumPy replica of models/adenet.adenet_forward (no dropout; ``train``
    selects batch-norm minibatch statistics).  The last-step head reads
    index -1, as the reference's SliceLayer(-1) does: with a ragged mask a
    summed BLSTM's backward half contributes its learned initial state
    there."""
    B, T = inputs[0].shape[:2]
    mask = np.asarray(mask, np.float32)
    stream_outs = []
    for i, spec in enumerate(config.streams):
        sp = params["streams"][spec.name]
        x = np.asarray(inputs[i], np.float32)
        if spec.encoder_shapes:
            flat = x.reshape(B * T, spec.input_dim)
            x = encoder_forward_np(sp["encoder"], flat,
                                   spec.encoder_nonlinearities).reshape(B, T, -1)
        if spec.use_batchnorm:
            x = batch_norm_np(sp["bn"], sp["bn_state"], x, train)
        if spec.use_delta:
            x = append_delta_np(x, config.window)
        if spec.use_lstm:
            x = lstm_forward_np(sp["lstm"], x, mask)
        stream_outs.append(x)

    if config.fusiontype == "sum":
        fused = np.sum(stream_outs, axis=0)
    elif config.fusiontype == "concat":
        fused = np.concatenate(stream_outs, axis=-1)
    elif config.fusiontype == "adasum":
        fused = sum(np.asarray(params["adasum"][f"adacoeff{i}"]) * s
                    for i, s in enumerate(stream_outs))
    else:
        raise ValueError(config.fusiontype)

    agg = fused
    for lp in params["aggregator"]:
        if "bwd" in lp:
            agg = (lstm_forward_np(lp["fwd"], agg, mask)
                   + lstm_forward_np(lp["bwd"], agg, mask, backwards=True))
        else:
            agg = lstm_forward_np(lp["fwd"], agg, mask)

    w = np.asarray(params["output"]["w"]); b = np.asarray(params["output"]["b"])
    if config.output_mode == "per_step":
        logits = agg.reshape(B * T, -1) @ w + b
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        return (e / e.sum(axis=1, keepdims=True)).reshape(B, T, -1)
    logits = agg[:, -1, :] @ w + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Conv-AE (tied-weight decoder) NumPy replica — models/convae.py.
# Encoder convs are valid cross-correlations; the tied deconvs are their
# exact linear transposes, i.e. FULL convolutions with the same kernels
# (what F.conv_transpose2d with the encoder's kernel computes at stride 1).
# Dropout never applied; BN uses batch statistics in both modes (matching
# models/convae._bn, which deliberately has no running averages).
# ---------------------------------------------------------------------------

def _scaled_tanh_np(x, a=0.5, b=2.4):
    return b * np.tanh(a * x)


def _conv_valid_np(x, w, b):
    """x (B, I, H, W) cross-correlated with w (O, I, kh, kw), valid —
    sliding windows + einsum (no framework anywhere)."""
    from numpy.lib.stride_tricks import sliding_window_view

    kh, kw = w.shape[2], w.shape[3]
    win = sliding_window_view(x, (kh, kw), axis=(2, 3))  # (B,I,H',W',kh,kw)
    out = np.einsum("bihwkl,oikl->bohw", win, w, optimize=True)
    return (out + b[None, :, None, None]).astype(np.float32)


def _deconv_full_np(h, w, b, crop_h=0):
    """Transpose of :func:`_conv_valid_np`: FULL convolution mapping O->I
    (full conv == valid cross-correlation of the zero-padded input with the
    spatially flipped kernel)."""
    from numpy.lib.stride_tricks import sliding_window_view

    kh, kw = w.shape[2], w.shape[3]
    hp = np.pad(h, ((0, 0), (0, 0), (kh - 1, kh - 1), (kw - 1, kw - 1)))
    wf = w[:, :, ::-1, ::-1]
    win = sliding_window_view(hp, (kh, kw), axis=(2, 3))  # (B,O,H+kh-1,...)
    out = np.einsum("bohwkl,oikl->bihw", win, wf, optimize=True)
    out = (out + b[None, :, None, None]).astype(np.float32)
    if crop_h:
        out = out[:, :, crop_h:-crop_h, :]
    return out


def _maxpool_np(x, pad_h=0):
    if pad_h:
        pad = np.full((x.shape[0], x.shape[1], pad_h, x.shape[3]), -np.inf,
                      x.dtype)
        x = np.concatenate([pad, x, pad], axis=2)
    B, C, H, W = x.shape
    return x[:, :, : H // 2 * 2, : W // 2 * 2].reshape(
        B, C, H // 2, 2, W // 2, 2).max(axis=(3, 5))


def _bn_np(x, p, eps=1e-4):
    axes = tuple(i for i in range(x.ndim) if i != 1) if x.ndim > 2 else (0,)
    mean = x.mean(axes, keepdims=True)
    var = x.var(axes, keepdims=True)
    shape = [1] * x.ndim
    shape[-1 if x.ndim == 2 else 1] = -1
    return ((x - mean) / np.sqrt(var + eps) * np.asarray(p["gamma"]).reshape(shape)
            + np.asarray(p["beta"]).reshape(shape))


def convae_forward_np(params: dict, config, x: np.ndarray) -> np.ndarray:
    """NumPy replica of models/convae.convae_forward (no dropout)."""
    p = {k: torch_tree_to_np(v) for k, v in params.items()}
    B = x.shape[0]
    f1, f2, f3 = config.filters
    ch, cw = config.conv_out_shape()
    h = np.asarray(x, np.float32).reshape(B, 1, *config.image_shape)

    h = _conv_valid_np(h, p["conv1"]["w"], p["conv1"]["b"])
    if config.use_batchnorm:
        h = _bn_np(h, p["bn_conv1"])
    h = _scaled_tanh_np(h)
    h = _maxpool_np(h)
    h = _conv_valid_np(h, p["conv3"]["w"], p["conv3"]["b"])
    if config.use_batchnorm:
        h = _bn_np(h, p["bn_conv3"])
    h = _scaled_tanh_np(h)
    h = _maxpool_np(h, pad_h=1)
    h = _conv_valid_np(h, p["conv5"]["w"], p["conv5"]["b"])
    if config.use_batchnorm:
        h = _bn_np(h, p["bn_conv5"])
    h = _scaled_tanh_np(h)
    h = h.reshape(B, -1)
    h = h @ p["dense7"]["w"] + p["dense7"]["b"]
    if config.use_batchnorm:
        h = _bn_np(h, p["bn_dense7"])
    h = _scaled_tanh_np(h)
    code = h @ p["bottleneck"]["w"] + p["bottleneck"]["b"]

    h = code @ p["bottleneck"]["w"].T + p["dense8_b"]
    h = _scaled_tanh_np(h @ p["dense7"]["w"].T + p["dense9_b"])
    h = h.reshape(B, f3, ch, cw)
    h = _scaled_tanh_np(_deconv_full_np(h, p["conv5"]["w"], p["deconv11_b"]))
    h = np.repeat(np.repeat(h, 2, axis=2), 2, axis=3)
    h = _scaled_tanh_np(_deconv_full_np(h, p["conv3"]["w"], p["deconv13_b"]))
    h = np.repeat(np.repeat(h, 2, axis=2), 2, axis=3)
    h = _scaled_tanh_np(_deconv_full_np(h, p["conv1"]["w"], p["deconv15_b"],
                                        crop_h=1))
    return h.reshape(B, -1)


def torch_tree_to_np(tree):
    """A tree of the port's parameters as numpy arrays, the counterpart of
    ip_avsr_tpu/reference_impl.py's ``jax_tree_to_np``: dicts, lists and
    tuples keep their shape, tensors (on the CPU or the card) are detached
    and copied to the host, numpy arrays pass through."""
    if isinstance(tree, dict):
        return {k: torch_tree_to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(torch_tree_to_np(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return tree
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)
