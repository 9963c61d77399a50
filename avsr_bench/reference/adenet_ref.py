"""The plain reference of the benchmark's models: an AdeNet forward, its
loss, its gradients by autograd and Lasagne's Adam, in plain PyTorch.

It imports no part of the program (``ip_avsr_torch``) and neither JAX nor
the JAX package, and reads a configuration through the ``model`` object of
its file (``avsr_bench/configs/<name>.json``).  It follows the reference
project (lzuwei/ip-avsr, Lasagne): per stream an optional dense encoder,
the delta layer [x, delta, accel] over an edge-padded time axis with taps
1/(2 theta), dropout with the 1/(1-p) rescale, a masked LSTM whose masked
steps carry both states, whose gate pre-activation gradients are clipped to
+-5 (the peephole terms added after the clip), and a backwards layer that
runs on the flipped sequence; sum or adasum fusion; a BLSTM whose halves are
summed; a last-step head reading index -1 or a per-step softmax head whose
loss applies a second softmax.  The trimodal pipeline (diff images, the
zigzag DCT features, the normalisations) is worked out here too.

Everything runs in float32; matrix products follow the global TF32 switch,
which :func:`precision` sets (TF32 on is the control's precision).  Dropout
draws ``torch.rand`` of each dropout site's whole (B, T, D) shape, in the
program's order (stream order, then before each aggregator layer), from a
generator the caller seeds as the program's is seeded: the same calls give
the same masks.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

GRAD_CLIP = 5.0
PEEPHOLE_KEYS = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in TF32 (``tf32``) or in full float32 inside the
    block; the previous switches are restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- the trimodal pipeline ----------------------------------------------------

def zigzag(rows: int, cols: int) -> list:
    """Flat indices of a (rows, cols) plane in JPEG zigzag order: diagonal
    r + c = d walked with r rising for odd d and falling for even d."""
    out = []
    for d in range(rows + cols - 1):
        rs = range(max(0, d - cols + 1), min(d, rows - 1) + 1)
        for r in (rs if d % 2 else reversed(rs)):
            out.append(r * cols + (d - r))
    return out


def dct_basis(image_shape, n_coeff: int, device) -> torch.Tensor:
    """(H*W, n_coeff) float32: columns k of the orthonormal DCT-II matrix
    over the flattened pixels, for the zigzag coefficients 1..n_coeff (the
    DC term skipped), built in float64."""
    N = int(image_shape[0]) * int(image_shape[1])
    k = np.asarray(zigzag(*image_shape)[1: n_coeff + 1], np.float64)
    n = np.arange(N, dtype=np.float64)[:, None]
    scale = np.where(k == 0, math.sqrt(1.0 / N), math.sqrt(2.0 / N))
    basis = scale * np.cos(math.pi * (2.0 * n + 1.0) * k[None, :] / (2.0 * N))
    return torch.as_tensor(basis, dtype=torch.float32, device=device)


def _samplewise(x, eps=1e-8):
    c = x - x.mean(dim=-1, keepdim=True)
    return c / (c.pow(2).mean(dim=-1, keepdim=True).sqrt() + eps)


def trimodal_streams(raw_u8: torch.Tensor, mask: torch.Tensor, image_shape,
                     n_coeff: int) -> list:
    """uint8 (B, T, H*W) pixels -> [raw, dct, diff] streams: each frame's
    pixels normalised to zero mean and unit std, the DCT features with each
    utterance's mean valid frame subtracted, and the normalised temporal
    difference (its first step repeated at t = 0); every padded frame 0."""
    raw = raw_u8.to(torch.float32)
    B, T, D = raw.shape
    m = mask[..., None]
    d = raw[:, 1:] - raw[:, :-1]
    diff = torch.cat([d[:, :1], d], dim=1)
    dct = (raw.reshape(B * T, D) @ dct_basis(image_shape, n_coeff, raw.device)).reshape(B, T, -1)
    mean = (dct * m).sum(dim=1, keepdim=True) / m.sum(dim=1, keepdim=True).clamp_min(1.0)
    dct = (dct - mean) * m
    return [_samplewise(raw * m) * m, dct, _samplewise(diff * m) * m]


# -- the model ----------------------------------------------------------------

class _Clip(torch.autograd.Function):
    """Identity whose gradient is clipped elementwise (Theano's grad_clip)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-GRAD_CLIP, GRAD_CLIP)


def _encoder(enc: dict, x, nonlins):
    names = sorted(enc, key=lambda n: {"fc1": 0, "fc2": 1, "fc3": 2, "bottleneck": 3}.get(
        n, 3 + int("".join(c for c in n if c.isdigit()) or 0)))
    for name, nl in zip(names, nonlins):
        x = x @ enc[name]["w"] + enc[name]["b"]
        if nl in ("sigmoid", "sigm"):
            x = torch.sigmoid(x)
        elif nl in ("rectify", "relu"):
            x = torch.relu(x)
        elif nl == "tanh":
            x = torch.tanh(x)
        elif nl != "linear":
            raise ValueError(f"nonlinearity {nl!r}")
    return x


def _delta(x, W: int):
    T = x.shape[1]
    pad = torch.cat([x[:, :1].expand(-1, W, -1), x, x[:, -1:].expand(-1, W, -1)], dim=1)
    out = torch.zeros_like(x)
    for k in range(1, W + 1):
        out = out + (pad[:, W + k: W + k + T] - pad[:, W - k: W - k + T]) / (2.0 * k)
    return out


def _append_delta(x, W: int):
    d = _delta(x, W)
    return torch.cat([x, d, _delta(d, W)], dim=-1)


def _dropout(x, p: float, gen):
    if gen is None or p <= 0.0:
        return x
    keep = 1.0 - p
    draw = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype)
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def lstm(p: dict, x, mask, backwards=False):
    """Masked LSTM over (B, T, D) -> (B, T, H): gates (in, forget, cell,
    out) stacked in W_in (D, 4H), W_hid (H, 4H), b (4H,)."""
    if backwards:
        x, mask = x.flip(1), mask.flip(1)
    B, T, _ = x.shape
    H = p["w_hid"].shape[0]
    xp = x @ p["w_in"] + p["b"]
    cell = p["cell_init"].expand(B, H)
    hid = p["hid_init"].expand(B, H)
    peep = PEEPHOLE_KEYS[0] in p
    outs = []
    for t in range(T):
        g = _Clip.apply(xp[:, t] + hid @ p["w_hid"])
        zi, zf, zc, zo = g[:, :H], g[:, H: 2 * H], g[:, 2 * H: 3 * H], g[:, 3 * H:]
        if peep:
            zi = zi + cell * p["w_cell_to_ingate"]
            zf = zf + cell * p["w_cell_to_forgetgate"]
        c = torch.sigmoid(zf) * cell + torch.sigmoid(zi) * torch.tanh(zc)
        if peep:
            zo = zo + c * p["w_cell_to_outgate"]
        h = torch.sigmoid(zo) * torch.tanh(c)
        m = mask[:, t: t + 1]
        cell = m * c + (1.0 - m) * cell
        hid = m * h + (1.0 - m) * hid
        outs.append(hid)
    out = torch.stack(outs, dim=1)
    return out.flip(1) if backwards else out


def forward(model: dict, params: dict, streams: list, mask, gen=None):
    """Probabilities: (B, C) of a last-step head, (B, T, C) of a per-step
    one.  ``gen`` (a seeded generator) turns dropout on."""
    feats = []
    for spec, x in zip(model["streams"], streams):
        sp = params["streams"][spec["name"]]
        B, T, D = x.shape
        if spec.get("encoder_shapes"):
            x = _encoder(sp["encoder"], x.reshape(B * T, D),
                         spec["encoder_nonlinearities"]).reshape(B, T, -1)
        if spec.get("use_delta", True):
            x = _append_delta(x, int(model["window"]))
        feats.append(x)
    feats = [_dropout(x, float(s.get("dropout", 0.0)), gen)
             for x, s in zip(feats, model["streams"])]
    outs = [lstm(params["streams"][s["name"]]["lstm"], x, mask) if s.get("use_lstm", True)
            else x for x, s in zip(feats, model["streams"])]
    if model["fusiontype"] == "sum":
        agg = sum(outs[1:], outs[0])
    elif model["fusiontype"] == "adasum":
        agg = sum(o * params["adasum"][f"adacoeff{i}"] for i, o in enumerate(outs))
    elif model["fusiontype"] == "concat":
        agg = torch.cat(outs, dim=-1)
    else:
        raise ValueError(model["fusiontype"])
    for layer in params["aggregator"]:
        agg = _dropout(agg, float(model.get("agg_dropout", 0.0)), gen)
        out = lstm(layer["fwd"], agg, mask)
        if "bwd" in layer:
            out = out + lstm(layer["bwd"], agg, mask, backwards=True)
        agg = out
    w, b = params["output"]["w"], params["output"]["b"]
    if model["output_mode"] == "last_step":
        return torch.softmax(agg[:, -1] @ w + b, dim=-1)
    return torch.softmax(agg @ w + b, dim=-1)


def loss(model: dict, probs, y, mask):
    """A last-step head: the mean -log p[y] over rows with a valid frame.
    A per-step head: the masked mean over valid frames of the cross entropy
    of softmax(probabilities), the reference's double softmax."""
    if probs.dim() == 2:
        w = (mask.sum(dim=1) > 0).to(probs.dtype)
        p = probs.gather(1, y[:, None])[:, 0]
        p = torch.where(w > 0, p, torch.ones_like(p))
        return -(w * p.log()).sum() / w.sum().clamp_min(1.0)
    B, T, C = probs.shape
    logp = torch.log_softmax(probs.reshape(B * T, C), dim=1)
    nll = -logp.gather(1, y[:, None].expand(B, T).reshape(B * T, 1))[:, 0]
    m = mask.reshape(B * T)
    return (m * nll).sum() / m.sum()


def leaves(tree, path=""):
    """``(path, tensor)`` pairs of a parameter tree, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def train_steps(model: dict, params: dict, batches, lr: float, gens, beta1=0.9, beta2=0.999,
                eps=1e-8):
    """Lasagne Adam over ``batches`` ((streams, y, mask) each, on the card),
    step k drawing its dropout from ``gens[k]`` (or none).  Returns
    ``(losses, first_grads, params)``: each step's loss, the first step's
    gradient by leaf path, and the parameters after the last step."""
    paths = [p for p, _ in leaves(params)]
    cur = [t.detach().clone() for _, t in leaves(params)]
    m = [torch.zeros_like(t) for t in cur]
    v = [torch.zeros_like(t) for t in cur]
    losses, first = [], None
    for k, (streams, y, mask) in enumerate(batches):
        tracked = [t.requires_grad_(True) for t in cur]
        tree = _rebuild(params, iter(tracked))
        value = loss(model, forward(model, tree, streams, mask, gens[k]), y, mask)
        grads = torch.autograd.grad(value, tracked)
        losses.append(float(value.detach()))
        if first is None:
            first = dict(zip(paths, (g.detach() for g in grads)))
        t = k + 1
        a_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = beta1 * m[i] + (1.0 - beta1) * g
                v[i] = beta2 * v[i] + (1.0 - beta2) * g * g
                cur[i] = cur[i].detach() - a_t * m[i] / (v[i].sqrt() + eps)
    return losses, first, dict(zip(paths, cur))
