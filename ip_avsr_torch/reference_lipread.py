"""The plain reference of the ResNet + BLSTM word lipreader: its forward,
its per-frame loss, its gradients by autograd and Lasagne's Adam, in plain
PyTorch and float32.

It imports nothing of the program (no module of ``ip_avsr_torch``, so no
kernel of it) and neither JAX nor the JAX package, and reads a
configuration through a ``model`` object of plain values (the ``model`` of
``avsr_bench/configs/resnet34-blstm-lrw.json``, or ``dataclasses.asdict``
of the program's ``AdeNetConfig``).  The parameters are the program's tree
(``models/adenet.init_adenet_params``): the front end's layers are read
from its keys.

The architecture is Stafylakis & Tzimiropoulos, "Combining Residual
Networks with LSTMs for Lipreading" (Interspeech 2017, arXiv:1703.04105,
section 3): grayscale mouth-ROI frames, a 3-D convolution of 5 x 7 x 7
kernels with batch norm, ReLU and a 3-D max-pool, a ResNet-34 of
BasicBlocks on every frame down to one feature vector a frame, a two-layer
BLSTM and a softmax over the words.  Departures from the paper, and sizes
it does not give:

* the LSTM is the Lasagne cell of the rest of this repository: a learned
  initial state, masked steps carrying both states, the gate
  pre-activations' gradients clipped to +-5 (Theano's ``grad_clip``); the
  paper's is Torch's LSTM;
* 256 cells a direction, the two halves concatenated, so the second layer
  and the classifier read 512 features;
* the stem's stride (1, 2, 2) and padding (2, 3, 3), no bias; the pool's
  kernel (1, 3, 3), stride (1, 2, 2), padding (0, 1, 1): those of public
  re-implementations;
* batch norm with PyTorch's eps 1e-5 and momentum 0.1, the running
  variance moved by the batch's unbiased variance;
* pixels normalised as (x / 255 - 0.421) / 0.165, LRW's pixel statistics
  as public re-implementations use them;
* a softmax at every frame, the loss the masked mean over frames of the
  cross entropy of the softmax of those probabilities (the repository's
  ``temporal_softmax_loss``, a double softmax); the paper trains without
  word boundaries, on whole clips, as here.

Batch norm is written out (mean, then the variance of the deviations from
it) rather than taken from ``torch.nn.functional.batch_norm``, which the
program runs.  Convolutions and matrix products go through :func:`conv`
and :func:`matmul`; they follow the global TF32 switches, which
:func:`precision` sets (TF32 on is the control's precision).  Every
frame, padded or not, enters the stem and the batch statistics.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

GRAD_CLIP = 5.0
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
STEM_STRIDE = (1, 2, 2)
STEM_PADDING = (2, 3, 3)
POOL = dict(kernel_size=(1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1))
PIXEL_MEAN = 0.421
PIXEL_STD = 0.165


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products and convolutions in TF32 (``tf32``) or in full
    float32 inside the block; the previous switches are restored after
    it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def conv(x, w, stride=1, padding=0):
    """A convolution without bias, 3-D for a 5-D kernel, else 2-D."""
    fn = F.conv3d if w.dim() == 5 else F.conv2d
    return fn(x, w, stride=stride, padding=padding)


def matmul(a, b):
    return a @ b


# -- the front end ------------------------------------------------------------

def batch_norm(x, p: dict, s: dict, train: bool):
    """Over every dim but the channels (dim 1) -> ``(y, new state)``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        dims = [0] + list(range(2, x.dim()))
        n = x.numel() // x.shape[1]
        mean = x.mean(dim=dims)
        d = x - mean.view(shape)
        var = (d * d).mean(dim=dims)
        new = {"mean": ((1.0 - BN_MOMENTUM) * s["mean"] + BN_MOMENTUM * mean).detach(),
               "var": ((1.0 - BN_MOMENTUM) * s["var"]
                       + BN_MOMENTUM * var * (n / (n - 1.0))).detach()}
    else:
        d, var, new = x - s["mean"].view(shape), s["var"], s
    y = d * (p["gamma"] / torch.sqrt(var + BN_EPS)).view(shape) + p["beta"].view(shape)
    return y, new


def basic_block(x, p: dict, s: dict, stride: int, train: bool):
    new = {}
    out, new["bn1"] = batch_norm(conv(x, p["conv1"], stride, 1), p["bn1"], s["bn1"], train)
    out, new["bn2"] = batch_norm(conv(torch.relu(out), p["conv2"], 1, 1), p["bn2"],
                                 s["bn2"], train)
    identity = x
    if "down_conv" in p:
        identity, new["down_bn"] = batch_norm(conv(x, p["down_conv"], stride, 0),
                                              p["down_bn"], s["down_bn"], train)
    return torch.relu(out + identity), new


def frontend(p: dict, s: dict, frames, train: bool):
    """(B, T, H, W) pixels -> ``((B, T, C) features, new state)``: the
    stem on the clip, the residual stages on each frame (the first block
    of every stage after the first at stride 2), the average over space."""
    B, T, H, W = frames.shape
    x = (frames.to(torch.float32) / 255.0 - PIXEL_MEAN) / PIXEL_STD
    new = {"stem": {}, "layers": []}
    x = conv(x.reshape(B, 1, T, H, W), p["stem"]["conv"], STEM_STRIDE, STEM_PADDING)
    x, new["stem"]["bn"] = batch_norm(x, p["stem"]["bn"], s["stem"]["bn"], train)
    x = F.max_pool3d(torch.relu(x), **POOL)
    x = x.permute(0, 2, 1, 3, 4).reshape(B * T, x.shape[1], x.shape[3], x.shape[4])
    for i, (stage, stage_state) in enumerate(zip(p["layers"], s["layers"])):
        new["layers"].append([])
        for j, (bp, bs) in enumerate(zip(stage, stage_state)):
            x, ns = basic_block(x, bp, bs, 2 if (i > 0 and j == 0) else 1, train)
            new["layers"][-1].append(ns)
    return x.mean(dim=(2, 3)).reshape(B, T, -1), new


# -- the back end ---------------------------------------------------------------

class _Clip(torch.autograd.Function):
    """Identity whose gradient is clipped elementwise (Theano's grad_clip)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.clamp(-GRAD_CLIP, GRAD_CLIP)


def lstm(p: dict, x, mask, backwards=False):
    """Masked LSTM over (B, T, D) -> (B, T, H): gates (in, forget, cell,
    out) stacked in W_in (D, 4H), W_hid (H, 4H), b (4H,); masked steps
    carry both states; a backwards layer runs on the flipped sequence."""
    if backwards:
        x, mask = x.flip(1), mask.flip(1)
    B, T, D = x.shape
    H = p["w_hid"].shape[0]
    xp = matmul(x.reshape(B * T, D), p["w_in"]).reshape(B, T, 4 * H) + p["b"]
    cell = p["cell_init"].expand(B, H)
    hid = p["hid_init"].expand(B, H)
    outs = []
    for t in range(T):
        g = _Clip.apply(xp[:, t] + matmul(hid, p["w_hid"]))
        zi, zf, zc, zo = g[:, :H], g[:, H: 2 * H], g[:, 2 * H: 3 * H], g[:, 3 * H:]
        c = torch.sigmoid(zf) * cell + torch.sigmoid(zi) * torch.tanh(zc)
        h = torch.sigmoid(zo) * torch.tanh(c)
        m = mask[:, t: t + 1]
        cell = m * c + (1.0 - m) * cell
        hid = m * h + (1.0 - m) * hid
        outs.append(hid)
    out = torch.stack(outs, dim=1)
    return out.flip(1) if backwards else out


def forward(model: dict, params: dict, frames, mask, train: bool = False):
    """(B, T, C) per-frame probabilities and the front end's new state:
    ``(probs, {stream name: state})``.  ``train`` normalises with the
    batch's statistics."""
    (spec,) = model["streams"]
    sp = params["streams"][spec["name"]]
    x, state = frontend(sp["frontend"], sp["frontend_state"], frames, train)
    mask = mask.to(torch.float32)
    for layer in params["aggregator"]:
        f = lstm(layer["fwd"], x, mask)
        if "bwd" not in layer:
            x = f
            continue
        b = lstm(layer["bwd"], x, mask, backwards=True)
        x = torch.cat([f, b], dim=-1) if model.get("agg_merge") == "concat" else f + b
    B, T, D = x.shape
    logits = matmul(x.reshape(B * T, D), params["output"]["w"]) + params["output"]["b"]
    return torch.softmax(logits, dim=-1).reshape(B, T, -1), {spec["name"]: state}


def loss(probs, y, mask):
    """The masked mean over valid frames of the cross entropy of
    softmax(probabilities) against each utterance's label y (B,)."""
    B, T, C = probs.shape
    logp = torch.log_softmax(probs.reshape(B * T, C), dim=1)
    nll = -logp.gather(1, y[:, None].expand(B, T).reshape(B * T, 1))[:, 0]
    m = mask.to(probs.dtype).reshape(B * T)
    return (m * nll).sum() / m.sum()


# -- training -------------------------------------------------------------------

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


def is_state(path: str) -> bool:
    """Whether the leaf at ``path`` is a running statistic (no parameter)."""
    return "/frontend_state/" in path


def train_steps(model: dict, params: dict, batches, lr: float, beta1=0.9, beta2=0.999,
                eps=1e-8):
    """Lasagne Adam over ``batches`` ((frames, y, mask) each), each step's
    moved running statistics written after its update.  Returns
    ``(losses, first_grads, params)``: each step's loss, the first step's
    gradient by leaf path (zero for the running statistics) and every leaf
    after the last step, by path."""
    paths = [p for p, _ in leaves(params)]
    index = {p: i for i, p in enumerate(paths)}
    cur = [t.detach().clone() for _, t in leaves(params)]
    trained = [i for i, p in enumerate(paths) if not is_state(p)]
    m = [torch.zeros_like(t) for t in cur]
    v = [torch.zeros_like(t) for t in cur]
    losses, first = [], None
    for k, (frames, y, mask) in enumerate(batches):
        for i in trained:
            cur[i].requires_grad_(True)
        tree = _rebuild(params, iter(cur))
        probs, states = forward(model, tree, frames, mask, train=True)
        value = loss(probs, y, mask)
        got = torch.autograd.grad(value, [cur[i] for i in trained])
        grads = [torch.zeros_like(t) for t in cur]
        for i, g in zip(trained, got):
            grads[i] = g.detach()
        del probs, tree, got
        losses.append(float(value.detach()))
        if first is None:
            first = dict(zip(paths, grads))
        t = k + 1
        a_t = lr * math.sqrt(1.0 - beta2 ** t) / (1.0 - beta1 ** t)
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = beta1 * m[i] + (1.0 - beta1) * g
                v[i] = beta2 * v[i] + (1.0 - beta2) * g * g
                cur[i] = cur[i].detach() - a_t * m[i] / (v[i].sqrt() + eps)
            for name, state in states.items():
                for path, stat in leaves(state, f"streams/{name}/frontend_state"):
                    cur[index[path]] = stat.detach().clone()
    return losses, first, dict(zip(paths, cur))
