"""The visual front end of a ResNet lipreader: a 3-D convolution stem and a
2-D residual trunk applied to every frame (Stafylakis & Tzimiropoulos,
"Combining Residual Networks with LSTMs for Lipreading", Interspeech 2017,
arXiv:1703.04105, section 3).

(B, T, H, W) uint8 mouth-ROI frames are cast to float32 on the device and
normalised as ``(x / 255 - PIXEL_MEAN) / PIXEL_STD``, LRW's pixel
statistics as public re-implementations use them; then

* the stem: one 3-D convolution of ``widths[0]`` kernels of 5 x 7 x 7
  (time x height x width), stride (1, 2, 2), padding (2, 3, 3), no bias,
  batch norm, ReLU and a 3-D max-pool of (1, 3, 3), stride (1, 2, 2),
  padding (0, 1, 1);
* the trunk, on the B*T frames: four stages of BasicBlocks (two 3 x 3
  convolutions with batch norm, ReLU after the first and after the
  residual sum), ``BLOCKS`` blocks a stage at ``widths`` channels, the
  first block of every stage after the first at stride 2; a block whose
  shape changes takes a 1 x 1 projection shortcut with batch norm;
* the global average pool: (B, T, widths[-1]) features.

At ``widths`` (64, 128, 256, 512) the trunk is ResNet-34's.  Convolutions, batch norm and pooling are torch's (cuDNN on
the card), as the dense encoders are cuBLAS's.

Batch norm (eps 1e-5, momentum 0.1, PyTorch's) keeps its running mean and
variance in a state tree beside the parameters.  A training forward
normalises with the batch's statistics (over the batch, time and space)
and returns the running statistics moved towards them (the variance's
unbiased form, as ``torch.nn.BatchNorm`` keeps it); an evaluation forward
normalises with the running statistics and returns the state as it is.

The stem's temporal window and the batch's statistics see every frame,
padded ones included: the front end assumes utterances of one length (LRW
clips are all 29 frames), where a mask changes nothing.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
STEM_KERNEL = (5, 7, 7)
STEM_STRIDE = (1, 2, 2)
STEM_PADDING = (2, 3, 3)
POOL_KERNEL = (1, 3, 3)
POOL_STRIDE = (1, 2, 2)
POOL_PADDING = (0, 1, 1)
BLOCKS = (3, 4, 6, 3)
PIXEL_MEAN = 0.421
PIXEL_STD = 0.165


def _he_uniform(generator, shape) -> torch.Tensor:
    """Uniform within the He limit sqrt(6 / fan_in), fan_in the kernel's
    input channels times its taps."""
    limit = math.sqrt(6.0 / math.prod(shape[1:]))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


def _bn(channels: int) -> tuple:
    return ({"gamma": torch.ones(channels), "beta": torch.zeros(channels)},
            {"mean": torch.zeros(channels), "var": torch.ones(channels)})


def stage_strides() -> list:
    """Each block's stride, stage by stage: 2 for the first block of every
    stage after the first, else 1."""
    return [[2 if (i > 0 and j == 0) else 1 for j in range(n)] for i, n in enumerate(BLOCKS)]


def init_resnet_params(generator, widths) -> tuple:
    """``(params, state)`` of the front end on the CPU: convolution kernels
    drawn uniform within their He limits in the order they run, batch norm
    at gamma 1, beta 0, running mean 0 and variance 1.

    ``params``: ``{"stem": {"conv", "bn"}, "layers": [[block, ...], ...]}``,
    a block ``{"conv1", "bn1", "conv2", "bn2"}`` and, where its shape
    changes, ``"down_conv"`` and ``"down_bn"``; ``state`` mirrors every
    ``bn`` with its ``{"mean", "var"}``."""
    widths = [int(w) for w in widths]
    if len(widths) != len(BLOCKS):
        raise ValueError(f"resnet front end: {len(widths)} widths for {len(BLOCKS)} stages")
    bn, bn_state = _bn(widths[0])
    params = {"stem": {"conv": _he_uniform(generator, (widths[0], 1, *STEM_KERNEL)), "bn": bn},
              "layers": []}
    state = {"stem": {"bn": bn_state}, "layers": []}
    cin = widths[0]
    for width, strides in zip(widths, stage_strides()):
        stage, stage_state = [], []
        for stride in strides:
            p, s = {}, {}
            p["conv1"] = _he_uniform(generator, (width, cin, 3, 3))
            p["bn1"], s["bn1"] = _bn(width)
            p["conv2"] = _he_uniform(generator, (width, width, 3, 3))
            p["bn2"], s["bn2"] = _bn(width)
            if stride != 1 or cin != width:
                p["down_conv"] = _he_uniform(generator, (width, cin, 1, 1))
                p["down_bn"], s["down_bn"] = _bn(width)
            stage.append(p)
            stage_state.append(s)
            cin = width
        params["layers"].append(stage)
        state["layers"].append(stage_state)
    return params, state


def _batch_norm(x, p, s, train: bool):
    """cuDNN's batch norm -> ``(y, new_state)``: in training the running
    statistics are updated in detached copies, so ``s`` is left as it was
    (a tracked statistic gets a zero gradient)."""
    if not train:
        return F.batch_norm(x, s["mean"].detach(), s["var"].detach(), p["gamma"], p["beta"],
                            False, 0.0, BN_EPS), s
    new = {"mean": s["mean"].detach().clone(), "var": s["var"].detach().clone()}
    y = F.batch_norm(x, new["mean"], new["var"], p["gamma"], p["beta"], True, BN_MOMENTUM,
                     BN_EPS)
    return y, new


def _block(x, p, s, stride: int, train: bool):
    ns = {}
    out = F.conv2d(x, p["conv1"], stride=stride, padding=1)
    out, ns["bn1"] = _batch_norm(out, p["bn1"], s["bn1"], train)
    out = F.relu_(out)
    out = F.conv2d(out, p["conv2"], padding=1)
    out, ns["bn2"] = _batch_norm(out, p["bn2"], s["bn2"], train)
    if "down_conv" in p:
        identity, ns["down_bn"] = _batch_norm(F.conv2d(x, p["down_conv"], stride=stride),
                                              p["down_bn"], s["down_bn"], train)
    else:
        identity = x
    return F.relu_(out.add_(identity)), ns


def resnet_forward(params: dict, state: dict, frames: torch.Tensor, train: bool = False) -> tuple:
    """``frames`` (B, T, H, W), uint8 or float pixel values in 0..255 ->
    ``((B, T, C) features, new state)``; ``train`` as in the module's
    docstring."""
    B, T, H, W = frames.shape
    x = (frames.to(torch.float32) * (1.0 / 255.0) - PIXEL_MEAN) * (1.0 / PIXEL_STD)
    new = {"stem": {}, "layers": []}
    x = F.conv3d(x.reshape(B, 1, T, H, W), params["stem"]["conv"], stride=STEM_STRIDE,
                 padding=STEM_PADDING)
    x, new["stem"]["bn"] = _batch_norm(x, params["stem"]["bn"], state["stem"]["bn"], train)
    x = F.max_pool3d(F.relu_(x), POOL_KERNEL, POOL_STRIDE, POOL_PADDING)
    C, h, w = x.shape[1], x.shape[3], x.shape[4]
    x = x.transpose(1, 2).reshape(B * T, C, h, w)
    for stage, stage_state, strides in zip(params["layers"], state["layers"], stage_strides()):
        new_stage = []
        for p, s, stride in zip(stage, stage_state, strides):
            x, ns = _block(x, p, s, stride, train)
            new_stage.append(ns)
        new["layers"].append(new_stage)
    return x.mean(dim=(2, 3)).reshape(B, T, -1), new
