"""The operations and bytes of convolutions, for ``conv_roofline.train`` and
``lipread_mfu.train``: of one traced call, from its shapes (a profiled
window with shapes, :func:`conv_records`), and of a conv front end's
forward, from a configuration's widths (:func:`frontend_convs`).

A convolution here has no bias and one group.  Its operations are two a
multiply-add: 2 x the output's values x the kernel's values a filter (input
channels x taps).  Its bytes are float32 values, each input read once and
each output written once: forward x, w and y; the backward's data
gradient reads dy and w and writes dx, its weight gradient reads dy and x
and writes dw, and the two in one call read dy, x and w once.
"""

from __future__ import annotations

import math

from avsr_bench.harness import yardstick
from avsr_bench.harness.trace import _device_us

FORWARD_OP = "aten::convolution"
BACKWARD_OP = "aten::convolution_backward"
BYTES = 4
# BasicBlocks a stage of a "resnet" front end (ResNet-34's)
BLOCKS = (3, 4, 6, 3)


def out_size(size: int, kernel: int, stride: int, padding: int, dilation: int = 1) -> int:
    return (size + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def forward_cost(x_shape, w_shape, y_shape) -> tuple:
    """(bytes, operations) of a forward convolution: x (N, Ci, ...), w (Co,
    Ci, taps...), y (N, Co, ...)."""
    flops = 2 * math.prod(y_shape) * math.prod(w_shape[1:])
    return BYTES * (math.prod(x_shape) + math.prod(w_shape) + math.prod(y_shape)), flops


def backward_cost(dy_shape, x_shape, w_shape, data: bool = True, weight: bool = True) -> tuple:
    """(bytes, operations) of one backward call that computes the data
    gradient (``data``), the weight gradient (``weight``) or both."""
    if not (data or weight):
        return 0, 0
    products = 2 * math.prod(dy_shape) * math.prod(w_shape[1:])
    x, w = math.prod(x_shape), math.prod(w_shape)
    # dy read once; the data gradient reads w and writes dx, the weight
    # gradient reads x and writes dw
    nbytes = math.prod(dy_shape) + (w + x if data else 0) + (x + w if weight else 0)
    return BYTES * nbytes, products * (int(data) + int(weight))


def conv_records(prof) -> list:
    """Every convolution call of a profile taken with shapes: ``(bytes,
    operations, device seconds)``, the forward's from its input, kernel,
    stride, padding and dilation, the backward's from its gradient, input,
    kernel and output mask.  A call whose arguments the trace does not
    hold gives None in its place."""
    out = []
    for e in prof.events():
        if e.name not in (FORWARD_OP, BACKWARD_OP):
            continue
        shapes = e.input_shapes or []
        args = getattr(e, "concrete_inputs", None) or []
        cost = None
        try:
            if e.name == FORWARD_OP:
                x, w = shapes[0], shapes[1]
                stride, padding, dilation = args[3], args[4], args[5]
                spatial = [out_size(n, k, s, p, d) for n, k, s, p, d in zip(
                    x[2:], w[2:], stride, padding, dilation)]
                cost = forward_cost(x, w, [x[0], w[0], *spatial])
            else:
                dy, x, w = shapes[0], shapes[1], shapes[2]
                mask = args[-1]
                cost = backward_cost(dy, x, w, bool(mask[0]), bool(mask[1]))
        except (IndexError, TypeError):
            cost = None
        out.append(None if cost is None else (*cost, _device_us(e) / 1e6))
    return out


def roofline(records: list):
    """Per cent: the calls' bound time (the larger of operations at the
    float32 peak and bytes at the HBM rate, call by call) over their traced
    device time; None without records, with a call the trace could not
    read, or without device time."""
    if not records or any(r is None for r in records):
        return None
    spent = sum(r[2] for r in records)
    if not spent:
        return None
    return 100.0 * sum(yardstick.bound(r[0], r[1]) for r in records) / spent


def frontend_convs(stream: dict, image_shape) -> list:
    """``(x, w, y)`` shapes of each convolution of one (H, W) =
    ``image_shape`` frame's forward through a ``"resnet"`` front end (N =
    1; the stem's time axis keeps its length, so one frame's share is a
    time step of it): the stem, then each BasicBlock's two 3 x 3
    convolutions and, where its shape changes, its 1 x 1 projection."""
    H, W = (int(v) for v in image_shape)
    widths = [int(w) for w in stream["frontend_widths"]]
    c = widths[0]
    h, w = out_size(H, 7, 2, 3), out_size(W, 7, 2, 3)
    convs = [((1, 1, 1, H, W), (c, 1, 5, 7, 7), (1, c, 1, h, w))]
    h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)  # the max-pool
    for i, (width, n) in enumerate(zip(widths, BLOCKS)):
        for j in range(n):
            s = 2 if (i > 0 and j == 0) else 1
            ho, wo = out_size(h, 3, s, 1), out_size(w, 3, s, 1)
            convs.append(((1, c, h, w), (width, c, 3, 3), (1, width, ho, wo)))
            convs.append(((1, width, ho, wo), (width, width, 3, 3), (1, width, ho, wo)))
            if s != 1 or c != width:
                convs.append(((1, c, h, w), (width, c, 1, 1), (1, width, ho, wo)))
            c, h, w = width, ho, wo
    return convs


def frontend_model_flops(config: dict):
    """One frame's forward operations of a configuration whose model is a
    conv front end and a BLSTM: the convolutions (:func:`frontend_convs`
    at the input's ``image_shape``), each aggregator LSTM's input
    projection and recurrent product, and the per-frame classifier; None
    for a model without a ``"resnet"`` front end."""
    model = config["model"]
    streams = [s for s in model["streams"] if s.get("frontend") == "resnet"]
    if len(streams) != 1 or len(model["streams"]) != 1:
        return None
    flops = sum(forward_cost(*c)[1] for c in frontend_convs(streams[0],
                                                            config["input"]["image_shape"]))
    d = int(streams[0]["frontend_widths"][-1])
    sizes = model.get("agg_sizes") or [int(model.get("agg_size") or model["lstm_size"])] * int(
        model["agg_layers"])
    bidir = bool(model.get("agg_bidirectional", True))
    for H in sizes:
        flops += (2 if bidir else 1) * (2 * d * 4 * H + 2 * H * 4 * H)
        d = 2 * H if bidir and model.get("agg_merge") == "concat" else H
    return flops + 2 * d * int(model["output_classes"])
