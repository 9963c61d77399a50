"""The benchmark's frozen yardsticks: the card's peaks, the bound of a piece of
work, and the operations and bytes of each configuration and kernel row.

Everything here is worked out from a configuration file's widths (the
``model`` object of ``avsr_bench/configs/<name>.json``) and from shapes; none
of it reads the program.  The peaks and :func:`bound` are copied from the
repository's ``chip_smoke.py`` (its ``HBM_BYTES_PER_S``, ``F32_FLOP_PER_S``
and ``bound``) and the LSTM rows' costs from its ``lstm_cost``,
``lstm_train_cost`` and ``lstm_bwd_cost``, so that later changes to that
script do not move the benchmark's numbers.
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
# FLOP/s outside the tensor cores (TF32 is off, so float32 work runs there).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# gate math per (row, step, unit): 3 sigmoids, 2 tanh, the cell and hidden
# update and the two mask blends, counted as 20 float32 operations; the
# backward's, with the clip and the carries, as 40; the peepholes' three
# multiply-adds 6 forward and 18 backward
LSTM_GATE_FLOPS = 20
LSTM_BWD_GATE_FLOPS = 40
PEEP_FLOPS = 6
PEEP_BWD_FLOPS = 18


def bound(nbytes: float, flops: float) -> float:
    """The least seconds the card could take for work of ``nbytes`` moved
    (each input read once, each output written once) and ``flops`` float32
    operations: the larger of the two times."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S)


def lstm_cost(B: int, T: int, H: int, peep: bool = False) -> tuple:
    """(bytes, operations) of one inference recurrence (rows 1 and 5):
    reads x_proj, mask, the initial state and W_hid, writes the hids."""
    nbytes = 4 * (B * T * 4 * H + B * T + 2 * B * H + B * T * H + (3 * H if peep else 0)
                  + H * 4 * H)
    flops = 2 * B * T * H * 4 * H + LSTM_GATE_FLOPS * B * T * H + (
        PEEP_FLOPS * B * T * H if peep else 0)
    return nbytes, flops


def lstm_train_cost(B: int, T: int, H: int, peep: bool = False) -> tuple:
    """Rows 3 and 6: the inference recurrence's traffic plus the residual
    cells and gates written."""
    nbytes, flops = lstm_cost(B, T, H, peep)
    return nbytes + 4 * (B * T * H + B * T * 4 * H), flops


def lstm_bwd_cost(B: int, T: int, H: int, peep: bool = False) -> tuple:
    """Rows 4 and 7: reads g_out, gates, cells, cells_prev, mask and W_hid,
    writes dgates and the initial state's gradients; with peepholes also
    the three vectors and their gradients."""
    nbytes = 4 * (3 * B * T * H + B * T * 4 * H + B * T + B * T * 4 * H + 2 * B * H
                  + (6 * H if peep else 0) + H * 4 * H)
    flops = 2 * B * T * 4 * H * H + LSTM_BWD_GATE_FLOPS * B * T * H + (
        PEEP_BWD_FLOPS * B * T * H + 3 * B * H if peep else 0)
    return nbytes, flops


def gemm_cost(M: int, K: int, N: int) -> tuple:
    """(bytes, operations) of an (M, K) x (K, N) float32 product."""
    return 4 * (M * K + K * N + M * N), 2 * M * K * N


def _encoder_widths(stream: dict) -> list:
    return [int(w) for w in (stream.get("encoder_shapes") or [])]


def stream_lstm_size(model: dict, stream: dict) -> int:
    return int(stream.get("lstm_size") or model["lstm_size"])


def lstm_layers(model: dict) -> list:
    """Every recurrence one forward runs, in order: ``(name, input width,
    H, peephole)`` for each stream LSTM and each direction of each
    aggregator layer."""
    peep = bool(model.get("use_peepholes", False))
    layers, outs = [], []
    for s in model["streams"]:
        widths = _encoder_widths(s)
        d = widths[-1] if widths else int(s["input_dim"])
        d *= 3 if s.get("use_delta", True) else 1
        if s.get("use_lstm", True):
            H = stream_lstm_size(model, s)
            layers.append((f"{s['name']}", d, H, peep))
            outs.append(H)
        else:
            outs.append(d)
    fused = sum(outs) if model.get("fusiontype", "sum") == "concat" else outs[0]
    sizes = model.get("agg_sizes") or [int(model.get("agg_size") or model["lstm_size"])] * int(
        model.get("agg_layers", 1))
    dirs = ("fwd", "bwd") if model.get("agg_bidirectional", True) else ("fwd",)
    d = fused
    for i, H in enumerate(sizes):
        for direction in dirs:
            layers.append((f"aggregator{i}.{direction}", d, int(H), peep))
        d = int(H)
    return layers


def classifier_in_dim(model: dict) -> int:
    return lstm_layers(model)[-1][2]


def model_flops(model: dict) -> tuple:
    """The model's matrix-product operations of one forward: ``(per valid
    frame, per utterance)``.  Per frame: the encoders' layers, each LSTM's
    input projection and recurrent product, and a per-step head's output
    layer; per utterance: a last-step head's output layer.  Gate
    arithmetic, the delta filter, the DCT and the softmax are left out."""
    per_frame = 0
    for s in model["streams"]:
        d = int(s["input_dim"])
        for w in _encoder_widths(s):
            per_frame += 2 * d * w
            d = w
    for _, d, H, _ in lstm_layers(model):
        per_frame += 2 * d * 4 * H + 2 * H * 4 * H
    head = 2 * classifier_in_dim(model) * int(model["output_classes"])
    if model.get("output_mode", "per_step") == "per_step":
        return per_frame + head, 0
    return per_frame, head
