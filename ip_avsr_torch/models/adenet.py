"""The AdeNet composer.

Mirrors ip_avsr_tpu/models/adenet.py: per stream, (B, T, D) -> optional dense
encoder on (B*T, D) frames -> optional batch norm -> optional DeltaLayer
(dim x3) -> optional stream LSTM; then fusion {sum | adasum | concat}; then
an aggregator of (bi)directional LSTM layers whose halves are summed (or,
with ``agg_merge="concat"``, concatenated); then a per-timestep softmax
("per_step") or a last-timestep classifier ("last_step").

Beyond the JAX package, a stream with ``frontend="resnet"`` takes (B, T, H,
W) uint8 frames through the 3-D convolution stem and residual trunk of
``models/resnet.py`` in place of a dense encoder (the span
``model.frontend``); its running batch-norm statistics live in
``streams/<name>/frontend_state``.  Such a stream runs on one device in
float32: a mesh or ``matmul_dtype="bfloat16"`` raises
``NotImplementedError`` (``check_supported``).

The streaming head (``check_streamable``, ``streaming_init_state``,
``head_forward_streaming``) advances a forward-only head chunk by chunk,
every recurrence carrying (cell, hid) in and out of a state dict.

``StreamSpec`` and ``AdeNetConfig`` carry the JAX dataclasses' fields, field
for field.  Batch norm (``use_batchnorm``) keeps its running statistics in
``streams/<name>/bn_state``; a training forward with ``return_aux=True``
hands the moved statistics back for the trainer to merge, as in the JAX
package.  ``fuse_scans`` runs the stream LSTMs as one group and each BLSTM
layer's halves as one group (``ops/lstm.lstm_forward_grouped``, member by
member); ``lstm_remat`` and ``lstm_residual_dtype`` reach every training
recurrence (``ops/lstm.lstm_forward``).  ``matmul_dtype="bfloat16"``
rounds the operands of every encoder product, input projection and
recurrent product to bf16 with float32 sums (the recurrences through the
kernels' bf16 instantiations).  Dropout
(``train=True``) follows Lasagne's DropoutLayer with its 1/(1-p) rescale,
drawing from an explicit ``torch.Generator``; its bits differ from JAX's.

On a mesh (``parallel/``) each rank runs the same forward on its block:
``bn_axis`` syncs batch norm's statistics over mesh dims, ``model_axis``
gathers the encoders' column blocks (tensor parallelism), ``delta_fn``
replaces the delta stage (sequence parallelism's halo FIR), and ``block``
(:class:`Block`) says where the rank's rows lie in the batch, so that its
dropout masks are its rows of the masks one process draws.
``lstm_impl`` selects a TPU backend and changes no result here: the
recurrences run the CUDA kernels whenever their tensors are on the card.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from ip_avsr_torch.device import resolve_device, tree_to
from ip_avsr_torch.models import encoder as encoder_mod
from ip_avsr_torch.models import resnet as resnet_mod
from ip_avsr_torch.ops import fusion as fusion_ops
from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops import lstm as lstm_ops
from ip_avsr_torch.ops import normalization as norm_ops
from ip_avsr_torch.ops.delta import delta_group
from ip_avsr_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Configuration of one input stream."""

    input_dim: int
    name: str = "stream"
    encoder_shapes: Optional[Sequence[int]] = None
    encoder_nonlinearities: Optional[Sequence] = None
    use_batchnorm: bool = False
    use_delta: bool = True
    dropout: float = 0.0
    use_lstm: bool = True
    lstm_size: Optional[int] = None
    # "resnet": (B, T, H, W) frames (input_dim = H * W pixels) through
    # models/resnet.py, its stages at ``frontend_widths`` channels; None:
    # (B, T, input_dim) features
    frontend: Optional[str] = None
    frontend_widths: Sequence[int] = (64, 128, 256, 512)

    def encoded_dim(self) -> int:
        if self.frontend:
            return int(self.frontend_widths[-1])
        d = self.encoder_shapes[-1] if self.encoder_shapes else self.input_dim
        return int(d)

    def feature_dim(self) -> int:
        return self.encoded_dim() * (3 if self.use_delta else 1)


@dataclasses.dataclass(frozen=True)
class AdeNetConfig:
    streams: Sequence[StreamSpec]
    output_classes: int
    lstm_size: int = 250
    window: int = 9
    fusiontype: str = "sum"
    agg_layers: int = 1
    agg_bidirectional: bool = True
    agg_size: Optional[int] = None
    agg_sizes: Optional[Sequence[int]] = None
    agg_dropout: float = 0.0
    # how a bidirectional layer's halves meet: "sum" (the reference's) or
    # "concat" (the next layer and the classifier read 2H)
    agg_merge: str = "sum"
    output_mode: str = "per_step"
    use_peepholes: bool = False
    w_init: str = "glorot"
    matmul_dtype: Optional[str] = None
    fuse_scans: bool = False
    lstm_impl: str = "xla"
    lstm_remat: bool = False
    lstm_residual_dtype: Optional[str] = None

    def stream_lstm_size(self, spec: StreamSpec) -> int:
        return int(spec.lstm_size or self.lstm_size)

    def stream_out_dim(self, spec: StreamSpec) -> int:
        return self.stream_lstm_size(spec) if spec.use_lstm else spec.feature_dim()

    def fused_dim(self) -> int:
        return fusion_ops.fused_dim(
            [self.stream_out_dim(s) for s in self.streams], self.fusiontype)

    def aggregator_sizes(self) -> list:
        if self.agg_sizes is not None:
            if len(self.agg_sizes) != self.agg_layers:
                raise ValueError(f"agg_sizes {self.agg_sizes} must have "
                                 f"agg_layers={self.agg_layers} entries")
            return [int(s) for s in self.agg_sizes]
        return [int(self.agg_size or self.lstm_size)] * self.agg_layers

    def agg_out_dim(self, size: int) -> int:
        """The width an aggregator layer of ``size`` units hands on."""
        return 2 * size if self.agg_bidirectional and self.agg_merge == "concat" else size

    def classifier_in_dim(self) -> int:
        sizes = self.aggregator_sizes()
        return self.agg_out_dim(sizes[-1]) if sizes else self.fused_dim()


# the fields of StreamSpec and AdeNetConfig that the JAX package's lack
PORT_FIELDS = ("frontend", "frontend_widths", "agg_merge")
FRONTENDS = (None, "resnet")
AGG_MERGES = ("sum", "concat")


def check_supported(config: AdeNetConfig, mesh=None) -> None:
    """Raise ``NotImplementedError`` for the config values the port does
    not cover, naming the ROADMAP item: a ``matmul_dtype`` other than
    None, float32 and bfloat16, the only operand types the LSTM kernels
    are instantiated for (``ops/lstm.matmul_dtype_of``); a conv front end
    on a ``mesh`` (its batch norm is not synced over ranks) or under
    ``matmul_dtype="bfloat16"`` (its convolutions run in float32).  An
    unknown front end or merge, or a conv stream with a dense encoder,
    raises ``ValueError``."""
    try:
        lstm_ops.matmul_dtype_of(config.matmul_dtype)
    except ValueError as e:
        raise NotImplementedError(
            f"not ported: matmul_dtype={config.matmul_dtype!r} (Queue 2 item 4 ported "
            "float32 and bfloat16 operands, the LSTM kernels' instantiations)") from e
    if config.agg_merge not in AGG_MERGES:
        raise ValueError(f"agg_merge must be one of {AGG_MERGES}, got {config.agg_merge!r}")
    for spec in config.streams:
        if spec.frontend not in FRONTENDS:
            raise ValueError(f"stream {spec.name}: unknown frontend {spec.frontend!r}")
        if not spec.frontend:
            continue
        if spec.encoder_shapes:
            raise ValueError(f"stream {spec.name}: a conv front end takes no dense encoder")
        if mesh is not None:
            raise NotImplementedError(
                f"not ported: the conv front end of stream {spec.name} on a mesh (ROADMAP "
                "Queue 6 item 5: batch norm synced across ranks)")
        if lstm_ops.matmul_dtype_of(config.matmul_dtype) is not None:
            raise NotImplementedError(
                f"not ported: the conv front end of stream {spec.name} under matmul_dtype="
                f"{config.matmul_dtype!r} (ROADMAP Queue 6 item 6: a bf16 front end)")


def init_adenet_params(generator: torch.Generator, config: AdeNetConfig,
                       device=None, pretrained_encoders: Optional[Sequence] = None,
                       pretrained_stream_lstms: Optional[Sequence] = None) -> dict:
    """Build the parameter tree with the JAX package's keys and layouts,
    drawn from ``generator`` on the CPU and moved to ``device`` (default
    ``cuda``).

    ``pretrained_encoders[i]`` is None or ``(weights, biases)`` for stream
    i (a DBN's layers); ``pretrained_stream_lstms[i]`` is None or an LSTM
    parameter dict, given zero ``cell_init``/``hid_init`` where it has none.
    A pretrained part draws nothing from the generator."""
    check_supported(config)
    device = resolve_device(device)
    w_init = inits.select_weight_init(config.w_init)
    params: dict = {"streams": {}}
    for i, spec in enumerate(config.streams):
        sp: dict = {}
        if spec.encoder_shapes:
            pre = pretrained_encoders[i] if pretrained_encoders else None
            if pre is not None:
                sp["encoder"] = encoder_mod.pretrained_encoder_params(pre[0], pre[1])
            else:
                sp["encoder"] = encoder_mod.init_encoder_params(
                    generator, spec.input_dim, spec.encoder_shapes, w_init)
        if spec.frontend:
            sp["frontend"], sp["frontend_state"] = resnet_mod.init_resnet_params(
                generator, spec.frontend_widths)
        if spec.use_batchnorm:
            sp["bn"], sp["bn_state"] = norm_ops.init_batch_norm(spec.encoded_dim())
        if spec.use_lstm:
            pre_lstm = pretrained_stream_lstms[i] if pretrained_stream_lstms else None
            H = config.stream_lstm_size(spec)
            if pre_lstm is not None:
                sp["lstm"] = {k: torch.as_tensor(np.asarray(v, np.float32))
                              for k, v in pre_lstm.items()}
                sp["lstm"].setdefault("cell_init", torch.zeros(1, H))
                sp["lstm"].setdefault("hid_init", torch.zeros(1, H))
            else:
                sp["lstm"] = lstm_ops.init_lstm_params(
                    generator, spec.feature_dim(), H, w_init, config.use_peepholes)
        params["streams"][spec.name] = sp
    if config.fusiontype == "adasum":
        params["adasum"] = fusion_ops.init_adasum_params(len(config.streams))
    in_dim = config.fused_dim()
    params["aggregator"] = []
    for agg in config.aggregator_sizes():
        if config.agg_bidirectional:
            fwd, bwd = lstm_ops.init_blstm_params(generator, in_dim, agg, w_init,
                                                  config.use_peepholes)
            params["aggregator"].append({"fwd": fwd, "bwd": bwd})
        else:
            params["aggregator"].append({"fwd": lstm_ops.init_lstm_params(
                generator, in_dim, agg, w_init, config.use_peepholes)})
        in_dim = config.agg_out_dim(agg)
    params["output"] = {
        "w": w_init(generator, (config.classifier_in_dim(), config.output_classes)),
        "b": torch.zeros(config.output_classes),
    }
    return tree_to(params, device)


@dataclasses.dataclass(frozen=True)
class Block:
    """Where a rank's (B, T, ...) inputs lie in the batch one process would
    run: rows ``rows`` of ``batch`` rows and, where time is split too,
    frames ``frames`` of ``time``.  A training forward draws each dropout
    mask for that whole batch and keeps the block, so the ranks of a mesh
    draw together what one process draws, as JAX's gspmd program equals
    its one-device program."""

    batch: int
    rows: slice
    time: Optional[int] = None
    frames: Optional[slice] = None


def _dropout(x: torch.Tensor, rate: float, generator, train: bool,
             block: Optional[Block] = None) -> torch.Tensor:
    """Lasagne DropoutLayer semantics: a train-time keep mask drawn from
    ``generator`` (on ``x``'s device), kept values rescaled by 1/(1-p);
    with ``block``, the mask of the whole batch cut to the block."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if block is None:
        draw = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    else:
        shape = (block.batch, x.shape[1] if block.time is None else block.time) + x.shape[2:]
        draw = torch.rand(shape, generator=generator, device=x.device, dtype=x.dtype)
        draw = draw[block.rows] if block.frames is None else draw[block.rows, block.frames]
    return torch.where(draw < keep, x / keep, torch.zeros_like(x))


def adenet_forward(params: dict, config: AdeNetConfig, inputs, mask: torch.Tensor,
                   window: Optional[int] = None, train: bool = False,
                   generator: Optional[torch.Generator] = None, return_aux: bool = False,
                   bn_axis=None, mesh=None, model_axis=None, block: Optional[Block] = None):
    """Run the model.  ``inputs[i]`` is (B, T, D_i); ``mask`` is (B, T).

    Returns (B, T, C) per-timestep probabilities ("per_step") or (B, C)
    probabilities ("last_step").  ``train=True`` applies dropout with draws
    from ``generator`` (default: a generator on the inputs' device seeded
    with 0, as the JAX package defaults to ``PRNGKey(0)``) and normalizes
    batch-norm streams with the batch's statistics.  ``return_aux=True``
    returns ``(out, {"bn_state": {stream name: new running statistics},
    "frontend_state": {conv stream name: its front end's new state}})``,
    detached, for the trainer to merge into the parameters.  On a mesh:
    ``bn_axis`` (a dim of ``mesh``, default the 1-D ``data`` mesh, or a
    tuple of dims) syncs batch norm's training statistics over its ranks,
    ``model_axis`` names the dim the encoders' columns are split over, and
    ``block`` places these rows in the whole batch for dropout."""
    check_supported(config, mesh)
    if train and generator is None:
        generator = torch.Generator(device=inputs[0].device).manual_seed(0)
    with spans.span("model.streams"):
        stream_feats, aux = stream_prefix(params, config, inputs, window, train, generator,
                                          return_aux=True, bn_axis=bn_axis, mesh=mesh,
                                          model_axis=model_axis, block=block)
    with spans.span("model.head"):
        out = head_forward(params, config, stream_feats, mask, train, generator, block=block)
    return (out, aux) if return_aux else out


def stream_prefix(params, config: AdeNetConfig, inputs, window=None, train=False,
                  generator=None, return_aux=False, bn_axis=None, delta_fn=None, mesh=None,
                  model_axis=None, block: Optional[Block] = None):
    """The frame-parallel part: per stream, encoder (or conv front end)
    -> batch norm -> delta -> dropout.  The encoders and front ends (each
    followed by its stream's batch norm) run first, then one grouped delta
    over every stream with ``use_delta`` (one kernel launch on CUDA), or
    ``delta_fn(x)`` per such stream when given, then dropout per stream in
    stream order.  Returns the features, and
    with ``return_aux`` also the batch-norm aux of :func:`adenet_forward`;
    ``bn_axis``, ``mesh``, ``model_axis`` and ``block`` as there."""
    window = config.window if window is None else window
    B, T = inputs[0].shape[0], inputs[0].shape[1]
    model_group = None if model_axis is None else mesh.group(model_axis)
    aux = {"bn_state": {}, "frontend_state": {}}
    feats = []
    for i, spec in enumerate(config.streams):
        sp = params["streams"][spec.name]
        x = inputs[i]
        if spec.frontend:
            with spans.span("model.frontend", count=B * T):
                x, aux["frontend_state"][spec.name] = resnet_mod.resnet_forward(
                    sp["frontend"], sp["frontend_state"], x, train)
        if spec.encoder_shapes:
            enc = encoder_mod.encoder_forward(sp["encoder"], x.reshape(B * T, spec.input_dim),
                                              spec.encoder_nonlinearities,
                                              matmul_dtype=config.matmul_dtype,
                                              widths=spec.encoder_shapes, group=model_group)
            x = enc.reshape(B, T, -1)
        if spec.use_batchnorm:
            x, aux["bn_state"][spec.name] = norm_ops.batch_norm_forward(
                sp["bn"], sp["bn_state"], x, train, axis_name=bn_axis, mesh=mesh)
        feats.append(x)
    with_delta = [i for i, spec in enumerate(config.streams) if spec.use_delta]
    if with_delta and delta_fn is not None:
        for i in with_delta:
            feats[i] = delta_fn(feats[i])
    elif with_delta:
        outs = delta_group([feats[i].contiguous() for i in with_delta], window)
        for i, out in zip(with_delta, outs):
            feats[i] = out
    feats = [_dropout(x, spec.dropout, generator, train, block)
             for x, spec in zip(feats, config.streams)]
    return (feats, aux) if return_aux else feats


def head_forward(params, config: AdeNetConfig, stream_feats, mask, train=False,
                 generator=None, block: Optional[Block] = None) -> torch.Tensor:
    """The recurrent part: per-stream LSTMs -> fusion -> aggregator
    (B)LSTM stack (dropout before each layer, cut to ``block`` when given;
    a BLSTM layer's halves summed or concatenated, ``agg_merge``) ->
    classifier head.

    With ``fuse_scans`` the stream LSTMs run as one group and each BLSTM
    layer's two halves as one group, where ``can_group_lstms`` allows it.
    Under training with ``lstm_remat`` or ``lstm_residual_dtype`` the
    grouping yields to the residual levers, with the JAX package's
    warning."""
    B, T = stream_feats[0].shape[0], stream_feats[0].shape[1]
    remat, resd, mm = config.lstm_remat, config.lstm_residual_dtype, config.matmul_dtype

    def run_lstm(p, feats, backwards=False):
        return lstm_ops.lstm_forward(p, feats, mask, backwards, remat=remat,
                                     residual_dtype=resd, matmul_dtype=mm)

    fuse_ok = config.fuse_scans and not (train and (remat or resd))
    if config.fuse_scans and not fuse_ok:
        warnings.warn(
            "fuse_scans is ignored under training when lstm_remat or "
            "lstm_residual_dtype is set (the grouped scan stores full-f32 "
            "residuals); running ungrouped LSTMs so the residual levers "
            "apply", stacklevel=2)
    lstm_idx = [i for i, s in enumerate(config.streams) if s.use_lstm]
    lstm_params = [params["streams"][config.streams[i].name]["lstm"] for i in lstm_idx]
    stream_outs = list(stream_feats)
    if fuse_ok and lstm_ops.can_group_lstms(lstm_params):
        grouped = lstm_ops.lstm_forward_grouped(
            lstm_params, [stream_feats[i] for i in lstm_idx], mask, [False] * len(lstm_idx),
            matmul_dtype=mm)
        for i, out in zip(lstm_idx, grouped):
            stream_outs[i] = out
    else:
        for i, p in zip(lstm_idx, lstm_params):
            stream_outs[i] = run_lstm(p, stream_feats[i])

    agg = fusion_ops.fuse(stream_outs, config.fusiontype, params.get("adasum"))
    for layer in range(config.agg_layers):
        agg = _dropout(agg, config.agg_dropout, generator, train, block)
        lp = params["aggregator"][layer]
        if config.agg_bidirectional:
            if fuse_ok and lstm_ops.can_group_lstms([lp["fwd"], lp["bwd"]]):
                f, bwd = lstm_ops.lstm_forward_grouped([lp["fwd"], lp["bwd"]], [agg, agg],
                                                       mask, [False, True], matmul_dtype=mm)
            else:
                f, bwd = run_lstm(lp["fwd"], agg), run_lstm(lp["bwd"], agg, backwards=True)
            agg = torch.cat([f, bwd], dim=-1) if config.agg_merge == "concat" else f + bwd
        else:
            agg = run_lstm(lp["fwd"], agg)

    w, b = params["output"]["w"], params["output"]["b"]
    if config.output_mode == "per_step":
        probs = torch.softmax(agg.reshape(B * T, -1) @ w + b, dim=-1)
        return probs.reshape(B, T, config.output_classes)
    if config.output_mode == "last_step":
        last = lstm_ops.last_valid_step(agg, mask)
        return torch.softmax(last @ w + b, dim=-1)
    raise ValueError(f"unknown output_mode: {config.output_mode}")


# ---------------------------------------------------------------------------
# Streaming (stateful) head: online serving, serve.StreamingSession
# ---------------------------------------------------------------------------

def check_streamable(config: AdeNetConfig) -> None:
    """Raise ``ValueError`` if the recurrent head cannot be advanced chunk
    by chunk: a bidirectional aggregator's backward half consumes the whole
    utterance.  last_step heads stream (the score appears at finalize)."""
    if config.agg_layers > 0 and config.agg_bidirectional:
        raise ValueError(
            "streaming requires a forward-only recurrent head: set "
            "agg_bidirectional=False or agg_layers=0 (a BLSTM aggregator's "
            "backward half consumes the whole utterance)")


def streaming_init_state(params, config: AdeNetConfig, batch: int) -> dict:
    """The initial (cell, hid) carries of every recurrence in the head,
    (batch, H) float32 each on the parameters' device, broadcast from the
    learned cell_init/hid_init as the one-shot forward broadcasts them:
    ``{"streams": {name: (cell, hid)}, "aggregator": [(cell, hid), ...]}``."""
    def init(p):
        H = lstm_ops.lstm_params_hidden_size(p)
        return tuple(p[k].to(torch.float32).expand(batch, H).contiguous()
                     for k in ("cell_init", "hid_init"))

    state = {"streams": {}, "aggregator": []}
    for spec in config.streams:
        if spec.use_lstm:
            state["streams"][spec.name] = init(params["streams"][spec.name]["lstm"])
    for layer in range(config.agg_layers):
        if config.agg_bidirectional:
            raise ValueError("streaming state is forward-only (check_streamable)")
        state["aggregator"].append(init(params["aggregator"][layer]["fwd"]))
    return state


def head_forward_streaming(params, config: AdeNetConfig, stream_feats, mask,
                           state) -> tuple:
    """One streaming chunk through the recurrent head: per-stream LSTMs ->
    fusion -> forward aggregator stack -> per-frame softmax, with every
    recurrence resuming from ``state`` and handing back its final (cell,
    hid).

    The one-shot :func:`head_forward`'s ops, restricted to the streamable
    subset (:func:`check_streamable`) with dropout off; masked steps carry
    the state, so zero-mask chunk padding is free.  Returns ``(probs (B, n,
    C), new_state)``; a last_step caller takes the last valid frame's
    probabilities at finalize."""
    check_streamable(config)
    B, n = stream_feats[0].shape[0], stream_feats[0].shape[1]
    new_state = {"streams": {}, "aggregator": []}
    stream_outs = list(stream_feats)
    for i, spec in enumerate(config.streams):
        if spec.use_lstm:
            stream_outs[i], new_state["streams"][spec.name] = lstm_ops.lstm_forward(
                params["streams"][spec.name]["lstm"], stream_feats[i], mask,
                initial_state=state["streams"][spec.name], return_state=True,
                matmul_dtype=config.matmul_dtype)

    agg = fusion_ops.fuse(stream_outs, config.fusiontype, params.get("adasum"))
    for layer in range(config.agg_layers):
        agg, st = lstm_ops.lstm_forward(params["aggregator"][layer]["fwd"], agg, mask,
                                        initial_state=state["aggregator"][layer],
                                        return_state=True, matmul_dtype=config.matmul_dtype)
        new_state["aggregator"].append(st)

    w, b = params["output"]["w"], params["output"]["b"]
    probs = torch.softmax(agg.reshape(B * n, -1) @ w + b, dim=-1)
    return probs.reshape(B, n, config.output_classes), new_state
