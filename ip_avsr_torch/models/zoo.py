"""Model zoo: reference-named AdeNet configurations.

Mirrors ip_avsr_tpu/models/zoo.py builder for builder and field for field:
the single-stream ``deltanet``, ``deltanet_v1``,
``deltanet_majority_vote``, ``lstm_classifier_baseline``,
``lstm_classifier_majority_vote`` and ``baseline_end2end``; the bimodal
raw + DCT family ``adenet_v1`` and ``adenet_v1_1`` (batch-normalized
encoder, feature concat into a two-layer BLSTM stack), ``adenet_v2``,
``adenet_v2_1`` to ``adenet_v2_4``, ``adenet_v2_nodelta`` and
``adenet_v4``; the trimodal flagship ``adenet_v3`` and ``adenet_v5`` (sum or
adaptive sum), the raw + diff ``adenet_v6``; and the generic N-stream
``adenet_nstream`` (peephole LSTMs by default; ``configs/oulu_4stream.ini``
builds it).  ``models/avnet.avnet_config`` builds the audio-visual
network.  Beyond the JAX package, ``resnet_blstm`` builds the ResNet-34 +
BLSTM word lipreader on uint8 frames.
"""

from __future__ import annotations

import dataclasses

from typing import Optional, Sequence

from ip_avsr_torch.models.adenet import AdeNetConfig, StreamSpec

SIGMOID_ENCODER = (["sigmoid", "sigmoid", "sigmoid", "linear"], [2000, 1000, 500, 50])
RELU_ENCODER = (["rectify", "rectify", "rectify", "linear"], [2000, 1000, 500, 50])


def _encoder_stream(input_dim, name, shapes=None, nonlinearities=None, **kw) -> StreamSpec:
    nl, sh = SIGMOID_ENCODER
    return StreamSpec(
        input_dim=input_dim,
        name=name,
        encoder_shapes=tuple(shapes or sh),
        encoder_nonlinearities=tuple(nonlinearities or nl),
        **kw,
    )


def deltanet(input_dim, encoder_shapes, encoder_nonlinearities, lstm_size=250,
             window=9, output_classes=26, w_init="glorot", use_peepholes=False) -> AdeNetConfig:
    """Encoder + delta + BLSTM + last-step classifier."""
    return AdeNetConfig(
        streams=[_encoder_stream(input_dim, "s1", encoder_shapes, encoder_nonlinearities,
                                 use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype="sum", agg_layers=1, agg_bidirectional=True,
        output_mode="last_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def deltanet_v1(input_dim, lstm_size=250, window=9, output_classes=26,
                w_init="glorot", use_peepholes=False, use_blstm=True) -> AdeNetConfig:
    """No-encoder DeltaLayer directly on the input, per-timestep softmax."""
    return AdeNetConfig(
        streams=[StreamSpec(input_dim=input_dim, name="s1", use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        agg_layers=1, agg_bidirectional=use_blstm,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def deltanet_majority_vote(input_dim, encoder_shapes, encoder_nonlinearities,
                           lstm_size=250, window=9, output_classes=26,
                           w_init="glorot", use_peepholes=False,
                           use_blstm=True) -> AdeNetConfig:
    """Encoder + delta + (B)LSTM + per-timestep softmax for majority voting."""
    return AdeNetConfig(
        streams=[_encoder_stream(input_dim, "s1", encoder_shapes, encoder_nonlinearities,
                                 use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        agg_layers=1, agg_bidirectional=use_blstm,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def lstm_classifier_majority_vote(input_dim, lstm_size=250, output_classes=26,
                                  w_init="glorot", use_peepholes=False,
                                  use_blstm=True) -> AdeNetConfig:
    """Raw-feature (B)LSTM + per-timestep softmax."""
    return AdeNetConfig(
        streams=[StreamSpec(input_dim=input_dim, name="s1", use_delta=False, use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size,
        agg_layers=1, agg_bidirectional=use_blstm, output_mode="per_step",
        w_init=w_init, use_peepholes=use_peepholes,
    )


def lstm_classifier_baseline(input_dim, lstm_size=250, output_classes=26,
                             w_init="glorot", use_peepholes=False) -> AdeNetConfig:
    """Raw-feature BLSTM + last-step classifier."""
    return AdeNetConfig(
        streams=[StreamSpec(input_dim=input_dim, name="s1", use_delta=False, use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size,
        agg_layers=1, agg_bidirectional=True, output_mode="last_step",
        w_init=w_init, use_peepholes=use_peepholes,
    )


def baseline_end2end(input_dim, encoder_shapes, encoder_nonlinearities, lstm_size=250,
                     output_classes=26, w_init="glorot", use_peepholes=False) -> AdeNetConfig:
    """Encoder + BLSTM (no delta) + last-step classifier."""
    return AdeNetConfig(
        streams=[_encoder_stream(input_dim, "s1", encoder_shapes, encoder_nonlinearities,
                                 use_delta=False, use_lstm=False)],
        output_classes=output_classes, lstm_size=lstm_size,
        agg_layers=1, agg_bidirectional=True, output_mode="last_step",
        w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v1(input_dim, dct_dim, lstm_size=250, window=9, output_classes=26) -> AdeNetConfig:
    """Raw encoder (sigmoid, 2000/1000/500/50) + batch norm -> delta, feature
    concat with the DCT, a 2-layer BLSTM stack (sizes lstm, 2*lstm),
    last-step classifier."""
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", use_batchnorm=True, use_lstm=False),
            StreamSpec(input_dim=dct_dim, name="dct", use_delta=False, use_lstm=False),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype="concat", agg_layers=2, agg_sizes=(lstm_size, lstm_size * 2),
        agg_bidirectional=True, output_mode="last_step", w_init="glorot",
    )


def adenet_v1_1(input_dim, dct_dim, lstm_size=250, window=9, output_classes=26) -> AdeNetConfig:
    """adenet_v1 with dropout 0.5 before both BLSTMs, both sized 2*lstm."""
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", use_batchnorm=True, use_lstm=False),
            StreamSpec(input_dim=dct_dim, name="dct", use_delta=False, use_lstm=False),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype="concat", agg_layers=2, agg_sizes=(lstm_size * 2, lstm_size * 2),
        agg_dropout=0.5, agg_bidirectional=True, output_mode="last_step", w_init="glorot",
    )


def adenet_v2(input_dim, dct_dim, encoder_shapes=None, encoder_nonlinearities=None,
              lstm_size=250, window=9, output_classes=26, fusiontype="sum",
              w_init="glorot", use_peepholes=False) -> AdeNetConfig:
    """Canonical bimodal raw+DCT: encoder -> delta, delta(DCT), per-stream
    LSTMs, fusion, BLSTM aggregator, per-timestep softmax."""
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", encoder_shapes, encoder_nonlinearities),
            StreamSpec(input_dim=dct_dim, name="dct"),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v2_1(input_dim, diff_dim, lstm_size=250, window=9, output_classes=26,
                fusiontype="sum", w_init="glorot", use_peepholes=True) -> AdeNetConfig:
    """Raw + diff-image with two ReLU encoders."""
    nl, sh = RELU_ENCODER
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", sh, nl),
            _encoder_stream(diff_dim, "diff", sh, nl),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v2_2(s1_dim, s2_dim, s1_encoder=None, s2_encoder=None, lstm_size=250,
                window=9, output_classes=26, fusiontype="sum", w_init="glorot",
                use_peepholes=True) -> AdeNetConfig:
    """Generic 2-stream with two ``(nonlinearities, shapes)`` encoders
    (sigmoid 2000/1000/500/50 by default)."""
    s1_nl, s1_sh = s1_encoder or SIGMOID_ENCODER
    s2_nl, s2_sh = s2_encoder or SIGMOID_ENCODER
    return AdeNetConfig(
        streams=[
            _encoder_stream(s1_dim, "s1", s1_sh, s1_nl),
            _encoder_stream(s2_dim, "s2", s2_sh, s2_nl),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v2_3(input_dim, dct_dim, encoder_shapes=None, encoder_nonlinearities=None,
                lstm_size=250, window=9, output_classes=26, fusiontype="sum",
                w_init="glorot", use_peepholes=True) -> AdeNetConfig:
    """adenet_v2 with a unidirectional LSTM aggregator."""
    cfg = adenet_v2(input_dim, dct_dim, encoder_shapes, encoder_nonlinearities,
                    lstm_size, window, output_classes, fusiontype, w_init, use_peepholes)
    return dataclasses.replace(cfg, agg_bidirectional=False)


def adenet_v2_4(input_dim, diff_dim, lstm_size=250, window=9, output_classes=26,
                fusiontype="sum", w_init="glorot", use_peepholes=True) -> AdeNetConfig:
    """Raw + diff with a unidirectional aggregator."""
    cfg = adenet_v2_1(input_dim, diff_dim, lstm_size, window, output_classes,
                      fusiontype, w_init, use_peepholes)
    return dataclasses.replace(cfg, agg_bidirectional=False)


def adenet_v2_nodelta(s1_dim, s2_dim, s1_encoder=None, s2_encoder=None, lstm_size=250,
                      output_classes=26, fusiontype="sum", w_init="glorot",
                      use_peepholes=True) -> AdeNetConfig:
    """The 2-stream ablation without DeltaLayers."""
    s1_nl, s1_sh = s1_encoder or SIGMOID_ENCODER
    s2_nl, s2_sh = s2_encoder or SIGMOID_ENCODER
    return AdeNetConfig(
        streams=[
            _encoder_stream(s1_dim, "s1", s1_sh, s1_nl, use_delta=False),
            _encoder_stream(s2_dim, "s2", s2_sh, s2_nl, use_delta=False),
        ],
        output_classes=output_classes, lstm_size=lstm_size,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v4(input_dim, dct_dim, encoder_shapes=None, encoder_nonlinearities=None,
              lstm_size=250, window=9, output_classes=26, fusiontype="sum",
              w_init="glorot", use_peepholes=False) -> AdeNetConfig:
    """Raw+DCT dropout variant: stream LSTMs sized 2*lstm with input dropout
    (0.5 delta / 0.2 DCT), unidirectional aggregator 2*lstm after dropout,
    last-step classifier."""
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", encoder_shapes, encoder_nonlinearities,
                            dropout=0.5, lstm_size=lstm_size * 2),
            StreamSpec(input_dim=dct_dim, name="dct", use_delta=False, dropout=0.2,
                       lstm_size=lstm_size * 2),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=False,
        agg_size=lstm_size * 2, agg_dropout=0.5,
        output_mode="last_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def adenet_v3(input_dim, dct_dim, diff_dim, lstm_size=250, window=9,
              output_classes=10, fusiontype="sum") -> AdeNetConfig:
    """North-star trimodal raw+DCT+diff: two sigmoid encoders, dropout on each
    delta stream (0.5/0.2/0.5), stream LSTMs sized lstm/(1-0.5) = 2*lstm,
    fusion, dropout + BLSTM(2*lstm) aggregator, last-step classifier,
    orthogonal init."""
    big = int(lstm_size / (1 - 0.5))
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", dropout=0.5, lstm_size=big),
            StreamSpec(input_dim=dct_dim, name="dct", use_delta=False, dropout=0.2,
                       lstm_size=big),
            _encoder_stream(diff_dim, "diff", dropout=0.5, lstm_size=big),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        agg_size=lstm_size * 2, agg_dropout=0.5,
        output_mode="last_step", w_init="ortho",
    )


def adenet_v5(input_dim, dct_dim, diff_dim, lstm_size=250, window=9,
              output_classes=10, use_adascale=False) -> AdeNetConfig:
    """Trimodal like adenet_v3, with adaptive-sum fusion when
    ``use_adascale``."""
    return adenet_v3(input_dim, dct_dim, diff_dim, lstm_size, window, output_classes,
                     fusiontype="adasum" if use_adascale else "sum")


def adenet_v6(input_dim, diff_dim, lstm_size=250, window=9, output_classes=10,
              use_adascale=False) -> AdeNetConfig:
    """Bimodal raw + diff (no DCT) with dropout 0.5 on both delta streams."""
    big = int(lstm_size / (1 - 0.5))
    return AdeNetConfig(
        streams=[
            _encoder_stream(input_dim, "raw", dropout=0.5, lstm_size=big),
            _encoder_stream(diff_dim, "diff", dropout=0.5, lstm_size=big),
        ],
        output_classes=output_classes, lstm_size=lstm_size, window=window,
        fusiontype="adasum" if use_adascale else "sum",
        agg_layers=1, agg_bidirectional=True, agg_size=lstm_size * 2,
        agg_dropout=0.5, output_mode="last_step", w_init="ortho",
    )


def adenet_nstream(
    input_dims: Sequence[int],
    encoders: Sequence[Optional[tuple]],
    lstm_size=250,
    window=9,
    output_classes=26,
    fusiontype="sum",
    w_init="glorot",
    use_peepholes=True,
    stream_dropout=0.0,
    stream_lstm_multiplier=1,
    use_delta=True,
    use_blstm=True,
) -> AdeNetConfig:
    """Generic N-stream AdeNet: ``encoders[i]`` is ``(nonlinearities,
    shapes)`` or None for an encoder-less stream; ``use_delta`` a bool or a
    per-stream list.  Stream LSTMs, fusion, a (B)LSTM aggregator and a
    per-timestep softmax."""
    if isinstance(use_delta, bool):
        use_delta = [use_delta] * len(input_dims)
    streams = []
    for i, (dim, enc) in enumerate(zip(input_dims, encoders)):
        kw = dict(dropout=stream_dropout, use_delta=bool(use_delta[i]),
                  lstm_size=(lstm_size * stream_lstm_multiplier
                             if stream_lstm_multiplier != 1 else None))
        if enc is not None:
            nl, sh = enc
            streams.append(_encoder_stream(dim, f"s{i + 1}", sh, nl, **kw))
        else:
            streams.append(StreamSpec(input_dim=dim, name=f"s{i + 1}", **kw))
    return AdeNetConfig(
        streams=streams, output_classes=output_classes, lstm_size=lstm_size,
        window=window, fusiontype=fusiontype, agg_layers=1,
        agg_bidirectional=use_blstm,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )


def resnet_blstm(output_classes=500, lstm_size=256, image_shape=(112, 112),
                 frontend_widths=(64, 128, 256, 512)) -> AdeNetConfig:
    """The word lipreader of Stafylakis & Tzimiropoulos (arXiv:1703.04105,
    section 3): (B, T, H, W) uint8 mouth-ROI frames through the 3-D stem and
    a residual trunk (``models/resnet.py``; ResNet-34 at the defaults), a
    two-layer BLSTM whose halves are concatenated, so both layers and the
    classifier read 2 * ``lstm_size``, and a per-frame softmax.  The LSTMs
    are the port's Lasagne cells (learned initial state, gate gradients
    clipped to +-5), where the paper's are Torch's."""
    H, W = (int(v) for v in image_shape)
    stream = StreamSpec(input_dim=H * W, name="video", use_delta=False, use_lstm=False,
                        frontend="resnet", frontend_widths=tuple(frontend_widths))
    return AdeNetConfig(
        streams=[stream], output_classes=output_classes, lstm_size=lstm_size,
        agg_layers=2, agg_bidirectional=True, agg_merge="concat", output_mode="per_step",
    )
