"""Model zoo: reference-named AdeNet configurations.

Mirrors ip_avsr_tpu/models/zoo.py for the flagship trimodal model; the other
zoo entries come with ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

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
