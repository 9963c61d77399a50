"""AVNet: audio and visual substreams fused into one network.

Mirrors ip_avsr_tpu/models/avnet.py.  Each substream is a dense encoder
(2000/1000/500/50, rectify x3 + linear) -> DeltaLayer -> LSTM (peepholes
on, orthogonal init); the substreams fuse by sum, adaptive sum or concat
into a BLSTM aggregator with a per-timestep softmax, as ``cli/audio_visual``
trains it.  A thin veneer over the AdeNet composer.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ip_avsr_torch.models.adenet import AdeNetConfig, StreamSpec


def avnet_config(
    substream_dims: Sequence[int],
    substream_names: Optional[Sequence[str]] = None,
    encoder_shapes=(2000, 1000, 500, 50),
    encoder_nonlinearities=("rectify", "rectify", "rectify", "linear"),
    lstm_size: int = 250,
    window: int = 9,
    output_classes: int = 26,
    fusiontype: str = "concat",
    w_init: str = "ortho",
    use_peepholes: bool = True,
    no_encoder_for: Sequence[str] = (),
) -> AdeNetConfig:
    """An AVNet config; ``no_encoder_for`` names substreams (such as a
    precomputed MFCC audio stream) that skip the dense encoder."""
    names = substream_names or [f"s{i + 1}" for i in range(len(substream_dims))]
    streams = []
    for dim, name in zip(substream_dims, names):
        if name in no_encoder_for:
            streams.append(StreamSpec(input_dim=dim, name=name))
        else:
            streams.append(StreamSpec(input_dim=dim, name=name,
                                      encoder_shapes=tuple(encoder_shapes),
                                      encoder_nonlinearities=tuple(encoder_nonlinearities)))
    return AdeNetConfig(
        streams=streams, output_classes=output_classes, lstm_size=lstm_size,
        window=window, fusiontype=fusiontype, agg_layers=1, agg_bidirectional=True,
        output_mode="per_step", w_init=w_init, use_peepholes=use_peepholes,
    )
