"""Serving on one device.

Mirrors ip_avsr_tpu/serve.py's ``make_trimodal_server`` (diff images, DCT
features, normalisations, encoders, deltas, LSTMs, fusion, aggregation,
softmax and optionally the masked majority vote run on the server's device;
raw (B, T, D) uint8 pixels in, (B, C) scores out) and the single-device
``make_server`` for preprocessed streams.
"""

from __future__ import annotations

from typing import Optional

import torch

from ip_avsr_torch.device import resolve_device, tree_to
from ip_avsr_torch.models import adenet
from ip_avsr_torch.ops import pipeline
from ip_avsr_torch.ops.voting import majority_voting_layer_masked


def make_trimodal_server(
    params: dict,
    config: adenet.AdeNetConfig,
    image_shape,
    dct_coeffs: Optional[int] = None,
    dct_mean=None,
    dct_std=None,
    vote: bool = True,
    device=None,
):
    """Returns ``serve(raw, mask) -> scores`` for a trimodal (raw, dct, diff)
    model on ``device`` (default ``cuda``).

    ``raw`` is (B, T, H*W) uint8 (or float) pixels and ``mask`` (B, T); both
    may be tensors or arrays.  Scores are (B, C); a per-step head with
    ``vote=False`` returns its (B, T, C) probabilities."""
    if (dct_mean is None) != (dct_std is None):
        raise ValueError("dct_mean and dct_std must be given together "
                         "(featurewise normalization needs both)")
    adenet.check_supported(config)
    device = resolve_device(device)
    dct_coeffs = dct_coeffs or config.streams[1].input_dim
    params = tree_to(params, device)
    if dct_mean is not None:
        dct_mean = torch.as_tensor(dct_mean, dtype=torch.float32, device=device)
        dct_std = torch.as_tensor(dct_std, dtype=torch.float32, device=device)

    @torch.inference_mode()
    def serve(raw, mask):
        raw = torch.as_tensor(raw, device=device).to(torch.float32)
        mask = torch.as_tensor(mask, device=device).to(torch.float32)
        streams = pipeline.trimodal_streams(raw, mask, image_shape, dct_coeffs,
                                            dct_mean, dct_std)
        return _scores(adenet.adenet_forward(params, config, list(streams), mask),
                       mask, config, vote)

    return serve


def _scores(out, mask, config, vote):
    """A per-step head's (B, T, C) probabilities through the masked vote
    when ``vote`` (padded frames must not cast votes), else as they are."""
    if out.dim() == 3 and vote:
        return majority_voting_layer_masked(out, mask, config.output_classes)
    return out


def make_server(params: dict, config: adenet.AdeNetConfig, vote: bool = True,
                mesh=None, device=None):
    """Returns ``serve(streams, mask) -> scores`` for preprocessed streams on
    ``device`` (default ``cuda``).

    ``streams[i]`` is (B, T, D_i) and ``mask`` (B, T), tensors or arrays.
    Scores are (B, C); a per-step head with ``vote=False`` returns its
    (B, T, C) probabilities.  ``mesh`` (data parallelism over several
    devices) is not ported yet (ROADMAP Queue 1 item 10) and raises."""
    if mesh is not None:
        raise NotImplementedError("make_server(mesh=...) is not ported yet (ROADMAP "
                                  "Queue 1 item 10: data parallelism)")
    adenet.check_supported(config)
    device = resolve_device(device)
    params = tree_to(params, device)

    @torch.inference_mode()
    def serve(streams, mask):
        streams = [torch.as_tensor(s, device=device).to(torch.float32) for s in streams]
        mask = torch.as_tensor(mask, device=device).to(torch.float32)
        return _scores(adenet.adenet_forward(params, config, streams, mask),
                       mask, config, vote)

    return serve
