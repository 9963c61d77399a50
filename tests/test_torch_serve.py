"""The port's serving path as a whole: ip_avsr_torch.serve.make_trimodal_server
on raw uint8 ROI frames against ip_avsr_tpu.serve.make_trimodal_server, with
identical parameters carried across by bridge.params_from_jax.

The tiny adenet_v3 is the one bench.py builds for its quick mode; the
full-width case is the flagship (1144/90/1144, H = 500, W = 9, T = 29).
Tolerance on probabilities: atol 2e-5.  The DCT stream feeds raw features of
magnitude ~1e3 straight into an LSTM, so float32 rounding differences
between JAX's FFT DCT and the port's basis product (~1e-3 absolute) reach
the gates; the saturating recurrences damp them to ~1e-6 on the scores.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu import serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_torch import bridge, serve as tserve
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=0)
T_FRAMES = 29


def _tiny_configs(output_mode="last_step"):
    """bench.py's tiny adenet_v3 for both packages."""
    enc = (("sigmoid", "sigmoid", "sigmoid", "linear"), (32, 24, 16, 8))
    out = []
    for zoo, ad in ((jzoo, jadenet), (tzoo, tadenet)):
        cfg = zoo.adenet_v3(64, 16, 64, lstm_size=16, window=4, output_classes=10)
        streams = [dataclasses.replace(s, encoder_shapes=enc[1],
                                       encoder_nonlinearities=enc[0])
                   if s.encoder_shapes else s for s in cfg.streams]
        out.append(dataclasses.replace(cfg, streams=streams, output_mode=output_mode))
    return out


def _batch(seed, B, D, lens):
    rng = np.random.RandomState(seed)
    raw = rng.randint(0, 256, (B, T_FRAMES, D)).astype(np.uint8)
    mask = (np.arange(T_FRAMES)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    return raw, mask


def _both(jcfg, tcfg, image_shape, dct, raw, mask, vote=True, init_cfg=None, stats=None):
    params = jadenet.init_adenet_params(jax.random.PRNGKey(0), init_cfg or jcfg)
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                     device="cpu")
    stats = stats or (None, None)
    ref = jserve.make_trimodal_server(params, jcfg, image_shape, dct, *stats, vote=vote)(
        jnp.asarray(raw), jnp.asarray(mask))
    got = tserve.make_trimodal_server(tparams, tcfg, image_shape, dct, *stats, vote=vote,
                                      device="cpu")(raw, mask)
    return np.asarray(ref), got.numpy()


@pytest.mark.parametrize("normalise", [False, True])
def test_tiny_last_step_server_matches_jax(normalise):
    jcfg, tcfg = _tiny_configs()
    raw, mask = _batch(0, 4, 64, [29, 15, 1, 7])
    rng = np.random.RandomState(1)
    stats = ((rng.randn(16).astype(np.float32) * 10, rng.rand(16).astype(np.float32) * 50 + 5)
             if normalise else None)
    ref, got = _both(jcfg, tcfg, (8, 8), 16, raw, mask, stats=stats)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("vote", [True, False])
def test_tiny_per_step_server_matches_jax(vote):
    jcfg, tcfg = _tiny_configs("per_step")
    raw, mask = _batch(2, 3, 64, [29, 10, 3])
    ref, got = _both(jcfg, tcfg, (8, 8), 16, raw, mask, vote=vote)
    assert got.shape == ((3, 10) if vote else (3, T_FRAMES, 10))
    np.testing.assert_allclose(got, ref, **TOL)


def test_full_width_server_matches_jax():
    jcfg = jzoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    tcfg = tzoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    raw, mask = _batch(3, 2, 1144, [29, 13])
    # glorot init only to keep the JAX init short (the orthogonal init's
    # SVDs take ~10 s at these widths); the forward is what is compared
    ref, got = _both(jcfg, tcfg, (26, 44), 90, raw, mask,
                     init_cfg=dataclasses.replace(jcfg, w_init="glorot"))
    assert got.shape == (2, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)


def test_param_buffers_tree_is_built_once_per_set_of_buffers():
    """``_ParamBuffers.tree`` keeps its float32 tree while the buffers stay
    the same objects, builds it anew after ``.to()`` swaps them, and upcasts
    narrower buffers on every call (nothing stale is kept)."""
    params = {"a": torch.ones(3), "b": [torch.zeros(2, 2), torch.arange(4.0)]}
    held = tserve._ParamBuffers(params)
    tree = held.tree()
    assert held.tree() is tree and tree["b"][1] is held.p2
    held.to(torch.float64).to(torch.float32)
    again = held.tree()
    assert again is not tree and again["b"][1] is held.p2
    narrow = tserve._ParamBuffers({"a": torch.ones(3, dtype=torch.bfloat16)})
    first = narrow.tree()
    assert first["a"].dtype == torch.float32 and narrow.tree() is not first
    narrow.p0.fill_(2)
    assert narrow.tree()["a"].eq(2).all()
