"""The port's streaming inference (ip_avsr_torch.serve.StreamingSession and
models/adenet's streaming head) against the JAX package's, on the CPU.

One case for each test of tests/test_streaming.py but its export leg: the
same configs, built by both packages' zoos, with the JAX parameters carried
across by bridge.params_from_jax, fed the same chunks.  The port's session
is held to the JAX session's per-frame probabilities within 2e-5 (float32,
chunked GEMMs and recurrences in another summation order), its votes and
last-step results to the JAX session's, and to the port's own one-shot
``make_server(vote=False)`` within 1e-6, as the JAX tests hold theirs.  Also
``_np_delta_fir`` against the JAX package's copy and ``ops.delta``, and the
six zoo builders streaming serves against the JAX zoo.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from ip_avsr_tpu import serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops import delta as jdelta
from ip_avsr_torch import bridge, serve as tserve
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.ops import delta as tdelta
from ip_avsr_torch.ops.voting import masked_majority_vote
from tests.torch_trainer_lib import jax_fields

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=0)
ONE_SHOT_TOL = dict(atol=1e-6, rtol=0)


def _cfgs(build, *args, **kw):
    """The same builder of both zoos, with the same replaced fields."""
    fields = kw.pop("replace", {})
    return [dataclasses.replace(getattr(z, build)(*args, **kw), **fields)
            for z in (jzoo, tzoo)]


def _streamable(**fields):
    return _cfgs("deltanet_majority_vote", 12, [10, 6], ["sigmoid", "linear"], lstm_size=8,
                 window=3, output_classes=4, replace={"agg_bidirectional": False, **fields})


def _params(jcfg, seed):
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _session(pkg, params, cfg, batch=1):
    if pkg is jserve:
        return jserve.StreamingSession(params, cfg, batch=batch)
    return tserve.StreamingSession(params, cfg, batch=batch, device="cpu")


def _run(sess, streams, splits):
    got, s = [], 0
    for n in splits:
        got += list(sess.feed([x[:, s:s + n] for x in streams]))
        s += n
    tail, result = sess.finalize()
    emitted = np.concatenate([np.stack(got, axis=1), tail], axis=1) if got else tail
    return emitted, result


def _both(jcfg, tcfg, seed, streams, splits, batch=1):
    """Both sessions over the same chunks: (JAX emitted, result), (port
    emitted, result), the port's parameters and its one-shot probabilities."""
    jp, tp = _params(jcfg, seed)
    ref = _run(_session(jserve, jp, jcfg, batch), streams, splits)
    got = _run(_session(tserve, tp, tcfg, batch), streams, splits)
    mask = torch.ones(streams[0].shape[:2])
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x) for x in streams], mask).numpy()
    return ref, got, tp, one_shot


def _hold(ref, got, one_shot, mode="per_step"):
    np.testing.assert_allclose(got[0], ref[0], **TOL)
    if mode == "per_step":
        assert got[0].shape == ref[0].shape
        np.testing.assert_allclose(got[0], one_shot, **ONE_SHOT_TOL)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(
            got[1], masked_majority_vote(one_shot, np.ones(one_shot.shape[:2])))
    else:
        np.testing.assert_allclose(got[1], ref[1], **TOL)
        np.testing.assert_allclose(got[1], one_shot, **ONE_SHOT_TOL)


@pytest.mark.parametrize("splits", [[21], [1] * 21, [1, 3, 2, 7, 4, 4]],
                         ids=["one_shot", "frame_by_frame", "ragged"])
def test_streaming_matches_jax_and_one_shot(splits):
    jcfg, tcfg = _streamable()
    x = np.random.RandomState(0).randn(1, sum(splits), 12).astype(np.float32)
    ref, got, _, one_shot = _both(jcfg, tcfg, 0, [x], splits)
    _hold(ref, got, one_shot)


def test_streaming_multistream_peepholes_batch():
    """Two streams (encoder + delta, and plain delta), peephole LSTMs,
    batch 2."""
    jcfg, tcfg = _cfgs("adenet_v2", 12, 8, encoder_shapes=[10, 6],
                       encoder_nonlinearities=["sigmoid", "linear"], lstm_size=8, window=3,
                       output_classes=4, use_peepholes=True,
                       replace={"agg_bidirectional": False})
    rng = np.random.RandomState(1)
    xs = [rng.randn(2, 17, 12).astype(np.float32), rng.randn(2, 17, 8).astype(np.float32)]
    ref, got, _, one_shot = _both(jcfg, tcfg, 1, xs, [5, 1, 8, 3], batch=2)
    _hold(ref, got, one_shot)


def test_streaming_last_step_head():
    jcfg, tcfg = _cfgs("lstm_classifier_baseline", 12, lstm_size=8, output_classes=4,
                       replace={"agg_bidirectional": False})
    assert tcfg.output_mode == "last_step"
    x = np.random.RandomState(2).randn(1, 13, 12).astype(np.float32)
    ref, got, _, one_shot = _both(jcfg, tcfg, 2, [x], [1] * 13)
    _hold(ref, got, one_shot, mode="last_step")


def test_streaming_no_delta_zero_lookahead():
    """Without delta streams every frame is final at once."""
    jcfg, tcfg = [dataclasses.replace(c, streams=[dataclasses.replace(s, use_delta=False)
                                                  for s in c.streams])
                  for c in _streamable()]
    jp, tp = _params(jcfg, 3)
    x = np.random.RandomState(3).randn(1, 9, 12).astype(np.float32)
    out = {}
    for pkg, params, cfg in ((jserve, jp, jcfg), (tserve, tp, tcfg)):
        sess = _session(pkg, params, cfg)
        first = list(sess.feed([x[:, :4]]))
        assert len(first) == 4  # no lookahead latency
        rest = list(sess.feed([x[:, 4:]]))
        tail, _ = sess.finalize()
        assert tail.shape[1] == 0
        out[pkg] = np.stack(first + rest, axis=1)
    np.testing.assert_allclose(out[tserve], out[jserve], **TOL)
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, 9)).numpy()
    np.testing.assert_allclose(out[tserve], one_shot, **ONE_SHOT_TOL)


def test_streaming_short_utterance_tail_only():
    """T < 2 * window: nothing is emitted before finalize."""
    jcfg, tcfg = _streamable()
    jp, tp = _params(jcfg, 4)
    x = np.random.RandomState(4).randn(1, 4, 12).astype(np.float32)
    tails = {}
    for pkg, params, cfg in ((jserve, jp, jcfg), (tserve, tp, tcfg)):
        sess = _session(pkg, params, cfg)
        assert list(sess.feed([x])) == []
        tails[pkg], _ = sess.finalize()
    np.testing.assert_allclose(tails[tserve], tails[jserve], **TOL)
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, 4)).numpy()
    np.testing.assert_allclose(tails[tserve], one_shot, **ONE_SHOT_TOL)


def test_streaming_requires_forward_only_head():
    _, tcfg = _cfgs("deltanet_majority_vote", 12, [10, 6], ["sigmoid", "linear"],
                    lstm_size=8, window=3, output_classes=4)
    assert tcfg.agg_bidirectional
    tp = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(ValueError, match="forward-only"):
        tserve.StreamingSession(tp, tcfg, device="cpu")


def test_streaming_api_misuse():
    _, tcfg = _streamable()
    tp = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    sess = tserve.StreamingSession(tp, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no frames"):
        sess.finalize()
    with pytest.raises(RuntimeError, match="lookahead"):
        sess.predict()
    x = np.zeros((1, 8, 12), np.float32)
    list(sess.feed([x]))
    sess.predict()
    sess.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        list(sess.feed([x]))
    with pytest.raises(RuntimeError, match="finalized"):
        sess.finalize()
    sess2 = tserve.StreamingSession(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        list(sess2.feed([np.zeros((2, 8, 12), np.float32)]))
    with pytest.raises(ValueError, match="streams"):
        sess2.feed([x, x])


def test_streaming_zero_length_chunks_finalize_raises():
    _, tcfg = _streamable()
    tp = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    sess = tserve.StreamingSession(tp, tcfg, device="cpu")
    assert list(sess.feed([np.zeros((1, 0, 12), np.float32)])) == []
    with pytest.raises(RuntimeError, match="no frames"):
        sess.finalize()


def test_streaming_buffer_is_bounded():
    """The encoded buffer keeps at most the 2W delta context plus the
    pending lookahead, frame by frame over 200 frames."""
    jcfg, tcfg = _streamable()
    jp, tp = _params(jcfg, 0)
    T = 200
    x = np.random.RandomState(9).randn(1, T, 12).astype(np.float32)
    sess = tserve.StreamingSession(tp, tcfg, device="cpu")
    got = []
    for t in range(T):
        got += sess.feed([x[:, t:t + 1]])
        assert sess._enc[0].shape[1] <= 4 * tcfg.window + 2, sess._enc[0].shape
    tail, _ = sess.finalize()
    emitted = np.concatenate([np.stack(got, axis=1), tail], axis=1)
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, T)).numpy()
    np.testing.assert_allclose(emitted, one_shot, **ONE_SHOT_TOL)
    ref = jserve.make_server(jp, jcfg, vote=False)([x], np.ones((1, T), np.float32))
    np.testing.assert_allclose(emitted, np.asarray(ref), **TOL)


def test_feed_is_eager():
    """feed() buffers its frames even when the caller ignores the scores."""
    jcfg, tcfg = _streamable()
    jp, tp = _params(jcfg, 0)
    x = np.random.RandomState(7).randn(1, 15, 12).astype(np.float32)
    got = {}
    for pkg, params, cfg in ((jserve, jp, jcfg), (tserve, tp, tcfg)):
        sess = _session(pkg, params, cfg)
        sess.feed([x[:, :10]])  # return value ignored on purpose
        out = sess.feed([x[:, 10:]])
        tail, _ = sess.finalize()
        got[pkg] = np.concatenate([np.stack(out, axis=1), tail], axis=1)
    np.testing.assert_allclose(got[tserve], got[jserve], **TOL)
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, 15)).numpy()
    np.testing.assert_allclose(got[tserve], one_shot[:, 15 - got[tserve].shape[1]:],
                               **ONE_SHOT_TOL)


@pytest.mark.parametrize("W", [1, 3, 4])
def test_np_delta_fir_matches_jax_copy_and_the_op(W):
    x = np.random.RandomState(0).randn(2, 15, 6).astype(np.float32)
    padded = np.pad(x, ((0, 0), (W, W), (0, 0)), mode="edge")
    got = tserve._np_delta_fir(padded, W)
    assert np.array_equal(got, jserve._np_delta_fir(padded, W))
    np.testing.assert_allclose(got, tdelta.delta_coeff(torch.from_numpy(x), W).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jdelta.delta_coeff(x, W)), atol=1e-6)


def test_streaming_config_family_property():
    """Hypothesis over the streamable config space (delta on or off per
    stream, encoders, peepholes, non-LSTM streams, fusion, 0-2 forward
    aggregator layers, both heads, windows 1-4, random chunk splits): every
    drawn case, both packages' sessions on the same parameters."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=12, deadline=None, derandomize=True)
    @given(data=st.data())
    def run(data):
        n_streams = data.draw(st.integers(1, 2), label="n_streams")
        window = data.draw(st.integers(1, 4), label="window")
        specs, any_lstm = [], False
        for i in range(n_streams):
            use_lstm = data.draw(st.booleans(), label=f"lstm{i}")
            any_lstm |= use_lstm
            enc = data.draw(st.booleans(), label=f"enc{i}")
            specs.append(dict(
                input_dim=6 + 2 * i, name=f"s{i}", encoder_shapes=(8, 5) if enc else None,
                encoder_nonlinearities=("sigmoid", "linear") if enc else None,
                use_delta=data.draw(st.booleans(), label=f"delta{i}"), use_lstm=use_lstm))
        agg_layers = data.draw(st.integers(0, 2), label="agg_layers")
        if not any_lstm and agg_layers == 0:
            agg_layers = 1
        dims = [(5 if s["encoder_shapes"] else s["input_dim"]) * (3 if s["use_delta"] else 1)
                if not s["use_lstm"] else 7 for s in specs]
        fusiontype = ("concat" if len(set(dims)) > 1 else
                      data.draw(st.sampled_from(["sum", "concat"]), label="fusion"))
        kw = dict(output_classes=4, lstm_size=7, window=window, fusiontype=fusiontype,
                  agg_layers=agg_layers, agg_bidirectional=False,
                  output_mode=data.draw(st.sampled_from(["per_step", "last_step"]),
                                        label="head"),
                  use_peepholes=data.draw(st.booleans(), label="peep"), w_init="glorot")
        jcfg, tcfg = [ad.AdeNetConfig(streams=[ad.StreamSpec(**s) for s in specs], **kw)
                      for ad in (jadenet, tadenet)]
        T = data.draw(st.integers(max(2 * window, 3), 14), label="T")
        rng = np.random.RandomState(T)
        xs = [rng.randn(1, T, s["input_dim"]).astype(np.float32) for s in specs]
        splits, left = [], T
        while left > 0:
            n = min(data.draw(st.integers(1, 5)), left)
            splits.append(n)
            left -= n
        ref, got, _, one_shot = _both(jcfg, tcfg, 7, xs, splits)
        if tcfg.output_mode == "per_step":
            _hold(ref, got, one_shot)
        else:
            np.testing.assert_allclose(got[0], ref[0], **TOL)
            _hold(ref, got, one_shot, mode="last_step")

    run()


def test_streaming_chunking_property():
    """Hypothesis: any chunk split gives the JAX session's scores and the
    one-shot ones."""
    from hypothesis import given, settings, strategies as st

    jcfg, tcfg = _streamable()
    jp, tp = _params(jcfg, 5)
    T = 18
    x = np.random.RandomState(5).randn(1, T, 12).astype(np.float32)
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, T)).numpy()
    ref = np.asarray(jserve.make_server(jp, jcfg, vote=False)([x], np.ones((1, T), np.float32)))
    template = tserve.StreamingSession(tp, tcfg, device="cpu")

    @settings(max_examples=15, deadline=None, derandomize=True)
    @given(st.lists(st.integers(1, 6), min_size=1, max_size=18))
    def run(sizes):
        total, splits = 0, []
        for n in sizes:
            if total + n > T:
                break
            splits.append(n)
            total += n
        if total < T:
            splits.append(T - total)
        emitted, _ = _run(template.fresh(), [x], splits)
        np.testing.assert_allclose(emitted, one_shot, **ONE_SHOT_TOL)
        np.testing.assert_allclose(emitted, ref, **TOL)

    run()


def test_fresh_sessions_share_callables_and_match():
    """fresh() revives per-utterance sessions from one set of prep/advance
    callables and parameters on the device; scores equal a newly built
    session's, and the JAX session's."""
    jcfg, tcfg = _streamable()
    jp, tp = _params(jcfg, 0)
    template = tserve.StreamingSession(tp, tcfg, device="cpu")
    jtemplate = jserve.StreamingSession(jp, jcfg)
    rng = np.random.RandomState(3)
    for _ in range(2):
        x = rng.randn(1, 11, 12).astype(np.float32)
        a, b, j = template.fresh(), tserve.StreamingSession(tp, tcfg, device="cpu"), \
            jtemplate.fresh()
        out_a = list(a.feed([x])) + [a.finalize()[0]]
        out_b = list(b.feed([x])) + [b.finalize()[0]]
        out_j = list(j.feed([x])) + [j.finalize()[0]]
        for u, v, w in zip(out_a, out_b, out_j):
            assert np.array_equal(u, v)
            np.testing.assert_allclose(u, np.asarray(w), **TOL)
        assert a._prep[0] is template._prep[0] and a._advance is template._advance
        assert a._state0 is template._state0


def test_streaming_state_stays_a_tensor_tree():
    """The carried state is the head's (cell, hid) per recurrence, (B, H)
    tensors on the session's device, replaced by every advance."""
    _, tcfg = _cfgs("adenet_v2_3", 12, 8, encoder_shapes=[10, 6],
                    encoder_nonlinearities=["sigmoid", "linear"], lstm_size=8, window=3,
                    output_classes=4)
    tp = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    sess = tserve.StreamingSession(tp, tcfg, batch=2, device="cpu")
    state0 = sess._state
    assert set(state0["streams"]) == {"raw", "dct"} and len(state0["aggregator"]) == 1
    sess.feed([np.ones((2, 9, 12), np.float32), np.ones((2, 9, 8), np.float32)])
    for cell, hid in (*sess._state["streams"].values(), *sess._state["aggregator"]):
        assert cell.shape == hid.shape == (2, 8) and cell.device.type == "cpu"
    assert sess._state is not state0


@pytest.mark.parametrize("build,args", [
    ("lstm_classifier_baseline", (12,)),
    ("adenet_v2", (1144, 90)),
    ("adenet_v2_1", (1144, 1144)),
    ("adenet_v2_3", (1144, 90)),
    ("adenet_v2_4", (1144, 1144)),
    ("adenet_v4", (1144, 90)),
])
def test_zoo_builders_match_jax(build, args):
    for kw in ({}, {"lstm_size": 16, "output_classes": 10}):
        jcfg, tcfg = (getattr(z, build)(*args, **kw) for z in (jzoo, tzoo))
        assert jax_fields(tcfg) == dataclasses.asdict(jcfg)
