"""Whole models with ``matmul_dtype="bfloat16"``: the port against the JAX
package on the CPU, the JAX parameters carried across by
``bridge.params_from_jax`` (they stay float32 in both packages).

* the tiny flagship-shaped trimodal adenet_v3 through
  ``serve.make_trimodal_server`` and the tiny peephole 4-stream adasum
  model (the topology of ``configs/oulu_4stream.ini``) through
  ``serve.make_server``, against the JAX servers;
* one train step of each (loss, gradients, Adam's updated parameters)
  against ``jax.value_and_grad`` of the same loss and the JAX Adam;
* a ``StreamingSession`` (a forward-only peephole model, two streams, one
  with an encoder) against the JAX session;
* the symbolic artifact of a bf16 model against the JAX package's artifact
  of it.

Each case asserts the port within its tolerance of JAX and the port's own
float32 model on the same parameters more than ten times that tolerance
from JAX's bf16 result: the rounding happens.  Tolerances, measured at
these sizes (see the constants): probabilities absolute, gradients
relative to each leaf's max abs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu import export as jexport, serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.train import optimizers as jopt, trainer as jtrainer
from ip_avsr_torch import bridge, export as texport, serve as tserve
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.train import trainer as ttrainer

torch.set_num_threads(1)
BF16 = {"matmul_dtype": "bfloat16"}
# served, streamed and exported probabilities, absolute: measured up to
# 3e-8, where the port's float32 model lies 2e-4 to 2.2e-3 from JAX's bf16
# one
PROB_TOL = 1e-6
# train step: the loss relative (measured up to 6e-7); the 4-stream model's
# gradients relative to each leaf's max abs (measured up to 7.2e-7, every
# leaf's float32-vs-bf16 gap 2.2e-4 or more); the flagship's gradients as
# one vector in relative norm, a rounding flip included (measured 4.9e-4
# with the last-step head and 1.2e-4 with the per-step one, the float32
# gap 2.5e-3: see the test); the updated parameters absolute
LOSS_TOL = 2e-6
GRAD_TOL = 5e-6
FLIP_GRAD_TOL = 1e-3
PARAM_TOL = 1e-6
LR = 1e-4
T = 7


def _pair(build, *args, **kw):
    fields = kw.pop("replace", {})
    return [dataclasses.replace(getattr(z, build)(*args, **kw), **fields)
            for z in (jzoo, tzoo)]


def _flagship(**fields):
    """The tiny adenet_v3 (bench.py's quick shape: 64-pixel raw frames,
    DCT 16, encoders 32-24-16-8) for both packages."""
    enc = (("sigmoid", "sigmoid", "sigmoid", "linear"), (32, 24, 16, 8))
    out = []
    for cfg in _pair("adenet_v3", 64, 16, 64, lstm_size=16, window=4, output_classes=10):
        streams = [dataclasses.replace(s, encoder_shapes=enc[1], encoder_nonlinearities=enc[0])
                   if s.encoder_shapes else s for s in cfg.streams]
        out.append(dataclasses.replace(cfg, streams=streams, **fields))
    return out


def _four_stream(**fields):
    """The oulu_4stream topology at tiny widths: peepholes, adasum, two
    16/12/6 encoders, DCT 9 and MFCC 6 without, W = 3, H = 8."""
    encoders = [(("sigmoid", "rectify", "linear"), (16, 12, 6)),
                (("rectify", "sigmoid", "linear"), (16, 12, 6)), None, None]
    return [dataclasses.replace(
        zoo.adenet_nstream([20, 20, 9, 6], encoders, lstm_size=8, window=3, output_classes=10,
                           fusiontype="adasum", use_peepholes=True), **fields)
        for zoo in (jzoo, tzoo)]


def _params(jcfg, seed=0):
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _hold(got, ref, f32, tol, name):
    got, ref, f32 = (np.asarray(a, np.float64) for a in (got, ref, f32))
    err, gap = np.abs(got - ref).max(), np.abs(f32 - ref).max()
    assert err <= tol, f"{name}: {err:.3g} from JAX's bf16 result, tol {tol}"
    assert gap > 10 * tol, f"{name}: the float32 model is only {gap:.3g} from JAX's bf16 one"


def _streams(cfg, seed, B, lens):
    rng = np.random.RandomState(seed)
    streams = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    y = rng.randint(0, cfg.output_classes, B).astype(np.int32)
    return streams, mask, y


def _streamable(**fields):
    return _pair("adenet_v2", 12, 8, encoder_shapes=[10, 6],
                 encoder_nonlinearities=["sigmoid", "linear"], lstm_size=8, window=3,
                 output_classes=4, use_peepholes=True,
                 replace={"agg_bidirectional": False, **fields})


def _feed(sess, xs, splits=(5, 1, 8, 3)):
    got, s = [], 0
    for n in splits:
        got += list(sess.feed([x[:, s:s + n] for x in xs]))
        s += n
    tail, result = sess.finalize()
    return np.concatenate([np.stack(got, axis=1), tail], axis=1), result


@pytest.mark.parametrize("output_mode", ["last_step", "per_step"])
def test_bf16_trimodal_server_matches_jax(output_mode):
    """Raw uint8 frames through both packages' trimodal servers: the
    encoders', the projections' and the recurrences' bf16 products."""
    jcfg, tcfg = _flagship(output_mode=output_mode, **BF16)
    jp, tp = _params(jcfg)
    rng = np.random.RandomState(1)
    raw = rng.randint(0, 256, (3, T, 64)).astype(np.uint8)
    mask = (np.arange(T)[None] < np.array([[T], [4], [2]])).astype(np.float32)
    ref = np.asarray(jserve.make_trimodal_server(jp, jcfg, (8, 8), 16, vote=False)(
        jnp.asarray(raw), jnp.asarray(mask)))
    got = tserve.make_trimodal_server(tp, tcfg, (8, 8), 16, vote=False, device="cpu")(
        raw, mask).numpy()
    f32 = tserve.make_trimodal_server(tp, dataclasses.replace(tcfg, matmul_dtype=None),
                                      (8, 8), 16, vote=False, device="cpu")(raw, mask).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    _hold(got, ref, f32, PROB_TOL, "scores")


def test_bf16_4stream_server_matches_jax():
    jcfg, tcfg = _four_stream(**BF16)
    jp, tp = _params(jcfg)
    streams, mask, _ = _streams(jcfg, 2, 3, [T, 4, 2])
    ref = np.asarray(jserve.make_server(jp, jcfg, vote=False)(
        [jnp.asarray(s) for s in streams], jnp.asarray(mask)))
    got = tserve.make_server(tp, tcfg, vote=False, device="cpu")(streams, mask).numpy()
    f32 = tserve.make_server(tp, dataclasses.replace(tcfg, matmul_dtype=None), vote=False,
                             device="cpu")(streams, mask).numpy()
    _hold(got, ref, f32, PROB_TOL, "probabilities")


def _pairs(got, ref, path=""):
    if isinstance(ref, dict):
        return [p for k in ref for p in _pairs(got[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (list, tuple)):
        return [p for i, r in enumerate(ref) for p in _pairs(got[i], r, f"{path}/{i}")]
    return [(got, ref, path)]


@pytest.mark.parametrize("model", ["flagship_last_step", "flagship_per_step", "4-stream"])
def test_bf16_train_step_matches_jax(model):
    """One training step at dropout 0: the loss, every gradient and Adam's
    updated parameters against ``jax.value_and_grad`` of the JAX
    Trainer's loss and the JAX Adam; the parameters and Adam's state stay
    float32 in both packages.

    The 4-stream model is held leaf by leaf (GRAD_TOL of each gradient's
    max abs, each leaf's float32 gap more than ten times that).  The tiny
    flagship has a rounding flip: at step 3 of its diff stream's forward
    recurrence one h_{t-1}, 6e-8 apart in the two packages (their sums run
    in other orders), lies on a bf16 rounding boundary and rounds to
    neighbouring bf16 values, and the one-ulp difference carries through
    the recurrence (1e-4 by step 6) and the whole backward.  Such a
    difference is of the size of the rounding itself, so the flagship's
    gradients are held as one vector: within FLIP_GRAD_TOL of JAX's in
    relative norm, and the float32 model's gradients more than twice that
    away; the loss within LOSS_TOL; Adam's parameters within 2 lr (a
    gradient entry near 0 may change sign), at most 1% of them more than
    PARAM_TOL apart."""
    flagship = model.startswith("flagship")
    if flagship:
        jcfg, tcfg = _flagship(output_mode=model.split("_", 1)[1], agg_dropout=0.0, **BF16)
        jcfg, tcfg = (dataclasses.replace(c, streams=[dataclasses.replace(s, dropout=0.0)
                                                      for s in c.streams])
                      for c in (jcfg, tcfg))
    else:
        jcfg, tcfg = _four_stream(**BF16)
    jp, tp = _params(jcfg, seed=1)
    streams, mask, y = _streams(jcfg, 3, 3, [T, 4, 2])
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainOptions(log_fn=lambda s: None))
    jl, jg = jax.value_and_grad(jt._loss)(jp, [jnp.asarray(s) for s in streams], jnp.asarray(y),
                                          jnp.asarray(mask), True, jax.random.PRNGKey(0))
    jo = jopt.adam(LR)
    jp1, _ = jo.apply(jp, jg, jo.init(jp))

    tstreams = [torch.from_numpy(s) for s in streams]
    ty, tmask = torch.from_numpy(y).long(), torch.from_numpy(mask)
    loss, grads = ttrainer.loss_and_grads(tp, tcfg, tstreams, ty, tmask)
    f32_grads = ttrainer.loss_and_grads(tp, dataclasses.replace(tcfg, matmul_dtype=None),
                                        tstreams, ty, tmask)[1]
    opt, step = ttrainer.make_train_step(tcfg, lr=LR)
    tp1, state1, tloss = step(tp, opt.init(tp), tstreams, ty, tmask)
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_TOL)
    assert float(tloss) == float(loss)
    jg = jax.tree_util.tree_map(np.asarray, jg)
    pairs, f32_pairs = _pairs(grads, jg), _pairs(f32_grads, jg)
    assert len(pairs) == len(jax.tree_util.tree_leaves(jp))
    if flagship:
        flat = [np.concatenate([np.asarray(a, np.float64).ravel() for a in col])
                for col in zip(*((g.numpy(), r, f.numpy())
                                 for (g, r, _), (f, _, _) in zip(pairs, f32_pairs)))]
        got, ref, f32 = flat
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        gap = np.linalg.norm(f32 - ref) / np.linalg.norm(ref)
        assert err <= FLIP_GRAD_TOL, f"gradients {err:.3g} from JAX in relative norm"
        assert gap > 2 * FLIP_GRAD_TOL, f"the float32 gradients are only {gap:.3g} away"
    else:
        for (g, r, path), (f, _, _) in zip(pairs, f32_pairs):
            scale = max(np.abs(r).max(), 1e-8)
            err = np.abs(g.numpy() - r).max() / scale
            gap = np.abs(f.numpy() - r).max() / scale
            assert err <= GRAD_TOL, f"grad {path}: {err:.3g} of max abs from JAX"
            assert gap > 10 * GRAD_TOL, f"grad {path}: the float32 gap is {gap:.3g}"
    off = np.concatenate([np.abs(g.numpy() - r).ravel()
                          for g, r, _ in _pairs(tp1, jax.tree_util.tree_map(np.asarray, jp1))])
    assert off.max() <= 2 * LR + 1e-7
    assert (off > PARAM_TOL).mean() <= (0.01 if flagship else 0.0)
    assert all(g.dtype == torch.float32 for g, _, _ in _pairs(tp1, jp))
    assert all(v.dtype == torch.float32 for v in jax.tree_util.tree_leaves(state1["m"]))


def test_bf16_streaming_session_matches_jax():
    """A forward-only peephole adenet_v2 (an encoder stream and a plain
    delta stream) at batch 2, fed in ragged chunks: every emitted frame
    and the vote against the JAX session; the state variants of rows 1 and
    5 carry the float32 state between feeds."""
    jcfg, tcfg = _streamable(**BF16)
    jp, tp = _params(jcfg, seed=4)
    rng = np.random.RandomState(5)
    xs = [rng.randn(2, 17, 12).astype(np.float32), rng.randn(2, 17, 8).astype(np.float32)]
    ref = _feed(jserve.StreamingSession(jp, jcfg, batch=2), xs)
    got = _feed(tserve.StreamingSession(tp, tcfg, batch=2, device="cpu"), xs)
    f32 = _feed(tserve.StreamingSession(tp, dataclasses.replace(tcfg, matmul_dtype=None),
                                        batch=2, device="cpu"), xs)
    _hold(got[0], ref[0], f32[0], PROB_TOL, "emitted")
    np.testing.assert_array_equal(got[1], ref[1])
    # the session equals the port's own one-shot bf16 server
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x) for x in xs], torch.ones(2, 17)).numpy()
    np.testing.assert_allclose(got[0], one_shot, atol=1e-6, rtol=0)


def test_bf16_model_artifact_matches_the_jax_artifact(tmp_path):
    """The symbolic artifact of a bf16 model (float32 weights) against the
    JAX package's artifact of it and the port's live server: the loaded
    program runs the bf16 operators, and meta.json carries the dtype."""
    jcfg, tcfg = _four_stream(**BF16)
    jp, tp = _params(jcfg, seed=6)
    tpath, jpath = str(tmp_path / "t.ipax"), str(tmp_path / "j.ipax")
    texport.save_artifact(tpath, tp, tcfg, vote=False, device="cpu")
    jexport.save_artifact(jpath, jp, jcfg, vote=False)
    streams, mask, _ = _streams(jcfg, 7, 2, [T, 5])
    art = texport.load_server(tpath, device="cpu")
    assert art.config.matmul_dtype == "bfloat16"
    got = art(streams, mask).numpy()
    ref = np.asarray(jexport.load_server(jpath)([jnp.asarray(s) for s in streams],
                                                jnp.asarray(mask)))
    live = tserve.make_server(tp, tcfg, vote=False, device="cpu")(streams, mask).numpy()
    f32 = tserve.make_server(tp, dataclasses.replace(tcfg, matmul_dtype=None), vote=False,
                             device="cpu")(streams, mask).numpy()
    _hold(got, ref, f32, PROB_TOL, "artifact")
    np.testing.assert_array_equal(got, live)



@pytest.mark.parametrize("kind", ["bf16_model", "bf16_weights"])
def test_bf16_streaming_artifacts_match_the_jax_artifacts(kind, tmp_path):
    """Streaming artifacts (a session's prep and advance programs): of a
    bf16 model with float32 weights, and of a float32 model stored with
    bf16 weights, whose advance runs the peephole recurrence's bf16
    instantiation on the stored bf16 ``w_hid`` as the JAX advance rounds
    h_{t-1} to it.  Each session's frames against the JAX artifact's
    session within PROB_TOL, the port's float32 session more than ten times
    that away."""
    fields, save_kw = (({**BF16}, {}) if kind == "bf16_model"
                       else ({}, {"weights_dtype": "bfloat16"}))
    jcfg, tcfg = _streamable(**fields)
    jp, tp = _params(jcfg, seed=8)
    tpath, jpath = str(tmp_path / "t.ipax"), str(tmp_path / "j.ipax")
    texport.save_streaming_artifact(tpath, tp, tcfg, batch=2, device="cpu", **save_kw)
    jexport.save_streaming_artifact(jpath, jp, jcfg, batch=2, **save_kw)
    rng = np.random.RandomState(9)
    xs = [rng.randn(2, 17, 12).astype(np.float32), rng.randn(2, 17, 8).astype(np.float32)]
    got = _feed(texport.load_streaming_session(tpath, device="cpu"), xs)
    ref = _feed(jexport.load_streaming_session(jpath), xs)
    f32 = _feed(tserve.StreamingSession(tp, dataclasses.replace(tcfg, matmul_dtype=None),
                                        batch=2, device="cpu"), xs)
    _hold(got[0], ref[0], f32[0], PROB_TOL, "emitted")
    np.testing.assert_array_equal(got[1], ref[1])
