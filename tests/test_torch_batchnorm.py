"""Batch norm through the port's training, serving, streaming and export paths
against the JAX package, on the tiny adenet_v1 of tests/zoo_cases.py (a
sigmoid encoder, batch norm, the delta, a DCT stream concatenated into two
BLSTM layers, no dropout) and a streamable batch-norm stream.

* one train step (Trainer.train_step and make_train_step) against the JAX
  Trainer's jitted step, whose ``jax.value_and_grad`` carries the aux and
  merges the moved running statistics after the Adam update: loss 1e-5
  relative, gradients (read from Adam's m) 1e-4 of each gradient's max
  abs (batch norm's backward multiplies float32 noise by 1/std, about 50
  at this init: the encoder's gradients differ by up to 2.8e-5 of max
  abs), updated parameters and ``bn_state`` 1e-5.  One leaf is held
  otherwise: the bias of the encoder's last layer, which batch norm
  follows, has an exact gradient of zero (any shift is normalized away).
  Each package returns float32 noise there (the port 2.0e-6, JAX 3e-8:
  sums of 50 rows of about 0.5 that cancel), held under 1e-4 of the same
  layer's weight gradient; Adam turns any nonzero gradient into a step of
  about lr, so that bias is held to have moved by at most lr in both;
* one ``Trainer.fit`` against the JAX Trainer at dropout 0, with adadelta,
  the reference schedule's optimizer (Adam would step that bias by lr in
  the direction of each package's noise, and evaluation's running
  statistics do not remove the shift, so the two fits' costs would part:
  3.5e-3 relative after 9 steps at lr 0.01): costs 1e-5 relative, rates
  and confusion matrix equal, ``bn_state`` moved from its init, best
  parameters within FIT_PARAM_TOL = 1e-4 of each leaf's max abs.  The
  batch-norm stream's encoder biases take gradients that are sums of
  terms that cancel (batch norm takes the mean out of its input's
  gradient): those within 1e-3 of their max abs (2.9e-4 measured), and the
  zero-gradient bias within 1e-4 absolute (the port's noise walk, 5e-5);
* a batch-norm stream through ``serve.StreamingSession`` against the JAX
  session (2e-5), its running statistics away from their init;
* a batch-norm artifact (``export.save_artifact``) against its live server
  and a streaming artifact against its live session (1e-6).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu import serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch import bridge, export as texport, serve as tserve
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.train import trainer as ttr
from tests import torch_trainer_lib as lib
from tests import zoo_cases

torch.set_num_threads(1)
V1_DIMS = (20, 8)
FIT_PARAM_TOL = 1e-4
FIT_ENCODER_BIAS_TOL = 1e-3
FIT_ZERO_GRAD_ATOL = 1e-4


def _v1():
    return zoo_cases.ZOO_CASES["adenet_v1"](), lib.zoo_case("adenet_v1")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, B=5, T=10, seed=1):
    rng = np.random.RandomState(seed)
    streams = [(3 * rng.randn(B, T, s.input_dim) + 1).astype(np.float32) for s in cfg.streams]
    lens = np.array([T, 6, 1, 0, 8][:B])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    y = rng.randint(0, cfg.output_classes, B).astype(np.int32)
    return streams, y, mask


def _leaves(tree):
    """[(path, numpy leaf)] of a tensor or numpy tree."""
    return [(path, np.asarray(t.detach().cpu() if hasattr(t, "detach") else t))
            for path, t in chip_smoke.named_leaves(tree)]


def _assert_trees(got, ref, tol, what, skip=()):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert sorted(got) == sorted(ref), what
    for k, r in ref.items():
        if k in skip:
            continue
        scale = max(np.abs(r).max(), 1e-3) if what == "grad" else 1.0
        np.testing.assert_allclose(got[k], r, rtol=0, atol=tol * scale, err_msg=f"{what} {k}")


def _assert_noise_step(grads, params0, params1, layers, lr):
    """At each layer of ``layers``: the bias gradient under 1e-4 of the
    weight gradient's max abs, the bias moved by at most ``lr``."""
    g, p0, p1 = (dict(_leaves(t)) for t in (grads, params0, params1))
    for layer in layers:
        assert np.abs(g[f"{layer}/b"]).max() <= 1e-4 * np.abs(g[f"{layer}/w"]).max(), layer
        assert np.abs(p1[f"{layer}/b"] - p0[f"{layer}/b"]).max() <= lr * (1 + 1e-3), layer


@pytest.mark.parametrize("entry", ["Trainer.train_step", "make_train_step"])
def test_adenet_v1_train_step_matches_jax(entry):
    jcfg, tcfg = _v1()
    opts = dict(optimizer="adam", learning_rate=1e-4)
    jt = jtr.Trainer(jcfg, lib.quiet_options(jtr, **opts))
    jp = lib.jax_params(jt)
    streams, y, mask = _batch(jcfg)
    # the jitted step donates its parameters and state: hand it copies
    jstate = _np(jt.optimizer.init(jax.tree_util.tree_map(jnp.asarray, jp)))
    jp1, js1, jloss = jt.train_step(jax.tree_util.tree_map(jnp.asarray, copy.deepcopy(jp)),
                                    jax.tree_util.tree_map(jnp.asarray, jstate),
                                    [jnp.asarray(s) for s in streams], jnp.asarray(y),
                                    jnp.asarray(mask), jax.random.PRNGKey(0), 1e-4)
    jp1, js1 = _np(jp1), _np(js1)

    tp = bridge.params_from_jax(jp, device="cpu")
    ts = bridge.params_from_jax(jstate, device="cpu")
    args = ([torch.from_numpy(s) for s in streams], torch.from_numpy(y).long(),
            torch.from_numpy(mask))
    if entry == "Trainer.train_step":
        tt = ttr.Trainer(tcfg, lib.quiet_options(ttr, **opts), device="cpu")
        tp1, ts1, tloss = tt.train_step(tp, ts, *args, torch.Generator(), 1e-4)
    else:
        _, step = ttr.make_train_step(tcfg, lr=1e-4)
        tp1, ts1, tloss = step(tp, ts, *args)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    grads = jax.tree_util.tree_map(lambda m: m / 0.1, js1["m"])
    tgrads = jax.tree_util.tree_map(lambda m: m / 0.1, lib.bridge_numpy(ts1["m"]))
    skip = chip_smoke.zero_grad_biases(tcfg)
    assert skip == ["/streams/raw/encoder/bottleneck/b"]
    layers = [path[:-2] for path in skip]
    _assert_trees(tgrads, grads, 1e-4, "grad", skip)
    bn = {"bn_state": tp1["streams"]["raw"]["bn_state"]}
    _assert_trees(bn, {"bn_state": jp1["streams"]["raw"]["bn_state"]}, 1e-5, "bn_state")
    _assert_trees(tp1, jp1, 1e-5, "param", skip)
    _assert_noise_step(tgrads, jp, tp1, layers, 1e-4)
    _assert_noise_step(grads, jp, jp1, layers, 1e-4)
    # the statistics moved; their gradient was zero
    assert not np.allclose(bn["bn_state"]["var"].numpy(), 1.0)
    assert not np.abs(grads["streams"]["raw"]["bn_state"]["mean"]).any()


def test_adenet_v1_fit_matches_jax():
    jcfg, tcfg = _v1()
    jr, tr, jt, _ = lib.fit_both(jtr, ttr, jcfg, tcfg, V1_DIMS, optimizer="adadelta",
                                 learning_rate=1.0)
    np.testing.assert_allclose(tr.cost_train, jr.cost_train, rtol=lib.COST_RTOL)
    np.testing.assert_allclose(tr.cost_val, jr.cost_val, rtol=lib.COST_RTOL)
    assert (tr.class_rate, tr.best_cr, tr.test_cr, tr.epochs_run) == (
        jr.class_rate, jr.best_cr, jr.test_cr, jr.epochs_run)
    np.testing.assert_array_equal(tr.test_conf, np.asarray(jr.test_conf))
    got, ref = dict(_leaves(tr.best_params)), dict(_leaves(jr.best_params))
    zero = chip_smoke.zero_grad_biases(tcfg)
    for k, r in ref.items():
        err = np.abs(got[k] - r).max()
        if k in zero:
            assert err <= FIT_ZERO_GRAD_ATOL, (k, err)
        elif "/encoder/" in k and k.endswith("/b"):
            assert err <= FIT_ENCODER_BIAS_TOL * np.abs(r).max(), (k, err)
        else:
            assert err <= FIT_PARAM_TOL * np.abs(r).max(), (k, err)
    init = lib.jax_params(jt)["streams"]["raw"]["bn_state"]
    moved = tr.best_params["streams"]["raw"]["bn_state"]
    assert not np.allclose(moved["mean"].numpy(), init["mean"])


def _bn_stream_cfgs():
    """A streamable batch-norm model: encoder, batch norm, delta, forward
    LSTM aggregator, per-step head."""
    out = []
    for zoo in (jzoo, tzoo):
        cfg = zoo.deltanet_majority_vote(12, [10, 6], ["sigmoid", "linear"], lstm_size=8,
                                         window=3, output_classes=4)
        out.append(dataclasses.replace(cfg, agg_bidirectional=False, streams=[
            dataclasses.replace(cfg.streams[0], use_batchnorm=True)]))
    return out


def _moved_params(jcfg, seed=0):
    jp = _np(jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.RandomState(seed)
    for spec in jcfg.streams:
        if spec.use_batchnorm:
            d = spec.encoded_dim()
            jp["streams"][spec.name]["bn_state"] = {
                "mean": (0.3 * rng.randn(d)).astype(np.float32),
                "var": (0.5 + rng.rand(d)).astype(np.float32)}
            jp["streams"][spec.name]["bn"]["gamma"] = (1 + 0.2 * rng.randn(d)).astype(
                np.float32)
    return jp, bridge.params_from_jax(jp, device="cpu")


def _feed(sess, streams, splits):
    got, s = [], 0
    for n in splits:
        got += list(sess.feed([x[:, s:s + n] for x in streams]))
        s += n
    tail, result = sess.finalize()
    return np.concatenate([np.stack(got, axis=1), tail], axis=1), result


def test_streaming_session_with_batch_norm_matches_jax():
    jcfg, tcfg = _bn_stream_cfgs()
    jp, tp = _moved_params(jcfg)
    x = np.random.RandomState(4).randn(1, 17, 12).astype(np.float32)
    splits = [1, 4, 2, 7, 3]
    ref = _feed(jserve.StreamingSession(jax.tree_util.tree_map(jnp.asarray, jp), jcfg),
                [x], splits)
    got = _feed(tserve.StreamingSession(tp, tcfg, device="cpu"), [x], splits)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    one_shot = tserve.make_server(tp, tcfg, vote=False, device="cpu")(
        [torch.from_numpy(x)], torch.ones(1, 17)).numpy()
    np.testing.assert_allclose(got[0], one_shot, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["server", "streaming"])
def test_batch_norm_artifact_matches_its_live_server(kind, tmp_path):
    path = str(tmp_path / "bn.ipax")
    if kind == "server":
        jcfg, tcfg = _v1()
        _, tp = _moved_params(jcfg)
        texport.save_artifact(path, tp, tcfg, device="cpu")
        streams, _, mask = _batch(tcfg, B=4, T=9, seed=5)
        mask[3] = 0.0
        mask[3, :4] = 1.0
        got = texport.load_server(path, device="cpu")(streams, mask).numpy()
        live = tserve.make_server(tp, tcfg, device="cpu")(
            [torch.from_numpy(s) for s in streams], torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)
        return
    jcfg, tcfg = _bn_stream_cfgs()
    _, tp = _moved_params(jcfg)
    texport.save_streaming_artifact(path, tp, tcfg, device="cpu")
    x = np.random.RandomState(6).randn(1, 13, 12).astype(np.float32)
    got = _feed(texport.load_streaming_session(path, device="cpu"), [x], [5, 8])
    live = _feed(tserve.StreamingSession(tp, tcfg, device="cpu"), [x], [5, 8])
    np.testing.assert_allclose(got[0], live[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1], live[1])
