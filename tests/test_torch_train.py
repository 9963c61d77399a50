"""The port's training step (ip_avsr_torch/train, ops/losses.py and dropout in
models/adenet.py) against the JAX package.

The whole-step oracle is ``bench._make_train_step`` on the tiny adenet_v3 of
bench.py's quick mode, with the dropout rates set to 0 (torch's random bits
differ from JAX's), from JAX parameters carried across by
``bridge.params_from_jax``.  On the CPU the JAX step takes its XLA scans.
Its gradients are read from the Adam state after one step (m = 0.1 g).

Tolerances, float32: losses and the optimizer at 1e-6 relative (the same
arithmetic in the same order); the step's loss at 1e-5, each gradient at
1e-5 relative to the largest entry of that gradient, and updated parameters
at 1e-6 absolute (Adam's first step moves each entry by about lr = 1e-4,
so a gradient's rounding cannot move it further).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops import losses as jlosses
from ip_avsr_tpu.train import optimizers as jopt
from ip_avsr_torch import bridge
from ip_avsr_torch.device import tree_map
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.ops import losses as tlosses
from ip_avsr_torch.train import optimizers as topt, trainer as ttrainer

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tiny(zoo, ad, output_mode="last_step", dropout=0.0):
    """bench.py's tiny adenet_v3, its dropout rates set to ``dropout``."""
    enc = (("sigmoid", "sigmoid", "sigmoid", "linear"), (32, 24, 16, 8))
    cfg = zoo.adenet_v3(64, 16, 64, lstm_size=16, window=4, output_classes=10)
    streams = [dataclasses.replace(s, dropout=dropout,
                                   **({"encoder_shapes": enc[1],
                                       "encoder_nonlinearities": enc[0]}
                                      if s.encoder_shapes else {}))
               for s in cfg.streams]
    return dataclasses.replace(cfg, streams=streams, output_mode=output_mode,
                               agg_dropout=dropout)


def _batch(seed, cfg, B=4, T=11):
    rng = np.random.RandomState(seed)
    streams = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
    lens = np.array([T, 5, 1, 0, 8, 3][:B])  # an all-pad row has weight 0
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    y = rng.randint(0, cfg.output_classes, B).astype(np.int32)
    return streams, y, mask


@pytest.mark.parametrize("output_mode", ["last_step", "per_step"])
def test_train_step_matches_bench_train_step(output_mode):
    jcfg = _tiny(jzoo, jadenet, output_mode)
    tcfg = _tiny(tzoo, tadenet, output_mode)
    jparams = jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg)
    streams, y, mask = _batch(1, jcfg)
    jo, jstep = bench._make_train_step(jcfg)
    jstate = jo.init(jparams)
    jp1, js1, jloss = jstep(jparams, jstate, [jnp.asarray(s) for s in streams],
                            jnp.asarray(y), jnp.asarray(mask), jax.random.PRNGKey(0))
    jp1, js1 = _np(jp1), _np(js1)

    tparams = bridge.params_from_jax(_np(jparams), device="cpu")
    tstate = bridge.params_from_jax(_np(jstate), device="cpu")
    tstreams = [torch.from_numpy(s) for s in streams]
    ty, tmask = torch.from_numpy(y).long(), torch.from_numpy(mask)
    loss, grads = ttrainer.loss_and_grads(tparams, tcfg, tstreams, ty, tmask)
    _, step = ttrainer.make_train_step(tcfg)
    tp1, ts1, tloss = step(tparams, tstate, tstreams, ty, tmask,
                           torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    pairs = _pairs(grads, tree_map(lambda m: m / 0.1, js1["m"]))
    assert len(pairs) == len(jax.tree_util.tree_leaves(jparams))
    for g, r, path in pairs:
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * max(1e-3, np.abs(r).max()),
                                   rtol=0, err_msg=f"grad {path}")
    for g, r, path in _pairs(tp1, jp1):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-6, rtol=0, err_msg=f"param {path}")
    assert float(ts1["t"]) == 1.0


def _pairs(got, ref, path=""):
    """[(port leaf, JAX leaf, path)] over two trees of the same structure."""
    if isinstance(ref, dict):
        return [p for k in ref for p in _pairs(got[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (list, tuple)):
        return [p for i, r in enumerate(ref) for p in _pairs(got[i], r, f"{path}/{i}")]
    return [(got, ref, path)]


def test_adam_matches_jax_over_three_steps():
    rng = np.random.RandomState(2)
    params = {"a": [rng.randn(3, 4).astype(np.float32)], "b": rng.randn(5).astype(np.float32)}
    grads = [tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
             for _ in range(3)]
    jo, to = jopt.adam(0.01), topt.adam(0.01)
    jp, js = jax.tree_util.tree_map(jnp.asarray, params), None
    js = jo.init(jp)
    tp = tree_map(torch.from_numpy, params)
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.apply(jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        tp, ts = to.apply(tp, tree_map(torch.from_numpy, g), ts)
    np.testing.assert_allclose(tp["a"][0].numpy(), np.asarray(jp["a"][0]), **TOL)
    np.testing.assert_allclose(tp["b"].numpy(), np.asarray(jp["b"]), **TOL)
    np.testing.assert_allclose(ts["v"]["b"].numpy(), np.asarray(js["v"]["b"]), **TOL)
    assert float(ts["t"]) == float(js["t"]) == 3.0


def test_adam_state_carries_across_from_jax():
    params = {"w": np.ones((2, 2), np.float32)}
    jo = jopt.adam(0.1)
    jp = {"w": jnp.asarray(params["w"])}
    js = jo.init(jp)
    jp, js = jo.apply(jp, {"w": jnp.full((2, 2), 0.5)}, js)
    ts = bridge.params_from_jax(_np(js), device="cpu")
    assert set(ts) == {"m", "v", "t"} and ts["t"].dim() == 0
    tp, ts = topt.adam(0.1).apply(bridge.params_from_jax(_np(jp), device="cpu"),
                                  {"w": torch.full((2, 2), -1.0)}, ts)
    jp, js = jo.apply(jp, {"w": jnp.full((2, 2), -1.0)}, js)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), **TOL)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_temporal_softmax_loss_matches_jax(scale):
    rng = np.random.RandomState(3)
    x = (rng.rand(3, 5, 4) * scale).astype(np.float32)
    y = rng.randint(0, 4, (3, 5)).astype(np.int32)
    mask = (rng.rand(3, 5) > 0.3).astype(np.float32)
    ref = jlosses.temporal_softmax_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask))
    got = tlosses.temporal_softmax_loss(torch.from_numpy(x), torch.from_numpy(y),
                                        torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_categorical_crossentropy_masked_matches_jax_and_clamps_pad_rows():
    rng = np.random.RandomState(4)
    probs = rng.rand(4, 3).astype(np.float32)
    probs /= probs.sum(1, keepdims=True)
    y = np.array([0, 2, 1, 1], np.int32)
    probs[3, 1] = 0.0  # a pad row whose picked probability underflowed
    w = np.array([1, 1, 1, 0], np.float32)
    ref, ref_g = jax.value_and_grad(jlosses.categorical_crossentropy_masked)(
        jnp.asarray(probs), jnp.asarray(y), jnp.asarray(w))
    tp = torch.from_numpy(probs).requires_grad_(True)
    got = tlosses.categorical_crossentropy_masked(tp, torch.from_numpy(y), torch.from_numpy(w))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(ref_g), **TOL)
    assert np.isfinite(tp.grad.numpy()).all()
    # all rows padded: the loss is 0, not 0/0
    zero = tlosses.categorical_crossentropy_masked(tp, torch.from_numpy(y), torch.zeros(4))
    assert float(zero.detach()) == 0.0


def test_dropout_is_identity_at_rate_zero_or_outside_training():
    x = torch.randn(3, 4, 5, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    assert tadenet._dropout(x, 0.0, g, True) is x
    assert tadenet._dropout(x, 0.5, g, False) is x


def test_dropout_keeps_values_scaled_by_one_over_keep():
    x = torch.rand(200, 50, generator=torch.Generator().manual_seed(0)) + 0.5
    out = tadenet._dropout(x, 0.2, torch.Generator().manual_seed(3), True)
    kept = out != 0
    torch.testing.assert_close(out[kept], x[kept] / 0.8, rtol=1e-6, atol=0)
    assert abs(kept.float().mean().item() - 0.8) < 0.01
    # the same seed draws the same mask
    again = tadenet._dropout(x, 0.2, torch.Generator().manual_seed(3), True)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


def test_train_forward_runs_on_cpu_with_dropout():
    cfg = _tiny(tzoo, tadenet, dropout=0.5)
    params = tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    streams, y, mask = _batch(5, cfg)
    streams = [torch.from_numpy(s) for s in streams]
    mask = torch.from_numpy(mask)
    a = tadenet.adenet_forward(params, cfg, streams, mask, train=True,
                               generator=torch.Generator().manual_seed(7))
    b = tadenet.adenet_forward(params, cfg, streams, mask, train=True,
                               generator=torch.Generator().manual_seed(7))
    ref = tadenet.adenet_forward(params, cfg, streams, mask)
    assert a.shape == (4, 10) and torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - ref).abs().max() > 1e-4  # dropout acted
    # three steps at the flagship's own dropout rates: finite, and training
    opt, step = ttrainer.make_train_step(cfg, lr=1e-2)
    state = opt.init(params)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(3):
        params, state, loss = step(params, state, streams, torch.from_numpy(y).long(),
                                   mask, gen)
        losses.append(float(loss))
    assert np.isfinite(losses).all() and float(state["t"]) == 3.0
    assert all(torch.isfinite(g).all() for g, _, _ in _pairs(params, params))
