"""The port's optimizers and initializers (ip_avsr_torch/train/optimizers.py,
ops/initializers.py) against the JAX package's.

Every optimizer runs 5 steps on a real (tiny) AdeNet parameter tree with the
same seeded gradients as its JAX twin, with and without a per-step
``learning_rate`` override (the trainer passes its scheduled rate each step),
and a JAX optimizer state carried across by ``bridge.params_from_jax``
continues identically.  Tolerance: 1e-6 relative to each leaf's max abs
(float32, the same arithmetic per element).  The rate maps are equal and
``generate_lr_map`` warns with the same text.  Draws of the initializers
differ between the packages, so those tests check statistics.
"""

import dataclasses
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops import initializers as jinit
from ip_avsr_tpu.train import optimizers as jopt
from ip_avsr_torch import bridge
from ip_avsr_torch.ops import initializers as tinit
from ip_avsr_torch.train import optimizers as topt

torch.set_num_threads(1)
RTOL = 1e-6
LR_MAP = {"output": 0.05, "aggregator/0/bwd": 0.001, "streams/raw/encoder/fc1": 0.3}


def _tree():
    """The tiny trimodal adenet_v3's JAX parameters, numpy leaves."""
    cfg = jzoo.adenet_v3(6, 4, 6, lstm_size=2, window=2, output_classes=3)
    enc = (("sigmoid", "linear"), (5, 3))
    cfg = dataclasses.replace(cfg, streams=[
        dataclasses.replace(s, encoder_shapes=enc[1], encoder_nonlinearities=enc[0])
        if s.encoder_shapes else s for s in cfg.streams])
    return jax.tree_util.tree_map(np.asarray,
                                  jadenet.init_adenet_params(jax.random.PRNGKey(1), cfg))


def _grads(tree, step):
    rng = np.random.RandomState(100 + step)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * 10.0 ** rng.randint(-3, 1)).astype(np.float32), tree)


def _pair(name, lr, params_np):
    """(JAX optimizer, port optimizer) of the same settings."""
    if name == "adam_vlr":
        return (jopt.adam_vlr(jopt.generate_lr_map(params_np, LR_MAP, 0.01), base_lr=0.01),
                topt.adam_vlr(topt.generate_lr_map(bridge.params_from_jax(
                    params_np, device="cpu"), LR_MAP, 0.01), base_lr=0.01))
    return jopt.select_optimizer(name, lr), topt.select_optimizer(name, lr)


def _assert_trees_close(got, ref):
    """Port tree (tensors) against JAX tree, same structure, leaf by leaf."""
    ref = jax.tree_util.tree_map(np.asarray, ref)
    got_np = jax.tree_util.tree_map(lambda t: t.detach().numpy(), got)
    assert jax.tree_util.tree_structure(got_np) == jax.tree_util.tree_structure(ref)
    for g, r in zip(jax.tree_util.tree_leaves(got_np), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=RTOL * max(np.abs(r).max(), 1e-30))


def _run(jo, to, jp, js, tp, ts, steps, first, override):
    for step in range(first, first + steps):
        g = _grads(jp, step)
        kw = {} if override is None else {"learning_rate": override * 0.9 ** step}
        jp, js = jo.apply(jax.tree_util.tree_map(jnp.asarray, jp),
                          jax.tree_util.tree_map(jnp.asarray, g), js,
                          **({k: jnp.float32(v) for k, v in kw.items()}))
        tp, ts = to.apply(tp, bridge.params_from_jax(g, device="cpu"), ts, **kw)
        _assert_trees_close(tp, jp)
        _assert_trees_close(ts, js)
    return jp, js, tp, ts


CASES = [(name, lr, override)
         for name, lr in (("adam", 1e-3), ("adadelta", 1.0), ("momentum", 0.05),
                          ("nesterov", 0.05), ("adam_vlr", 0.01))
         for override in (None, 0.02)]


@pytest.mark.parametrize("name,lr,override", CASES)
def test_optimizer_matches_jax_for_five_steps(name, lr, override):
    params = _tree()
    jo, to = _pair(name, lr, params)
    js = jo.init(jax.tree_util.tree_map(jnp.asarray, params))
    tp = bridge.params_from_jax(params, device="cpu")
    ts = to.init(tp)
    _assert_trees_close(ts, js)
    _run(jo, to, params, js, tp, ts, 5, 0, override)


@pytest.mark.parametrize("name,lr", [("adadelta", 1.0), ("momentum", 0.05),
                                     ("adam_vlr", 0.01), ("adam", 1e-3)])
def test_jax_state_carries_across_and_continues(name, lr):
    """3 JAX steps, then the JAX state (numpy leaves) through
    bridge.params_from_jax: 2 more port steps equal 2 more JAX steps."""
    params = _tree()
    jo, to = _pair(name, lr, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jo.init(jp)
    for step in range(3):
        jp, js = jo.apply(jp, jax.tree_util.tree_map(jnp.asarray, _grads(params, step)), js)
    carried = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    _run(jo, to, jax.tree_util.tree_map(np.asarray, jp), js, tp, carried, 2, 3, None)


def test_generate_lr_map_matches_jax_rates_and_warning():
    params = _tree()
    config = {**LR_MAP, "streams/missing": 9.0}
    with pytest.warns(UserWarning) as jw:
        jmap = jopt.generate_lr_map(params, config, 0.01)
    with pytest.warns(UserWarning) as tw:
        tmap = topt.generate_lr_map(bridge.params_from_jax(params, device="cpu"), config, 0.01)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert "'streams/missing' matches no parameter path" in str(tw[0].message)
    assert jax.tree_util.tree_leaves(tmap) == jax.tree_util.tree_leaves(jmap)
    assert jax.tree_util.tree_structure(tmap) == jax.tree_util.tree_structure(jmap)
    # the list entry is named by its index, the prefixes apply where they match
    assert tmap["aggregator"][0]["bwd"]["w_in"] == 0.001
    assert tmap["aggregator"][0]["fwd"]["w_in"] == 0.01
    assert tmap["streams"]["raw"]["encoder"]["fc1"]["w"] == 0.3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        topt.generate_lr_map(bridge.params_from_jax(params, device="cpu"), LR_MAP, 0.01)


@pytest.mark.parametrize("name", ["adam", "adadelta", "momentum", "nesterov"])
def test_select_optimizer_names(name):
    params = bridge.params_from_jax(_tree(), device="cpu")
    jstate = jopt.select_optimizer(name, 0.1).init(
        jax.tree_util.tree_map(jnp.asarray, _tree()))
    tstate = topt.select_optimizer(name, 0.1).init(params)
    assert set(tstate) == set(jstate)
    if name in ("momentum", "nesterov"):
        for module in (jopt, topt):
            with pytest.raises(TypeError):
                module.select_optimizer(name)
    else:
        assert set(topt.select_optimizer(name).init(params)) == set(jstate)
    with pytest.raises(KeyError):
        topt.select_optimizer("sgd", 0.1)


def test_optimizers_leave_their_inputs_alone():
    params = bridge.params_from_jax(_tree(), device="cpu")
    grads = bridge.params_from_jax(_grads(_tree(), 0), device="cpu")
    before = {id(t): t.clone() for t in jax.tree_util.tree_leaves(params)}
    for name in ("adam", "adadelta", "momentum", "nesterov"):
        opt = topt.select_optimizer(name, 0.1)
        state = opt.init(params)
        opt.apply(params, grads, state)
    for t in jax.tree_util.tree_leaves(params):
        torch.testing.assert_close(t, before[id(t)], rtol=0, atol=0)


@pytest.mark.parametrize("rng_range", [0.01, 0.5])
def test_uniform_statistics(rng_range):
    g = torch.Generator().manual_seed(0)
    u = tinit.uniform(rng_range)(g, (300, 400))
    j = np.asarray(jinit.uniform(rng_range)(jax.random.PRNGKey(0), (300, 400)))
    for a in (u.numpy(), j):
        assert np.abs(a).max() <= rng_range and np.abs(a).max() > 0.99 * rng_range
        assert abs(a.mean()) < 0.01 * rng_range
        assert abs(a.std() - rng_range / np.sqrt(3)) < 0.01 * rng_range
    assert u.dtype == torch.float32 and tuple(u.shape) == (300, 400)


def test_constant_and_registry():
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    c = tinit.constant(0.7)(g, (3, 4))
    torch.testing.assert_close(c, torch.full((3, 4), 0.7))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jinit.constant(0.7)(None, (3, 4))))
    assert torch.equal(g.get_state(), state)  # draws nothing
    assert set(tinit._REGISTRY) == set(jinit._REGISTRY)
    assert tinit.select_weight_init(tinit.constant(1.0)) is not None
