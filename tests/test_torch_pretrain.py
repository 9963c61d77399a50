"""The port's pretraining (ip_avsr_torch/pretrain: rbm, dbn, unfold,
finetune.finetune_autoencoder, sde) against the JAX package's, on the CPU at
small widths (a 12-8-6-3 DBN).

A torch generator cannot reproduce ``jax.random``, so every stochastic part
is held against JAX with JAX's own draws fed through the port's seams:
``cd1_step(noise=)`` and the module-level ``init_rbm``, ``batch_orders``
and ``draw_cd1_noise`` (RBMs, split as ``cd1_step`` and ``_rbm_epoch``
split their keys), ``init_layer`` and ``draw_corruption`` (SDE).  The
default draws are held by their statistics.

Tolerances, float32: one CD-1 step's state and velocity within 1e-6
(absolute; the update moves entries by about 1e-2), its error within 1e-5
relative; an epoch, a DBN and the finetuned or denoising AEs within 1e-5.
A Bernoulli state is ``probs > u``: a one-ulp difference in ``probs``
between the two packages' products flips it wherever ``u`` lies that
close, and the runs then diverge legitimately.  So every state comparison
counts the flips and reports the smallest ``|probs - u|`` in its message;
the seeded data here flips none, and no tolerance is widened to fit one.
The unfolding and ``extract_nn`` are numpy and equal exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.pretrain import dbn as jdbn
from ip_avsr_tpu.pretrain import finetune as jft
from ip_avsr_tpu.pretrain import rbm as jrbm
from ip_avsr_tpu.pretrain import sde as jsde
from ip_avsr_tpu.pretrain import unfold as junfold
from ip_avsr_torch import bridge, device as tdevice
from ip_avsr_torch.ops import losses as tlosses
from ip_avsr_torch.pretrain import dbn as tdbn
from ip_avsr_torch.pretrain import finetune as tft
from ip_avsr_torch.pretrain import rbm as trbm
from ip_avsr_torch.pretrain import sde as tsde
from ip_avsr_torch.pretrain import unfold as tunfold
from ip_avsr_tpu.ops import losses as jlosses

torch.set_num_threads(1)
STEP_TOL = dict(atol=1e-6, rtol=0)
TOL = dict(atol=1e-5, rtol=0)
DBN_HIDDEN = [8, 6, 3]
DBN_ACTS = ["sigm", "sigm", "linear"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return bridge.params_from_jax(_np(tree), device="cpu")


def _data(n, d, seed=0, binary=False):
    x = np.random.RandomState(seed).rand(n, d).astype(np.float32)
    return (x > 0.5).astype(np.float32) if binary else x


def jax_draw(key, layer_type, shape):
    """``compute_states``'s draw for ``layer_type`` in the JAX package."""
    kind = trbm.noise_kind(layer_type)
    if kind == "uniform":
        return np.asarray(jax.random.uniform(key, shape))
    if kind == "normal":
        return np.asarray(jax.random.normal(key, shape, jnp.float32))
    return None


def jax_step_draws(step_key, bs, d, h, vl, hl, cd_type):
    """The draws of one JAX ``cd1_step`` (keys k1, k2 of its three-way
    split; k3's states are thrown away) at the padded batch shape."""
    k1, k2, _ = jax.random.split(step_key, 3)
    return (jax_draw(k1, hl, (bs, h)),
            jax_draw(k2, vl, (bs, d)) if cd_type == 2 else None)


def _rows(draws, rows):
    return tuple(None if a is None else torch.tensor(a[:rows]) for a in draws)


def flips(p, q, u):
    """(states that differ, smallest |p - u|) between the Bernoulli states
    ``p > u`` (the port's probs) and ``q > u`` (JAX's)."""
    return int(((p > u) != (q > u)).sum()), float(np.abs(p - u).min())


def cd1_flips(state, data, draws, vl, hl, cd_type):
    """The flips of one CD-1 step's Bernoulli states: the positive hidden
    ones and, with cd_type 2, the negative visible ones (from JAX's
    positive states)."""
    t, s, key = _t(state), _np(state), jax.random.PRNGKey(0)
    out = []
    if hl == "sigm":
        p = trbm.rbm_up(torch.from_numpy(data), t["weights"], t["hidbiases"], hl)[0].numpy()
        q = np.asarray(jrbm.rbm_up(jnp.asarray(data), s["weights"], s["hidbiases"], hl, key)[0])
        out.append(flips(p, q, draws[0]))
        if cd_type == 2 and vl == "sigm":
            pos = torch.from_numpy((q > draws[0]).astype(np.float32))
            p = trbm.rbm_down(pos, t["weights"], t["visbiases"], vl)[0].numpy()
            q = np.asarray(jrbm.rbm_down(jnp.asarray(pos.numpy()), s["weights"],
                                         s["visbiases"], vl, key)[0])
            out.append(flips(p, q, draws[1]))
    return out


@pytest.mark.parametrize("layer_type", ["sigm", "tanh", "linear", "relu", "ReLu", "leakyrelu",
                                        "softplus", "softsign", "softmax"])
def test_activations_match_jax(layer_type):
    x = np.random.RandomState(1).randn(5, 7).astype(np.float32) * 4
    np.testing.assert_allclose(
        trbm.compute_activations(layer_type, torch.from_numpy(x)).numpy(),
        np.asarray(jrbm.compute_activations(layer_type, jnp.asarray(x))), atol=1e-6, rtol=1e-6)


def test_unknown_layer_type_raises_and_hyperparameters_match():
    with pytest.raises(ValueError, match="unknown layer type"):
        trbm.compute_activations("cubic", torch.zeros(2, 2))
    assert ([(f.name, f.default) for f in dataclasses.fields(trbm.RBMHyperParams)]
            == [(f.name, f.default) for f in dataclasses.fields(jrbm.RBMHyperParams)])
    hyper, jhyper = trbm.RBMHyperParams(), jrbm.RBMHyperParams()
    for vl, hl in (("sigm", "sigm"), ("sigm", "linear"), ("relu", "sigm"), ("tanh", "sigm")):
        assert hyper.rates_for(vl, hl) == jhyper.rates_for(vl, hl)
    assert hyper.rates_for("ReLu", "sigm") == (0.001, 0.001, 0.001)


@pytest.mark.parametrize("vl,hl,cd_type,rows", [
    ("sigm", "sigm", 1, 8), ("sigm", "sigm", 2, 8), ("sigm", "linear", 1, 8),
    ("sigm", "linear", 2, 8), ("linear", "sigm", 2, 8), ("sigm", "relu", 1, 8),
    ("relu", "sigm", 2, 8), ("sigm", "sigm", 1, 5), ("sigm", "sigm", 2, 5),
    ("linear", "relu", 2, 3)])
def test_cd1_step_with_jax_draws(vl, hl, cd_type, rows):
    """One step from the same state, velocity (nonzero, so the momentum
    term shows) and draws; ``rows`` < 8 is a partial last batch: JAX pads
    it to the configured batchsize and masks, the port slices it, and both
    divide by 8."""
    bs, d, h = 8, 12, 6
    state = jrbm.init_rbm(jax.random.PRNGKey(0), d, h, vl, hl)
    rng = np.random.RandomState(2)
    velocity = {k: jnp.asarray(0.01 * rng.randn(*v.shape).astype(np.float32))
                for k, v in state.items()}
    data = np.zeros((bs, d), np.float32)
    data[:rows] = _data(rows, d, seed=3, binary=vl == "sigm")
    mask = (np.arange(bs) < rows).astype(np.float32)[:, None]
    step_key = jax.random.PRNGKey(42)
    lrs = jrbm.RBMHyperParams().rates_for(vl, hl)
    ref_state, ref_vel, ref_err = jrbm.cd1_step(
        jax.tree_util.tree_map(jnp.copy, state), jax.tree_util.tree_map(jnp.copy, velocity),
        jnp.asarray(data), jnp.asarray(mask), step_key, jnp.asarray(0.9),
        tuple(jnp.asarray(r, jnp.float32) for r in lrs), vl_type=vl, hl_type=hl,
        cd_type=cd_type, batchsize=bs)

    draws = jax_step_draws(step_key, bs, d, h, vl, hl, cd_type)
    got_state, got_vel = _t(state), _t(velocity)
    err = trbm.cd1_step(got_state, got_vel, torch.from_numpy(data[:rows]), 0.9, lrs, vl_type=vl,
                        hl_type=hl, cd_type=cd_type, batchsize=bs, noise=_rows(draws, rows))
    for n_flips, gap in cd1_flips(state, data[:rows], tuple(
            None if a is None else a[:rows] for a in draws), vl, hl, cd_type):
        assert n_flips == 0, f"{n_flips} states flipped (smallest |probs - u| {gap:.3g})"
    for k in ("weights", "hidbiases", "visbiases"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(ref_state[k]), **STEP_TOL,
                                   err_msg=k)
        np.testing.assert_allclose(got_vel[k].numpy(), np.asarray(ref_vel[k]), **STEP_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(err.item(), float(ref_err), rtol=1e-5)
    assert np.abs(got_state["weights"].numpy() - np.asarray(state["weights"])).max() > 1e-4


class JaxRBMDraws:
    """Replaces the port's ``init_rbm``, ``batch_orders`` and
    ``draw_cd1_noise`` with the JAX package's draws for the RBM layers of
    ``train_dbn(key, ...)`` (or one ``train_rbm(layer_key, ...)``): per
    layer the init key and the order seed of ``train_rbm``, then one step
    key per batch from ``_rbm_epoch``'s carried key.  Layers are told apart
    by their (visible, hidden) widths.  ``gap`` records the smallest
    ``|probs - u|`` of the port's Bernoulli states, for the messages."""

    def __init__(self, monkeypatch, layer_keys, widths, types, bs, cd_type):
        self.layers, self.gap = {}, float("inf")
        for key, (d, h), (vl, hl) in zip(layer_keys, widths, types):
            key, init_key = jax.random.split(key)
            self.layers[(d, h)] = dict(
                init=_t(jrbm.init_rbm(init_key, d, h, vl, hl)),
                seed=int(np.asarray(jax.random.key_data(init_key))[-1] % (2 ** 31)),
                key=key, vl=vl, hl=hl)
        self.bs, self.cd_type = bs, cd_type
        monkeypatch.setattr(trbm, "init_rbm", self.init_rbm)
        monkeypatch.setattr(trbm, "batch_orders", self.batch_orders)
        monkeypatch.setattr(trbm, "draw_cd1_noise", self.draw)
        states = trbm.compute_states

        def recorded(layer_type, probs, x, noise):
            if layer_type.lower() == "sigm":
                self.gap = min(self.gap, (probs - noise).abs().min().item())
            return states(layer_type, probs, x, noise)

        monkeypatch.setattr(trbm, "compute_states", recorded)

    def init_rbm(self, generator, d, h, vl, hl):
        self.current = self.layers[(d, h)]
        return {k: v.clone() for k, v in self.current["init"].items()}

    def batch_orders(self, seed, n, epochs):
        rng = np.random.RandomState(self.current["seed"])
        return [rng.permutation(n) for _ in range(epochs)]

    def draw(self, generator, rows, d, h, vl, hl, cd_type, device):
        layer = self.layers[(d, h)]
        layer["key"], step_key = jax.random.split(layer["key"])
        return _rows(jax_step_draws(step_key, self.bs, d, h, vl, hl, cd_type), rows)


@pytest.mark.parametrize("vl,hl,cd_type", [("sigm", "sigm", 1), ("sigm", "linear", 2)])
def test_rbm_epoch_with_jax_orders_and_draws(monkeypatch, vl, hl, cd_type):
    """A whole epoch of 7 steps (the last partial: 50 rows, batch 8)."""
    n, d, h, bs = 50, 12, 6, 8
    data = _data(n, d, seed=4, binary=True)
    state = jrbm.init_rbm(jax.random.PRNGKey(1), d, h, vl, hl)
    velocity = jax.tree_util.tree_map(jnp.zeros_like, state)
    order = np.random.RandomState(5).permutation(n)
    nb = -(-n // bs)
    stack = np.zeros((nb * bs, d), np.float32)
    stack[:n] = data[order]
    masks = (np.arange(nb * bs) < n).astype(np.float32).reshape(nb, bs, 1)
    lrs = jrbm.RBMHyperParams().rates_for(vl, hl)
    key = jax.random.PRNGKey(9)
    ref_state, _, _, ref_err = jrbm._rbm_epoch(
        state, velocity, key, jnp.asarray(stack.reshape(nb, bs, d)), jnp.asarray(masks),
        jnp.asarray(0.5, jnp.float32), tuple(jnp.asarray(r, jnp.float32) for r in lrs),
        vl_type=vl, hl_type=hl, cd_type=cd_type, batchsize=bs, weight_penalty_l2=0.0002)

    draws = JaxRBMDraws(monkeypatch, [], [], [], bs, cd_type)
    draws.layers[(d, h)] = dict(key=key)
    got_state, got_vel = _t(state), _t(velocity)
    err = trbm.rbm_epoch(got_state, got_vel, torch.from_numpy(data), torch.from_numpy(order),
                         0.5, lrs, None, vl_type=vl, hl_type=hl, cd_type=cd_type, batchsize=bs,
                         weight_penalty_l2=0.0002)
    for k in ("weights", "hidbiases", "visbiases"):
        np.testing.assert_allclose(got_state[k].numpy(), np.asarray(ref_state[k]), **TOL,
                                   err_msg=f"{k}; smallest |probs - u| {draws.gap:.3g}")
    np.testing.assert_allclose(err.item(), float(ref_err), rtol=1e-5)


def _carried_dbn(monkeypatch, data, epochs=2, cd_type=1):
    """``train_dbn`` of both packages on ``data`` with JAX's draws; returns
    (port dbn, JAX dbn)."""
    hyper = jrbm.RBMHyperParams(epochs=epochs, batchsize=10, cd_type=cd_type)
    key = jax.random.PRNGKey(3)
    ref = jdbn.train_dbn(key, data, DBN_HIDDEN, DBN_ACTS, hyper=hyper, log_fn=lambda s: None)
    layer_keys, k = [], key
    for _ in DBN_HIDDEN:
        k, layer_key, _ = jax.random.split(k, 3)
        layer_keys.append(layer_key)
    dims = [data.shape[1]] + DBN_HIDDEN
    draws = JaxRBMDraws(monkeypatch, layer_keys, list(zip(dims, dims[1:])),
                        list(zip(["sigm"] + DBN_ACTS, DBN_ACTS)), hyper.batchsize, cd_type)
    got = tdbn.train_dbn(0, data, DBN_HIDDEN, DBN_ACTS,
                         hyper=trbm.RBMHyperParams(**dataclasses.asdict(hyper)),
                         log_fn=lambda s: None, device="cpu")
    return got, ref, draws.gap


@pytest.mark.parametrize("cd_type", [1, 2])
def test_train_dbn_with_jax_draws(monkeypatch, cd_type):
    """Three RBMs, 2 epochs each on 45 rows (a partial last batch), each on
    the previous layer's probs."""
    data = _data(45, 12, seed=6, binary=True)
    got, ref, gap = _carried_dbn(monkeypatch, data, cd_type=cd_type)
    for part in ("W", "hidbiases", "visbiases"):
        assert [a.shape for a in got[part]] == [np.shape(a) for a in ref[part]]
        for i, (a, b) in enumerate(zip(got[part], ref[part])):
            np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=(
                f"{part}[{i}]; smallest |probs - u| {gap:.3g}"))
    assert got["hidbiases"][0].shape == (1, 8)


@pytest.mark.parametrize("dbn_type", [1, 2])
def test_unfold_and_extract_equal_jax_on_a_carried_dbn(dbn_type):
    data = _data(40, 12, seed=7, binary=True)
    dbn = jdbn.train_dbn(jax.random.PRNGKey(0), data, DBN_HIDDEN, DBN_ACTS,
                         hyper=jrbm.RBMHyperParams(epochs=1, batchsize=10),
                         log_fn=lambda s: None)
    carried = {k: [np.asarray(a) for a in v] for k, v in dbn.items()}
    out = 12 if dbn_type == 1 else 5
    got = tunfold.unfold_dbn_to_nn(carried, dbn_type, DBN_HIDDEN, DBN_ACTS, "sigm", out,
                                   rng=np.random.RandomState(4))
    ref = junfold.unfold_dbn_to_nn(carried, dbn_type, DBN_HIDDEN, DBN_ACTS, "sigm", out,
                                   rng=np.random.RandomState(4))
    assert got["activationFunctions"] == ref["activationFunctions"]
    assert got["layers"] == ref["layers"] and got["pretraining"] == 1
    for a, b in zip(got["W"] + got["biases"], ref["W"] + ref["biases"]):
        np.testing.assert_array_equal(a, b)
    gx, rx = tunfold.extract_nn(got), junfold.extract_nn(ref)
    assert list(gx) == list(rx) == [f"{p}{i}" for i in range(1, len(got["W"]) + 1)
                                    for p in "wb"]
    for k in gx:
        np.testing.assert_array_equal(gx[k], rx[k])
    if dbn_type == 1:
        assert len(got["W"]) == 6 and got["W"][3].shape == (3, 6)
        with pytest.raises(ValueError, match="Input size differs"):
            tunfold.unfold_dbn_to_ae(carried, DBN_HIDDEN, DBN_ACTS, "sigm", 13)
    else:
        assert got["W"][-1].shape == (3, 5)
        w, b, _, _ = tunfold.unfold_dbn_to_clsf(carried, DBN_HIDDEN, DBN_ACTS, 5)
        np.testing.assert_array_equal(w[-1], 0.1 * np.random.RandomState(0).randn(3, 5))
    with pytest.raises(ValueError, match="dbn_type"):
        tunfold.unfold_dbn_to_nn(carried, 3, DBN_HIDDEN, DBN_ACTS, "sigm", out)


@pytest.mark.parametrize("fcn", ["linear", "sigm", "tanh"])
def test_normalise_data_with_ps_reuse(fcn):
    rng = np.random.RandomState(8)
    train = (rng.rand(30, 5) * 4).astype(np.float32)
    train[:, 2] = 1.5  # a constant column: std 0 is taken as 1
    val = (rng.rand(10, 5) * 9).astype(np.float32)
    got, ps = trbm.normalise_data(fcn, train)
    ref, jps = jrbm.normalise_data(fcn, train)
    np.testing.assert_array_equal(got, ref)
    got_val, ps2 = trbm.normalise_data(fcn, val, ps)
    np.testing.assert_array_equal(got_val, jrbm.normalise_data(fcn, val, jps)[0])
    assert ps2 is ps
    if fcn == "sigm":
        assert ps == (float(train.max()),) and got_val.max() > 1.0
    if fcn == "linear":
        np.testing.assert_array_equal(got[:, 2], 0.0)
        np.testing.assert_allclose(got.std(axis=0, ddof=1)[[0, 1, 3, 4]], 1.0, rtol=1e-5)


@pytest.mark.parametrize("optimizer,lr", [("adadelta", None), ("nesterov", 0.01)])
def test_finetune_autoencoder_matches_jax(optimizer, lr):
    """3 epochs of a 12-8-3-8-12 AE on 50 rows at batch 16 (3 full batches
    an epoch, the rest dropped as in JAX): deterministic, so equal."""
    rng = np.random.RandomState(9)
    sizes, acts = [8, 3, 8, 12], ["sigm", "linear", "sigm", "sigm"]
    weights, biases, fan = [], [], 12
    for s in sizes:
        weights.append((0.3 * rng.randn(fan, s)).astype(np.float32))
        biases.append((0.1 * rng.randn(s)).astype(np.float32))
        fan = s
    x = _data(50, 12, seed=10)
    logs = []
    got = tft.finetune_autoencoder(weights, biases, acts, x, epochs=3, batchsize=16,
                                   optimizer=optimizer, learning_rate=lr, seed=2,
                                   log_fn=logs.append, device="cpu")
    ref = jft.finetune_autoencoder(weights, biases, acts, x, epochs=3, batchsize=16,
                                   optimizer=optimizer, learning_rate=lr, seed=2,
                                   log_fn=lambda s: None)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a, b, **TOL)
    assert len(logs) == 3 and logs[0].startswith("AE finetune epoch 1: loss = ")
    assert np.abs(got[0][0] - weights[0]).max() > 1e-4
    # fewer rows than the batch size: one batch of all rows per epoch
    small = tft.finetune_autoencoder(weights, biases, acts, x[:5], epochs=1, batchsize=16,
                                     log_fn=lambda s: None, device="cpu")
    assert np.abs(small[0][0] - weights[0]).max() > 0


def test_losses_match_jax():
    rng = np.random.RandomState(11)
    a, b = rng.randn(6, 4).astype(np.float32), rng.randn(6, 4).astype(np.float32)
    np.testing.assert_allclose(tlosses.squared_error(torch.from_numpy(a), torch.from_numpy(b))
                               .item(), float(jlosses.squared_error(a, b)), rtol=1e-6)
    tree = {"fc1": {"w": rng.randn(4, 3).astype(np.float32),
                    "b": rng.randn(3).astype(np.float32)},
            "conv": [rng.randn(2, 1, 3, 3).astype(np.float32)]}
    got = tlosses.l2_regularization(bridge.params_from_jax(tree, device="cpu"), 0.005)
    np.testing.assert_allclose(got.item(), float(jlosses.l2_regularization(tree, 0.005)),
                               rtol=1e-6)
    # biases are not penalised
    np.testing.assert_allclose(got.item(), 0.005 * ((tree["fc1"]["w"] ** 2).sum()
                                                    + (tree["conv"][0] ** 2).sum()), rtol=1e-6)


class JaxSDEDraws:
    """Replaces the port's ``init_layer`` and ``draw_corruption`` with the
    JAX package's glorot init from ``key`` and one normal draw per step
    from the key chain ``train_denoising_layer`` splits."""

    def __init__(self, monkeypatch, key, d, encode_size):
        w = jsde.inits.glorot_uniform(key, (d, encode_size))
        self.init = {"w": torch.tensor(np.asarray(w)),
                     "b_enc": torch.zeros(encode_size), "b_dec": torch.zeros(d)}
        self.key = key
        monkeypatch.setattr(tsde, "init_layer", lambda g, d, e: dict(self.init))
        monkeypatch.setattr(tsde, "draw_corruption", self.draw)

    def draw(self, generator, shape, device):
        self.key, noise_key = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.normal(noise_key, tuple(shape))))


@pytest.mark.parametrize("nl,sigma", [("sigmoid", 0.5), ("linear", 0.3)])
def test_train_denoising_layer_with_carried_init_and_noise(monkeypatch, nl, sigma):
    """2 epochs of 3 steps (40 rows, batch 12), the order from
    RandomState(0) in both packages."""
    key = jax.random.PRNGKey(5)
    x = _data(40, 12, seed=12)
    init = JaxSDEDraws(monkeypatch, key, 12, 6).init["w"].numpy().copy()
    logs = []
    w, b = tsde.train_denoising_layer(0, x, 6, sigma, nl, epochs=2, batchsize=12,
                                      log_fn=logs.append, device="cpu")
    rw, rb = jsde.train_denoising_layer(key, x, 6, sigma, nl, epochs=2, batchsize=12,
                                        log_fn=lambda s: None)
    np.testing.assert_allclose(w.numpy(), rw, **TOL)
    np.testing.assert_allclose(b.numpy(), rb, **TOL)
    assert logs[-1].startswith("SDE layer epoch 2: loss = ")
    assert np.abs(w.numpy() - init).max() > 1e-3


def test_train_sde_stack_shapes_and_codes():
    """The default draws: three layers, sigmoid then the linear bottleneck,
    each trained on the previous layer's clean codes."""
    x = _data(60, 12, seed=13)
    logs = []
    weights, biases = tsde.train_sde(0, x, [8, 6, 3], epochs=2, batchsize=16,
                                     log_fn=logs.append, device="cpu")
    assert [w.shape for w in weights] == [(12, 8), (8, 6), (6, 3)]
    assert [b.shape for b in biases] == [(8,), (6,), (3,)]
    assert "SDE layer 3: 6 -> 3 (linear, sigma=0.3)" in logs
    assert "SDE layer 1: 12 -> 8 (sigmoid, sigma=0.5)" in logs
    assert all(np.isfinite(w).all() for w in weights)


def test_states_sampling_semantics():
    """JAX's test_states_sampling_semantics on the port's default draws."""
    g = torch.Generator().manual_seed(0)
    probs = torch.full((2000, 4), 0.7)
    states = trbm.compute_states("sigm", probs, probs,
                                 trbm.draw_states_noise(g, "sigm", probs.shape, "cpu"))
    assert set(np.unique(states.numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(states.numpy().mean(), 0.7, atol=0.05)
    x = torch.zeros((2000, 4))
    lin = trbm.compute_states("linear", x, x, trbm.draw_states_noise(g, "linear", x.shape, "cpu"))
    np.testing.assert_allclose(lin.numpy().std(), 1.0, atol=0.05)
    pre = torch.full((2000, 4), 5.0)
    relu = trbm.compute_states("ReLu", pre, pre,
                               trbm.draw_states_noise(g, "ReLu", pre.shape, "cpu"))
    assert relu.numpy().min() >= 0.0
    np.testing.assert_allclose(relu.numpy().mean(), 5.0, atol=0.1)
    assert trbm.draw_states_noise(g, "tanh", (2, 2), "cpu") is None
    u, n = trbm.draw_cd1_noise(g, 3, 5, 4, "linear", "sigm", 2, "cpu")
    assert u.shape == (3, 4) and 0 <= u.min() and u.max() < 1 and n.shape == (3, 5)
    assert trbm.draw_cd1_noise(g, 3, 5, 4, "linear", "sigm", 1, "cpu")[1] is None


def test_train_rbm_lowers_its_error_like_jax():
    """JAX's test_train_rbm_reduces_error data: two binary prototypes and
    5% noise, 8 epochs at batch 20, each package with its own draws."""
    rng = np.random.RandomState(0)
    protos = rng.rand(2, 16) > 0.5
    data = np.repeat(protos, 60, axis=0).astype(np.float32)
    data = np.abs(data - (rng.rand(*data.shape) < 0.05))
    hyper = trbm.RBMHyperParams(epochs=8, batchsize=20)
    logs = []
    state, errors = trbm.train_rbm(0, data, 8, "sigm", "sigm", hyper, log_fn=logs.append,
                                   device="cpu")
    _, ref = jrbm.train_rbm(jax.random.PRNGKey(0), data, 8, "sigm", "sigm",
                            jrbm.RBMHyperParams(epochs=8, batchsize=20), log_fn=lambda s: None)
    assert len(errors) == len(ref) == 8 and errors[-1] < errors[0] and ref[-1] < ref[0]
    # the two runs draw differently; their last errors agree within a band
    assert abs(errors[-1] - ref[-1]) < 0.5 * ref[-1], (errors, ref)
    assert logs[0].startswith("RBM epoch 1: mse/sample = ")
    assert state["weights"].shape == (16, 8) and state["hidbiases"].shape == (1, 8)


def test_bridge_carries_rbm_state_and_fc_tree():
    state = _np(jrbm.init_rbm(jax.random.PRNGKey(2), 12, 8, "sigm", "sigm"))
    got = bridge.params_from_jax(state, device="cpu")
    assert set(got) == {"weights", "hidbiases", "visbiases"}
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), state[k])
    weights = [np.random.RandomState(3).randn(12, 8).astype(np.float32),
               np.random.RandomState(4).randn(8, 12).astype(np.float32)]
    biases = [np.zeros(8, np.float32), np.ones(12, np.float32)]
    tree = _np(jft.ae_params_from_lists(weights, biases))
    carried = bridge.params_from_jax(tree, device="cpu")
    direct = tft.ae_params_from_lists(weights, biases, device="cpu")
    assert set(carried) == set(direct) == {"fc1", "fc2"}
    for name in carried:
        for k in ("w", "b"):
            torch.testing.assert_close(carried[name][k], direct[name][k], rtol=0, atol=0)
    back = tft.ae_params_to_lists(carried)
    for a, b in zip(back[0] + back[1], weights + biases):
        np.testing.assert_array_equal(a, b)


def test_entry_points_raise_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _data(20, 6)
    calls = [
        lambda d: trbm.train_rbm(0, x, 4, "sigm", "sigm", trbm.RBMHyperParams(epochs=1),
                                 log_fn=lambda s: None, device=d),
        lambda d: tdbn.train_dbn(0, x, [4], ["sigm"], hyper=trbm.RBMHyperParams(epochs=1),
                                 log_fn=lambda s: None, device=d),
        lambda d: tft.finetune_autoencoder([np.ones((6, 6), np.float32)],
                                           [np.zeros(6, np.float32)], ["sigmoid"], x,
                                           epochs=1, log_fn=lambda s: None, device=d),
        lambda d: tsde.train_sde(0, x, [4], epochs=1, log_fn=lambda s: None, device=d),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
