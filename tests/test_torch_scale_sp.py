"""Sequence parallelism of the port (ip_avsr_torch/parallel/sequence.py) on
four gloo ranks, against the unsharded port and the JAX package
(tests/test_sequence_parallel.py's cases): the halo-exchanged delta and its
gradient, the sharded forward and its gradients on data x seq meshes,
synced batch norm, the three checks, a delta-free model, and the Trainer's
``sequence_parallel``.  Tolerances are the JAX tests' (delta 1e-6; forward
1e-5 relative with 1e-6 absolute, 2e-5 with batch norm; gradients 2e-4
relative); dropout is bit-equal to the unsharded forward in the port, so a
training forward with dropout is held at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops.delta import append_delta_coeff as jappend
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.ops.delta import append_delta_coeff
from ip_avsr_torch.parallel import _multiprocess_worker as worker
from ip_avsr_torch.train import trainer as ttr
from tests import torch_scale_lib as lib

torch.set_num_threads(1)
RANKS = 4


@pytest.fixture(scope="module")
def ranks():
    with lib.pool(RANKS) as p:
        yield p


@pytest.mark.parametrize("n_seq,T,window", [(2, 8, 3), (4, 16, 4), (2, 6, 3), (4, 8, 2)])
def test_delta_sp_matches_global(ranks, n_seq, T, window):
    rng = np.random.RandomState(0)
    x = rng.randn(4, T, 5).astype(np.float32)
    w = rng.randn(4, T, 15).astype(np.float32)
    want = append_delta_coeff(torch.from_numpy(x), window).numpy()
    np.testing.assert_allclose(want, np.asarray(jappend(jnp.asarray(x), window)),
                               rtol=1e-6, atol=1e-6)
    xt = torch.from_numpy(x).requires_grad_(True)
    (append_delta_coeff(xt, window) * torch.from_numpy(w)).sum().backward()
    for got in ranks.run(worker.sp_delta, x, window, n_seq, w):
        np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["grad"], xt.grad.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window,normalized", [(3, True), (3, False), (1, True), (0, True)])
def test_delta_taps_and_coeff_match_jax(window, normalized):
    """The port's copies of ``delta_taps_from_padded`` (over a halo-sized
    extension that is not an edge padding) and ``delta_coeff(normalized=)``
    against the JAX originals."""
    from ip_avsr_tpu.ops import delta as jdelta
    from ip_avsr_torch.ops import delta as tdelta

    rng = np.random.RandomState(window)
    x = rng.randn(2, 7, 4).astype(np.float32)
    ext = rng.randn(2, 7 + 2 * window, 4).astype(np.float32)
    np.testing.assert_allclose(
        tdelta.delta_taps_from_padded(torch.from_numpy(ext), window, normalized).numpy(),
        np.asarray(jdelta.delta_taps_from_padded(jnp.asarray(ext), window, normalized)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tdelta.delta_coeff(torch.from_numpy(x), window, normalized=normalized).numpy(),
        np.asarray(jdelta.delta_coeff(jnp.asarray(x), window, normalized=normalized)),
        rtol=1e-6, atol=1e-6)


def test_halo_needs_enough_local_frames(ranks):
    x = np.zeros((2, 8, 3), np.float32)  # T_local = 2 < window = 3
    for got in ranks.run(worker.sp_delta, x, 3, 4, np.zeros((2, 8, 9), np.float32)):
        assert got["error"].startswith("sequence-parallel halo needs T_local >= window: 2 < 3")


def _flagship_tiny():
    """tests/test_sequence_parallel.py's tiny flagship in both packages, the
    JAX init, and seeded inputs (B 8, T 16, lengths T/2..T)."""
    def shrink(zoo, adenet):
        cfg = zoo.adenet_v3(20, 6, 20, lstm_size=8, window=3, output_classes=5)
        streams = [adenet.StreamSpec(**{**s.__dict__, "encoder_shapes": (24, 16, 8),
                                        "encoder_nonlinearities": ("sigmoid", "sigmoid",
                                                                   "linear")})
                   if s.encoder_shapes else s for s in cfg.streams]
        return adenet.AdeNetConfig(**{**cfg.__dict__, "streams": streams})

    jcfg, tcfg = shrink(jzoo, jadenet), shrink(tzoo, tadenet)
    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(1)
    B, T = 8, 16
    inputs = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in tcfg.streams]
    lens = rng.randint(T // 2, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return jcfg, tcfg, params, inputs, mask


def _unsharded(tcfg, params, inputs, mask, train=False, seed=7):
    return tadenet.adenet_forward(lib.torch_tree(params), tcfg,
                                  [torch.from_numpy(x) for x in inputs], torch.from_numpy(mask),
                                  train=train, generator=torch.Generator().manual_seed(seed),
                                  return_aux=True)


@pytest.mark.parametrize("data,seq", [(2, 2), (1, 4)])
def test_adenet_forward_sp_matches_unsharded(ranks, data, seq):
    jcfg, tcfg, params, inputs, mask = _flagship_tiny()
    want = _unsharded(tcfg, params, inputs, mask)[0].numpy()
    jwant = np.asarray(jadenet.adenet_forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                              [jnp.asarray(x) for x in inputs],
                                              jnp.asarray(mask), train=False))
    np.testing.assert_allclose(want, jwant, rtol=1e-5, atol=1e-6)
    for got in ranks.run(worker.sp_forward, tcfg, params, inputs, mask, data, seq):
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-6)


def test_adenet_sp_grads_match_unsharded(ranks):
    jcfg, tcfg, params, inputs, mask = _flagship_tiny()
    y = np.random.RandomState(2).randint(0, 5, inputs[0].shape[0]).astype(np.int32)

    def loss_plain(p):
        out = jadenet.adenet_forward(p, jcfg, [jnp.asarray(x) for x in inputs],
                                     jnp.asarray(mask), train=False)
        from ip_avsr_tpu.ops import losses as jlosses

        return jlosses.categorical_crossentropy_masked(out, jnp.asarray(y),
                                                       jnp.sum(jnp.asarray(mask), axis=1) > 0)

    jgrads = lib.np_tree(jax.grad(loss_plain)(jax.tree_util.tree_map(jnp.asarray, params)))
    loss, tgrads = ttr.grads_of(lambda p: (lambda v: (v, v.detach()))(ttr.loss_fn(
        p, tcfg, [torch.from_numpy(x) for x in inputs], torch.from_numpy(y).long(),
        torch.from_numpy(mask), train=False)), lib.torch_tree(params))
    for got in ranks.run(worker.sp_forward, tcfg, params, inputs, mask, 2, 2, y):
        assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
        for ref in (jgrads, jax.tree_util.tree_map(lambda t: t.numpy(), tgrads)):
            for (path, a), (_, b) in zip(lib.leaves(got["grads"]), lib.leaves(ref)):
                np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6, err_msg=path)


def test_adenet_sp_train_forward_equals_unsharded_with_dropout(ranks):
    """A training forward with dropout: each rank draws the whole batch's
    masks and keeps its block, so the sharded forward equals the unsharded
    one (JAX's draws per shard; the port's masks are the unsharded ones)."""
    _, tcfg, params, inputs, mask = _flagship_tiny()
    assert any(s.dropout > 0 for s in tcfg.streams) and tcfg.agg_dropout > 0
    want = _unsharded(tcfg, params, inputs, mask, train=True)[0].detach().numpy()
    plain = _unsharded(tcfg, params, inputs, mask, train=False)[0].numpy()
    assert np.abs(want - plain).max() > 1e-3  # dropout bites
    for got in ranks.run(worker.sp_forward, tcfg, params, inputs, mask, 2, 2, None, True):
        assert np.isfinite(got["out"]).all()
        np.testing.assert_allclose(got["out"], want, rtol=1e-5, atol=1e-6)


def test_sp_validation_errors(ranks):
    _, tcfg, params, inputs, mask = _flagship_tiny()
    for got in ranks.run(worker.sp_errors, tcfg, params, inputs, mask, 1, 4):
        assert got == ["T=15 not divisible by seq axis 4", "B=6 not divisible by data*seq=4"]


def _bn_config(zoo, adenet):
    cfg = zoo.adenet_v1(12, 6, lstm_size=8, window=3, output_classes=4)
    s0 = adenet.StreamSpec(**{**cfg.streams[0].__dict__, "encoder_shapes": (10, 8, 6, 5),
                              "encoder_nonlinearities": ("sigmoid",) * 3 + ("linear",)})
    return adenet.AdeNetConfig(**{**cfg.__dict__, "streams": [s0, cfg.streams[1]]})


def test_sp_batchnorm_synced_matches_unsharded(ranks):
    jcfg, tcfg = _bn_config(jzoo, jadenet), _bn_config(tzoo, tadenet)
    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.RandomState(4)
    B, T = 8, 16
    inputs = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in tcfg.streams]
    lens = rng.randint(T // 2, T + 1, B)
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    want, aux = _unsharded(tcfg, params, inputs, mask, train=True)
    jwant, jaux = jadenet.adenet_forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                         [jnp.asarray(x) for x in inputs], jnp.asarray(mask),
                                         train=True, return_aux=True)
    for got in ranks.run(worker.sp_forward, tcfg, params, inputs, mask, 2, 2, None, True):
        for ref, ref_aux in ((want.detach().numpy(), aux["bn_state"]),
                             (np.asarray(jwant), jaux["bn_state"])):
            np.testing.assert_allclose(got["out"], ref, rtol=1e-5, atol=2e-5)
            lib.assert_trees_close(got["bn_state"], lib.np_tree(ref_aux), atol=1e-7, rtol=1e-5)


def _sp_corpus():
    rng = np.random.RandomState(1)
    dim, classes, n = 8, 3, 48
    lens = rng.randint(8, 17, n)
    lens[0] = 16
    y_video = rng.randint(0, classes, n)
    frames, y_frames = [], []
    for length, c in zip(lens, y_video):
        base = np.zeros(dim)
        base[c] = 3.0
        frames.append(base + 0.3 * rng.randn(length, dim))
        y_frames.append(np.full(length, c))
    return [np.concatenate(frames).astype(np.float32)], np.concatenate(y_frames), lens


def test_trainer_sequence_parallel_fit(ranks):
    """TrainOptions(sequence_parallel=2) on four ranks builds the data 2 x
    seq 2 mesh, and a short fit learns; a step equals the one-process
    step, and the JAX package's."""
    from ip_avsr_tpu.train import trainer as jtr

    corpus = _sp_corpus()
    mk = lambda zoo: zoo.deltanet_majority_vote(8, [16, 8], ["sigmoid", "linear"],  # noqa: E731
                                                lstm_size=12, window=3, output_classes=3)
    jcfg, tcfg = mk(jzoo), mk(tzoo)
    opts = dict(num_epoch=4, epochsize=5, batchsize=16, learning_rate=0.01, optimizer="adam",
                prefetch_batches=False)
    fits = ranks.run(worker.trainer_fit, tcfg, dict(opts, sequence_parallel=2), corpus, corpus,
                     corpus)
    assert fits[0]["class_rate"][-1] > 0.6
    assert all(f["cost_val"] == fits[0]["cost_val"] for f in fits)

    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
    streams, y, mask = lib.ragged_batch(16, 16, (8,), 3, seed=5, min_len=4)
    step = dict(opts, optimizer="momentum")
    single = worker.trainer_step(tcfg, step, params, (streams, y, mask))
    jt = jtr.Trainer(jcfg, jtr.TrainOptions(log_fn=lambda *_: None, **step))
    dev = jt._device_batch(streams, y, mask)
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _, jloss = jt.train_step(p0, jt.optimizer.init(p0), *dev, jax.random.PRNGKey(3),
                                 jnp.asarray(1e-3, jnp.float32))
    for got in ranks.run(worker.trainer_step, tcfg, dict(step, sequence_parallel=2), params,
                         (streams, y, mask)):
        assert got["mesh"] == {"data": 2, "seq": 2}
        for ref_loss, ref_params in ((single["loss"], single["params"]),
                                     (float(jloss), lib.np_tree(jp))):
            assert got["loss"] == pytest.approx(ref_loss, rel=1e-5)
            lib.assert_trees_close(got["params"], ref_params, atol=1e-6, rtol=1e-4)
        lib.assert_trees_close(got["grads"], single["grads"], atol=1e-6, rtol=2e-4)
        assert got["eval_cost"] == pytest.approx(single["eval_cost"], rel=1e-5)
        np.testing.assert_allclose(got["predict"][:16], single["predict"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["confusion"], single["confusion"])


def test_sp_no_delta_model_ignores_window_constraint(ranks):
    """A model without delta streams exchanges no halo: T_local 2 < window 9
    runs and equals the unsharded forward."""
    mk = lambda zoo: zoo.lstm_classifier_majority_vote(12, lstm_size=8,  # noqa: E731
                                                       output_classes=4)
    jcfg, tcfg = mk(jzoo), mk(tzoo)
    assert not any(s.use_delta for s in tcfg.streams) and tcfg.window > 2
    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
    x = np.random.RandomState(0).randn(8, 8, 12).astype(np.float32)
    mask = np.ones((8, 8), np.float32)
    want = _unsharded(tcfg, params, [x], mask)[0].numpy()
    for got in ranks.run(worker.sp_forward, tcfg, params, [x], mask, 1, 4):
        np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=1e-6)
