"""The port's conv-AE (ip_avsr_torch/models/convae.py and
pretrain/finetune.train_convae) against the JAX package's, on the CPU at
the architecture's 30 x 40 input with a narrow dense layer and bottleneck.

JAX's initial parameters are carried into the port
(``bridge.params_from_jax``); with dropout off nothing else is drawn, so
the forward, the encoding and a 2-epoch fit are held to JAX within 1e-5
(float32; convolutions summed in another order by XLA and by PyTorch's CPU
kernels).  The dropout masks are drawn from the port's own generator and
held by their statistics.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ip_avsr_tpu.models import convae as jconvae
from ip_avsr_tpu.ops import losses as jlosses
from ip_avsr_tpu.pretrain import finetune as jft
from ip_avsr_tpu.train import optimizers as jopt
from ip_avsr_torch import bridge
from ip_avsr_torch.models import convae as tconvae
from ip_avsr_torch.pretrain import finetune as tft
from ip_avsr_torch.train import optimizers as topt

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
# a 2-epoch fit, after pooling windows rerouted gradients: the bound on
# |port - JAX| over |port - initial| per leaf (Frobenius norms; the
# batchnorm fit reached 1.2e-2 at 24 images of batch 12 and 8.2e-5 at 16 of
# batch 8; a 10% error in the learning rate would put it near 0.1), and on the
# epochs' losses, relative (1.6e-5, batchnorm, 24 images of batch 12)
FIT_SPREAD = 0.05
FIT_LOSS_RTOL = 1e-4
NARROW = dict(bottleneck=6, dense=16)
VARIANTS = {"plain": dict(), "batchnorm": dict(use_batchnorm=True),
            "dropout": dict(use_dropout=True),
            "bndrop": dict(use_batchnorm=True, use_dropout=True)}


def configs(variant):
    kw = dict(NARROW, **VARIANTS[variant])
    return jconvae.ConvAEConfig(**kw), tconvae.ConvAEConfig(**kw)


# the JAX package's init under jit: op by op, XLA compiles each operation
# anew and a batch-norm init alone takes seconds
jax_init = jax.jit(jconvae.init_convae_params, static_argnums=1)
# the forward and step tests' init seed and batch
SEED, BATCH = 3, dict(n=4, seed=6)


def carried_init(jcfg, seed=0):
    jp = jax_init(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def images(n, seed=1):
    return np.random.RandomState(seed).randn(n, 1200).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_reference(variant):
    """JAX's side of the forward and step tests for ``variant``, as numpy,
    from one compiled program: the bottleneck codes, the reconstruction,
    the loss, its gradients and the adadelta (lr 0.8) update, with the
    carried init of seed SEED on BATCH.  ``train=False`` skips dropout
    (batch norm takes the batch's statistics in either mode), which is the
    training step with dropout off."""
    jcfg, _ = configs(variant)
    jp = jax_init(jax.random.PRNGKey(SEED), jcfg)
    x = jnp.asarray(images(**BATCH))
    opt = jopt.adadelta(0.8)

    def run(p):
        loss, grads = jax.value_and_grad(
            lambda q: jlosses.squared_error(jconvae.convae_forward(q, jcfg, x), x))(p)
        return dict(code=jconvae.convae_encode(p, jcfg, x),
                    recon=jconvae.convae_forward(p, jcfg, x), loss=loss, grads=grads,
                    new=opt.apply(p, grads, opt.init(p))[0])

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(jp))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_encode_match_jax(variant):
    """Every variant at dropout off (``train=False``); batch norm uses the
    batch's statistics in every mode."""
    jcfg, tcfg = configs(variant)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.filters, tcfg.dense_mid, tcfg.encode_size, tcfg.conv_out_shape()) == \
        (jcfg.filters, jcfg.dense_mid, jcfg.encode_size, jcfg.conv_out_shape())
    _, tp = carried_init(jcfg, seed=SEED)
    ref = jax_reference(variant)
    x = images(**BATCH)
    code = tconvae.convae_encode(tp, tcfg, torch.from_numpy(x))
    assert code.shape == (len(x), jcfg.encode_size)
    np.testing.assert_allclose(code.numpy(), ref["code"], **TOL)
    got = tconvae.convae_forward(tp, tcfg, torch.from_numpy(x).reshape(len(x), 1, 30, 40))
    assert got.shape == (len(x), 1200)
    np.testing.assert_allclose(got.numpy(), ref["recon"], **TOL)


def test_init_has_jax_keys_shapes_and_glorot_limits():
    for variant in ("plain", "bndrop"):
        jcfg, tcfg = configs(variant)
        got = tconvae.init_convae_params(torch.Generator().manual_seed(0), tcfg)
        ref = jax.eval_shape(lambda k: jconvae.init_convae_params(k, jcfg),
                             jax.random.PRNGKey(0))
        shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa
        assert shapes(got) == shapes(ref)
    w = got["conv3"]["w"]
    lim = np.sqrt(6.0 / (w.shape[1] * 25 + w.shape[0] * 25))
    assert w.abs().max() <= lim and w.abs().max() > 0.99 * lim
    assert torch.equal(got["bn_dense7"]["gamma"], torch.ones(tcfg.dense_mid))


def test_maxpool_pads_h_with_minus_inf():
    """conv3's output (9 x 14) pooled with pad (1, 0) -> 5 x 7; negative
    inputs show that the padded rows hold -inf, not 0."""
    x = -1.0 - np.abs(np.random.RandomState(2).randn(2, 3, 9, 14)).astype(np.float32)
    got = tconvae._maxpool(torch.from_numpy(x), pad_h=1)
    ref = jconvae._maxpool(jnp.asarray(x), pad_h=1)
    assert got.shape == (2, 3, 5, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() < 0).all()
    np.testing.assert_array_equal(tconvae._maxpool(torch.from_numpy(x[..., :8, :])).numpy(),
                                  np.asarray(jconvae._maxpool(jnp.asarray(x[..., :8, :]))))


def test_deconv_is_the_tied_transpose_of_conv():
    """The decoder's transposed convolution with the encoder's (O, I, kH,
    kW) kernel equals JAX's ``conv_transpose(transpose_kernel=True)`` and
    is the adjoint of the encoder's cross-correlation; the crop takes
    ``crop_h`` rows off each side of H."""
    rng = np.random.RandomState(3)
    w = rng.randn(7, 4, 5, 5).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    y = rng.randn(2, 7, 6, 8).astype(np.float32)
    for crop in (0, 1):
        got = tconvae._deconv(torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(b),
                              crop_h=crop)
        ref = jconvae._deconv(jnp.asarray(y), jnp.asarray(w), jnp.asarray(b), crop_h=crop)
        assert got.shape == (2, 4, 10 - 2 * crop, 12)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    x = torch.from_numpy(rng.randn(2, 4, 10, 12).astype(np.float32))
    conv = tconvae._conv(x, torch.from_numpy(w), torch.zeros(7))
    back = tconvae._deconv(torch.from_numpy(y), torch.from_numpy(w), torch.zeros(4))
    torch.testing.assert_close((conv * torch.from_numpy(y)).sum(), (x * back).sum(),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(
        tconvae._upscale(torch.from_numpy(y)).numpy(), np.asarray(jconvae._upscale(y)))


@pytest.mark.parametrize("shape", [(6, 5), (4, 3, 5, 6)])
def test_bn_uses_batch_statistics(shape):
    rng = np.random.RandomState(4)
    x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
    c = shape[1]
    p = {"gamma": rng.rand(c).astype(np.float32) + 0.5, "beta": rng.randn(c).astype(np.float32)}
    got = tconvae._bn(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    ref = jconvae._bn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def dropout_off(monkeypatch):
    """Dropout off in both packages' forwards, the dropout variants'
    widened layers kept."""
    for mod in (jconvae, tconvae):
        monkeypatch.setattr(mod, "_dropout", lambda x, rate, rng, train: x)


def record_pool_gaps(monkeypatch):
    """Wrap the port's ``_maxpool`` so that every call appends the smallest
    gap between the top two values of a pooling window; returns the list."""
    gaps, pool = [], tconvae._maxpool

    def recorded(x, pad_h=0):
        v = F.pad(x.detach(), (0, 0, pad_h, pad_h), value=-float("inf"))
        B, C, H, W = v.shape
        win = v[:, :, :H // 2 * 2, :W // 2 * 2].reshape(B, C, H // 2, 2, W // 2, 2)
        top = win.permute(0, 1, 2, 4, 3, 5).reshape(B, C, H // 2, W // 2, 4).topk(2, -1).values
        gaps.append((top[..., 0] - top[..., 1]).min().item())
        return pool(x, pad_h)

    monkeypatch.setattr(tconvae, "_maxpool", recorded)
    return gaps


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_convae_train_step_matches_jax(monkeypatch, variant):
    """One training step from the same parameters and batch, dropout off
    (the port's ``_dropout`` patched to the identity on its training path,
    JAX's step from :func:`jax_reference`): the loss, every gradient and
    the adadelta update within TOL.  A pooling
    window whose top two values lie closer than the two packages' rounding
    routes its gradient to another input in each (as a Bernoulli state
    flips); from equal parameters the two forwards round alike often
    enough that none does here, and a failure reports the smallest gap."""
    dropout_off(monkeypatch)
    gaps = record_pool_gaps(monkeypatch)
    jcfg, tcfg = configs(variant)
    _, tp = carried_init(jcfg, seed=SEED)
    ref = jax_reference(variant)
    loss, grads = tft.value_and_grad(tft._convae_loss, tp, torch.from_numpy(images(**BATCH)),
                                     tcfg, None)
    np.testing.assert_allclose(loss.item(), float(ref["loss"]), rtol=1e-5)
    new, _ = topt.adadelta(0.8).apply(tp, grads, topt.adadelta(0.8).init(tp))
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref["grads"]):
        name = jax.tree_util.keystr(path)
        np.testing.assert_allclose(leaf_at(grads, path).numpy(), leaf, **TOL,
                                   err_msg=f"gradient {name}; smallest pooling gap "
                                   f"{min(gaps):.3g}")
        np.testing.assert_allclose(leaf_at(new, path).numpy(), leaf_at(ref["new"], path),
                                   **TOL, err_msg=name)


def leaf_at(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("variant", ["plain", "batchnorm"])
def test_train_convae_matches_jax_with_carried_init(monkeypatch, variant):
    """``train_convae`` over 2 epochs of 2 steps (16 images, batch 8),
    adadelta at lr 0.8 with the decay from epoch 1, JAX's initial
    parameters carried into the port, dropout off.  Held by statistics, as
    an RBM epoch is: a pooling window whose top two values lie within the
    packages' drifting rounding reroutes one channel's gradient (with 40
    images at batch 16 the batchnorm fit's last step had a window 1.19e-6
    apart, and 21 of conv1's 2500 kernel entries ended 2.5e-4 apart), and
    the runs then
    diverge legitimately (the training step above holds every step's
    arithmetic elementwise).  So the epochs' losses agree within
    FIT_LOSS_RTOL, and each leaf of the two fits is within TOL or, where
    rerouted gradients put entries beyond it, within FIT_SPREAD of the
    distance the fit moved it (|port - JAX| over |port - initial| in
    Frobenius norm); the entries beyond TOL, the worst such ratio and the
    smallest pooling gap are reported."""
    dropout_off(monkeypatch)
    gaps = record_pool_gaps(monkeypatch)
    jcfg, tcfg = configs(variant)
    _, tp = carried_init(jcfg, seed=3)
    monkeypatch.setattr(tconvae, "init_convae_params", lambda g, cfg: tp)
    monkeypatch.setattr(jconvae, "init_convae_params", jax_init)
    x = images(16, seed=5)
    logs = []
    got, history = tft.train_convae(x, tcfg, epochs=2, batchsize=8, decay_start=1, seed=3,
                                    log_fn=logs.append, device="cpu")
    ref, ref_history = jft.train_convae(x, jcfg, epochs=2, batchsize=8, decay_start=1,
                                        seed=3, log_fn=lambda s: None)
    np.testing.assert_allclose(history, ref_history, rtol=FIT_LOSS_RTOL)
    beyond, spread = {}, {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        name = jax.tree_util.keystr(path)
        mine, ref_leaf = leaf_at(got, path).numpy(), np.asarray(leaf)
        diff = np.abs(mine - ref_leaf)
        beyond[name] = int((diff > TOL["atol"] + TOL["rtol"] * np.abs(ref_leaf)).sum())
        if not beyond[name]:
            continue
        spread[name] = float(np.linalg.norm(diff)
                             / np.linalg.norm(mine - leaf_at(tp, path).numpy()))
        assert spread[name] <= FIT_SPREAD, (
            f"{name}: |port - JAX| is {spread[name]:.3g} of |port - initial|, "
            f"{beyond[name]} entries beyond TOL; smallest pooling gap {min(gaps):.3g}")
    worst = max(spread, key=spread.get, default=None)
    print(f"{variant}: entries beyond TOL {sum(beyond.values())} in {sorted(spread)}, worst "
          f"spread {spread.get(worst, 0):.3g}; smallest pooling gap {min(gaps):.3g}")
    assert logs[1] == f"conv-AE epoch 2: loss = {history[1]:.6f} (lr=0.7200)"
    assert (got["conv1"]["w"] - tp["conv1"]["w"]).abs().max() > 1e-4


def test_train_convae_stops_on_flag_and_trains_with_dropout():
    _, tcfg = configs("bndrop")
    calls = []
    params, history = tft.train_convae(images(20), tcfg, epochs=3, batchsize=10,
                                       log_fn=calls.append, stop_flag=lambda: True,
                                       device="cpu")
    assert len(history) == 1 and np.isfinite(history[0])
    assert calls[-1] == "stop requested; ending conv-AE training"
    assert set(params) >= {"bn_conv1", "bn_dense7", "deconv15_b"}


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate(rate):
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 100)
    out = tconvae._dropout(x, rate, g, train=True)
    kept = out != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1.0 / (1 - rate)))
    assert tconvae._dropout(x, rate, g, train=False) is x
    # two draws differ; a training forward of the dropout variant is
    # stochastic, an evaluation forward is not
    _, tcfg = configs("dropout")
    _, tp = carried_init(configs("dropout")[0])
    xs = torch.from_numpy(images(3))
    a = tconvae.convae_forward(tp, tcfg, xs, train=True, generator=g)
    b = tconvae.convae_forward(tp, tcfg, xs, train=True, generator=g)
    assert not torch.equal(a, b)
    torch.testing.assert_close(tconvae.convae_forward(tp, tcfg, xs),
                               tconvae.convae_forward(tp, tcfg, xs), rtol=0, atol=0)


def test_bridge_carries_a_convae_tree_with_batchnorm():
    jcfg, _ = configs("bndrop")
    jp = jax.tree_util.tree_map(np.asarray, jax_init(jax.random.PRNGKey(1), jcfg))
    got = bridge.params_from_jax(jp, device="cpu")
    assert set(got) == set(jp) and {"bn_conv1", "bn_conv3", "bn_conv5", "bn_dense7"} <= set(got)
    for name, node in jp.items():
        if isinstance(node, dict):
            for k, v in node.items():
                np.testing.assert_array_equal(got[name][k].numpy(), v)
        else:
            np.testing.assert_array_equal(got[name].numpy(), node)


def test_train_convae_raises_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = configs("plain")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tft.train_convae(images(4), tcfg, epochs=1)
    tft.train_convae(images(4), tcfg, epochs=1, log_fn=lambda s: None, device="cpu")
