"""The port's numpy oracle, ``ip_avsr_torch.reference_impl``.

(a) The copy against the original: every public function of the port's
oracle and of ``ip_avsr_tpu.reference_impl`` on the same seeded numpy
inputs and parameter trees, equal bit for bit (both are numpy).
(b) The port against its oracle, the counterpart of
tests/test_reference_parity.py: every ZOO_CASES entry built by the port
(``tests/torch_trainer_lib.zoo_case``), its CPU forward against
``adenet_forward_np`` within rtol 2e-4 / atol 2e-5, with ragged masks (a
row of length 1 among them) and every bias, scale, coefficient and initial
state moved off its init (``chip_smoke.perturbed``: zero biases and initial
states, unit adasum coefficients and batch-norm scales would hide their
wiring); batch-norm training statistics, ``adenet_nstream`` with pretrained
stream LSTMs and the conv-AE family too.
(c) ``torch_tree_to_np`` on nested trees.
"""

import ast
import os

import numpy as np
import pytest
import torch

from chip_smoke import perturbed
from ip_avsr_tpu import reference_impl as jref
from ip_avsr_torch import reference_impl as ref
from ip_avsr_torch.models import adenet, convae, zoo
from ip_avsr_torch.ops import lstm as lstm_ops
from tests import zoo_cases
from tests.torch_trainer_lib import zoo_case

torch.set_num_threads(1)
RTOL, ATOL = 2e-4, 2e-5
B, T = 3, 9
PUBLIC = ("encoder_forward_np", "delta_np", "append_delta_np", "lstm_forward_np",
          "batch_norm_np", "adenet_forward_np", "convae_forward_np")
CONVAE_VARIANTS = [(False, False), (True, False), (False, True), (True, True)]


def batch(cfg, seed):
    rng = np.random.RandomState(seed)
    inputs = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[1] = T, 1
    return inputs, (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def port_model(cfg, seed=3, **kw):
    params = adenet.init_adenet_params(torch.Generator().manual_seed(seed), cfg,
                                       device="cpu", **kw)
    return perturbed(params, seed)


def lstm_params(D, H, peep, seed):
    p = lstm_ops.init_lstm_params(torch.Generator().manual_seed(seed), D, H,
                                  use_peepholes=peep)
    return ref.torch_tree_to_np(perturbed(p, seed))


# (a) the copy against the original, bit for bit --------------------------

def test_the_copy_has_the_originals_public_functions():
    for name in PUBLIC:
        assert callable(getattr(ref, name)) and callable(getattr(jref, name))
    assert hasattr(ref, "torch_tree_to_np") and not hasattr(ref, "jax_tree_to_np")


@pytest.mark.parametrize("layers", [4, 10])
def test_encoder_forward_np_bitwise(layers):
    # a deltanet-style stack past bottleneck: fc5 .. fc10 sort numerically
    rng = np.random.RandomState(layers)
    names = ["fc1", "fc2", "fc3", "bottleneck"] + [f"fc{i}" for i in range(5, layers + 1)]
    widths = [11] + [int(w) for w in rng.randint(3, 9, len(names))]
    enc = {n: {"w": rng.randn(widths[i], widths[i + 1]).astype(np.float32),
               "b": rng.randn(widths[i + 1]).astype(np.float32)}
           for i, n in enumerate(names)}
    shuffled = {n: enc[n] for n in rng.permutation(names)}
    nls = (["sigmoid", "tanh", "rectify", "linear", "sigm", "relu"] * 2)[:len(names)]
    x = rng.randn(7, 11).astype(np.float32)
    got = ref.encoder_forward_np(shuffled, x, nls)
    assert got.shape == (7, widths[-1])
    assert np.array_equal(got, jref.encoder_forward_np(shuffled, x, nls))


@pytest.mark.parametrize("window,T_", [(1, 6), (3, 9), (9, 5)])
def test_delta_np_bitwise(window, T_):
    x = np.random.RandomState(window).randn(2, T_, 4).astype(np.float32)
    assert np.array_equal(ref.delta_np(x, window), jref.delta_np(x, window))
    got = ref.append_delta_np(x, window)
    assert got.shape == (2, T_, 12)
    assert np.array_equal(got, jref.append_delta_np(x, window))


@pytest.mark.parametrize("peep", [False, True])
@pytest.mark.parametrize("backwards", [False, True])
def test_lstm_forward_np_bitwise(peep, backwards):
    p = lstm_params(5, 6, peep, 11 + peep)
    rng = np.random.RandomState(2)
    x = rng.randn(4, T, 5).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([T, 1, 5, 0])[:, None]).astype(np.float32)
    got = ref.lstm_forward_np(p, x, mask, backwards)
    assert np.array_equal(got, jref.lstm_forward_np(p, x, mask, backwards))
    # an all-pad row holds its learned initial state at every step
    np.testing.assert_array_equal(got[3], np.repeat(p["hid_init"], T, 0))


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_np_bitwise(train):
    rng = np.random.RandomState(4)
    bn = {"gamma": rng.rand(6).astype(np.float32) + 0.5, "beta": rng.randn(6).astype(np.float32)}
    state = {"mean": rng.randn(6).astype(np.float32),
             "var": rng.rand(6).astype(np.float32) + 0.5}
    x = rng.randn(B, T, 6).astype(np.float32)
    got = ref.batch_norm_np(bn, state, x, train)
    assert np.array_equal(got, jref.batch_norm_np(bn, state, x, train))


@pytest.mark.parametrize("name", sorted(zoo_cases.ZOO_CASES))
def test_adenet_forward_np_bitwise(name):
    # the zoo covers sum, concat and adasum fusion, per_step and last_step
    # heads, peepholes, BLSTM and unidirectional aggregators and batch norm
    cfg = zoo_case(name)
    params = ref.torch_tree_to_np(port_model(cfg))
    inputs, mask = batch(cfg, 5)
    for train in (False, True) if any(s.use_batchnorm for s in cfg.streams) else (False,):
        got = ref.adenet_forward_np(params, cfg, inputs, mask, train=train)
        assert np.array_equal(got, jref.adenet_forward_np(params, cfg, inputs, mask,
                                                          train=train))


@pytest.mark.parametrize("bn,drop", CONVAE_VARIANTS)
def test_convae_forward_np_bitwise(bn, drop):
    cfg = convae.ConvAEConfig(bottleneck=10, dense=20, use_batchnorm=bn, use_dropout=drop)
    params = ref.torch_tree_to_np(perturbed(
        convae.init_convae_params(torch.Generator().manual_seed(5), cfg), 5))
    x = np.random.RandomState(0).randn(2, 30 * 40).astype(np.float32)
    got = ref.convae_forward_np(params, cfg, x)
    assert got.shape == (2, 1200)
    assert np.array_equal(got, jref.convae_forward_np(params, cfg, x))


# (b) the port against its oracle -----------------------------------------

def port_against_oracle(cfg, params, train=False, seed=0):
    inputs, mask = batch(cfg, seed)
    with torch.no_grad():
        out = adenet.adenet_forward(params, cfg, [torch.from_numpy(x) for x in inputs],
                                    torch.from_numpy(mask), train=train,
                                    return_aux=train)
    got = (out[0] if train else out).numpy()
    want = ref.adenet_forward_np(ref.torch_tree_to_np(params), cfg, inputs, mask, train=train)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(zoo_cases.ZOO_CASES))
def test_port_matches_its_oracle(name):
    # evaluation: dropout off, batch norm on its (moved) running statistics
    port_against_oracle(zoo_case(name), port_model(zoo_case(name)))


def test_batchnorm_train_statistics_match_the_oracle():
    cfg = zoo_case("adenet_v1")
    assert all(s.dropout == 0 for s in cfg.streams) and cfg.agg_dropout == 0
    port_against_oracle(cfg, port_model(cfg), train=True)


def test_nstream_with_pretrained_stream_lstms_matches_the_oracle():
    cfg = zoo.adenet_nstream([20, 8], [zoo_cases.ENC, None], use_peepholes=True,
                             **zoo_cases.K)
    pre = [{k: v.numpy() for k, v in lstm_ops.init_lstm_params(
        torch.Generator().manual_seed(100 + i), s.feature_dim(), cfg.stream_lstm_size(s),
        use_peepholes=True).items() if k not in ("cell_init", "hid_init")}
        for i, s in enumerate(cfg.streams)]
    params = adenet.init_adenet_params(torch.Generator().manual_seed(3), cfg, device="cpu",
                                       pretrained_stream_lstms=pre)
    np.testing.assert_array_equal(params["streams"]["s1"]["lstm"]["w_in"], pre[0]["w_in"])
    port_against_oracle(cfg, params)


@pytest.mark.parametrize("bn,drop", CONVAE_VARIANTS)
def test_convae_matches_the_oracle(bn, drop):
    cfg = convae.ConvAEConfig(bottleneck=10, dense=20, use_batchnorm=bn, use_dropout=drop)
    params = perturbed(convae.init_convae_params(torch.Generator().manual_seed(5), cfg), 5)
    x = np.random.RandomState(0).randn(2, 30 * 40).astype(np.float32)
    with torch.no_grad():
        got = convae.convae_forward(params, cfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref.convae_forward_np(params, cfg, x), rtol=RTOL,
                               atol=ATOL)


# (c) torch_tree_to_np ------------------------------------------------------

def test_torch_tree_to_np_keeps_the_tree():
    a = np.arange(3, dtype=np.float32)
    t = torch.arange(6, dtype=torch.float32, requires_grad=True).reshape(2, 3)
    tree = {"x": t * 2, "l": [torch.ones(2), (a, torch.zeros(1))], "n": {"s": torch.tensor(1.5)}}
    got = ref.torch_tree_to_np(tree)
    assert set(got) == {"x", "l", "n"}
    assert isinstance(got["l"], list) and isinstance(got["l"][1], tuple)
    assert got["l"][1][0] is a
    np.testing.assert_array_equal(got["x"], [[0, 2, 4], [6, 8, 10]])
    assert isinstance(got["x"], np.ndarray) and got["x"].dtype == np.float32
    assert got["n"]["s"].shape == () and float(got["n"]["s"]) == 1.5
    np.testing.assert_array_equal(got["l"][1][1], [0.0])


def test_the_oracle_imports_nothing_of_the_package():
    path = ref.__file__
    tree = ast.parse(open(path).read())
    modules = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    modules |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert modules == {"__future__", "numpy", "numpy.lib.stride_tricks", "torch"}
    top = {a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names}
    assert top == {"numpy"}, "only numpy at module level"
    assert os.path.dirname(path).endswith("ip_avsr_torch")
