"""The port's grouped DeltaLayer (ip_avsr_torch/ops/kernels/delta.py
``append_delta_group``, ip_avsr_torch/ops/delta.py ``delta_group`` and the
cached matrix ``delta_matrix``) against the JAX package.

References: ``ip_avsr_tpu.ops.delta.append_delta_coeff`` per stream, and its
``jax.vjp`` for the backward (the transpose ``_append_delta_bwd`` computes).
Tolerances are test_torch_delta.py's: float32 at atol 1e-5 / rtol 1e-5 for
the forward, and atol 1e-5 times max(1, max |ref|) / rtol 1e-5 for the
gradient.  On the CPU the wrapper takes the plain version.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops import delta as jdelta
from ip_avsr_torch.models import adenet, zoo
from ip_avsr_torch.ops import delta as tdelta
from ip_avsr_torch.ops.kernels import delta as kdelta

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
WIDTHS = (5, 9, 3)


def _x(seed, B, T, D):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32) * 3.0


def _jax_delta(x, window):
    return np.asarray(jdelta.append_delta_coeff(jnp.asarray(x), window))


@pytest.mark.parametrize("T", [1, 3, 29])
@pytest.mark.parametrize("window", [0, 1, 4, 9])
def test_group_matches_jax_per_stream(window, T):
    xs = [_x(window * 100 + T * 10 + i, 2, T, D) for i, D in enumerate(WIDTHS)]
    outs = kdelta.append_delta_group([torch.from_numpy(x) for x in xs], window)
    assert len(outs) == len(xs)
    for x, out in zip(xs, outs):
        assert out.shape == (2, T, 3 * x.shape[2])
        np.testing.assert_allclose(out.numpy(), _jax_delta(x, window), **TOL)


# W = 9 at T = 29 is the models'; T < W, T = 1 and W = 0 are the edges
@pytest.mark.parametrize("window,T", [(9, 29), (4, 9), (4, 3), (1, 1), (0, 6)])
def test_delta_matrix_product_and_transpose_match_jax(window, T):
    x = _x(window * 7 + T + 3, 2, T, 5)
    g = _x(window * 7 + T + 4, 2, T, 15)
    S = tdelta.delta_matrix(T, window)
    assert S.shape == (3 * T, T) and S.dtype == torch.float32
    got = torch.matmul(S, torch.from_numpy(x)).reshape(2, T, 15).numpy()
    np.testing.assert_allclose(
        got, tdelta.append_delta_coeff(torch.from_numpy(x), window).numpy(), **TOL)
    np.testing.assert_allclose(got, _jax_delta(x, window), **TOL)
    _, vjp = jax.vjp(lambda v: jdelta.append_delta_coeff(v, window), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    dx = torch.matmul(S.T, torch.from_numpy(g).reshape(2, 3 * T, 5)).numpy()
    np.testing.assert_allclose(dx, ref, atol=1e-5 * max(1.0, np.abs(ref).max()), rtol=1e-5)


def test_delta_matrix_rows_are_identity_fir_and_its_square():
    T, W = 7, 2
    S = tdelta.delta_matrix(T, W, dtype=torch.float64)
    F = tdelta.fir_matrix(T, W, dtype=torch.float64)
    torch.testing.assert_close(S[0::3], torch.eye(T, dtype=torch.float64), rtol=0, atol=0)
    torch.testing.assert_close(S[1::3], F, rtol=0, atol=0)
    torch.testing.assert_close(S[2::3], F @ F, rtol=0, atol=0)


def test_delta_matrix_is_cached_per_key():
    S = tdelta.delta_matrix(11, 3)
    builds = tdelta.delta_matrix.builds
    assert tdelta.delta_matrix(11, 3) is S
    assert tdelta.delta_matrix(11, 3, torch.device("cpu"), torch.float32) is S
    assert tdelta.delta_matrix.builds == builds
    others = [tdelta.delta_matrix(12, 3), tdelta.delta_matrix(11, 4),
              tdelta.delta_matrix(11, 3, dtype=torch.float64)]
    assert all(o is not S for o in others)
    assert len({id(o) for o in others}) == 3
    assert tdelta.delta_matrix.builds == builds + 3


def test_backward_after_a_warm_cache_builds_no_matrix():
    xs = [torch.from_numpy(_x(40 + i, 2, 13, D)).requires_grad_(True)
          for i, D in enumerate(WIDTHS)]

    def step():
        outs = tdelta.delta_group(xs, 5)
        torch.autograd.backward(outs, [torch.ones_like(o) for o in outs])

    step()
    builds = tdelta.delta_matrix.builds
    step()
    assert tdelta.delta_matrix.builds == builds


def test_group_gradients_equal_single_stream_gradients():
    window, T = 4, 9
    xs = [_x(50 + i, 3, T, D) for i, D in enumerate(WIDTHS)]
    gs = [_x(60 + i, 3, T, 3 * D) for i, D in enumerate(WIDTHS)]
    grouped = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    outs = tdelta.delta_group(grouped, window)
    torch.autograd.backward(outs, [torch.from_numpy(g) for g in gs])
    for x, g, tx, out in zip(xs, gs, grouped, outs):
        single = torch.from_numpy(x).requires_grad_(True)
        ref = tdelta.delta_layer(single, window)
        ref.backward(torch.from_numpy(g))
        torch.testing.assert_close(out.detach(), ref.detach(), rtol=0, atol=0)
        torch.testing.assert_close(tx.grad, single.grad, rtol=0, atol=0)


def test_backward_runs_one_product_per_stream_that_needs_a_gradient(monkeypatch):
    # the last stream as the 4-stream model's DCT and MFCC streams, fed from
    # the input; the first needs a gradient, but its output gets none
    window, T = 4, 9
    xs = [torch.from_numpy(_x(80 + i, 2, T, D)) for i, D in enumerate(WIDTHS)]
    xs[0].requires_grad_(True)
    xs[1].requires_grad_(True)
    products = []
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: products.append(1) or matmul(a, b))
    outs = tdelta.delta_group(xs, window)
    assert [o.requires_grad for o in outs] == [True, True, False]
    g = torch.from_numpy(_x(90, 2, T, 3 * WIDTHS[1]))
    torch.autograd.backward(outs[1], g)
    assert len(products) == 1 and xs[0].grad is None and xs[2].grad is None
    monkeypatch.setattr(torch, "matmul", matmul)
    single = xs[1].detach().clone().requires_grad_(True)
    tdelta.delta_layer(single, window).backward(g)
    torch.testing.assert_close(xs[1].grad, single.grad, rtol=0, atol=0)


def _group(*shapes):
    return [torch.zeros(s) for s in shapes]


@pytest.mark.parametrize("xs,window,error", [
    (_group((2, 5, 3), (3, 5, 4)), 2, ValueError),                      # B differs
    (_group((2, 5, 3), (2, 6, 4)), 2, ValueError),                      # T differs
    (_group((2, 5, 3), (2, 5, 4)), [2, 3], TypeError),                  # a window per tensor
    (_group(*[(2, 5, 3)] * 17), 2, ValueError),                         # above MAX_STREAMS
    ([torch.zeros(2, 3, 5).transpose(1, 2)], 2, ValueError),            # not contiguous
    ([torch.zeros(2, 5, 3, dtype=torch.float64)], 2, TypeError),        # not float32
    ([torch.zeros(2, 5, 3, device="meta")], 2, ValueError),             # not CPU or CUDA
    ([torch.zeros(2, 5, 3), torch.zeros(2, 5, 3, device="meta")], 2, ValueError),
    ([], 2, ValueError),                                                # empty group
    (_group((5, 3)), 2, ValueError),                                    # not (B, T, D)
])
def test_group_wrapper_raises_on_what_the_kernel_does_not_take(xs, window, error):
    with pytest.raises(error):
        kdelta.append_delta_group(xs, window)


def test_stream_prefix_runs_one_group_over_the_delta_streams(monkeypatch):
    cfg = zoo.adenet_v3(12, 6, 12, lstm_size=4, window=3, output_classes=5)
    cfg = dataclasses.replace(cfg, streams=[
        dataclasses.replace(s, encoder_shapes=(8, 6, 5),
                            encoder_nonlinearities=("sigmoid", "sigmoid", "linear"))
        if s.encoder_shapes else s for s in cfg.streams])
    params = adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    calls = []
    original = adenet.delta_group

    def spy(xs, window):
        calls.append(([tuple(x.shape) for x in xs], window))
        return original(xs, window)

    monkeypatch.setattr(adenet, "delta_group", spy)
    rng = np.random.RandomState(1)
    inputs = [torch.from_numpy(rng.randn(2, 7, s.input_dim).astype(np.float32))
              for s in cfg.streams]
    feats = adenet.stream_prefix(params, cfg, inputs)
    with_delta = [s for s in cfg.streams if s.use_delta]
    assert calls == [([(2, 7, s.encoded_dim()) for s in with_delta], 3)]
    assert [f.shape[-1] for f in feats] == [s.feature_dim() for s in cfg.streams]
