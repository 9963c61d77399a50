"""The port's DeltaLayer (ip_avsr_torch/ops/delta.py, the plain version of
the delta kernel in ops/kernels/delta.py) against the JAX package.

References: the TPU kernel body ``_delta_kernel`` run by ``pallas_call`` in
interpret mode (the function the CUDA kernel replaces, built as
tests/test_ops.py builds it) and ``ip_avsr_tpu.ops.delta.append_delta_coeff``.
Tolerance: float32 at atol 1e-5 / rtol 1e-5 (summation order only).  The
delta layer's gradient is held against ``jax.vjp`` of
``append_delta_coeff``, the transpose ``_append_delta_bwd`` computes.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ip_avsr_tpu.ops import delta as jdelta
from ip_avsr_tpu.ops.pallas import delta_kernel
from ip_avsr_torch.ops import delta as tdelta
from ip_avsr_torch.ops.kernels import delta as kdelta

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _pallas_interpret(x, window):
    B, T, D = x.shape
    kernel = functools.partial(delta_kernel._delta_kernel, window=window, T=T, D=D)
    d, a = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((B, T, D), jnp.float32),
                   jax.ShapeDtypeStruct((B, T, D), jnp.float32)),
        grid=(B,),
        in_specs=[pl.BlockSpec((1, T, D), lambda b: (b, 0, 0))],
        out_specs=(pl.BlockSpec((1, T, D), lambda b: (b, 0, 0)),
                   pl.BlockSpec((1, T, D), lambda b: (b, 0, 0))),
        scratch_shapes=[pltpu.VMEM((T + 2 * window, D), jnp.float32)],
        interpret=True,
    )(jnp.asarray(x))
    return np.concatenate([x, np.asarray(d), np.asarray(a)], axis=-1)


def _x(seed, B, T, D):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32) * 3.0


# (window, T): W = 1 and 4 at a T above the window, and T < W
@pytest.mark.parametrize("window,T", [(1, 9), (4, 9), (4, 3), (4, 1)])
def test_plain_delta_matches_pallas_interpret(window, T):
    x = _x(window * 10 + T, 2, T, 6)
    got = tdelta.append_delta_coeff(torch.from_numpy(x), window).numpy()
    np.testing.assert_allclose(got, _pallas_interpret(x, window), **TOL)


# W = 0 is checked against append_delta_coeff only: the Pallas body's tap
# loop is empty there and returns no array (the TPU dispatch never sends
# window <= 0 to it); the CUDA kernel's empty loop gives zero deltas.
@pytest.mark.parametrize("window,T", [(0, 9), (1, 9), (4, 9), (4, 3), (9, 29)])
def test_plain_delta_matches_append_delta_coeff(window, T):
    x = _x(window + T, 3, T, 5)
    got = tdelta.append_delta_coeff(torch.from_numpy(x), window).numpy()
    ref = np.asarray(jdelta.append_delta_coeff(jnp.asarray(x), window))
    np.testing.assert_allclose(got, ref, **TOL)
    if window == 0:
        assert not got[..., 5:].any()


def test_delta_layer_routes_cpu_tensors_to_plain_version():
    x = torch.from_numpy(_x(7, 2, 9, 4))
    before = kdelta.append_delta.launches
    torch.testing.assert_close(tdelta.delta_layer(x, 3),
                               tdelta.append_delta_coeff(x, 3), rtol=0, atol=0)
    assert kdelta.append_delta.launches == before


def test_edge_padding_repeats_first_and_last_frame():
    # a ramp has constant slope inside and a damped slope near the edges,
    # where the repeated first/last frame flattens the window
    x = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1)
    d = tdelta.delta_coeff(x, 1)[0, :, 0]
    torch.testing.assert_close(d, torch.tensor([0.5, 1.0, 1.0, 1.0, 1.0, 0.5]))


# W = 9 at T = 29 is the flagship's; T < W and W = 0 are the edges
@pytest.mark.parametrize("window,T", [(9, 29), (4, 9), (4, 3), (1, 1), (0, 6)])
def test_delta_layer_gradient_matches_jax_vjp(window, T):
    x = _x(window * 7 + T, 2, T, 5)
    g = _x(window * 7 + T + 1, 2, T, 15)
    _, vjp = jax.vjp(lambda v: jdelta.append_delta_coeff(v, window), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tdelta.delta_layer(tx, window)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), ref, atol=1e-5 * max(1.0, np.abs(ref).max()),
                               rtol=1e-5)
    # the forward is unchanged by the Function
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jdelta.append_delta_coeff(jnp.asarray(x), window)),
                               **TOL)


def test_fir_matrix_is_the_delta_filter():
    x = torch.from_numpy(_x(11, 3, 8, 4)).double()
    for window in (0, 1, 3, 10):
        F = tdelta.fir_matrix(8, window, dtype=torch.float64)
        torch.testing.assert_close(torch.matmul(F, x), tdelta.delta_coeff(x, window))
    # a row sums to zero: a constant sequence has no slope
    assert tdelta.fir_matrix(8, 3).sum(1).abs().max() < 1e-6
