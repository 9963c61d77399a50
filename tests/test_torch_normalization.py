"""The port's normalization, pooling and LCN ops against the JAX package's
(ip_avsr_torch/ops/{normalization,pooling,lcn}.py).

Tolerances, float32: 1e-5 relative and 1e-6 absolute on normalized outputs
(the same two-pass statistics in the same order of ops); the running state
within 1e-5 (one moving-average step of statistics the two packages sum in
another order); ``gaussian_filter`` bit for bit (the same numpy code); the
LCN's two convolutions within 1e-5 of JAX's.  The batch-norm cases include
the one that makes a one-pass variance cancel in float32 (mean ~2e3, std
~1e-2) and check that the variance divides by N, not N - 1.  There the
float32 mean itself is off by a few ulps of 2e3 (1.2e-4 each) in either
package, in different rows, which moves a normalized value by up to
4 ulp / std: both packages are then held to a float64 reference on the
same inputs within that bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.ops import lcn as jlcn
from ip_avsr_tpu.ops import normalization as jnorm
from ip_avsr_tpu.ops import pooling as jpool
from ip_avsr_torch.ops import lcn as tlcn
from ip_avsr_torch.ops import normalization as tnorm
from ip_avsr_torch.ops import pooling as tpool

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
STATE_TOL = 1e-5


def _x(case, shape=(4, 7, 5)):
    rng = np.random.RandomState(0)
    if case == "large_mean":
        return (2e3 + 1e-2 * rng.randn(*shape)).astype(np.float32)
    return (3.0 * rng.randn(*shape) + 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_normalized(got, ref, x, case, gamma=1.0, beta=0.0, eps=0.0):
    """Port against JAX; in the large-mean case both against the float64
    normalization of the same float32 inputs within the mean-rounding bound
    (gamma, beta: the affine map after it; eps inside the std)."""
    if case != "large_mean":
        np.testing.assert_allclose(got, ref, **TOL)
        return
    flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
    std = np.sqrt(flat.var(axis=0) + eps)
    exact = ((flat - flat.mean(axis=0)) / std * gamma + beta).reshape(x.shape)
    bound = 4 * np.spacing(np.float32(2e3)) / std.min() * np.max(np.abs(gamma)) + 1e-5
    for name, a in (("port", got), ("jax", ref)):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, exact, rtol=0, atol=bound, err_msg=name)


@pytest.mark.parametrize("case", ["normal", "large_mean"])
def test_znormalize_matches_jax(case):
    x = _x(case)
    got = tnorm.znormalize(_t(x), eps=1e-6).numpy()
    ref = np.asarray(jnorm.znormalize(jnp.asarray(x), eps=1e-6))
    _assert_normalized(got, ref, x, case)


def _bn_params(dim, seed=1):
    rng = np.random.RandomState(seed)
    params = {"gamma": (1 + 0.1 * rng.randn(dim)).astype(np.float32),
              "beta": (0.1 * rng.randn(dim)).astype(np.float32)}
    state = {"mean": (0.2 * rng.randn(dim)).astype(np.float32),
             "var": (1 + 0.1 * rng.rand(dim)).astype(np.float32)}
    return params, state


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", ["normal", "large_mean"])
def test_batch_norm_matches_jax(train, case):
    x = _x(case)
    params, state = _bn_params(x.shape[-1])
    y, new = tnorm.batch_norm_forward({k: _t(v) for k, v in params.items()},
                                      {k: _t(v) for k, v in state.items()}, _t(x), train)
    jy, jnew = jnorm.batch_norm_forward(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(x), train)
    assert np.isfinite(y.numpy()).all()
    if train:
        _assert_normalized(y.numpy(), np.asarray(jy), x, case, params["gamma"],
                           params["beta"], eps=1e-4)
    else:
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]), rtol=STATE_TOL,
                                   atol=STATE_TOL, err_msg=k)
        assert not new[k].requires_grad
    if train:
        # the variance divides by N: the running var moved by alpha towards it
        flat = x.reshape(-1, x.shape[-1]).astype(np.float64)
        np.testing.assert_allclose(new["var"].numpy(),
                                   0.99 * state["var"] + 0.01 * flat.var(axis=0), rtol=1e-5)
    else:
        assert new is not None and all(new[k] is not None for k in ("mean", "var"))


def test_init_batch_norm_matches_jax():
    params, state = tnorm.init_batch_norm(6)
    jparams, jstate = jnorm.init_batch_norm(6)
    for got, ref in ((params, jparams), (state, jstate)):
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_batch_norm_mesh_axis_raises():
    """``axis_name`` syncs the training statistics over mesh dims: on the
    one-process mesh the synced forward, its moved statistics and its input
    gradient equal the unsynced ones (and JAX's); a dim the mesh lacks
    raises."""
    rng = np.random.RandomState(3)
    x = (5.0 + rng.randn(4, 6, 3)).astype(np.float32)
    params, state = tnorm.init_batch_norm(3)
    xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(2)]
    (y0, s0), (y1, s1) = (tnorm.batch_norm_forward(params, state, xi, True, axis_name=ax)
                          for xi, ax in zip(xs, (None, "data")))
    ref, jstate = jnorm.batch_norm_forward(*jnorm.init_batch_norm(3), jnp.asarray(x), True)
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(), atol=1e-6, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(s1[k].numpy(), s0[k].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(s1[k].numpy(), np.asarray(jstate[k]), rtol=1e-5, atol=1e-6)
    w = torch.from_numpy(rng.randn(4, 6, 3).astype(np.float32))
    g0, g1 = (torch.autograd.grad((y * w).sum(), xi)[0] for y, xi in zip((y0, y1), xs))
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unbound axis name 'seq'"):
        tnorm.batch_norm_forward(params, state, torch.zeros(2, 3), True, axis_name="seq")


def test_masked_mean_pool_matches_jax_with_an_all_pad_row():
    rng = np.random.RandomState(2)
    x = rng.randn(4, 6, 3).astype(np.float32)
    lens = np.array([6, 3, 1, 0])
    mask = (np.arange(6)[None] < lens[:, None]).astype(np.float32)
    got = tpool.masked_mean_pool(_t(x), _t(mask)).numpy()
    ref = np.asarray(jpool.masked_mean_pool(jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got[3], np.zeros(3, np.float32))
    np.testing.assert_allclose(got[1], x[1, :3].mean(axis=0), **TOL)


@pytest.mark.parametrize("kernel_shape,sigma", [(9, None), (5, 1.3), (4, None)])
def test_gaussian_filter_matches_jax(kernel_shape, sigma):
    got = tlcn.gaussian_filter(kernel_shape, sigma)
    ref = jlcn.gaussian_filter(kernel_shape, sigma)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel_shape", [9, 5])
def test_lecun_lcn_matches_jax(kernel_shape):
    x = np.random.RandomState(3).rand(2, 1, 12, 15).astype(np.float32) * 255
    got = tlcn.make_lecun_lcn(kernel_shape)(_t(x)).numpy()
    ref = np.asarray(jlcn.make_lecun_lcn(kernel_shape)(jnp.asarray(x)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
