"""The port's masked LSTM (ip_avsr_torch/ops/lstm.py and the plain version
of the recurrence kernel, ops/kernels/lstm.py) against the JAX package.

References: the TPU kernel ``lstm_pallas`` in interpret mode (the function
the CUDA kernel replaces) and ``ip_avsr_tpu.ops.lstm.lstm_forward``.
Tolerance: float32 at atol 1e-5 / rtol 1e-5 — the two sides differ only in
summation order of the h @ W_hid products.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_tpu.ops.pallas import lstm_kernel
from ip_avsr_torch.ops import lstm as tlstm
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, B=5, T=9, D=7, H=6):
    """Random layer with a learned non-zero initial state, ragged lengths
    including an all-pad row."""
    rng = np.random.RandomState(seed)
    params = {
        "w_in": rng.randn(D, 4 * H).astype(np.float32) * 0.5,
        "w_hid": rng.randn(H, 4 * H).astype(np.float32) * 0.5,
        "b": rng.randn(4 * H).astype(np.float32) * 0.1,
        "cell_init": rng.randn(1, H).astype(np.float32),
        "hid_init": rng.randn(1, H).astype(np.float32) * 0.5,
    }
    x = rng.randn(B, T, D).astype(np.float32)
    lens = np.array([T, T // 2, 1, 0, T - 1][:B])
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    return params, x, mask


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("backwards", [False, True])
def test_plain_recurrence_matches_pallas_interpret(backwards):
    params, x, mask = _case(0)
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    # the TPU kernel takes the flipped sequence of a backwards layer
    xs, ms = (x[:, ::-1], mask[:, ::-1]) if backwards else (x, mask)
    x_proj = (xs.reshape(B * T, -1) @ params["w_in"]).reshape(B, T, 4 * H) + params["b"]
    cell0 = np.broadcast_to(params["cell_init"], (B, H)).copy()
    hid0 = np.broadcast_to(params["hid_init"], (B, H)).copy()
    ref = np.asarray(lstm_kernel.lstm_pallas(
        jnp.asarray(x_proj), jnp.asarray(params["w_hid"]), jnp.asarray(ms.copy()),
        jnp.asarray(cell0), jnp.asarray(hid0), block_b=8, interpret=True))
    got = klstm.lstm_recurrence_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                                        (x_proj, params["w_hid"], ms, cell0, hid0)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # the port's whole layer (projection, flip, recurrence, flip back)
    full = tlstm.lstm_forward(_t(params), torch.from_numpy(x), torch.from_numpy(mask),
                              backwards=backwards)
    np.testing.assert_allclose(full.numpy(), ref[:, ::-1] if backwards else ref, **TOL)


@pytest.mark.parametrize("backwards", [False, True])
def test_lstm_forward_matches_jax(backwards):
    params, x, mask = _case(1)
    ref = jlstm.lstm_forward({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jnp.asarray(mask), backwards=backwards)
    got = tlstm.lstm_forward(_t(params), torch.from_numpy(x),
                             torch.from_numpy(mask), backwards=backwards)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_mask_carry_and_backwards_tail_hold_init_state():
    params, x, mask = _case(2)
    H = params["w_hid"].shape[0]
    fwd = tlstm.lstm_forward(_t(params), torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    bwd = tlstm.lstm_forward(_t(params), torch.from_numpy(x), torch.from_numpy(mask),
                             backwards=True).numpy()
    lens = mask.sum(1).astype(int)
    for b, n in enumerate(lens):
        # forward: pad steps carry the last valid output (or the init state)
        carried = fwd[b, n - 1] if n > 0 else params["hid_init"][0]
        np.testing.assert_array_equal(fwd[b, n:], np.broadcast_to(carried, (x.shape[1] - n, H)))
        # backwards: the padded tail comes first in the flipped scan, so it
        # holds the learned initial hidden state
        np.testing.assert_array_equal(bwd[b, n:], np.broadcast_to(params["hid_init"][0],
                                                                  (x.shape[1] - n, H)))


def test_blstm_and_last_valid_step_match_jax():
    pf, x, mask = _case(3)
    pb, _, _ = _case(4)
    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    ref = jlstm.blstm_forward(jp(pf), jp(pb), jnp.asarray(x), jnp.asarray(mask))
    got = tlstm.blstm_forward(_t(pf), _t(pb), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # index -1, mask ignored: reads the backward half's init state on pad rows
    np.testing.assert_allclose(
        tlstm.last_valid_step(got, torch.from_numpy(mask)).numpy(),
        np.asarray(jlstm.last_valid_step(ref, jnp.asarray(mask))), **TOL)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    params, x, mask = _case(5)
    before = klstm.lstm_recurrence.launches
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    x_proj = torch.randn(B, T, 4 * H, generator=torch.Generator().manual_seed(0))
    args = (x_proj, torch.from_numpy(params["w_hid"]), torch.from_numpy(mask),
            torch.zeros(B, H), torch.zeros(B, H))
    torch.testing.assert_close(klstm.lstm_recurrence(*args),
                               klstm.lstm_recurrence_plain(*args), rtol=0, atol=0)
    assert klstm.lstm_recurrence.launches == before


def test_peephole_params_raise_not_implemented():
    """Peephole parameters no longer raise NotImplementedError: the layer
    runs the peephole recurrence (equal to the JAX forward), and the init
    draws the three vectors in the JAX layout."""
    params, x, mask = _case(6)
    rng = np.random.RandomState(16)
    for k in ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate"):
        params[k] = rng.randn(6).astype(np.float32)
    ref = jlstm.lstm_forward({k: jnp.asarray(v) for k, v in params.items()},
                             jnp.asarray(x), jnp.asarray(mask))
    got = tlstm.lstm_forward(_t(params), torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    ref_p = jlstm.init_lstm_params(jax.random.PRNGKey(0), 3, 4, use_peepholes=True)
    got_p = tlstm.init_lstm_params(torch.Generator().manual_seed(0), 3, 4, use_peepholes=True)
    assert {k: tuple(v.shape) for k, v in got_p.items()} == {
        k: tuple(v.shape) for k, v in ref_p.items()}


def test_init_lstm_params_layout_matches_jax():
    ref = jlstm.init_lstm_params(jax.random.PRNGKey(0), 7, 5)
    got = tlstm.init_lstm_params(torch.Generator().manual_seed(0), 7, 5)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
