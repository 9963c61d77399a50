"""The port's LSTM training path against the JAX package: the residual-emitting
recurrence and the reverse-time backward chain (plain versions of the kernels
in ip_avsr_torch/ops/kernels/lstm.py), and the gradients of
ip_avsr_torch.ops.lstm.lstm_forward.

References: the TPU kernels ``lstm_pallas_train`` and ``lstm_pallas_bwd_chain``
in interpret mode (the functions the CUDA kernels replace; they keep the
residuals time-major, the port batch-major, so the tests transpose), and
``jax.grad`` of ``ip_avsr_tpu.ops.lstm.lstm_forward`` (its custom-VJP core,
gate-gradient clip at 5).  Tolerances, float32: 1e-5 absolute and relative on
forward values (summation order of h @ W_hid only); gradients at 1e-5
relative to the largest entry of each gradient, since the chain sums up to T
products of 4H terms in another order than XLA's scan.
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
KEYS = ("w_in", "w_hid", "b", "cell_init", "hid_init")


def _case(seed, B=5, T=9, D=7, H=6):
    """Random layer with a learned non-zero initial state, ragged lengths
    including a fully padded row."""
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
    g = rng.randn(B, T, H).astype(np.float32)
    return params, x, mask, g


def _scan_inputs(params, x, mask, backwards):
    """The recurrence's inputs as _lstm_prep builds them (batch-major)."""
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    xs, ms = (x[:, ::-1], mask[:, ::-1]) if backwards else (x, mask)
    x_proj = (xs.reshape(B * T, -1) @ params["w_in"]).reshape(B, T, 4 * H) + params["b"]
    cell0 = np.broadcast_to(params["cell_init"], (B, H)).copy()
    hid0 = np.broadcast_to(params["hid_init"], (B, H)).copy()
    return [np.ascontiguousarray(a, dtype=np.float32)
            for a in (x_proj, params["w_hid"], ms, cell0, hid0)]


def _tm(a):
    """(B, T, .) <-> (T, B, .)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("backwards", [False, True])
def test_train_recurrence_plain_matches_pallas_interpret(backwards):
    params, x, mask, _ = _case(0)
    x_proj, w_hid, ms, cell0, hid0 = _scan_inputs(params, x, mask, backwards)
    ref = lstm_kernel.lstm_pallas_train(
        jnp.asarray(_tm(x_proj)), jnp.asarray(w_hid), jnp.asarray(_tm(ms[..., None])),
        jnp.asarray(cell0), jnp.asarray(hid0), block_b=8, interpret=True)
    got = klstm.lstm_recurrence_train_plain(*map(_t, (x_proj, w_hid, ms, cell0, hid0)))
    for name, r, g in zip(("hids", "cells", "gates_pre"), ref, got):
        np.testing.assert_allclose(g.numpy(), _tm(r), err_msg=name, **TOL)
    # the hids are the inference recurrence's output, bit for bit
    torch.testing.assert_close(
        got[0], klstm.lstm_recurrence_plain(*map(_t, (x_proj, w_hid, ms, cell0, hid0))),
        rtol=0, atol=0)


def _chain_inputs(seed, scale, backwards=False):
    params, x, mask, g = _case(seed)
    x_proj, w_hid, ms, cell0, hid0 = _scan_inputs(params, x, mask, backwards)
    hids, cells, gates = klstm.lstm_recurrence_train_plain(
        *map(_t, (x_proj, w_hid, ms, cell0, hid0)))
    cells = cells.numpy()
    cells_prev = np.concatenate([cell0[:, None], cells[:, :-1]], axis=1)
    return (g * scale, gates.numpy(), cells, cells_prev, ms, w_hid)


# scale 100 makes the +-5 clip bite; clip 0 means no clip
@pytest.mark.parametrize("clip,scale", [(5.0, 1.0), (5.0, 100.0), (0.0, 1.0), (0.0, 100.0)])
def test_bwd_chain_plain_matches_pallas_interpret(clip, scale):
    g, gates, cells, cells_prev, ms, w_hid = _chain_inputs(1, scale)
    ref = lstm_kernel.lstm_pallas_bwd_chain(
        jnp.asarray(_tm(g)), jnp.asarray(_tm(gates)), jnp.asarray(_tm(cells)),
        jnp.asarray(_tm(cells_prev)), jnp.asarray(_tm(ms[..., None])), jnp.asarray(w_hid),
        clip, block_b=4, interpret=True)
    got = klstm.lstm_bwd_chain_plain(*map(_t, (g, gates, cells, cells_prev, ms, w_hid)),
                                     clip)
    ref = (_tm(ref[0]), np.asarray(ref[1]), np.asarray(ref[2]))
    for name, r, o in zip(("dgates", "dcell0", "dhid0"), ref, got):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5 * max(1.0, np.abs(r).max()),
                                   rtol=1e-5, err_msg=name)
    dgates = got[0].numpy()
    if clip:
        assert np.abs(dgates).max() <= clip
        if scale > 1:
            assert (np.abs(dgates) == clip).mean() > 0.05  # the clip bites
    elif scale > 1:
        assert np.abs(dgates).max() > 5.0
    # the fully padded row (index 3): no gate gradient, and every step passes
    # the carries through, so dcell0 stays 0 and dhid0 sums the upstream g
    assert not dgates[3].any() and not got[1][3].any()
    np.testing.assert_allclose(got[2][3].numpy(), g[3].sum(0), atol=1e-5 * scale, rtol=1e-5)


def test_bwd_chain_passes_carries_through_pad_steps():
    """With the upstream gradient only on a padded row, dhid0 is the sum of
    g over that row's steps and dcell0 is zero (pad steps carry through)."""
    g, gates, cells, cells_prev, ms, w_hid = _chain_inputs(2, 1.0)
    g = np.zeros_like(g)
    g[3] = np.random.RandomState(0).randn(*g[3].shape)
    dgates, dcell0, dhid0 = klstm.lstm_bwd_chain_plain(
        *map(_t, (g, gates, cells, cells_prev, ms, w_hid)), 5.0)
    assert not dgates.any() and not dcell0.any()
    np.testing.assert_allclose(dhid0[3].numpy(), g[3].sum(0), **TOL)


def _grads_port(params, x, mask, g, backwards, clip=5.0):
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx = _t(x).requires_grad_(True)
    out = tlstm.lstm_forward(tp, tx, _t(mask), backwards=backwards, grad_clipping=clip)
    out.backward(_t(g))
    return out.detach().numpy(), {**{k: tp[k].grad.numpy() for k in KEYS},
                                  "x": tx.grad.numpy()}


def _grads_jax(params, x, mask, g, backwards):
    def f(p, xx):
        out = jlstm.lstm_forward(p, xx, jnp.asarray(mask), backwards=backwards)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {**{k: np.asarray(gp[k]) for k in KEYS}, "x": np.asarray(gx)}


def _assert_grads_close(got, ref):
    for k, r in ref.items():
        scale = max(1.0, np.abs(r).max())
        np.testing.assert_allclose(got[k], r, atol=1e-5 * scale, rtol=0, err_msg=k)


# scale 100 is the case where the clip bites: without it the port's
# gradients were off by up to 160 where JAX's largest entry is ~26
@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_lstm_forward_grads_match_jax(backwards, scale):
    params, x, mask, g = _case(3, B=3, T=6, D=5, H=4)
    out, got = _grads_port(params, x, mask, g * scale, backwards)
    ref_out, ref = _grads_jax(params, x, mask, g * scale, backwards)
    np.testing.assert_allclose(out, ref_out, **TOL)
    _assert_grads_close(got, ref)


def test_blstm_grads_match_jax_through_last_step():
    """The last-step head reads index -1: its gradient reaches the padded
    tail of the backward half and, through it, hid_init."""
    pf, x, mask, _ = _case(4)
    pb, _, _, _ = _case(5)
    w = np.random.RandomState(6).randn(6, 3).astype(np.float32) * 10

    def jloss(pf_, pb_):
        out = jlstm.blstm_forward(pf_, pb_, jnp.asarray(x), jnp.asarray(mask))
        return jnp.sum(jnp.tanh(jlstm.last_valid_step(out, None) @ jnp.asarray(w)))

    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    ref = jax.grad(jloss, argnums=(0, 1))(jp(pf), jp(pb))
    tf = {k: _t(v).requires_grad_(True) for k, v in pf.items()}
    tb = {k: _t(v).requires_grad_(True) for k, v in pb.items()}
    out = tlstm.blstm_forward(tf, tb, _t(x), _t(mask))
    torch.tanh(tlstm.last_valid_step(out, None) @ _t(w)).sum().backward()
    for tree, r in ((tf, ref[0]), (tb, ref[1])):
        _assert_grads_close({k: tree[k].grad.numpy() for k in KEYS},
                            {k: np.asarray(r[k]) for k in KEYS})
    assert np.abs(tb["hid_init"].grad.numpy()).max() > 0


@pytest.mark.parametrize("backwards", [False, True])
def test_unclipped_grads_equal_autograd_of_plain_loop(backwards):
    """clip 0: the Function's gradients equal plain autograd through the
    step-by-step recurrence (an oracle independent of both backward chains)."""
    params, x, mask, g = _case(7)
    out, got = _grads_port(params, x, mask, g * 100, backwards, clip=0.0)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx = _t(x).requires_grad_(True)
    x_, m_ = (torch.flip(tx, (1,)), torch.flip(_t(mask), (1,))) if backwards else (tx, _t(mask))
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    x_proj = (x_.reshape(B * T, -1) @ tp["w_in"]).reshape(B, T, 4 * H) + tp["b"]
    ref_out = klstm.lstm_recurrence_plain(x_proj, tp["w_hid"], m_,
                                          tp["cell_init"].expand(B, H),
                                          tp["hid_init"].expand(B, H))
    if backwards:
        ref_out = torch.flip(ref_out, (1,))
    ref_out.backward(_t(g * 100))
    np.testing.assert_allclose(out, ref_out.detach().numpy(), **TOL)
    _assert_grads_close(got, {**{k: tp[k].grad.numpy() for k in KEYS},
                              "x": tx.grad.numpy()})


def test_no_grad_takes_the_inference_recurrence(monkeypatch):
    params, x, mask, _ = _case(8)
    calls = []
    monkeypatch.setattr(tlstm, "lstm_recurrence_train",
                        lambda *a: calls.append(1) or klstm.lstm_recurrence_train_plain(*a))
    tp = {k: _t(v) for k, v in params.items()}
    plain = tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert not calls  # nothing requires a gradient
    tp["w_hid"].requires_grad_(True)
    with torch.no_grad():
        tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert not calls
    trained = tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert calls == [1] and trained.requires_grad
    torch.testing.assert_close(trained.detach(), plain, rtol=0, atol=0)


def test_train_wrappers_route_cpu_tensors_to_plain_versions():
    g, gates, cells, cells_prev, ms, w_hid = _chain_inputs(9, 1.0)
    before = (klstm.lstm_recurrence_train.launches, klstm.lstm_bwd_chain.launches)
    B, T, H = cells.shape
    x_proj = torch.randn(B, T, 4 * H, generator=torch.Generator().manual_seed(0))
    fwd_args = (x_proj, _t(w_hid), _t(ms), torch.zeros(B, H), torch.zeros(B, H))
    for a, b in zip(klstm.lstm_recurrence_train(*fwd_args),
                    klstm.lstm_recurrence_train_plain(*fwd_args)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bwd_args = tuple(map(_t, (g, gates, cells, cells_prev, ms, w_hid)))
    for a, b in zip(klstm.lstm_bwd_chain(*bwd_args, 5.0),
                    klstm.lstm_bwd_chain_plain(*bwd_args, 5.0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="clip"):
        klstm.lstm_bwd_chain(*bwd_args, -1.0)
    assert (klstm.lstm_recurrence_train.launches, klstm.lstm_bwd_chain.launches) == before
