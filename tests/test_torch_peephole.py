"""The port's peephole LSTM against the JAX package: the plain versions of the
peephole kernels in ip_avsr_torch/ops/kernels/lstm.py (inference recurrence,
training recurrence, backward chain), the gradients of
ip_avsr_torch.ops.lstm.lstm_forward with peephole parameters, and their init.

References: the TPU kernels ``lstm_pallas_peep``, ``lstm_pallas_peep_train``
and ``lstm_pallas_peep_bwd_chain`` in interpret mode (the functions the CUDA
kernels replace; they keep sequences time-major, the port batch-major, so the
tests transpose), the XLA scans of ip_avsr_tpu/ops/lstm.py
(``_peep_recurrence_scan`` and the scan branch of ``_lstm_core_peep_bwd``),
and ``jax.grad`` of ``lstm_forward`` with and without its custom VJP.

Cases: both directions, ragged masks with a fully padded row, H = 6 and 5
(not multiples of 4, as the kernels' H = 250 is not), the +-5 clip with the
upstream gradient x100 so that it bites, and clip 0.  Tolerances, float32:
1e-6 absolute on forward values (the same arithmetic; summation order of
h @ W_hid only); backward values at 1e-5 relative to the largest entry of
each output with a 1e-8 absolute floor (a chain of T steps summing 4H
products in another order; the floor keeps an output that is near zero
from asking for more than float32 gives).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_tpu.ops.pallas import lstm_kernel
from ip_avsr_torch.ops import initializers as tinits
from ip_avsr_torch.ops import lstm as tlstm
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
FWD_TOL = dict(atol=1e-6, rtol=0)
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
KEYS = ("w_in", "w_hid", "b", "cell_init", "hid_init") + PEEP


def _case(seed, B=5, T=9, D=7, H=6):
    """Random peephole layer with a learned non-zero initial state, ragged
    lengths including a fully padded row (index 3)."""
    rng = np.random.RandomState(seed)
    params = {
        "w_in": rng.randn(D, 4 * H).astype(np.float32) * 0.5,
        "w_hid": rng.randn(H, 4 * H).astype(np.float32) * 0.5,
        "b": rng.randn(4 * H).astype(np.float32) * 0.1,
        "cell_init": rng.randn(1, H).astype(np.float32),
        "hid_init": rng.randn(1, H).astype(np.float32) * 0.5,
        **{k: rng.randn(H).astype(np.float32) * 0.5 for k in PEEP},
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


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close_rel(got, ref, name):
    """Within 1e-5 of the largest entry of ``ref``, floor 1e-8 absolute."""
    ref = np.asarray(ref)
    atol = max(1e-5 * np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("H", [6, 5])
@pytest.mark.parametrize("backwards", [False, True])
def test_peep_recurrences_plain_match_pallas_interpret_and_scan(backwards, H):
    params, x, mask, _ = _case(0, H=H)
    x_proj, w_hid, ms, cell0, hid0 = _scan_inputs(params, x, mask, backwards)
    peep = [params[k] for k in PEEP]
    got_inf = klstm.lstm_peep_recurrence_plain(*map(_t, (x_proj, w_hid, ms, cell0, hid0)),
                                               *map(_t, peep))
    got = klstm.lstm_peep_recurrence_train_plain(*map(_t, (x_proj, w_hid, ms, cell0, hid0)),
                                                 *map(_t, peep))
    # the TPU inference kernel takes batch-major inputs, the training one
    # time-major
    ref_inf = lstm_kernel.lstm_pallas_peep(*_j(x_proj, w_hid, ms, cell0, hid0, *peep),
                                           block_b=8, interpret=True)
    np.testing.assert_allclose(got_inf.numpy(), np.asarray(ref_inf), **FWD_TOL)
    ref = lstm_kernel.lstm_pallas_peep_train(
        *_j(_tm(x_proj), w_hid, _tm(ms[..., None]), cell0, hid0, *peep),
        block_b=8, interpret=True)
    scan = jlstm._peep_recurrence_scan(*_j(_tm(x_proj), _tm(ms[..., None]), cell0, hid0,
                                           w_hid, *peep), H, jnp.float32, True)
    for name, r, s, o in zip(("hids", "cells", "gates_pre"), ref, scan, got):
        np.testing.assert_allclose(o.numpy(), _tm(r), err_msg=f"{name} vs Pallas", **FWD_TOL)
        np.testing.assert_allclose(o.numpy(), _tm(s), err_msg=f"{name} vs scan", **FWD_TOL)
    # the inference hids are the training recurrence's, bit for bit
    torch.testing.assert_close(got[0], got_inf, rtol=0, atol=0)
    # gates_pre are stored before the peephole terms
    hids_prev = np.concatenate([hid0[:, None], got[0].numpy()[:, :-1]], axis=1)
    np.testing.assert_allclose(got[2].numpy(), x_proj + hids_prev @ w_hid, atol=1e-5, rtol=0)


def _chain_inputs(seed, scale, backwards=False, H=6):
    params, x, mask, g = _case(seed, H=H)
    x_proj, w_hid, ms, cell0, hid0 = _scan_inputs(params, x, mask, backwards)
    peep = [params[k] for k in PEEP]
    hids, cells, gates = klstm.lstm_peep_recurrence_train_plain(
        *map(_t, (x_proj, w_hid, ms, cell0, hid0)), *map(_t, peep))
    cells = cells.numpy()
    cells_prev = np.concatenate([cell0[:, None], cells[:, :-1]], axis=1)
    chain = (g * scale, gates.numpy(), cells, cells_prev, ms, w_hid)
    return chain, peep, (hids.numpy(), cell0, hid0)


def _scan_chain(chain, peep, state, clip):
    """The XLA scan's chain, through the scan branch of _lstm_core_peep_bwd
    with W_in = I (so dx is dgates) and x = 0: returns dgates, the row sums
    of dcell0 and dhid0, and the three peephole gradients."""
    g, gates, cells, cells_prev, ms, w_hid = chain
    hids, cell0, hid0 = state
    B, T, H = cells.shape
    eye = np.eye(4 * H, dtype=np.float32)
    residuals = _j(eye, w_hid, np.zeros(4 * H, np.float32), cell0[:1], hid0[:1], *peep,
                   np.zeros((B, T, 4 * H), np.float32), ms, _tm(hids), _tm(cells),
                   _tm(gates), cell0, hid0)
    out = jlstm._lstm_core_peep_bwd((False, clip, None), tuple(residuals), jnp.asarray(g))
    _, _, _, dcell_init, dhid_init, dw_ci, dw_cf, dw_co, dx, _ = out
    return dx, dcell_init[0], dhid_init[0], dw_ci, dw_cf, dw_co


@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("clip,scale", [(5.0, 1.0), (5.0, 100.0), (0.0, 1.0), (0.0, 100.0)])
def test_peep_bwd_chain_plain_matches_pallas_interpret_and_scan(clip, scale, backwards):
    chain, peep, state = _chain_inputs(1, scale, backwards)
    g, gates, cells, cells_prev, ms, w_hid = chain
    ref = lstm_kernel.lstm_pallas_peep_bwd_chain(
        *_j(_tm(g), _tm(gates), _tm(cells), _tm(cells_prev), _tm(ms[..., None]), w_hid,
            *peep), clip, block_b=4, interpret=True)
    got = klstm.lstm_peep_bwd_chain_plain(*map(_t, chain), *map(_t, peep), clip)
    names = ("dgates", "dcell0", "dhid0", "dw_ci", "dw_cf", "dw_co")
    ref = (_tm(ref[0]), *ref[1:])
    for name, r, o in zip(names, ref, got):
        _close_rel(o.numpy(), r, f"{name} vs Pallas")
    scan = _scan_chain(chain, peep, state, clip)
    summed = (got[0], got[1].sum(0), got[2].sum(0), *got[3:])
    for name, r, o in zip(names, scan, summed):
        _close_rel(o.numpy(), r, f"{name} vs scan")
    dgates = got[0].numpy()
    if clip:
        assert np.abs(dgates).max() <= clip
        if scale > 1:
            assert (np.abs(dgates) == clip).mean() > 0.05  # the clip bites
    elif scale > 1:
        assert np.abs(dgates).max() > 5.0
    # the fully padded row: no gate gradient, no peephole contribution, and
    # every step passes the carries through
    assert not dgates[3].any() and not got[1][3].any()
    np.testing.assert_allclose(got[2][3].numpy(), g[3].sum(0), atol=1e-5 * scale, rtol=1e-5)


def test_peep_clip_leaves_the_peephole_routes_unclipped():
    """At clip 5 with x100 upstream, dw_ci sums the in-gate cotangents from
    before the clip: it differs from the same sum over the clipped dgates."""
    chain, peep, _ = _chain_inputs(2, 100.0)
    got = klstm.lstm_peep_bwd_chain_plain(*map(_t, chain), *map(_t, peep), 5.0)
    _, _, cells, cells_prev, _, _ = chain
    H = cells.shape[-1]
    di_clipped = got[0][..., :H].numpy()
    # sum of the clipped in-gate cotangent times c_prev: what a clip before
    # the peephole routes would give for dw_ci
    wrong = (di_clipped * cells_prev).sum((0, 1))
    assert np.abs(got[3].numpy() - wrong).max() > 1e-3 * np.abs(wrong).max()


def _grads_port(params, x, mask, g, backwards, clip=5.0):
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx = _t(x).requires_grad_(True)
    out = tlstm.lstm_forward(tp, tx, _t(mask), backwards=backwards, grad_clipping=clip)
    out.backward(_t(g))
    return out.detach().numpy(), {**{k: tp[k].grad.numpy() for k in KEYS},
                                  "x": tx.grad.numpy()}


def _grads_jax(params, x, mask, g, backwards, use_custom_vjp):
    def f(p, xx):
        out = jlstm.lstm_forward(p, xx, jnp.asarray(mask), backwards=backwards,
                                 use_custom_vjp=use_custom_vjp)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out), {**{k: np.asarray(gp[k]) for k in KEYS}, "x": np.asarray(gx)}


@pytest.mark.parametrize("use_custom_vjp", [True, False])
@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("scale", [1.0, 100.0])
def test_peep_lstm_forward_grads_match_jax(use_custom_vjp, backwards, scale):
    params, x, mask, g = _case(3, B=5, T=6, D=5, H=6)
    out, got = _grads_port(params, x, mask, g * scale, backwards)
    ref_out, ref = _grads_jax(params, x, mask, g * scale, backwards, use_custom_vjp)
    np.testing.assert_allclose(out, ref_out, **FWD_TOL)
    for k, r in ref.items():
        _close_rel(got[k], r, k)
    for k in PEEP:
        assert np.abs(got[k]).max() > 0, k


@pytest.mark.parametrize("backwards", [False, True])
def test_peep_unclipped_grads_equal_autograd_of_plain_loop(backwards):
    """clip 0: the Function's gradients equal plain autograd through the
    step-by-step peephole recurrence (an oracle independent of both backward
    chains), peephole vectors included."""
    params, x, mask, g = _case(7)
    out, got = _grads_port(params, x, mask, g * 100, backwards, clip=0.0)
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    tx = _t(x).requires_grad_(True)
    x_, m_ = (torch.flip(tx, (1,)), torch.flip(_t(mask), (1,))) if backwards else (tx, _t(mask))
    B, T, _ = x.shape
    H = params["w_hid"].shape[0]
    x_proj = (x_.reshape(B * T, -1) @ tp["w_in"]).reshape(B, T, 4 * H) + tp["b"]
    ref_out = klstm.lstm_peep_recurrence_plain(
        x_proj, tp["w_hid"], m_, tp["cell_init"].expand(B, H), tp["hid_init"].expand(B, H),
        *(tp[k] for k in PEEP))
    if backwards:
        ref_out = torch.flip(ref_out, (1,))
    ref_out.backward(_t(g * 100))
    np.testing.assert_allclose(out, ref_out.detach().numpy(), **FWD_TOL)
    for k in KEYS:
        _close_rel(got[k], tp[k].grad.numpy(), k)
    _close_rel(got["x"], tx.grad.numpy(), "x")


def test_peep_no_grad_takes_the_inference_recurrence(monkeypatch):
    params, x, mask, _ = _case(8)
    calls = []
    monkeypatch.setattr(tlstm, "lstm_peep_recurrence_train",
                        lambda *a: calls.append(1) or klstm.lstm_peep_recurrence_train_plain(*a))
    tp = {k: _t(v) for k, v in params.items()}
    plain = tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert not calls
    tp["w_cell_to_outgate"].requires_grad_(True)  # a peephole vector alone
    with torch.no_grad():
        tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert not calls
    trained = tlstm.lstm_forward(tp, _t(x), _t(mask))
    assert calls == [1] and trained.requires_grad
    torch.testing.assert_close(trained.detach(), plain, rtol=0, atol=0)


def test_peep_wrappers_route_cpu_tensors_to_plain_versions():
    chain, peep, _ = _chain_inputs(9, 1.0, H=5)
    _, gates, cells, _, ms, w_hid = chain
    counters = (klstm.lstm_peep_recurrence, klstm.lstm_peep_recurrence_train,
                klstm.lstm_peep_bwd_chain)
    before = [c.launches for c in counters]
    B, T, H = cells.shape
    x_proj = torch.randn(B, T, 4 * H, generator=torch.Generator().manual_seed(0))
    fwd = (x_proj, _t(w_hid), _t(ms), torch.zeros(B, H), torch.zeros(B, H), *map(_t, peep))
    torch.testing.assert_close(klstm.lstm_peep_recurrence(*fwd),
                               klstm.lstm_peep_recurrence_plain(*fwd), rtol=0, atol=0)
    for a, b in zip(klstm.lstm_peep_recurrence_train(*fwd),
                    klstm.lstm_peep_recurrence_train_plain(*fwd)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    bwd = (*map(_t, chain), *map(_t, peep))
    for a, b in zip(klstm.lstm_peep_bwd_chain(*bwd, 5.0),
                    klstm.lstm_peep_bwd_chain_plain(*bwd, 5.0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="clip"):
        klstm.lstm_peep_bwd_chain(*bwd, -1.0)
    assert [c.launches for c in counters] == before


def test_init_lstm_params_peepholes_follow_the_gate_blocks():
    """The three vectors are normal(0.1) draws taken after the eight gate
    blocks; the rest of the layer is what the init without peepholes
    draws."""
    got = tlstm.init_lstm_params(torch.Generator().manual_seed(4), 30, 400,
                                 use_peepholes=True)
    plain = tlstm.init_lstm_params(torch.Generator().manual_seed(4), 30, 400)
    for k in plain:
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=0)
    gen = torch.Generator().manual_seed(4)
    tlstm.init_lstm_params(gen, 30, 400)
    for k in PEEP:
        torch.testing.assert_close(got[k], tinits.normal(0.1)(gen, (400,)), rtol=0, atol=0)
    allp = torch.cat([got[k] for k in PEEP])
    assert abs(allp.std().item() - 0.1) < 0.01 and abs(allp.mean().item()) < 0.01
    fwd, bwd = tlstm.init_blstm_params(torch.Generator().manual_seed(5), 3, 4,
                                       use_peepholes=True)
    ref = jlstm.init_blstm_params(jax.random.PRNGKey(0), 3, 4, use_peepholes=True)
    for t_half, j_half in ((fwd, ref[0]), (bwd, ref[1])):
        assert {k: tuple(v.shape) for k, v in t_half.items()} == {
            k: tuple(v.shape) for k, v in j_half.items()}
    assert not torch.equal(fwd["w_cell_to_ingate"], bwd["w_cell_to_ingate"])
