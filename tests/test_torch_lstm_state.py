"""The LSTM state carry of the port: ``lstm_forward(initial_state=...,
return_state=True)`` and the state versions of kernel-table rows 1 and 5
(``lstm_recurrence_state``, ``lstm_peep_recurrence_state``) against the JAX
package's ``lstm_forward`` with the same options (its plain scan,
ip_avsr_tpu/ops/lstm.py:109-290).

Held here on the CPU, from numpy-seeded inputs at B = 3, T = 7, D = 5:
the plain state versions and ``lstm_forward`` against JAX (hids, cell_T and
hid_T within 1e-5), one-shot against chunks of 1 + 2 + 4 frames, an all-pad
chunk handing its state back bit for bit, ``backwards=True`` refused, the
gradients with respect to the parameters, the input and the per-row initial
state against ``jax.grad`` (clip 5, upstream x1 and x100, within 1e-5 of
each gradient's max abs), and the final cell's row chunks through
``map_chunks`` driven with the plain versions, as the kernel's launches
slice it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_torch.ops import lstm as tlstm
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
B, T, D = 3, 7, 5
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")


def _case(seed, H, peep):
    """A layer (learned non-zero cell_init/hid_init, which the state
    replaces), input, ragged mask (lengths T, 4 and 1), a per-row state and
    upstream gradients for out, cell_T and hid_T."""
    rng = np.random.RandomState(seed)
    params = {
        "w_in": rng.randn(D, 4 * H).astype(np.float32) * 0.5,
        "w_hid": rng.randn(H, 4 * H).astype(np.float32) * 0.5,
        "b": rng.randn(4 * H).astype(np.float32) * 0.1,
        "cell_init": rng.randn(1, H).astype(np.float32),
        "hid_init": rng.randn(1, H).astype(np.float32) * 0.5,
    }
    if peep:
        params.update({k: rng.randn(H).astype(np.float32) * 0.5 for k in PEEP})
    x = rng.randn(B, T, D).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 4, 1])[:, None]).astype(np.float32)
    state = (rng.randn(B, H).astype(np.float32), (rng.randn(B, H) * 0.5).astype(np.float32))
    grads = (rng.randn(B, T, H).astype(np.float32), rng.randn(B, H).astype(np.float32),
             rng.randn(B, H).astype(np.float32))
    return params, x, mask, state, grads


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _jax_state(params, x, mask, state):
    out, (c, h) = jlstm.lstm_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                     jnp.asarray(x), jnp.asarray(mask),
                                     initial_state=tuple(map(jnp.asarray, state)),
                                     return_state=True)
    return np.asarray(out), np.asarray(c), np.asarray(h)


@pytest.mark.parametrize("H", [4, 6])
@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_state_plain_versions_match_jax(peep, H):
    params, x, mask, state, _ = _case(0, H, peep)
    x_proj = _t(x).reshape(B * T, D) @ _t(params["w_in"]) + _t(params["b"])
    args = (x_proj.reshape(B, T, 4 * H), _t(params["w_hid"]), _t(mask), *map(_t, state))
    if peep:
        hids, cell_T = klstm.lstm_peep_recurrence_state_plain(
            *args, *(_t(params[k]) for k in PEEP))
    else:
        hids, cell_T = klstm.lstm_recurrence_state_plain(*args)
    ref_out, ref_c, ref_h = _jax_state(params, x, mask, state)
    np.testing.assert_allclose(hids.numpy(), ref_out, **TOL)
    np.testing.assert_allclose(cell_T.numpy(), ref_c, **TOL)
    np.testing.assert_allclose(hids[:, -1].numpy(), ref_h, **TOL)


@pytest.mark.parametrize("H", [4, 6])
@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_lstm_forward_state_matches_jax(peep, H):
    params, x, mask, state, _ = _case(1, H, peep)
    tp = {k: _t(v) for k, v in params.items()}
    out, (cell_T, hid_T) = tlstm.lstm_forward(tp, _t(x), _t(mask),
                                              initial_state=tuple(map(_t, state)),
                                              return_state=True)
    ref_out, ref_c, ref_h = _jax_state(params, x, mask, state)
    np.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    np.testing.assert_allclose(cell_T.numpy(), ref_c, **TOL)
    np.testing.assert_allclose(hid_T.numpy(), ref_h, **TOL)
    assert hid_T.is_contiguous() and cell_T.shape == (B, H)
    # without initial_state the learned cell_init/hid_init start the carry,
    # and without return_state the call returns out alone
    plain = tlstm.lstm_forward(tp, _t(x), _t(mask))
    first, _ = tlstm.lstm_forward(tp, _t(x), _t(mask), return_state=True)
    assert torch.equal(plain, first)
    ref_plain = jlstm.lstm_forward(jax.tree_util.tree_map(jnp.asarray, params),
                                   jnp.asarray(x), jnp.asarray(mask), return_state=True)[0]
    np.testing.assert_allclose(first.numpy(), np.asarray(ref_plain), **TOL)


@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_one_shot_equals_chunks(peep):
    """Chunks of 1 + 2 + 4 frames, each resumed from the last one's state,
    give the one-shot hids and final state."""
    params, x, mask, state, _ = _case(2, 6, peep)
    tp = {k: _t(v) for k, v in params.items()}
    whole, (c_ref, h_ref) = tlstm.lstm_forward(tp, _t(x), _t(mask),
                                               initial_state=tuple(map(_t, state)),
                                               return_state=True)
    st, outs, s = tuple(map(_t, state)), [], 0
    for n in (1, 2, 4):
        out, st = tlstm.lstm_forward(tp, _t(x[:, s:s + n]), _t(mask[:, s:s + n]),
                                     initial_state=st, return_state=True)
        outs.append(out)
        s += n
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st[0].numpy(), c_ref.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(st[1].numpy(), h_ref.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_all_pad_chunk_returns_its_state_bit_for_bit(peep):
    params, x, _, state, _ = _case(3, 6, peep)
    tp = {k: _t(v) for k, v in params.items()}
    st = tuple(map(_t, state))
    for n in (1, 4):
        out, (c, h) = tlstm.lstm_forward(tp, _t(x[:, :n]), torch.zeros(B, n),
                                         initial_state=st, return_state=True)
        assert torch.equal(c, st[0]) and torch.equal(h, st[1])
        assert torch.equal(out, st[1][:, None].expand(B, n, -1))


@pytest.mark.parametrize("option", ["initial_state", "return_state"])
def test_backwards_with_state_raises(option):
    params, x, mask, state, _ = _case(4, 4, False)
    tp = {k: _t(v) for k, v in params.items()}
    kw = ({"initial_state": tuple(map(_t, state))} if option == "initial_state"
          else {"return_state": True})
    with pytest.raises(ValueError, match="forward recurrence"):
        tlstm.lstm_forward(tp, _t(x), _t(mask), backwards=True, **kw)
    with pytest.raises(ValueError, match="initial_state must be"):
        tlstm.lstm_forward(tp, _t(x), _t(mask), initial_state=(_t(state[0][:2]),
                                                               _t(state[1][:2])))


def _grads_port(params, x, mask, state, grads, use_cell):
    keys = [k for k in params if k not in ("cell_init", "hid_init")]
    tp = {k: _t(v).requires_grad_(k in keys) for k, v in params.items()}
    tx = _t(x).requires_grad_(True)
    ts = tuple(_t(s).requires_grad_(True) for s in state)
    out, (c, h) = tlstm.lstm_forward(tp, tx, _t(mask), initial_state=ts, return_state=True)
    loss = (out * _t(grads[0])).sum() + (h * _t(grads[2])).sum()
    if use_cell:
        loss = loss + (c * _t(grads[1])).sum()
    loss.backward()
    assert tp["cell_init"].grad is None and tp["hid_init"].grad is None
    return {**{k: tp[k].grad.numpy() for k in keys}, "x": tx.grad.numpy(),
            "cell0": ts[0].grad.numpy(), "hid0": ts[1].grad.numpy()}


def _grads_jax(params, x, mask, state, grads, use_cell):
    keys = [k for k in params if k not in ("cell_init", "hid_init")]
    fixed = {k: jnp.asarray(params[k]) for k in ("cell_init", "hid_init")}

    def f(p, xx, c0, h0):
        out, (c, h) = jlstm.lstm_forward({**p, **fixed}, xx, jnp.asarray(mask),
                                         grad_clipping=5.0, initial_state=(c0, h0),
                                         return_state=True)
        loss = jnp.sum(out * grads[0]) + jnp.sum(h * grads[2])
        return loss + jnp.sum(c * grads[1]) if use_cell else loss

    gp, gx, gc, gh = jax.grad(f, argnums=(0, 1, 2, 3))(
        {k: jnp.asarray(params[k]) for k in keys}, jnp.asarray(x),
        *(jnp.asarray(s) for s in state))
    return {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx),
            "cell0": np.asarray(gc), "hid0": np.asarray(gh)}


@pytest.mark.parametrize("use_cell", [True, False], ids=["cell_T_used", "cell_T_unused"])
@pytest.mark.parametrize("scale", [1.0, 100.0])
@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_state_grads_match_jax(peep, scale, use_cell):
    """Clip 5; x100 upstream makes the clip bite.  The initial state's
    gradients are the chain's per row, not summed."""
    params, x, mask, state, grads = _case(5, 6, peep)
    grads = tuple(g * scale for g in grads)
    got = _grads_port(params, x, mask, state, grads, use_cell)
    ref = _grads_jax(params, x, mask, state, grads, use_cell)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                   atol=1e-5 * max(np.abs(ref[k]).max(), 1e-30), err_msg=k)
    assert np.abs(ref["cell0"][0] - ref["cell0"][1]).max() > 0  # rows differ


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("peep", [False, True], ids=["row1", "row5"])
def test_state_chunks_slice_cell_last(peep, chunks):
    """The split drives the plain state versions chunk by chunk, each
    writing its rows of hids and of the final cell, as the kernel's
    launches do: the pieces reassemble to the unsplit call, bit-equal."""
    Bc, Tc, H = 19, 7, 32
    rng = np.random.RandomState(6)
    x_proj = _t(rng.randn(Bc, Tc, 4 * H))
    w_hid = _t(rng.randn(H, 4 * H) * 0.5)
    lens = rng.randint(1, Tc + 1, Bc)
    lens[0], lens[4], lens[7] = Tc, 0, 1
    mask = _t(np.arange(Tc)[None, :] < lens[:, None])
    cell0, hid0 = _t(rng.randn(Bc, H)), _t(rng.randn(Bc, H) * 0.5)
    vecs = [_t(rng.randn(H) * 0.5) for _ in range(3 * peep)]
    plain = (klstm.lstm_peep_recurrence_state_plain if peep
             else klstm.lstm_recurrence_state_plain)
    whole = plain(x_proj, w_hid, mask, cell0, hid0, *vecs)
    outs = [torch.full_like(w, float("nan")) for w in whole]

    def launch(x_c, mask_c, cell0_c, hid0_c, *outs_c):
        for o, g in zip(outs_c, plain(x_c, w_hid, mask_c, cell0_c, hid0_c, *vecs)):
            o.copy_(g)

    klstm.map_chunks(launch, chunks, x_proj, mask, cell0, hid0, *outs)
    for o, w in zip(outs, whole):
        assert torch.equal(o, w)
    assert torch.equal(outs[1][4], cell0[4])  # the all-pad row keeps its cell


def test_state_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the state wrappers run their plain versions and count
    no launch of rows 1 and 5."""
    params, x, mask, state, _ = _case(7, 4, True)
    before = (klstm.lstm_recurrence.launches, klstm.lstm_peep_recurrence.launches)
    x_proj = (_t(x).reshape(B * T, D) @ _t(params["w_in"])).reshape(B, T, 16)
    args = (x_proj, _t(params["w_hid"]), _t(mask), *map(_t, state))
    for got, ref in ((klstm.lstm_recurrence_state(*args),
                      klstm.lstm_recurrence_state_plain(*args)),
                     (klstm.lstm_peep_recurrence_state(*args, *(_t(params[k]) for k in PEEP)),
                      klstm.lstm_peep_recurrence_state_plain(*args,
                                                             *(_t(params[k]) for k in PEEP)))):
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (klstm.lstm_recurrence.launches, klstm.lstm_peep_recurrence.launches) == before
