"""The grouped LSTM forward (``ops/lstm.lstm_forward_grouped``,
``can_group_lstms``) and ``fuse_scans`` in ``models/adenet.head_forward``
against the JAX package.

JAX runs a group as one scan over stacked weights; the port runs its
members one after another (on the card one launch of the same row each),
which JAX calls numerically identical to separate recurrences.  Held here:
values within 1e-5 and gradients within 1e-5 of each gradient's max abs
of JAX's grouped call, with and without peepholes, with backward members
and members of different input widths; a ``fuse_scans`` forward of the
tiny flagship within 2e-5 of JAX's (and equal to the port's unfused one);
the warning when training with the residual levers.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_torch import bridge
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.ops import lstm as tlstm

torch.set_num_threads(1)
TOL = 1e-5
PEEP = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")


def _params(rng, D, H, peep):
    p = {"w_in": rng.randn(D, 4 * H) * 0.5, "w_hid": rng.randn(H, 4 * H) * 0.5,
         "b": rng.randn(4 * H) * 0.1, "cell_init": rng.randn(1, H),
         "hid_init": rng.randn(1, H) * 0.5}
    if peep:
        p.update({k: rng.randn(H) * 0.3 for k in PEEP})
    return {k: v.astype(np.float32) for k, v in p.items()}


def _group(seed, dims, peep, B=4, T=8, H=5):
    rng = np.random.RandomState(seed)
    plist = [_params(rng, D, H, peep) for D in dims]
    xs = [rng.randn(B, T, D).astype(np.float32) for D in dims]
    lens = np.array([T, 5, 1, 0][:B])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    gs = [rng.randn(B, T, H).astype(np.float32) for _ in dims]
    return plist, xs, mask, gs


@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
@pytest.mark.parametrize("dims,flags", [((7, 7), (False, True)), ((7, 4, 9), (False, False, True))],
                         ids=["blstm_halves", "streams_of_differing_width"])
def test_grouped_forward_and_grads_match_jax(peep, dims, flags):
    plist, xs, mask, gs = _group(1, dims, peep)
    tp = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()} for p in plist]
    tx = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    outs = tlstm.lstm_forward_grouped(tp, tx, torch.from_numpy(mask), list(flags))
    sum(torch.sum(o * torch.from_numpy(g)) for o, g in zip(outs, gs)).backward()

    def f(ps, xx):
        o = jlstm.lstm_forward_grouped(ps, xx, jnp.asarray(mask), list(flags))
        return sum(jnp.sum(a * jnp.asarray(g)) for a, g in zip(o, gs)), o

    (_, ref_outs), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in plist],
        [jnp.asarray(x) for x in xs])
    for i, (o, r) in enumerate(zip(outs, ref_outs)):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r), rtol=TOL, atol=TOL,
                                   err_msg=f"member {i}")
        # each member is its own recurrence: the separate call's values
        sep = tlstm.lstm_forward({k: v.detach() for k, v in tp[i].items()}, tx[i].detach(),
                                 torch.from_numpy(mask), flags[i])
        assert torch.equal(o.detach(), sep)
    for i in range(len(plist)):
        for k, r in gp[i].items():
            r = np.asarray(r)
            np.testing.assert_allclose(tp[i][k].grad.numpy(), r, rtol=0,
                                       atol=TOL * max(np.abs(r).max(), 1e-3),
                                       err_msg=f"member {i} {k}")
        r = np.asarray(gx[i])
        np.testing.assert_allclose(tx[i].grad.numpy(), r, rtol=0,
                                   atol=TOL * np.abs(r).max(), err_msg=f"member {i} x")


def test_can_group_lstms_matches_jax():
    rng = np.random.RandomState(2)
    a, b = _params(rng, 3, 4, False), _params(rng, 6, 4, False)
    c, d = _params(rng, 3, 5, False), _params(rng, 3, 4, True)
    for plist in ([a], [a, b], [a, c], [a, d], [d, _params(rng, 2, 4, True)], [a, b, c]):
        assert tlstm.can_group_lstms(plist) == jlstm.can_group_lstms(plist)
    assert tlstm.can_group_lstms([a, b]) and not tlstm.can_group_lstms([a, d])
    with pytest.raises(ValueError, match="hidden sizes"):
        tlstm.lstm_forward_grouped([{k: torch.from_numpy(v) for k, v in p.items()}
                                    for p in (a, c)],
                                   [torch.zeros(2, 3, 3)] * 2, None, [False, False])


def _tiny_flagship(zoo, **kw):
    enc = (("sigmoid", "sigmoid", "linear"), (12, 8, 6))
    cfg = zoo.adenet_v3(20, 8, 20, lstm_size=4, window=3, output_classes=5)
    return dataclasses.replace(cfg, agg_dropout=0.0, streams=[
        dataclasses.replace(s, dropout=0.0, **({"encoder_shapes": enc[1],
                                                "encoder_nonlinearities": enc[0]}
                                               if s.encoder_shapes else {}))
        for s in cfg.streams], **kw)


def test_fuse_scans_forward_matches_jax_and_unfused():
    jcfg, tcfg = (_tiny_flagship(m, fuse_scans=True) for m in (jzoo, tzoo))
    jparams = jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(3)
    xs = [rng.randn(3, 7, s.input_dim).astype(np.float32) for s in jcfg.streams]
    mask = (np.arange(7)[None] < np.array([7, 4, 1])[:, None]).astype(np.float32)
    ref = jax.jit(lambda p, x, m: jadenet.adenet_forward(p, jcfg, x, m))(
        jparams, [jnp.asarray(x) for x in xs], jnp.asarray(mask))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                     device="cpu")
    txs = [torch.from_numpy(x) for x in xs]
    got = tadenet.adenet_forward(tparams, tcfg, txs, torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-5)
    unfused = tadenet.adenet_forward(tparams, dataclasses.replace(tcfg, fuse_scans=False),
                                     txs, torch.from_numpy(mask))
    assert torch.equal(got, unfused)


@pytest.mark.parametrize("lever", [dict(lstm_remat=True),
                                   dict(lstm_residual_dtype="bfloat16")],
                         ids=["remat", "residual_dtype"])
def test_fuse_scans_yields_to_the_levers_under_training(lever):
    cfg = _tiny_flagship(tzoo, fuse_scans=True, **lever)
    params = tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    xs = [torch.randn(2, 5, s.input_dim) for s in cfg.streams]
    mask = torch.ones(2, 5)
    with pytest.warns(UserWarning, match="fuse_scans is ignored under training"):
        tadenet.adenet_forward(params, cfg, xs, mask, train=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tadenet.adenet_forward(params, cfg, xs, mask)  # inference: grouped, no warning
    calls = []
    grouped = tlstm.lstm_forward_grouped
    try:
        tlstm.lstm_forward_grouped = lambda *a, **k: calls.append(1) or grouped(*a, **k)
        tadenet.adenet_forward(params, cfg, xs, mask)
        assert len(calls) == 2  # the three stream LSTMs, then the BLSTM halves
    finally:
        tlstm.lstm_forward_grouped = grouped
