"""The port's bucketed and pipelined servers (ip_avsr_torch.serve.
make_bucketed_server, PipelinedServer) against the JAX package's, on the CPU.

The cases of tests/test_pipeline_serve.py that drive these two servers (and
the masked vote they rely on), each run through both packages on the same
parameters (carried across by bridge.params_from_jax) and the same requests:
scores within 1e-5 (float32; the JAX servers are one XLA program, the port
runs eager), shapes equal, results in submission order, including the
shape-change flush and the ``vote=False`` (B, T, C) blocks.  The delta-free
lstm_classifier_majority_vote keeps padding invariance exact, as in the JAX
tests (the delta FIR has no mask in either package); the bucketed server is
also driven on a delta model, against the JAX bucketed server.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from ip_avsr_tpu import serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_torch import bridge, serve as tserve
from ip_avsr_torch.models import zoo as tzoo

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _model(D=6, H=4, C=3, seed=0, build="lstm_classifier_majority_vote", **kw):
    """(JAX params, port params, JAX config, port config)."""
    jcfg, tcfg = (getattr(z, build)(D, lstm_size=H, output_classes=C, **kw)
                  for z in (jzoo, tzoo))
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp, jcfg, tcfg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_bucketed_server_static_shapes_and_chunking():
    """Odd B and T round up to their buckets, a different bucketing of the
    same request gives the same scores, and a request past the largest
    batch bucket is served in chunks of it."""
    jp, tp, jcfg, tcfg = _model()
    kw = dict(batch_buckets=(2, 4), time_buckets=(5, 8))
    jsrv = jserve.make_bucketed_server(jp, jcfg, **kw)
    tsrv = tserve.make_bucketed_server(tp, tcfg, device="cpu", **kw)
    probs_fn = tserve.make_server(tp, tcfg, vote=False, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(3, 6, 6).astype(np.float32)
    lengths = np.array([6, 4, 2])
    got = _np(tsrv([x], lengths))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, _np(jsrv([x], lengths)), **TOL)
    mask = torch.from_numpy((np.arange(6)[None] < lengths[:, None]).astype(np.float32))
    from ip_avsr_torch.ops.voting import majority_voting_layer_masked
    want = majority_voting_layer_masked(probs_fn([torch.from_numpy(x)], mask), mask, 3)
    np.testing.assert_allclose(got, want.numpy(), **TOL)

    other = tserve.make_bucketed_server(tp, tcfg, batch_buckets=(8,), time_buckets=(11,),
                                        device="cpu")
    np.testing.assert_allclose(got, _np(other([x], lengths)), **TOL)

    x9 = rng.randn(9, 5, 6).astype(np.float32)
    lengths9 = rng.randint(1, 6, 9)
    got9 = _np(tsrv([x9], lengths9))
    assert got9.shape == (9, 3)
    np.testing.assert_allclose(got9, _np(jsrv([x9], lengths9)), **TOL)


def test_bucketed_server_rejects_overlong_requests():
    jp, tp, jcfg, tcfg = _model()
    tsrv = tserve.make_bucketed_server(tp, tcfg, batch_buckets=(4,), time_buckets=(5,),
                                       device="cpu")
    x = np.random.RandomState(1).randn(2, 9, 6).astype(np.float32)
    with pytest.raises(ValueError, match="time bucket"):
        tsrv([x], np.array([9, 7]))
    kw = dict(batch_buckets=(4,), time_buckets=(5,), allow_time_truncation=True)
    lossy = _np(tserve.make_bucketed_server(tp, tcfg, device="cpu", **kw)([x], np.array([9, 7])))
    assert lossy.shape == (2, 3)
    np.testing.assert_allclose(lossy, _np(tsrv([x[:, :5]], np.array([5, 5]))), **TOL)
    jlossy = jserve.make_bucketed_server(jp, jcfg, **kw)([x], np.array([9, 7]))
    np.testing.assert_allclose(lossy, _np(jlossy), **TOL)


def test_bucketed_server_novote_slices_time_padding():
    jp, tp, jcfg, tcfg = _model()
    kw = dict(batch_buckets=(4,), time_buckets=(8,), vote=False)
    x = np.random.RandomState(0).randn(2, 5, 6).astype(np.float32)
    lengths = np.array([5, 3])
    got = _np(tserve.make_bucketed_server(tp, tcfg, device="cpu", **kw)([x], lengths))
    assert got.shape == (2, 5, 3)
    np.testing.assert_allclose(got, _np(jserve.make_bucketed_server(jp, jcfg, **kw)(
        [x], lengths)), **TOL)
    mask = (np.arange(5)[None] < lengths[:, None]).astype(np.float32)
    plain = tserve.make_server(tp, tcfg, vote=False, device="cpu")([x], mask)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_bucketed_server_serve_fn_and_classes():
    """A caller's per-step serve_fn is voted by the wrapper (masked), and
    vote=True without a config needs output_classes."""
    _, tp, _, tcfg = _model()
    fn = tserve.make_server(tp, tcfg, vote=False, device="cpu")
    with pytest.raises(ValueError, match="output_classes"):
        tserve.make_bucketed_server(serve_fn=fn, device="cpu")
    wrapped = tserve.make_bucketed_server(serve_fn=fn, output_classes=3, batch_buckets=(4,),
                                          time_buckets=(8,), device="cpu")
    live = tserve.make_bucketed_server(tp, tcfg, batch_buckets=(4,), time_buckets=(8,),
                                       device="cpu")
    x = np.random.RandomState(2).randn(3, 7, 6).astype(np.float32)
    lengths = np.array([7, 2, 5])
    np.testing.assert_allclose(_np(wrapped([x], lengths)), _np(live([x], lengths)), **TOL)


def test_bucketed_server_delta_model_matches_jax():
    """A two-stream delta model with peepholes: the bucket's zero time
    padding reaches the delta features of the last 2W valid frames in both
    packages alike."""
    kw = dict(encoder_shapes=[10, 6], encoder_nonlinearities=["sigmoid", "linear"],
              lstm_size=6, window=3, output_classes=4, use_peepholes=True)
    jcfg, tcfg = (z.adenet_v2(12, 8, **kw) for z in (jzoo, tzoo))
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(4), jcfg)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(4)
    xs = [rng.randn(3, 7, 12).astype(np.float32), rng.randn(3, 7, 8).astype(np.float32)]
    lengths = np.array([7, 5, 2])
    for vote in (True, False):
        skw = dict(batch_buckets=(2, 4), time_buckets=(8, 16), vote=vote)
        got = _np(tserve.make_bucketed_server(tp, tcfg, device="cpu", **skw)(xs, lengths))
        ref = _np(jserve.make_bucketed_server(jp, jcfg, **skw)(xs, lengths))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)


def test_server_vote_ignores_padding():
    """The masked vote: a padded request scores as the exact-length one."""
    jp, tp, jcfg, tcfg = _model()
    server = tserve.make_server(tp, tcfg, device="cpu")
    x = np.random.RandomState(0).randn(1, 5, 6).astype(np.float32)
    exact = server([x], np.ones((1, 5), np.float32)).numpy()
    mask = np.zeros((1, 25), np.float32)
    mask[0, :5] = 1.0
    padded = server([np.pad(x, ((0, 0), (0, 20), (0, 0)))], mask).numpy()
    np.testing.assert_allclose(padded, exact, **TOL)
    np.testing.assert_allclose(padded, _np(jserve.make_server(jp, jcfg)(
        [np.pad(x, ((0, 0), (0, 20), (0, 0)))], mask)), **TOL)


def _requests(seed, shapes, D=6, pad_tail=True):
    rng = np.random.RandomState(seed)
    reqs = []
    for i, (rows, T) in enumerate(shapes):
        x = rng.randn(rows, T, D).astype(np.float32)
        m = np.ones((rows, T), np.float32)
        if pad_tail:
            m[:, T - 2 + (i % 2):] = 0.0
        reqs.append(([x], m))
    return reqs


def _hold_in_order(got, want):
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("depth", [1, 3, 16])
def test_pipelined_server_matches_jax_and_sync_in_order(depth):
    jp, tp, jcfg, tcfg = _model(D=10, H=8, C=4)
    reqs = _requests(0, [(1, 6)] * 7, D=10)
    sync = tserve.make_server(tp, tcfg, device="cpu")
    want = [sync(*r).numpy() for r in reqs]
    got = list(tserve.PipelinedServer(tp, tcfg, depth=depth, device="cpu").map(iter(reqs)))
    _hold_in_order(got, want)
    ref = list(jserve.PipelinedServer(jp, jcfg, depth=depth).map(iter(reqs)))
    _hold_in_order(got, [np.asarray(r) for r in ref])


def test_pipelined_server_flushes_on_shape_change():
    """vote=False results are (B, T, C): a change of T flushes the block."""
    jp, tp, jcfg, tcfg = _model(H=6)
    fn = tserve.make_server(tp, tcfg, vote=False, device="cpu")
    reqs = _requests(0, [(1, T) for T in (7, 7, 9, 7, 9, 9, 5)], pad_tail=False)
    got = list(tserve.PipelinedServer(serve_fn=fn, depth=3, device="cpu").map(iter(reqs)))
    _hold_in_order(got, [fn(*r).numpy() for r in reqs])
    jfn = jserve.make_server(jp, jcfg, vote=False)
    ref = list(jserve.PipelinedServer(serve_fn=jfn, depth=3).map(iter(reqs)))
    _hold_in_order(got, [np.asarray(r) for r in ref])


@pytest.mark.parametrize("batch,depth", [(2, 3), (4, 1), (8, 16), (16, 2)])
def test_pipelined_server_microbatch_matches_per_request(batch, depth):
    jp, tp, jcfg, tcfg = _model(D=10, H=8, C=4)
    reqs = _requests(1, [(2 if i in (3, 4) else 1, 6) for i in range(11)], D=10)
    sync = tserve.make_server(tp, tcfg, device="cpu")
    got = list(tserve.PipelinedServer(tp, tcfg, depth=depth, batch=batch,
                                      device="cpu").map(iter(reqs)))
    _hold_in_order(got, [sync(*r).numpy() for r in reqs])
    ref = list(jserve.PipelinedServer(jp, jcfg, depth=depth, batch=batch).map(iter(reqs)))
    _hold_in_order(got, [np.asarray(r) for r in ref])


def test_pipelined_server_microbatch_mixed_shapes():
    jp, tp, jcfg, tcfg = _model(H=6)
    fn = tserve.make_server(tp, tcfg, vote=False, device="cpu")
    reqs = _requests(2, [(1, T) for T in (7, 7, 9, 7, 9, 9, 5, 5, 5, 5)])
    got = list(tserve.PipelinedServer(serve_fn=fn, depth=2, batch=3,
                                      device="cpu").map(iter(reqs)))
    _hold_in_order(got, [fn(*r).numpy() for r in reqs])
    jfn = jserve.make_server(jp, jcfg, vote=False)
    ref = list(jserve.PipelinedServer(serve_fn=jfn, depth=2, batch=3).map(iter(reqs)))
    _hold_in_order(got, [np.asarray(r) for r in ref])


def test_pipelined_submit_and_result():
    """submit/result serve one request on its own; on the CPU nothing is
    pinned."""
    _, tp, _, tcfg = _model()
    pipe = tserve.PipelinedServer(tp, tcfg, device="cpu")
    (x,), m = _requests(3, [(2, 6)])[0]
    handle = pipe.submit([x], m)
    assert handle[1] == []
    np.testing.assert_array_equal(pipe.result(handle),
                                  tserve.make_server(tp, tcfg, device="cpu")([x], m).numpy())


def test_pipelined_server_property_random_streams():
    """Hypothesis over request sequences (row counts, T, vote on or off) and
    (depth, batch): equal to per-request serving and to the JAX pipelined
    server, in order."""
    from hypothesis import given, settings, strategies as st

    jp, tp, jcfg, tcfg = _model(H=6)
    servers = {v: tserve.make_server(tp, tcfg, vote=v, device="cpu") for v in (True, False)}
    jservers = {v: jserve.make_server(jp, jcfg, vote=v) for v in (True, False)}

    @settings(max_examples=12, deadline=None, derandomize=True)
    @given(spec=st.lists(st.tuples(st.integers(1, 3), st.sampled_from([5, 8])),
                         min_size=1, max_size=12),
           depth=st.integers(1, 6), batch=st.integers(1, 6), vote=st.booleans())
    def run(spec, depth, batch, vote):
        rng = np.random.RandomState(len(spec) * 7 + depth)
        reqs = []
        for rows, T in spec:
            x = rng.randn(rows, T, 6).astype(np.float32)
            m = (np.arange(T)[None] < rng.randint(2, T + 1, (rows, 1))).astype(np.float32)
            reqs.append(([x], m))
        got = list(tserve.PipelinedServer(serve_fn=servers[vote], depth=depth, batch=batch,
                                          device="cpu").map(iter(reqs)))
        _hold_in_order(got, [servers[vote](*r).numpy() for r in reqs])
        ref = list(jserve.PipelinedServer(serve_fn=jservers[vote], depth=depth,
                                          batch=batch).map(iter(reqs)))
        _hold_in_order(got, [np.asarray(r) for r in ref])

    run()


def test_bucketed_server_property_random_sizes():
    """Hypothesis over bucket ladders and ragged request sizes: equal to the
    unbucketed server and to the JAX bucketed server, row for row."""
    from hypothesis import given, settings, strategies as st

    jp, tp, jcfg, tcfg = _model(H=6)
    plain = tserve.make_server(tp, tcfg, device="cpu")

    @settings(max_examples=10, deadline=None, derandomize=True)
    @given(bbs=st.lists(st.integers(1, 6), min_size=1, max_size=3),
           tbs=st.lists(st.integers(6, 12), min_size=1, max_size=2),
           B=st.integers(1, 9), T=st.integers(2, 12), seed=st.integers(0, 99))
    def run(bbs, tbs, B, T, seed):
        T = min(T, max(tbs))
        rng = np.random.RandomState(seed)
        x = rng.randn(B, T, 6).astype(np.float32)
        lens = rng.randint(1, T + 1, B)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        got = _np(tserve.make_bucketed_server(tp, tcfg, batch_buckets=bbs, time_buckets=tbs,
                                              device="cpu")([x], lens))
        np.testing.assert_allclose(got, plain([x], mask).numpy(), **TOL)
        ref = jserve.make_bucketed_server(jp, jcfg, batch_buckets=bbs, time_buckets=tbs)(
            [x], lens)
        np.testing.assert_allclose(got, _np(ref), **TOL)

    run()


def test_make_server_mesh_still_raises():
    """``make_server(mesh=)`` on the one-process mesh: the server keeps its
    mesh and its scores equal the plain server's and JAX's (the multi-rank
    split is tests/test_torch_scale_multihost.py's)."""
    from ip_avsr_torch.parallel import mesh as tmesh

    jp, tp, jcfg, tcfg = _model()
    mesh = tmesh.make_mesh()
    serve = tserve.make_server(tp, tcfg, mesh=mesh, device="cpu")
    assert serve._mesh is mesh and dataclasses.is_dataclass(tcfg)
    rng = np.random.RandomState(5)
    x = rng.randn(3, 7, 6).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([7, 3, 1])[:, None]).astype(np.float32)
    got = _np(serve([x], mask))
    np.testing.assert_array_equal(got, _np(tserve.make_server(tp, tcfg, device="cpu")([x], mask)))
    np.testing.assert_allclose(got, _np(jserve.make_server(jp, jcfg)([x], mask)), **TOL)
