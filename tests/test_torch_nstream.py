"""The port's N-stream path against the JAX package: INI configs through
ip_avsr_torch.train.config, the peephole 4-stream adasum AdeNet served by
ip_avsr_torch.serve.make_server, and its training step.

The model is the one ``configs/oulu_4stream.ini`` selects (raw and diff
streams through sigmoid encoders, DCT and MFCC streams without, a W = 9 delta
on every stream, peephole stream LSTMs, adasum fusion, a peephole BLSTM
aggregator, a per-step softmax), at tiny widths and at the file's full
widths.  Parameters come from the JAX init, carried across by
``bridge.params_from_jax``.

Tolerances, float32: probabilities at 2e-5 absolute, as for the flagship;
the train step's loss at 1e-5 relative, each gradient at 1e-5 relative to its
largest entry with a 1e-8 absolute floor (the adasum coefficients' gradients
are of order 1e-5 and come out of a cancelling sum), and updated parameters
at 1e-6 absolute (Adam's first step moves each entry by about lr = 1e-4).
"""

import dataclasses
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu import export as jexport, serve as jserve
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.ops import losses as jlosses
from ip_avsr_tpu.train import config as jconfig, optimizers as jopt
from ip_avsr_torch import bridge, serve as tserve
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.train import config as tconfig, trainer as ttrainer
from tests.torch_trainer_lib import jax_fields

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OULU = os.path.join(ROOT, "configs", "oulu_4stream.ini")
STREAM_INIS = ["avletters_1stream.ini", "cuave_bimodal.ini", "oulu_4stream.ini",
               "synthetic_1stream.ini", "synthetic_3stream.ini"]
PROB_TOL = dict(atol=2e-5, rtol=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_stream_inis_are_the_generic_configs():
    """Every INI of the generic ([streamN]) schema in configs/ is covered."""
    generic = []
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "*.ini"))):
        with open(path) as f:
            if "[stream1]" in f.read():
                generic.append(os.path.basename(path))
    assert generic == STREAM_INIS


@pytest.mark.parametrize("name", STREAM_INIS)
def test_build_model_config_matches_jax(name):
    path = os.path.join(ROOT, "configs", name)
    jcp, tcp = jconfig.load_config(path), tconfig.load_config(path)
    for parse in ("parse_streams", "parse_classifier", "parse_training", "parse_lr_map"):
        ref, got = getattr(jconfig, parse)(jcp), getattr(tconfig, parse)(tcp)
        as_dict = lambda v: ([dataclasses.asdict(s) for s in v] if isinstance(v, list)  # noqa: E731
                             else dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
        assert as_dict(got) == as_dict(ref), parse
    ref = jconfig.build_model_config(jconfig.parse_streams(jcp), jconfig.parse_classifier(jcp))
    got = tconfig.build_model_config(tconfig.parse_streams(tcp), tconfig.parse_classifier(tcp))
    assert jax_fields(got) == jexport.config_to_dict(ref)
    assert got.fused_dim() == ref.fused_dim()
    tadenet.check_supported(got)


def test_config_helpers_match_jax():
    subjects = np.random.RandomState(0).randint(1, 21, 200)
    for a, b in zip(tconfig.synthetic_subject_split(subjects),
                    jconfig.synthetic_subject_split(subjects)):
        np.testing.assert_array_equal(a, b)
    for raw in (None, "", "auto", " 29, 10,10,20"):
        assert tconfig._parse_buckets(raw) == jconfig._parse_buckets(raw)
    with pytest.raises(FileNotFoundError):
        tconfig.load_config(os.path.join(ROOT, "configs", "missing.ini"))
    # the single-stream branches, peepholes and no-delta ablations included
    for use_encoder in (True, False):
        for use_delta in (True, False):
            stream = dict(name="stream1", input_dimensions=30, shape=[16, 6],
                          nonlinearities=["sigmoid", "linear"], use_encoder=use_encoder,
                          use_delta=use_delta)
            clf = dict(use_peepholes=True, use_blstm=False, lstm_size=8, windowsize=3,
                       lstm_remat=True)
            ref = jconfig.build_model_config([jconfig.StreamConfig(**stream)],
                                             jconfig.ClassifierConfig(**clf))
            got = tconfig.build_model_config([tconfig.StreamConfig(**stream)],
                                             tconfig.ClassifierConfig(**clf))
            assert jax_fields(got) == jexport.config_to_dict(ref)


def _oulu_configs():
    return [m.build_model_config(m.parse_streams(cp), m.parse_classifier(cp))
            for m, cp in ((jconfig, jconfig.load_config(OULU)),
                          (tconfig, tconfig.load_config(OULU)))]


def _tiny_configs():
    """The oulu_4stream topology at tiny widths: two 16/12/6 encoders (one
    sigmoid and one rectify layer each), DCT 9 and MFCC 6 without, W = 3,
    H = 8."""
    encoders = [(("sigmoid", "rectify", "linear"), (16, 12, 6)),
                (("rectify", "sigmoid", "linear"), (16, 12, 6)), None, None]
    return [zoo.adenet_nstream([20, 20, 9, 6], encoders, lstm_size=8, window=3,
                               output_classes=10, fusiontype="adasum", use_peepholes=True)
            for zoo in (jzoo, tzoo)]


def _batch(seed, cfg, B, T, lens):
    rng = np.random.RandomState(seed)
    streams = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
    mask = (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)
    y = rng.randint(0, cfg.output_classes, B).astype(np.int32)
    return streams, mask, y


def _params(jcfg, seed=0):
    jparams = jadenet.init_adenet_params(jax.random.PRNGKey(seed), jcfg)
    return jparams, bridge.params_from_jax(_np(jparams), device="cpu")


def test_4stream_params_have_jax_keys_and_shapes():
    jcfg, tcfg = _tiny_configs()
    got = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    ref = jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg)
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(_np(ref)) == shapes({**got})
    assert set(got["streams"]["s1"]["lstm"]) >= {"w_cell_to_ingate", "w_cell_to_outgate"}
    assert set(got["aggregator"][0]["bwd"]) == set(ref["aggregator"][0]["bwd"])


def _serve_both(jcfg, tcfg, streams, mask, vote):
    jparams, tparams = _params(jcfg)
    ref = jserve.make_server(jparams, jcfg, vote=vote)([jnp.asarray(s) for s in streams],
                                                       jnp.asarray(mask))
    got = tserve.make_server(tparams, tcfg, vote=vote, device="cpu")(streams, mask)
    return np.asarray(ref), got.numpy()


def _assert_no_near_tie(probs, mask, margin=1e-4):
    """The vote compares argmaxes: a frame whose top two probabilities are
    within rounding of each other could vote either way."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    gaps = (top2[..., 1] - top2[..., 0])[mask > 0]
    assert gaps.min() > margin, gaps.min()


@pytest.mark.parametrize("vote", [False, True])
def test_tiny_4stream_server_matches_jax(vote):
    jcfg, tcfg = _tiny_configs()
    streams, mask, _ = _batch(1, jcfg, 3, 7, [7, 4, 2])
    ref, got = _serve_both(jcfg, tcfg, streams, mask, vote=False)
    assert got.shape == (3, 7, 10)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, ref, **PROB_TOL)
    if vote:
        _assert_no_near_tie(ref, mask)
        ref, got = _serve_both(jcfg, tcfg, streams, mask, vote=True)
        assert got.shape == (3, 10)
        np.testing.assert_allclose(got, ref, **PROB_TOL)


def test_full_width_4stream_server_matches_jax():
    jcfg, tcfg = _oulu_configs()
    assert [s.feature_dim() for s in tcfg.streams] == [150, 150, 270, 117]
    assert tcfg.use_peepholes and tcfg.fusiontype == "adasum"
    streams, mask, _ = _batch(2, jcfg, 2, 29, [29, 13])
    jparams, tparams = _params(jcfg)
    jstreams, jmask = [jnp.asarray(s) for s in streams], jnp.asarray(mask)
    ref = np.asarray(jserve.make_server(jparams, jcfg, vote=False)(jstreams, jmask))
    got = tserve.make_server(tparams, tcfg, vote=False, device="cpu")(streams, mask).numpy()
    assert got.shape == (2, 29, 10) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **PROB_TOL)
    _assert_no_near_tie(ref, mask)
    ref_v = np.asarray(jserve.make_server(jparams, jcfg, vote=True)(jstreams, jmask))
    got_v = tserve.make_server(tparams, tcfg, vote=True, device="cpu")(streams, mask).numpy()
    np.testing.assert_allclose(got_v, ref_v, **PROB_TOL)


def _pairs(got, ref, path=""):
    """[(port leaf, JAX leaf, path)] over two trees of the same structure."""
    if isinstance(ref, dict):
        return [p for k in ref for p in _pairs(got[k], ref[k], f"{path}/{k}")]
    if isinstance(ref, (list, tuple)):
        return [p for i, r in enumerate(ref) for p in _pairs(got[i], r, f"{path}/{i}")]
    return [(got, ref, path)]


def test_4stream_train_step_matches_jax():
    jcfg, tcfg = _tiny_configs()
    streams, mask, y = _batch(3, jcfg, 3, 7, [7, 4, 2])
    jparams, tparams = _params(jcfg, seed=1)

    def jloss(p):  # Trainer._loss, per-step branch
        out = jadenet.adenet_forward(p, jcfg, [jnp.asarray(s) for s in streams],
                                     jnp.asarray(mask), train=True,
                                     dropout_rng=jax.random.PRNGKey(0))
        y2d = jnp.repeat(jnp.asarray(y)[:, None], mask.shape[1], axis=1)
        return jlosses.temporal_softmax_loss(out, y2d, jnp.asarray(mask))

    jl, jgrads = jax.value_and_grad(jloss)(jparams)
    jo = jopt.adam(1e-4)
    jp1, _ = jo.apply(jparams, jgrads, jo.init(jparams))

    tstreams = [torch.from_numpy(s) for s in streams]
    ty, tmask = torch.from_numpy(y).long(), torch.from_numpy(mask)
    loss, grads = ttrainer.loss_and_grads(tparams, tcfg, tstreams, ty, tmask)
    opt, step = ttrainer.make_train_step(tcfg, lr=1e-4)
    tp1, ts1, tloss = step(tparams, opt.init(tparams), tstreams, ty, tmask)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(jl), rtol=1e-5)
    pairs = _pairs(grads, _np(jgrads))
    assert len(pairs) == len(jax.tree_util.tree_leaves(jparams)) >= 48 + 18
    for g, r, path in pairs:
        np.testing.assert_allclose(g.numpy(), r, atol=max(1e-5 * np.abs(r).max(), 1e-8),
                                   rtol=0, err_msg=f"grad {path}")
        if "w_cell_to" in path:
            assert np.abs(r).max() > 0, path
    for g, r, path in _pairs(tp1, _np(jp1)):
        np.testing.assert_allclose(g.numpy(), r, atol=1e-6, rtol=0, err_msg=f"param {path}")
    assert float(ts1["t"]) == 1.0


def test_make_server_rejects_mesh_and_defaults_to_cuda():
    """``mesh=`` takes a mesh: on the one-process mesh the 4-stream server's
    scores equal the plain server's; without ``device`` it needs CUDA."""
    from ip_avsr_torch.parallel import mesh as tmesh

    _, tcfg = _tiny_configs()
    params = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    streams, mask = _batch(3, tcfg, 4, 9, [9, 5, 1, 7])[:2]
    got = tserve.make_server(params, tcfg, mesh=tmesh.make_mesh(), device="cpu")(streams, mask)
    want = tserve.make_server(params, tcfg, device="cpu")(streams, mask)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.make_server(params, tcfg)
