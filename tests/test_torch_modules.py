"""The port's leaf modules (ip_avsr_torch/ops, models/encoder, the config
dataclasses, the parameter bridge) against their JAX twins.

Tolerances: float32 ops at atol 1e-5 / rtol 1e-5 unless stated.  DCT
features of raw 0..255 pixels reach ~1e3, so they are held at atol 2e-3
(float32 rounding of sums over 1144 pixels; JAX uses an FFT, the port a
basis product).
"""

import dataclasses
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from ip_avsr_tpu import export as jexport
from ip_avsr_tpu.data import preprocessing as jprep
from ip_avsr_tpu.models import adenet as jadenet, encoder as jencoder, zoo as jzoo
from ip_avsr_tpu.ops import (dct as jdct, fusion as jfusion, nonlinearities as jnl,
                             pipeline as jpipe, voting as jvoting)
from ip_avsr_torch import bridge, device as tdevice
from tests.torch_trainer_lib import jax_fields
from ip_avsr_torch.models import adenet as tadenet, encoder as tencoder, zoo as tzoo
from ip_avsr_torch.ops import (dct as tdct, fusion as tfusion, initializers as tinit,
                               nonlinearities as tnl, pipeline as tpipe, voting as tvoting)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.RandomState(seed)


@pytest.mark.parametrize("name", sorted(jnl._REGISTRY))
def test_nonlinearities_match_jax(name):
    x = _rng(1).randn(4, 7).astype(np.float32) * 3
    np.testing.assert_allclose(tnl.select_nonlinearity(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jnl.select_nonlinearity(name)(jnp.asarray(x))),
                               **TOL)


def test_initializers_statistics():
    g = torch.Generator().manual_seed(0)
    w = tinit.glorot_uniform(g, (300, 200))
    limit = np.sqrt(6.0 / 500)
    assert w.abs().max() <= limit and w.abs().max() > 0.95 * limit
    assert abs(w.mean().item()) < 0.01 * limit
    q = tinit.select_weight_init("ortho")(g, (50, 200))
    torch.testing.assert_close(q @ q.T, torch.eye(50), atol=1e-5, rtol=0)
    n = tinit.select_weight_init("norm")(g, (400, 400))
    assert abs(n.std().item() - 0.1) < 0.005 and abs(n.mean().item()) < 0.005
    # same seed, same draws
    torch.testing.assert_close(tinit.orthogonal(torch.Generator().manual_seed(3), (8, 8)),
                               tinit.orthogonal(torch.Generator().manual_seed(3), (8, 8)))
    u = tinit.select_weight_init("uniform")(g, (400, 400))
    assert u.abs().max() <= 0.01 and u.abs().max() > 0.0099
    assert abs(u.mean().item()) < 1e-4 and abs(u.std().item() - 0.01 / np.sqrt(3)) < 1e-4


def test_encoder_matches_jax_and_keeps_layer_order():
    params = jencoder.init_encoder_params(jax.random.PRNGKey(0), 12,
                                          [10, 9, 8, 7, 6, 5])
    names = sorted(params, key=jencoder._layer_sort_key)
    assert names == sorted(params, key=tencoder._layer_sort_key)
    assert names[:4] == list(tencoder.DEFAULT_NAMES) and names[4:] == ["fc5", "fc6"]
    nls = ["sigmoid", "rectify", "tanh", "linear", "elu", "sigmoid"]
    x = _rng(2).randn(11, 12).astype(np.float32)
    ref = jencoder.encoder_forward(params, jnp.asarray(x), nls)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    got = tencoder.encoder_forward(tp, torch.from_numpy(x), nls)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError, match="nonlinearities"):
        tencoder.encoder_forward(tp, torch.from_numpy(x), nls[:-1])


def test_zigzag_indices_match_host_preprocessing():
    for shape in [(26, 44), (8, 8), (3, 5)]:
        np.testing.assert_array_equal(tdct.zigzag_indices(shape),
                                      jprep.zigzag_indices(shape))


def test_dct_basis_is_ortho_dct2():
    # coefficient 0 scales by sqrt(1/N), the others by sqrt(2/N); with every
    # column gathered, the basis is the orthonormal DCT-II matrix
    N = 12
    full = tdct.dct_feature_basis_np((3, 4), N - 1)
    k = tdct.zigzag_indices((3, 4))[1:N]
    assert np.allclose(full.T @ full, np.eye(N - 1), atol=1e-12)
    x = _rng(3).randn(N)
    ref = np.asarray(jax.scipy.fft.dct(jnp.asarray(x, jnp.float32), type=2, norm="ortho"))
    np.testing.assert_allclose(x @ full, ref[k], atol=1e-5)
    assert np.isclose(np.sqrt(1.0 / N) * x.sum(),
                      float(jax.scipy.fft.dct(jnp.asarray(x, jnp.float32), type=2,
                                              norm="ortho")[0]), atol=1e-5)


def test_dct_features_match_jax_on_raw_pixels():
    X = _rng(4).randint(0, 256, (6, 1144)).astype(np.float32)
    ref = np.asarray(jdct.compute_dct_features_device(jnp.asarray(X), (26, 44), 90))
    got = tdct.compute_dct_features_device(torch.from_numpy(X), (26, 44), 90).numpy()
    assert np.abs(ref).max() > 100
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=1e-5)


def test_samplewise_normalize_uses_population_std_and_eps_on_std():
    x = _rng(5).randn(3, 4, 10).astype(np.float32) * 7 + 2
    x[1, 2] = 0.0  # an all-zero pad frame normalises to 0, not NaN
    got = tpipe.samplewise_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpipe.samplewise_normalize(jnp.asarray(x))),
                               **TOL)
    assert np.all(got[1, 2] == 0.0)
    np.testing.assert_allclose(got[0, 0].std(), 1.0, rtol=1e-5)  # ddof 0


def test_diff_images_duplicates_first_difference():
    x = _rng(6).randn(2, 5, 3).astype(np.float32)
    got = tpipe.diff_images(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpipe.diff_images(jnp.asarray(x))), **TOL)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


@pytest.mark.parametrize("normalise", [False, True])
def test_trimodal_streams_match_jax_with_zero_pad_frames(normalise):
    rng = _rng(7)
    B, T, shape = 3, 6, (4, 5)
    raw = rng.randint(0, 256, (B, T, 20)).astype(np.float32)
    lens = np.array([6, 3, 1])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    raw *= mask[..., None]  # pad frames are all-zero, as a padded batch has
    stats = ((rng.randn(8).astype(np.float32), rng.rand(8).astype(np.float32) + 0.5)
             if normalise else (None, None))
    ref = jpipe.trimodal_streams(jnp.asarray(raw), jnp.asarray(mask), shape, 8, *stats)
    got = tpipe.trimodal_streams(torch.from_numpy(raw), torch.from_numpy(mask), shape, 8,
                                 *(None if s is None else torch.from_numpy(s) for s in stats))
    for name, r, g in zip(("raw", "dct", "diff"), ref, got):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4 if name == "dct" else 1e-5,
                                   rtol=1e-5, err_msg=name)
        assert not g.numpy()[2, 1:].any(), name


@pytest.mark.parametrize("fusiontype", ["sum", "adasum", "concat"])
def test_fusion_matches_jax(fusiontype):
    xs = [_rng(8 + i).randn(2, 3, 4).astype(np.float32) for i in range(3)]
    jp = {f"adacoeff{i}": jnp.asarray(0.5 + i, jnp.float32) for i in range(3)}
    tp = {k: torch.tensor(float(v)) for k, v in jp.items()}
    ref = jfusion.fuse([jnp.asarray(x) for x in xs], fusiontype, jp)
    got = tfusion.fuse([torch.from_numpy(x) for x in xs], fusiontype, tp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert tfusion.fused_dim([4, 4, 4], fusiontype) == jfusion.fused_dim([4, 4, 4], fusiontype)
    assert set(tfusion.init_adasum_params(3)) == set(jfusion.init_adasum_params(3))


def test_masked_vote_matches_jax():
    rng = _rng(9)
    probs = rng.rand(4, 7, 5).astype(np.float32)
    mask = (rng.rand(4, 7) > 0.3).astype(np.float32)
    mask[3] = 0.0  # an all-pad row votes uniformly
    ref = jvoting.majority_voting_layer_masked(jnp.asarray(probs), jnp.asarray(mask), 5)
    got = tvoting.majority_voting_layer_masked(torch.from_numpy(probs),
                                               torch.from_numpy(mask), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_config_fields_match_jax():
    for port, ref in ((tadenet.StreamSpec, jadenet.StreamSpec),
                      (tadenet.AdeNetConfig, jadenet.AdeNetConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(port)
                 if f.name not in tadenet.PORT_FIELDS]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
    # the port's own fields are those PORT_FIELDS names, and no other
    assert {f.name for c in (tadenet.StreamSpec, tadenet.AdeNetConfig)
            for f in dataclasses.fields(c)} - {f.name for c in (jadenet.StreamSpec,
                                                              jadenet.AdeNetConfig)
                                               for f in dataclasses.fields(c)} == set(
        tadenet.PORT_FIELDS)
    # the flagship config round-trips through the JAX exporter's dict form
    port = tzoo.adenet_v3(1144, 90, 1144)
    ref = jzoo.adenet_v3(1144, 90, 1144)
    assert jax_fields(port) == jexport.config_to_dict(ref)
    assert port.fused_dim() == ref.fused_dim()
    assert port.classifier_in_dim() == ref.classifier_in_dim()


# adenet_v3 fixes its encoders at 2000-1000-500-50 whatever the input width;
# the tiny pairs below narrow them, keeping the fc1..bottleneck tree
NARROW_ENCODER = (12, 10, 8, 6)


def _narrow_v3(zoo, **stream_fields):
    """The tiny adenet_v3 of ``zoo`` with its encoders narrowed to
    NARROW_ENCODER and ``stream_fields`` set on every stream."""
    cfg = zoo.adenet_v3(16, 4, 16, lstm_size=4)
    return dataclasses.replace(cfg, streams=[
        dataclasses.replace(s, encoder_shapes=NARROW_ENCODER if s.encoder_shapes else None,
                            **stream_fields) for s in cfg.streams])


def _tiny_v3_pair(**fields):
    """The tiny adenet_v3 of both zoos at dropout 0, narrow encoders, with
    ``fields`` set, JAX's parameters and the same ones in the port, and a
    ragged batch."""
    cfgs = [dataclasses.replace(_narrow_v3(z, dropout=0.0), agg_dropout=0.0, **fields)
            for z in (jzoo, tzoo)]
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(0), cfgs[0])
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = _rng(5)
    xs = [rng.randn(3, 6, s.input_dim).astype(np.float32) for s in cfgs[0].streams]
    mask = (np.arange(6)[None] < np.array([6, 4, 1])[:, None]).astype(np.float32)
    return cfgs, jp, tp, xs, mask


@pytest.mark.parametrize("field,value", [
    ("fuse_scans", True), ("matmul_dtype", "bfloat16")])
def test_unported_config_values_raise(field, value):
    """Both values are ported: the same config builds and its forward
    equals JAX's.  ``matmul_dtype="bfloat16"`` is held closer, at 1e-6
    (measured 1.5e-8 here), and the port's float32 forward of the same
    parameters lies more than ten times that from JAX's bf16 one; a dtype
    with no kernel instantiation raises, naming Queue 2 item 4."""
    (jcfg, tcfg), jp, tp, xs, mask = _tiny_v3_pair(**{field: value})
    tadenet.init_adenet_params(torch.Generator(), tcfg, device="cpu")
    got = tadenet.adenet_forward(tp, tcfg, [torch.from_numpy(x) for x in xs],
                                 torch.from_numpy(mask))
    ref = jax.jit(lambda p, x, m: jadenet.adenet_forward(p, jcfg, x, m))(
        jp, [jnp.asarray(x) for x in xs], jnp.asarray(mask))
    if field != "matmul_dtype":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    f32 = tadenet.adenet_forward(tp, dataclasses.replace(tcfg, matmul_dtype=None),
                                 [torch.from_numpy(x) for x in xs], torch.from_numpy(mask))
    assert np.abs(f32.numpy() - np.asarray(ref)).max() > 10 * 1e-6
    with pytest.raises(NotImplementedError, match="Queue 2 item 4"):
        tadenet.init_adenet_params(torch.Generator(), dataclasses.replace(
            tcfg, matmul_dtype="float16"), device="cpu")


def test_batchnorm_and_train_raise():
    """Batch norm is ported: the config passes ``check_supported``, and a
    training forward with ``return_aux`` gives JAX's output and moved
    running statistics; ``bn_axis`` (statistics synced over mesh axes) on
    the one-process mesh gives the unsharded forward and statistics."""
    (jcfg, tcfg), _, _, xs, mask = _tiny_v3_pair()
    jbn, tbn = (dataclasses.replace(c, streams=[
        dataclasses.replace(c.streams[0], use_batchnorm=True), *c.streams[1:]])
        for c in (jcfg, tcfg))
    tadenet.check_supported(tbn)
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(0), jbn)
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    assert set(tp["streams"]["raw"]) == {"encoder", "bn", "bn_state", "lstm"}
    got, aux = tadenet.adenet_forward(tp, tbn, [torch.from_numpy(x) for x in xs],
                                      torch.from_numpy(mask), train=True, return_aux=True)
    ref, jaux = jadenet.adenet_forward(jp, jbn, [jnp.asarray(x) for x in xs],
                                       jnp.asarray(mask), train=True, return_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    assert list(aux["bn_state"]) == list(jaux["bn_state"]) == ["raw"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(aux["bn_state"]["raw"][k].numpy(),
                                   np.asarray(jaux["bn_state"]["raw"][k]), atol=1e-5, rtol=0)
    synced, saux = tadenet.adenet_forward(tp, tbn, [torch.from_numpy(x) for x in xs],
                                          torch.from_numpy(mask), train=True, bn_axis="data",
                                          return_aux=True)
    np.testing.assert_allclose(synced.detach().numpy(), got.detach().numpy(), atol=1e-6, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(saux["bn_state"]["raw"][k].numpy(),
                                   aux["bn_state"]["raw"][k].numpy(), atol=1e-7, rtol=1e-6)


def test_init_adenet_params_has_jax_keys_and_shapes():
    """At adenet_v3's own widths (2000-1000-500-50 encoders); the JAX tree's
    shapes come from ``jax.eval_shape``, which draws nothing.  JAX's
    orthogonal initializer takes an SVD of concrete numpy arrays, which a
    shape trace has not, so the JAX side traces the glorot initializer:
    ``w_init`` picks values, never keys or shapes.  The port's SVDs run on
    one BLAS thread: beside five other test workers, all cores each took
    this test from 1.5 s to 24 s."""
    cfg_t = tzoo.adenet_v3(16, 4, 16, lstm_size=4)
    cfg_j = dataclasses.replace(jzoo.adenet_v3(16, 4, 16, lstm_size=4), w_init="glorot")
    with threadpool_limits(1):
        got = tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg_t, device="cpu")
    ref = jax.eval_shape(lambda k: jadenet.init_adenet_params(k, cfg_j), jax.random.PRNGKey(0))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(got) == shapes(ref)


def test_bridge_keeps_structure_and_values():
    tree = {"a": [{"w": np.arange(6, dtype=np.float32).reshape(2, 3)}],
            "b": {"c": np.ones(2, np.float32)}}
    got = bridge.params_from_jax(tree, device="cpu")
    assert isinstance(got["a"], list)
    np.testing.assert_array_equal(got["a"][0]["w"].numpy(), tree["a"][0]["w"])
    assert got["b"]["c"].dtype == torch.float32


def test_entry_points_raise_without_cuda_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _narrow_v3(tzoo)
    from ip_avsr_torch import serve as tserve

    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadenet.init_adenet_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax({"w": np.ones(2, np.float32)})
    params = tadenet.init_adenet_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.make_trimodal_server(params, cfg, (4, 4), 4)
    assert tdevice.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import ip_avsr_torch, ip_avsr_torch.serve, ip_avsr_torch.bridge, "
        "ip_avsr_torch.device, ip_avsr_torch.models.adenet, ip_avsr_torch.models.zoo, "
        "ip_avsr_torch.models.encoder, ip_avsr_torch.ops.delta, ip_avsr_torch.ops.lstm, "
        "ip_avsr_torch.ops.dct, ip_avsr_torch.ops.pipeline, ip_avsr_torch.ops.fusion, "
        "ip_avsr_torch.ops.voting, ip_avsr_torch.ops.nonlinearities, "
        "ip_avsr_torch.ops.initializers, ip_avsr_torch.ops.kernels.delta, "
        "ip_avsr_torch.ops.kernels.lstm, ip_avsr_torch.ops.kernels._build, "
        "ip_avsr_torch.ops.losses, ip_avsr_torch.train.optimizers, "
        "ip_avsr_torch.train.trainer, ip_avsr_torch.train.config\n"
        "import sys\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m.startswith('ip_avsr_tpu')]\n"
        "assert not bad, bad\n")
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
