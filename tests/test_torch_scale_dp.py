"""Data parallelism, ZeRO-1 and tensor parallelism of the port's Trainer on
four gloo ranks, against the one-process port and the JAX package
(tests/test_multidevice.py and tests/test_shard_map_trainer.py's cases).

Every step case runs a batch of 14 ragged rows (a full row and a length-1
row), which the mesh pads to 16 with zero-mask rows: the ranks' frame
counts differ, so a mean of per-rank means would fail where the quotient of
summed parts holds.  Tolerances: the JAX tests' (loss 1e-5 relative,
parameters 1e-4 relative with 1e-6 absolute, predictions 1e-5 / 1e-6), and
gradients 2e-4 relative as tests/test_multidevice.py:273 holds the dp x tp
gradients.  Momentum keeps the update proportional to the gradient, as in
the JAX tests; the ZeRO-1 case takes adam, as JAX's does.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.parallel import mesh as jmesh
from ip_avsr_tpu.parallel import multihost as jmultihost
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.parallel import _multiprocess_worker as worker
from ip_avsr_torch.parallel import mesh as tmesh
from ip_avsr_torch.parallel import multihost as tmultihost
from tests import torch_scale_lib as lib

torch.set_num_threads(1)
RANKS = 4
B, T = 14, 9


@pytest.fixture(scope="module")
def ranks():
    with lib.pool(RANKS) as p:
        yield p


def _tp_cfg(zoo):
    return zoo.deltanet_majority_vote(24, [32, 16, 8], ["sigmoid", "sigmoid", "linear"],
                                      lstm_size=8, window=4, output_classes=4)


def _last_step_cfg(zoo):
    return zoo.lstm_classifier_baseline(24, lstm_size=8, output_classes=4)


CONFIGS = {"per_step": _tp_cfg, "last_step": _last_step_cfg}


@pytest.fixture(scope="module")
def cases():
    """Per config: (port config, JAX-init params, batch, the one-process
    port's momentum step and the JAX package's)."""
    out = {}
    for name, mk in CONFIGS.items():
        jcfg, tcfg = mk(jzoo), mk(tzoo)
        params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
        batch = lib.ragged_batch(B, T, (24,), 4, seed=0)
        single = worker.trainer_step(tcfg, dict(optimizer="momentum"), params, batch)
        jt = jtr.Trainer(jcfg, jtr.TrainOptions(optimizer="momentum", learning_rate=1e-3,
                                                log_fn=lambda *_: None))
        dev = jt._device_batch(*batch)
        p0 = jax.tree_util.tree_map(jnp.asarray, params)
        jp, _, jloss = jt.train_step(p0, jt.optimizer.init(p0), *dev, jax.random.PRNGKey(3),
                                     jnp.asarray(1e-3, jnp.float32))
        out[name] = (tcfg, params, batch, single, (float(jloss), lib.np_tree(jp)))
    return out


def _check_step(got, single, jax_ref):
    assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)
    assert got["loss"] == pytest.approx(jax_ref[0], rel=1e-5)
    lib.assert_trees_close(got["params"], single["params"], atol=1e-6, rtol=1e-4, what="params")
    lib.assert_trees_close(got["params"], jax_ref[1], atol=1e-6, rtol=1e-4, what="jax params")
    lib.assert_trees_close(got["grads"], single["grads"], atol=1e-7, rtol=2e-4, what="grads")
    assert got["eval_cost"] == pytest.approx(single["eval_cost"], rel=1e-5)
    np.testing.assert_allclose(got["predict"][:B], single["predict"], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got["confusion"], single["confusion"])


MESH_MODES = {"gspmd": dict(use_mesh=True), "shard_map": dict(use_mesh=True, mesh_mode="shard_map"),
              "multihost": dict(use_mesh=True, multihost=True),
              "accum": dict(use_mesh=True, grad_accum_steps=2, batchsize=16)}


@pytest.mark.parametrize("head", sorted(CONFIGS))
@pytest.mark.parametrize("mode", sorted(MESH_MODES))
def test_step_single_vs_sharded(ranks, cases, mode, head):
    """Forward, gradients, eval cost, confusion counts and one step on the
    data mesh equal one process and JAX (test_multidevice.py:43-98,
    test_shard_map_trainer.py:47-83; accumulation as the JAX gspmd path
    composes it)."""
    tcfg, params, batch, single, jax_ref = cases[head]
    for got in ranks.run(worker.trainer_step, tcfg, dict(MESH_MODES[mode], optimizer="momentum"),
                         params, batch):
        assert got["mesh"] == {"data": RANKS}
        _check_step(got, single, jax_ref)


def test_tensor_parallel_step(ranks, cases):
    """model_parallel=2 (data 2 x model 2): the encoders' w and b and their
    moments hold column blocks, the rest is replicated, and the step equals
    one process and JAX (test_multidevice.py:207, :273)."""
    tcfg, params, batch, single, jax_ref = cases["per_step"]
    for got in ranks.run(worker.trainer_step, tcfg, dict(optimizer="momentum", model_parallel=2),
                         params, batch):
        assert got["mesh"] == {"data": 2, "model": 2}
        enc = got["local_params"]["streams"]["s1"]["encoder"]
        assert enc["fc1"] == {"w": (24, 16), "b": (16,)} and enc["fc3"]["w"] == (16, 4)
        assert got["local_opt_state"]["velocity"]["streams"]["s1"]["encoder"]["fc2"]["w"] \
            == (32, 8)
        assert got["local_params"]["output"]["w"] == (8, 4)
        _check_step(got, single, jax_ref)


def test_zero1_step(ranks, cases):
    """zero1: each moment leaf holds this rank's ``zero1_spec`` block (as
    JAX's spec for the leaf), the parameters stay whole, and the adam step
    equals the replicated one (test_multidevice.py:502)."""
    tcfg, params, batch, _, _ = cases["per_step"]
    single = worker.trainer_step(tcfg, dict(optimizer="adam"), params, batch)
    for got in ranks.run(worker.trainer_step, tcfg, dict(optimizer="adam", zero1=True), params,
                         batch):
        for path, leaf in lib.leaves(params):
            shape = got["local_opt_state"]["m"]
            for key in path.split("/"):
                shape = shape[int(key) if isinstance(shape, list) else key]
            spec = jmesh.zero1_spec(leaf, RANKS)
            want = tuple(n // RANKS if a else n for n, a in zip(leaf.shape, tuple(spec)
                                                                 + (None,) * leaf.ndim))
            assert tuple(shape) == want, path
        assert got["local_params"]["streams"]["s1"]["encoder"]["fc1"]["w"] == (24, 32)
        assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)
        lib.assert_trees_close(got["params"], single["params"], atol=1e-6, rtol=1e-4)
        lib.assert_trees_close(got["opt_state"], single["opt_state"], atol=1e-7, rtol=1e-4)


def _bn_cfg(zoo, adenet):
    cfg = zoo.adenet_v1(12, 6, lstm_size=8, window=3, output_classes=4)
    s0 = adenet.StreamSpec(**{**cfg.streams[0].__dict__, "encoder_shapes": (10, 8, 6, 5),
                              "encoder_nonlinearities": ("sigmoid",) * 3 + ("linear",)})
    return adenet.AdeNetConfig(**{**cfg.__dict__, "streams": [s0, cfg.streams[1]]})


@pytest.mark.parametrize("mode", ["gspmd", "shard_map", "model_parallel"])
def test_synced_batchnorm_step(ranks, mode):
    """Batch-norm streams train with statistics synced over the ranks: the
    loss, parameters and moved running statistics equal one process and
    JAX (test_shard_map_trainer.py:143), the gradients one process's."""
    jcfg, tcfg = _bn_cfg(jzoo, jadenet), _bn_cfg(tzoo, tadenet)
    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg))
    batch = lib.ragged_batch(16, 6, (12, 6), 4, seed=0, min_len=3)
    opts = {"gspmd": dict(use_mesh=True), "shard_map": dict(use_mesh=True, mesh_mode="shard_map"),
            "model_parallel": dict(model_parallel=2)}[mode]
    single = worker.trainer_step(tcfg, dict(optimizer="momentum"), params, batch)
    jt = jtr.Trainer(jcfg, jtr.TrainOptions(optimizer="momentum", learning_rate=1e-3,
                                            log_fn=lambda *_: None, use_mesh=True,
                                            mesh_mode="shard_map"))
    dev = jt._device_batch(*batch)
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _, jloss = jt.train_step(p0, jt.optimizer.init(p0), *dev, jax.random.PRNGKey(3),
                                 jnp.asarray(1e-3, jnp.float32))
    for got in ranks.run(worker.trainer_step, tcfg, dict(opts, optimizer="momentum"), params,
                         batch):
        assert np.abs(got["params"]["streams"]["raw"]["bn_state"]["mean"]).max() > 0
        for loss, ref in ((single["loss"], single["params"]), (float(jloss), lib.np_tree(jp))):
            assert got["loss"] == pytest.approx(loss, rel=1e-5)
            lib.assert_trees_close(got["params"], ref, atol=1e-6, rtol=1e-4)
        # the last encoder bias before batch norm has an exact gradient of 0
        for path, g in lib.leaves(got["grads"]):
            ref = dict(lib.leaves(single["grads"]))[path]
            if path != "streams/raw/encoder/bottleneck/b":
                np.testing.assert_allclose(g, ref, rtol=0, atol=2e-4 * np.abs(ref).max(),
                                           err_msg=path)


def test_batchnorm_control_and_bottleneck_terms(ranks):
    """The card's batch-norm checks (chip_smoke.phase_scale) at tiny width:
    the step with each rank's own statistics
    (``_multiprocess_worker.local_bn_statistics``) lies far from one
    process where the synced step is within the 2e-4 above, and the
    factors ``bottleneck_terms`` takes on the ranks rebuild the bottleneck
    weight's gradient: the ranks' X^T dZ over the loss's count (the rows
    with a frame, for this last-step head)."""
    tcfg = _bn_cfg(tzoo, tadenet)
    params = lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0),
                                                    _bn_cfg(jzoo, jadenet)))
    batch = lib.ragged_batch(16, 6, (12, 6), 4, seed=0, min_len=3)
    zero = ["/streams/raw/encoder/bottleneck/b"]
    shape = params["streams"]["raw"]["encoder"]["bottleneck"]["w"].shape
    single = worker.chip_step({}, tcfg, params, batch, {}, device="cpu")["result"]
    synced = ranks.run(worker.chip_step, {}, tcfg, params, batch, dict(use_mesh=True), None,
                       zero, device="cpu", bottleneck=shape)
    control = ranks.run(worker.chip_step, {}, tcfg, params, batch, dict(use_mesh=True),
                        single, zero, device="cpu", local_bn=True)
    for got in synced:
        assert worker.step_gaps(got["result"], single, zero)["grad_rel"] <= 2e-4
    for got in control:
        assert got["gaps"]["grad_rel"] > 1e-2
    X, dZ = (np.concatenate([got["bottleneck"][k] for got in synced]) for k in ("X", "dZ"))
    count = (batch[2].sum(axis=1) > 0).sum()
    want = synced[0]["result"][1]["streams"]["raw"]["encoder"]["bottleneck"]["w"]
    # float32 made want: its product's rounding (about 2e-6 of max abs here)
    # against a wrong row order or count, which would be off by O(1)
    np.testing.assert_allclose(X.T @ dZ / count, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_synced_batchnorm_no_cancellation_on_large_mean(ranks):
    """The synced variance is two-pass: at |mean| / std = 2e5 the one-pass
    form gives NaN (test_shard_map_trainer.py:223); held as JAX's test holds
    it."""
    from ip_avsr_torch.ops import normalization as tnorm

    x = (2000.0 + 0.01 * np.random.RandomState(0).randn(32, 4)).astype(np.float32)
    want, state = tnorm.batch_norm_forward(*tnorm.init_batch_norm(4), torch.from_numpy(x), True)
    for got in ranks.run(worker.bn_synced, x):
        assert np.isfinite(got["y"]).all()
        np.testing.assert_allclose(got["y"], want.numpy(), rtol=0.15, atol=0.15)
        np.testing.assert_allclose(got["state"]["var"], state["var"].numpy(), rtol=0.05)


def test_gspmd_dropout_equals_one_process_shard_map_draws_per_rank(ranks):
    """Under gspmd each rank keeps its rows of the whole batch's dropout
    masks: the step with dropout equals one process; under shard_map the
    rank is folded into the seed, so its loss differs."""
    from tests import torch_trainer_lib as tlib

    cfg = dataclasses.replace(tlib.flagship_config(tzoo), agg_dropout=0.3)
    cfg = dataclasses.replace(cfg, streams=[dataclasses.replace(s, dropout=0.2)
                                            for s in cfg.streams])
    params = worker.arrays(tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg,
                                                      device="cpu"))
    batch = lib.ragged_batch(16, 7, tlib.FLAGSHIP_DIMS, 3, seed=1)
    single = worker.trainer_step(cfg, dict(optimizer="momentum"), params, batch, evaluate=False)
    no_dropout = dataclasses.replace(cfg, agg_dropout=0.0, streams=[
        dataclasses.replace(s, dropout=0.0) for s in cfg.streams])
    plain = worker.trainer_step(no_dropout, dict(optimizer="momentum"), params, batch,
                                evaluate=False)
    assert abs(plain["loss"] - single["loss"]) > 1e-3
    gspmd = ranks.run(worker.trainer_step, cfg, dict(optimizer="momentum", use_mesh=True),
                      params, batch, evaluate=False)
    sm = ranks.run(worker.trainer_step, cfg, dict(optimizer="momentum", use_mesh=True,
                                                  mesh_mode="shard_map"), params, batch,
                   evaluate=False)
    for got in gspmd:
        assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)
        lib.assert_trees_close(got["params"], single["params"], atol=1e-6, rtol=1e-4)
    assert np.isfinite(sm[0]["loss"]) and abs(sm[0]["loss"] - single["loss"]) > 1e-4
    assert all(r["loss"] == sm[0]["loss"] for r in sm)


def _corpus(n_videos, dim=24, classes=4, seed=1):
    rng = np.random.RandomState(seed)
    lens = rng.randint(5, 10, n_videos)
    y_video = rng.randint(0, classes, n_videos)
    frames, y_frames = [], []
    for length, c in zip(lens, y_video):
        base = np.zeros(dim)
        base[c] = 3.0
        frames.append(base + 0.3 * rng.randn(length, dim))
        y_frames.append(np.full(length, c))
    return [np.concatenate(frames).astype(np.float32)], np.concatenate(y_frames), lens


FITS = {"zero1": dict(zero1=True), "shard_map": dict(use_mesh=True, mesh_mode="shard_map"),
        "shard_map_bucketed": dict(use_mesh=True, mesh_mode="shard_map",
                                   bucket_boundaries="auto"),
        "model_parallel_bucketed": dict(model_parallel=2, bucket_boundaries="auto")}


@pytest.mark.parametrize("kind", sorted(FITS))
def test_fit_learns_and_tracks_one_process(ranks, kind):
    """A short adam fit on the mesh learns the separable corpus, and its
    validation costs track one process's fit (test_multidevice.py:329,
    :555; test_shard_map_trainer.py:120, :185, :209)."""
    cfg = _tp_cfg(tzoo)
    train, val = _corpus(48), _corpus(12, seed=2)
    opts = dict(num_epoch=4, epochsize=5, batchsize=16, learning_rate=0.01, optimizer="adam",
                prefetch_batches=False)
    if "bucket" in kind:
        opts["bucket_boundaries"] = "auto"
    base = worker.trainer_fit(cfg, opts, train, val, val)
    for got in ranks.run(worker.trainer_fit, cfg, dict(opts, **FITS[kind]), train, val, val):
        assert got["class_rate"][-1] > 0.5
        np.testing.assert_allclose(got["cost_val"], base["cost_val"], rtol=0.05, atol=0.02)


def test_checkpoint_resume_across_mesh_shapes(ranks, tmp_path):
    """A checkpoint written on the data 4 mesh (the whole state, by rank 0)
    resumes on data 2 x model 2 and on one process; the restored history is
    verbatim and the continued epochs track a straight run
    (test_multidevice.py:417's tolerances)."""
    cfg = _tp_cfg(tzoo)
    train, val = _corpus(48), _corpus(12, seed=2)
    opts = dict(num_epoch=2, epochsize=3, batchsize=16, learning_rate=0.01, optimizer="adam",
                use_mesh=True, prefetch_batches=False)
    ref = ranks.run(worker.trainer_fit, cfg, dict(opts, num_epoch=4), train, val, val)[0]
    ck = str(tmp_path / "ckpt")
    first = ranks.run(worker.trainer_fit, cfg, dict(opts, checkpoint_dir=ck), train, val, val)[0]
    np.testing.assert_allclose(first["cost_val"], ref["cost_val"][:2], rtol=1e-4, atol=1e-6)
    resumed = {
        "model_parallel": ranks.run(worker.trainer_fit, cfg, dict(
            opts, model_parallel=2, checkpoint_dir=ck, resume=True, num_epoch=4), train, val,
            val)[0],
        "one_process": worker.trainer_fit(cfg, dict(opts, use_mesh=False, checkpoint_dir=ck,
                                                    resume=True, num_epoch=4), train, val, val)}
    for name, got in resumed.items():
        assert len(got["cost_val"]) == 4, name
        np.testing.assert_allclose(got["cost_val"][:2], ref["cost_val"][:2], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got["cost_val"][2:], ref["cost_val"][2:], rtol=5e-3,
                                   atol=1e-5)
        assert abs(got["best_val"] - ref["best_val"]) < 5e-3
    assert abs(resumed["one_process"]["test_cr"] - ref["test_cr"]) < 1e-9
    assert abs(resumed["one_process"]["best_cr"] - ref["best_cr"]) < 1e-9


@pytest.mark.parametrize("head", sorted(CONFIGS))
def test_device_eval_matches_host_eval(ranks, cases, head):
    """Evaluation on the mesh, counted on the device (each rank's confusion
    counts summed) and on the host (predictions all-gathered), chunked and
    not, equals one process's (test_multidevice.py:359)."""
    tcfg, params, _, _, _ = cases[head]
    streams, y, mask = lib.ragged_batch(21, 7, (24,), 4, seed=3)
    want_cr, want_conf = worker.evaluate(tcfg, {}, params, streams, y, mask)
    for opts in (dict(use_mesh=True), dict(use_mesh=True, device_eval=True)):
        for bs in (512, 8):
            for cr, conf in ranks.run(worker.evaluate, tcfg, opts, params, streams, y, mask, bs):
                assert cr == want_cr, (opts, bs)
                np.testing.assert_array_equal(conf, want_conf)


def test_param_shardings_match_jax():
    """The sharding descriptions equal the JAX package's, leaf by leaf: the
    default rules with demotion of a dim the model size does not divide
    (test_multidevice.py:394) and of an axis the mesh lacks (:483), the
    mirrored and ZeRO-1 optimizer states, and DTensor placements."""
    params = {"streams": {"s1": {"encoder": {
        "fc1": {"w": np.zeros((6, 8)), "b": np.zeros((8,))},
        "fc2": {"w": np.zeros((8, 7)), "b": np.zeros((7,))}}}},
        "output": {"w": np.zeros((7, 4)), "b": np.zeros((4,))}}
    opt = {"m": params, "v": params, "t": np.zeros(())}
    for shape in ({"data": 4, "model": 2}, {"data": 8}):
        jm, tm = jmesh.make_mesh_nd(shape), tmesh.Mesh(shape)
        jsh, tsh = jmesh.param_shardings(params, jm), tmesh.param_shardings(params, tm)
        specs = lambda tree: [tuple(s.spec) for s in jax.tree_util.tree_leaves(  # noqa: E731
            tree, is_leaf=lambda x: hasattr(x, "spec"))]
        assert specs(tsh) == specs(jsh), shape
        assert specs(tmesh.opt_state_shardings(opt, params, tsh, tm)) == specs(
            jmesh.opt_state_shardings(opt, params, jsh, jm))
        assert specs(tmesh.zero1_opt_state_shardings(opt, params, tm)) == specs(
            jmesh.zero1_opt_state_shardings(opt, params, jm))
    from torch.distributed.tensor.placement_types import Replicate, Shard

    tm = tmesh.Mesh({"data": 4, "model": 2})
    w = tmesh.param_shardings(params, tm)["streams"]["s1"]["encoder"]["fc1"]["w"]
    assert w.placements == (Replicate(), Shard(1))
    assert tmesh.NamedSharding(tm, tmesh.P(("data", "model"))).placements == (Shard(0), Shard(0))


@pytest.mark.parametrize("rows,multiple", [(14, 4), (16, 4), (1, 8), (9, 2)])
def test_pad_batch_and_local_slice_match_jax(rows, multiple):
    """The copies of ``pad_batch_to_multiple`` and (one process)
    ``process_local_slice`` against the JAX originals."""
    rng = np.random.RandomState(rows)
    arrays = [rng.randn(rows, 3).astype(np.float32), rng.randint(0, 5, rows).astype(np.int32)]
    got, n = tmesh.pad_batch_to_multiple(arrays, multiple)
    want, jn = jmesh.pad_batch_to_multiple(arrays, multiple)
    assert n == jn == rows
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tmultihost.process_local_slice(rows) == jmultihost.process_local_slice(rows)


MATRIX = {
    "mp_and_sp": dict(model_parallel=2, sequence_parallel=2),
    "mp_shard_map": dict(model_parallel=2, mesh_mode="shard_map"),
    "mp_divides": dict(model_parallel=3),
    "sp_shard_map": dict(sequence_parallel=2, mesh_mode="shard_map"),
    "sp_buckets": dict(sequence_parallel=2, bucket_boundaries="auto"),
    "sp_multihost": dict(sequence_parallel=2, multihost=True),
    "sp_divides": dict(sequence_parallel=3),
    "mesh_mode": dict(use_mesh=True, mesh_mode="pjit"),
    "zero1_shard_map": dict(zero1=True, mesh_mode="shard_map"),
    "zero1_mp": dict(zero1=True, model_parallel=2),
    "zero1_sp": dict(zero1=True, sequence_parallel=2),
    "zero1_multihost": dict(zero1=True, multihost=True),
    "accum_shard_map": dict(use_mesh=True, mesh_mode="shard_map", grad_accum_steps=2,
                            batchsize=4),
}


@pytest.mark.parametrize("case", sorted(MATRIX))
def test_option_refusals_match_jax(ranks, case):
    """The JAX Trainer's ValueError matrix (trainer.py:186-235;
    test_multidevice.py:572, test_sequence_parallel.py:165): each refused
    combination raises the same message on four ranks, the device count
    aside (JAX sees 8 devices, the port 4 ranks)."""
    cfg = _tp_cfg(jzoo)
    with pytest.raises(ValueError) as jerr:
        jtr.Trainer(cfg, jtr.TrainOptions(log_fn=lambda *_: None, **MATRIX[case]))
    for got in ranks.run(worker.trainer_refusal, _tp_cfg(tzoo), MATRIX[case]):
        assert re.sub(r"count \d+", "count N", got) == re.sub(r"count \d+", "count N",
                                                              str(jerr.value))
