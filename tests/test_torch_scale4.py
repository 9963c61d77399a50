"""The four-card phase's harness (chip_smoke.phase_scale4) at tiny width on
four gloo ranks, against one process and the JAX package: every mesh of
the phase (data 4 with padded rows, data 2 x model 2, data 1 x model 4,
data 2 x seq 2 with padded frames, data 1 x seq 4) stepped through
``_multiprocess_worker.chip_step`` with each rank's launches counted
(``counted_on_cpu``: no row-2 call under sequence parallelism), the model 4
demotion of a column block the dim does not divide, sequence parallelism
at seq 4 and its refusal for a short T, batch norm synced over data and
over data x seq with its control, and the collectives on tensors in
permuted strides.  Tolerances: a step within 1e-5 (loss, relative), 2e-4
of max abs (gradients), 1e-6 (parameters), as tests/test_torch_scale_dp.py
holds its steps; batch norm's synced gradients 2e-4 and its control above
1e-2, as test_batchnorm_control_and_bottleneck_terms holds them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.parallel import mesh as jmesh
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.parallel import _multiprocess_worker as worker
from ip_avsr_torch.parallel import mesh as tmesh
from tests import torch_scale_lib as lib

torch.set_num_threads(1)
RANKS = 4
# the counters chip_smoke reads, by name: (module, wrapper, attribute)
SPEC = {name: chip_smoke.KERNEL_COUNTERS[name]
        for name in ("delta", "lstm_fwd", "lstm_fwd_train", "lstm_bwd")}


@pytest.fixture(scope="module")
def ranks():
    with lib.pool(RANKS) as p:
        yield p


def _flagship(zoo, adenet):
    """adenet_v3 at tiny width and dropout 0, as the phase steps it (the
    mesh draws a padded batch's masks for its padded rows, as JAX does);
    its last encoder layer (6 wide) splits over model 2 and not over
    model 4."""
    cfg = zoo.adenet_v3(20, 6, 20, lstm_size=8, window=3, output_classes=5)
    streams = [adenet.StreamSpec(**{**s.__dict__, "encoder_shapes": (24, 16, 6),
                                    "encoder_nonlinearities": ("sigmoid", "sigmoid", "linear"),
                                    "dropout": 0.0})
               if s.encoder_shapes else adenet.StreamSpec(**{**s.__dict__, "dropout": 0.0})
               for s in cfg.streams]
    return adenet.AdeNetConfig(**{**cfg.__dict__, "streams": streams, "agg_dropout": 0.0})


def _bn(zoo, adenet):
    cfg = zoo.adenet_v1(12, 6, lstm_size=8, window=3, output_classes=4)
    s0 = adenet.StreamSpec(**{**cfg.streams[0].__dict__, "encoder_shapes": (10, 8, 6, 5),
                              "encoder_nonlinearities": ("sigmoid",) * 3 + ("linear",)})
    return adenet.AdeNetConfig(**{**cfg.__dict__, "streams": [s0, cfg.streams[1]]})


@functools.cache
def _params(mk):
    return lib.np_tree(jadenet.init_adenet_params(jax.random.PRNGKey(0), mk(jzoo, jadenet)))


def _batch(cfg, B, T, seed):
    return lib.ragged_batch(B, T, [s.input_dim for s in cfg.streams], cfg.output_classes,
                            seed=seed, min_len=2)


def _step_gaps_ok(g, grad_tol=2e-4):
    return (g["loss_rel"] <= 1e-5 and g["grad_rel"] <= grad_tol and g["param_abs"] <= 1e-6
            and g["zero_noise"] <= max(grad_tol, 1e-4))


# name: (options, mesh, B, T, T padded for the seq dim)
MESHES = {
    "data4_rows_padded": (dict(use_mesh=True), {"data": 4}, 10, 9, 9),
    "data2_model2": (dict(model_parallel=2), {"data": 2, "model": 2}, 10, 9, 9),
    "data1_model4": (dict(model_parallel=4), {"data": 1, "model": 4}, 10, 9, 9),
    "data2_seq2": (dict(sequence_parallel=2), {"data": 2, "seq": 2}, 12, 9, 10),
    "data1_seq4": (dict(sequence_parallel=4), {"data": 1, "seq": 4}, 12, 16, 16),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_step_and_launches_match_one_process(ranks, name):
    """Each of phase_scale4's meshes steps as one process does (its rows
    and frames padded as the phase pads them), every rank's launches those
    of one process but for row 2, which the sequence-parallel prefix never
    calls (its delta is torch ops over the halo)."""
    opts, mesh, B, T, padded = MESHES[name]
    cfg = _flagship(tzoo, tadenet)
    batch = _batch(cfg, B, T, seed=len(name))
    if padded != T:
        batch = chip_smoke.pad_frames(batch, padded)
        assert batch[0][0].shape[1] == padded and not batch[2][:, T:].any()
    params = _params(_flagship)
    ref = worker.chip_step(SPEC, cfg, params, batch, {}, device="cpu")
    assert ref["launches"] == {"delta": 1, "lstm_fwd": 0, "lstm_fwd_train": 5, "lstm_bwd": 5}
    want = dict(ref["launches"], delta=0) if "seq" in mesh else ref["launches"]
    for got in ranks.run(worker.chip_step, SPEC, cfg, params, batch, opts, ref["result"],
                         device="cpu"):
        assert got["mesh"] == mesh and got["world"] == RANKS
        assert _step_gaps_ok(got["gaps"]), got["gaps"]
        assert got["launches"] == want


@pytest.mark.parametrize("opts", [dict(model_parallel=4), dict(sequence_parallel=4)],
                         ids=["model4", "seq4"])
def test_four_way_step_matches_jax(ranks, opts):
    """model_parallel=4 (data 1 x model 4) keeps column blocks of the
    layers 4 divides and the whole 6-wide last layer, as JAX's
    param_shardings demotes it; sequence_parallel=4 (data 1 x seq 4) at
    T = 16 (T_local 4 >= window 3); each step equals one process and the
    JAX package's."""
    jcfg, tcfg = _flagship(jzoo, jadenet), _flagship(tzoo, tadenet)
    params = _params(_flagship)
    batch = _batch(tcfg, 8, 16, seed=3)
    if "model_parallel" in opts:
        specs = lambda sh: [tuple(s.spec) for s in jax.tree_util.tree_leaves(  # noqa: E731
            sh, is_leaf=lambda x: hasattr(x, "spec"))]
        got_sh = tmesh.param_shardings(params, tmesh.Mesh({"data": 1, "model": 4}))
        assert specs(got_sh) == specs(jmesh.param_shardings(
            params, jmesh.make_mesh_nd({"data": 2, "model": 4})))
        enc = got_sh["streams"]["raw"]["encoder"]
        assert tuple(enc["fc1"]["w"].spec) == (None, "model") and tuple(enc["fc3"]["w"].spec) == ()
    step = dict(opts, optimizer="momentum")
    single = worker.trainer_step(tcfg, dict(optimizer="momentum"), params, batch)
    jt = jtr.Trainer(jcfg, jtr.TrainOptions(optimizer="momentum", learning_rate=1e-3,
                                            log_fn=lambda *_: None))
    p0 = jax.tree_util.tree_map(jnp.asarray, params)
    jp, _, jloss = jt.train_step(p0, jt.optimizer.init(p0), *jt._device_batch(*batch),
                                 jax.random.PRNGKey(3), jnp.asarray(1e-3, jnp.float32))
    for got in ranks.run(worker.trainer_step, tcfg, step, params, batch):
        if "model_parallel" in opts:
            enc = got["local_params"]["streams"]["raw"]["encoder"]
            assert enc["fc1"]["w"] == (20, 6) and enc["fc3"]["w"] == (16, 6)
        for ref_loss, ref_params in ((single["loss"], single["params"]),
                                     (float(jloss), lib.np_tree(jp))):
            assert got["loss"] == pytest.approx(ref_loss, rel=1e-5)
            lib.assert_trees_close(got["params"], ref_params, atol=1e-6, rtol=1e-4)
        lib.assert_trees_close(got["grads"], single["grads"], atol=1e-7, rtol=2e-4)


def test_sequence_parallel_4_refuses_a_short_stream_as_jax(ranks):
    """seq 4 at the flagship's T = 29 (padded to 32: T_local 8 < window 9)
    raises the JAX trainer's message, which chip_smoke.SP4_REFUSAL holds;
    T = 29 at seq 2 pads to 30 and T = 48 at seq 4 stays 48."""
    tcfg = tzoo.adenet_v3(1144, 90, 1144)
    jt = jtr.Trainer(jzoo.adenet_v3(1144, 90, 1144),
                     jtr.TrainOptions(sequence_parallel=4, log_fn=lambda *_: None))
    with pytest.raises(ValueError) as err:
        jt._sp_max_t(np.array([29, 20]))
    assert str(err.value) == chip_smoke.SP4_REFUSAL
    for sp, lens, want in ((4, [29, 20], chip_smoke.SP4_REFUSAL), (2, [29, 20], 30),
                           (4, [48, 30], 48)):
        assert ranks.run(worker.sp_max_t, tcfg, dict(sequence_parallel=sp), lens) == [want] * 4


@pytest.mark.parametrize("opts", [dict(use_mesh=True), dict(sequence_parallel=2)],
                         ids=["data4", "data2_seq2"])
def test_synced_batchnorm_and_its_control(ranks, opts):
    """adenet_v1's step with batch norm synced over data 4 and over data 2
    x seq 2 (frames padded to 10) equals one process; the control, each
    rank's block normalised with its own statistics
    (``local_bn_statistics``, which both forwards reach), does not."""
    cfg = _bn(tzoo, tadenet)
    params = _params(_bn)
    batch = chip_smoke.pad_frames(_batch(cfg, 16, 9, seed=6), 10)
    zero = ["/streams/raw/encoder/bottleneck/b"]
    ref = worker.chip_step(SPEC, cfg, params, batch, {}, device="cpu")["result"]
    synced = ranks.run(worker.chip_step, SPEC, cfg, params, batch, opts, ref, zero, device="cpu")
    control = ranks.run(worker.chip_step, SPEC, cfg, params, batch, opts, ref, zero,
                        device="cpu", local_bn=True)
    for got, ctl in zip(synced, control):
        assert _step_gaps_ok(got["gaps"]), got["gaps"]
        assert ctl["gaps"]["grad_rel"] > 1e-2


def test_collectives_take_tensors_in_permuted_strides(ranks):
    """A transposed tensor through ppermute (and its backward, whose
    cotangent is transposed too) and all_gather: nccl and gloo send and
    receive contiguous tensors only, and gloo refused the exchange's
    permuted receive buffer."""
    rng = np.random.RandomState(0)
    a = rng.randn(RANKS, 3, 4).astype(np.float32)
    w = rng.randn(RANKS, 3, 4).astype(np.float32)
    gathered = np.concatenate([x.T for x in a], axis=0)
    for k, got in enumerate(ranks.run(worker.strided_collectives, a, w)):
        np.testing.assert_array_equal(got["y"], a[k - 1].T if k else np.zeros((4, 3)))
        np.testing.assert_array_equal(got["grad"], w[k + 1] if k < RANKS - 1 else 0 * w[k])
        np.testing.assert_array_equal(got["gathered"], gathered)


def test_counted_on_cpu_counts_each_wrapper_call_and_restores():
    """On the CPU a wrapper's call counts as its launch while
    ``counted_on_cpu`` is active: a served tiny flagship counts 5
    inference recurrences and 1 grouped delta, and the wrappers are
    restored after."""
    from ip_avsr_torch import serve as tserve
    from ip_avsr_torch.ops import lstm as lstm_ops
    from ip_avsr_torch.ops.kernels import delta as delta_kernel

    before = (lstm_ops.lstm_recurrence, delta_kernel.append_delta_group)
    cfg = _flagship(tzoo, tadenet)
    streams, _, mask = _batch(cfg, 4, 9, seed=1)
    server = tserve.make_server(lib.torch_tree(_params(_flagship)), cfg, device="cpu")
    counters = worker._counters(SPEC)
    with worker.counted_on_cpu(SPEC):
        _, launches = worker._launched(counters, lambda: server(streams, mask))
    assert launches == {"delta": 1, "lstm_fwd": 5, "lstm_fwd_train": 0, "lstm_bwd": 0}
    assert (lstm_ops.lstm_recurrence, delta_kernel.append_delta_group) == before
