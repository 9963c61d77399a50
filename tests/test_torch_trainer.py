"""The port's Trainer (ip_avsr_torch/train/trainer.py) against the JAX
Trainer (ip_avsr_tpu/train/trainer.py) on the CPU: whole fits from the same
parameters on the same seeded splits, dropout 0, with the tolerances of
tests/torch_trainer_lib.py (costs 1e-5 relative, rates and confusion
matrices equal, best parameters 1e-5 of each leaf's max abs).  On the CPU
the JAX fits take their XLA scans, the port its plain loops.

Cases: both heads; the reference trimodal schedule (adadelta, lr 1.0, decay,
early stopping); adam_vlr with an lr map; gradient accumulation (also
against the full-batch step); bucketed batches; device-resident data and
device-side evaluation against the host paths; chunked evaluation; the
refusals; and each mesh option's step on two gloo ranks.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.models import adenet as jadenet, zoo as jzoo
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch import bridge
from ip_avsr_torch.data.datagen import PaddedDataset
from ip_avsr_torch.models import adenet as tadenet, zoo as tzoo
from ip_avsr_torch.parallel import _multiprocess_worker as worker
from ip_avsr_torch.train import trainer as ttr
from tests import torch_scale_lib as scale_lib
from tests import torch_trainer_lib as lib

torch.set_num_threads(1)


@pytest.mark.parametrize("head", ["per_step", "last_step"])
def test_fit_matches_jax(head):
    if head == "per_step":
        cfgs, dims = (lib.per_step_config(jzoo), lib.per_step_config(tzoo)), lib.PER_STEP_DIMS
    else:
        cfgs, dims = (lib.flagship_config(jzoo), lib.flagship_config(tzoo)), lib.FLAGSHIP_DIMS
    jr, tr, _, _ = lib.fit_both(jtr, ttr, *cfgs, dims, optimizer="adam")
    assert tr.epochs_run == 3
    lib.assert_results_match(jr, tr)


def test_fit_trimodal_schedule_matches_jax():
    """configs/oulu_trimodal.ini's schedule on the tiny flagship: adadelta at
    lr 1.0 with decay 0.1 from epoch 2; validation_window 2 and a validation
    split whose targets are shifted by one class, so its cost turns up as
    training fits and early_stop2 ends the run before num_epoch."""
    logs = {"jax": [], "port": []}
    jr, tr, _, _ = lib.fit_both(
        jtr, ttr, lib.flagship_config(jzoo), lib.flagship_config(tzoo), lib.FLAGSHIP_DIMS,
        jax_kw={"log_fn": logs["jax"].append}, port_kw={"log_fn": logs["port"].append},
        optimizer="adadelta", learning_rate=1.0, decay_rate=0.1, decay_start=2,
        num_epoch=12, epochsize=4, validation_window=2, val_shift=1)
    assert tr.epochs_run < 12, tr.cost_val  # early stopping fired
    assert tr.final_lr == pytest.approx(0.9 ** (tr.epochs_run - 1), rel=1e-12)
    lib.assert_results_match(jr, tr)
    # the same epoch lines, timings aside
    strip = [[line.rsplit(" (", 1)[0] for line in logs[k]] for k in ("jax", "port")]
    assert strip[0] == strip[1]


def test_fit_adam_vlr_matches_jax():
    lr_map = {"output": 0.05, "aggregator/0/bwd": 0.001, "streams/s1/encoder": 0.02}
    jr, tr, _, _ = lib.fit_both(
        jtr, ttr, lib.per_step_config(jzoo), lib.per_step_config(tzoo), lib.PER_STEP_DIMS,
        optimizer="adam_vlr", lr_map_config=lr_map, decay_rate=0.5, decay_start=1)
    lib.assert_results_match(jr, tr)
    np.testing.assert_allclose(tr.final_lr, 0.01 * 0.5 ** 3)


def test_fit_grad_accum_matches_jax():
    jr, tr, _, _ = lib.fit_both(
        jtr, ttr, lib.flagship_config(jzoo), lib.flagship_config(tzoo), lib.FLAGSHIP_DIMS,
        optimizer="momentum", batchsize=6, grad_accum_steps=2)
    lib.assert_results_match(jr, tr)


def test_grad_accum_step_equals_full_batch_step():
    """K = 3 microbatches of an uneven batch (an all-pad row, ragged rows)
    give the full batch's loss and update, float32 sums in another order."""
    cfg = lib.flagship_config(tzoo)
    params = tadenet.init_adenet_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    rng = np.random.RandomState(3)
    B, T = 6, 7
    streams = [torch.from_numpy(rng.randn(B, T, D).astype(np.float32))
               for D in lib.FLAGSHIP_DIMS]
    lens = np.array([7, 3, 0, 5, 1, 6])
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, lib.CLASSES, B)).long()
    out = []
    for k in (1, 3):
        trainer = ttr.Trainer(cfg, lib.quiet_options(ttr, batchsize=B, grad_accum_steps=k,
                                                     optimizer="momentum"), device="cpu")
        out.append(trainer.train_step(params, trainer.optimizer.init(params), streams, y,
                                      mask, None, 0.01))
    (p1, _, l1), (p3, _, l3) = out
    np.testing.assert_allclose(float(l3), float(l1), rtol=1e-6)
    lib.assert_params_close(p3, lib.bridge_numpy(p1), tol=1e-6)


def test_fit_bucketed_matches_jax():
    logs = {"jax": [], "port": []}
    jr, tr, _, _ = lib.fit_both(
        jtr, ttr, lib.per_step_config(jzoo), lib.per_step_config(tzoo), lib.PER_STEP_DIMS,
        jax_kw={"log_fn": logs["jax"].append}, port_kw={"log_fn": logs["port"].append},
        bucket_boundaries="auto", epochsize=5)
    lib.assert_results_match(jr, tr)
    assert logs["port"][0] == logs["jax"][0]
    assert logs["port"][0].startswith("bucketed batches: boundaries=")


def _port_fit(data, params_np, cfg=None, **kw):
    cfg = cfg or lib.per_step_config(tzoo)
    return lib.port_trainer(ttr, cfg, lib.quiet_options(ttr, **kw), params_np).fit(*data)


@pytest.fixture(scope="module")
def per_step_start():
    """The per-step model's JAX initial parameters and splits of 19, 7 and 7
    (19 % 5 != 0, so the last batch of each pass is padded)."""
    jt = jtr.Trainer(lib.per_step_config(jzoo), lib.quiet_options(jtr))
    data = [lib.data_of(lib.synthetic(n, lib.PER_STEP_DIMS, seed))
            for n, seed in ((19, 0), (7, 1), (7, 2))]
    return lib.jax_params(jt), data


@pytest.mark.parametrize("option", ["device_data", "device_eval"])
def test_device_paths_equal_host_path(per_step_start, option):
    params_np, data = per_step_start
    host = _port_fit(data, params_np, epochsize=4)
    dev = _port_fit(data, params_np, epochsize=4, **{option: True})
    np.testing.assert_allclose(dev.cost_train, host.cost_train, rtol=1e-6)
    np.testing.assert_allclose(dev.cost_val, host.cost_val, rtol=1e-6)
    assert dev.class_rate == host.class_rate and dev.test_cr == host.test_cr
    np.testing.assert_array_equal(dev.test_conf, host.test_conf)
    lib.assert_params_close(dev.best_params, lib.bridge_numpy(host.best_params), tol=1e-6)


def test_prefetch_off_equals_prefetch_on(per_step_start):
    params_np, data = per_step_start
    a = _port_fit(data, params_np)
    b = _port_fit(data, params_np, prefetch_batches=False)
    assert a.cost_train == b.cost_train and a.cost_val == b.cost_val


@pytest.mark.parametrize("device_eval", [False, True])
@pytest.mark.parametrize("eval_batchsize", [4, 7, 512])
def test_evaluate_matches_jax(per_step_start, device_eval, eval_batchsize):
    """Trainer.evaluate over a split of 11, whole or in chunks of 4 (the last
    padded) or 7, against the JAX Trainer's on the same parameters."""
    params_np, _ = per_step_start
    streams, y, lens = lib.synthetic(11, lib.PER_STEP_DIMS, 5, min_len=1)
    ds = PaddedDataset(streams, y, lens)
    s, yy, mask = ds.gather(np.arange(ds.n))
    mask[4] = 0  # an all-pad row is left out of the rate
    jt = jtr.Trainer(lib.per_step_config(jzoo),
                     lib.quiet_options(jtr, device_eval=device_eval))
    jcr, jconf = jt.evaluate(jax.tree_util.tree_map(jnp.asarray, params_np), s, yy, mask,
                             eval_batchsize=eval_batchsize)
    tt = ttr.Trainer(lib.per_step_config(tzoo),
                     lib.quiet_options(ttr, device_eval=device_eval), device="cpu")
    tparams = bridge.params_from_jax(params_np, device="cpu")
    tcr, tconf = tt.evaluate(tparams, s, yy, mask, eval_batchsize=eval_batchsize)
    assert tcr == jcr
    np.testing.assert_array_equal(tconf, np.asarray(jconf))
    assert tconf.sum() == 10
    dev = tt._device_batch(s, yy, mask)
    assert tt.evaluate(tparams, s, yy, mask, eval_batchsize=eval_batchsize, dev=dev)[0] == tcr


def test_options_fields_match_jax():
    assert ([f.name for f in dataclasses.fields(ttr.TrainOptions)]
            == [f.name for f in dataclasses.fields(jtr.TrainOptions)])
    assert ([f.name for f in dataclasses.fields(ttr.TrainResult)]
            == [f.name for f in dataclasses.fields(jtr.TrainResult)])


def _bn_config(module):
    cfg = lib.per_step_config(module)
    return dataclasses.replace(cfg, streams=[dataclasses.replace(cfg.streams[0],
                                                                 use_batchnorm=True)])


@pytest.mark.parametrize("case", ["lr_map_without_vlr", "accum_divides", "accum_bn",
                                  "mesh_mode"])
def test_refusals_match_jax(case):
    """Each ValueError of the JAX Trainer's constructor, with its message."""
    kw = {"lr_map_without_vlr": dict(lr_map_config={"output": 0.1}),
          "accum_divides": dict(batchsize=10, grad_accum_steps=3),
          "accum_bn": dict(grad_accum_steps=5),
          "mesh_mode": dict(mesh_mode="pjit")}[case]
    cfgs = ((_bn_config(jzoo), _bn_config(tzoo)) if case == "accum_bn"
            else (lib.per_step_config(jzoo), lib.per_step_config(tzoo)))
    with pytest.raises(ValueError) as jerr:
        jtr.Trainer(cfgs[0], lib.quiet_options(jtr, **kw))
    with pytest.raises(ValueError) as terr:
        ttr.Trainer(cfgs[1], lib.quiet_options(ttr, **kw), device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.fixture(scope="module")
def two_ranks():
    with scale_lib.pool(2) as pool:
        yield pool


@pytest.mark.parametrize("kw", [dict(use_mesh=True), dict(model_parallel=2),
                                dict(sequence_parallel=2), dict(zero1=True),
                                dict(multihost=True), dict(mesh_mode="shard_map")],
                         ids=lambda kw: next(iter(kw)))
def test_mesh_options_raise(two_ranks, kw):
    """Each mesh option trains: one step on two gloo ranks (multihost and
    shard_map with use_mesh) equals the one-process step from the same
    parameters on a ragged batch of 7 rows, padded to 8 on the mesh."""
    cfg = lib.per_step_config(tzoo)
    opts = dict(kw, optimizer="momentum", **({"use_mesh": True} if "multihost" in kw
                                             or "mesh_mode" in kw else {}))
    params = lib.jax_params(jtr.Trainer(lib.per_step_config(jzoo), lib.quiet_options(jtr)))
    rng = np.random.RandomState(4)
    x = rng.randn(7, 8, lib.PER_STEP_DIMS[0]).astype(np.float32)
    mask = (np.arange(8)[None] < np.array([8, 1, 5, 6, 8, 3, 4])[:, None]).astype(np.float32)
    batch = ([x], rng.randint(0, lib.CLASSES, 7).astype(np.int32), mask)
    single = worker.trainer_step(cfg, dict(optimizer="momentum"), params, batch, evaluate=False)
    for got in two_ranks.run(worker.trainer_step, cfg, opts, params, batch, evaluate=False):
        assert got["mesh"] is not None and np.prod(list(got["mesh"].values())) == 2
        assert got["loss"] == pytest.approx(single["loss"], rel=1e-5)
        scale_lib.assert_trees_close(got["params"], single["params"], atol=1e-6, rtol=1e-4)


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        assert ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(ttr)).device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(ttr))


def test_pretrained_encoders_seed_the_fit():
    """A CLI replaces init_params with pretrained encoders (JAX
    cli/trimodal.py): the port's init takes them as the JAX init does."""
    jcfg, tcfg = lib.flagship_config(jzoo), lib.flagship_config(tzoo)
    rng = np.random.RandomState(0)
    shapes = (6, 5, 4, 3, 2)
    pre = ([rng.randn(a, b) for a, b in zip(shapes, shapes[1:])],
           [rng.randn(b) for b in shapes[1:]])
    pretrained = [pre, None, pre]
    lstm = {k: rng.randn(*shape).astype(np.float32)
            for k, shape in (("w_in", (4, 16)), ("w_hid", (4, 16)), ("b", (16,)))}
    jp = jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg, pretrained,
                                    [None, lstm, None])
    tp = tadenet.init_adenet_params(torch.Generator().manual_seed(0), tcfg, device="cpu",
                                    pretrained_encoders=pretrained,
                                    pretrained_stream_lstms=[None, lstm, None])
    for name in ("raw", "diff"):
        lib.assert_params_close(tp["streams"][name]["encoder"],
                                jp["streams"][name]["encoder"], tol=0.0)
    lib.assert_params_close(tp["streams"]["dct"]["lstm"], jp["streams"]["dct"]["lstm"],
                            tol=0.0)
    assert jax.tree_util.tree_structure(lib.bridge_numpy(tp)) \
        == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, jp))
