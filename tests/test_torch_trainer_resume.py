"""The port's Trainer (ip_avsr_torch/train/trainer.py): NaN recovery, NaN
checks, checkpoint and resume, the profiler trace, against the JAX Trainer
where it has the same behaviour, on the CPU.  Tolerances as in
tests/torch_trainer_lib.py.

A resumed run reseeds its batch order and dropout with seed + the restored
epoch, as the JAX package does, so its later epochs draw other batches than
an uninterrupted run: it keeps the uninterrupted run's restored history and
learning-rate schedule, and it equals the JAX package's resume from the same
train state.
"""

import json
import os

import numpy as np
import jax
import pytest
import torch

from ip_avsr_tpu.models import zoo as jzoo
from ip_avsr_tpu.train import checkpoints as jckpt, trainer as jtr
from ip_avsr_torch import bridge
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.train import checkpoints as tckpt, trainer as ttr
from tests import torch_trainer_lib as lib

torch.set_num_threads(1)


def test_recover_on_nan_matches_jax():
    """An absurd momentum rate (as tests/test_trainer.py's recovery test):
    every epoch's cost is non-finite, so each restores the best (initial)
    parameters, resets the optimizer and halves the rate, in both."""
    logs = {"jax": [], "port": []}
    jr, tr, _, _ = lib.fit_both(
        jtr, ttr, lib.per_step_config(jzoo), lib.per_step_config(tzoo), lib.PER_STEP_DIMS,
        jax_kw={"log_fn": logs["jax"].append}, port_kw={"log_fn": logs["port"].append},
        learning_rate=1e25, optimizer="momentum", recover_on_nan=True, num_epoch=4)
    nonfinite = {k: [line.split(":")[0] for line in v if "non-finite" in line]
                 for k, v in logs.items()}
    assert nonfinite["port"] == nonfinite["jax"] == [f"Epoch {e}" for e in range(1, 5)]
    assert tr.final_lr == jr.final_lr == 1e25 * 0.5 ** 4
    assert tr.cost_train == [] and tr.best_val == float("inf")
    lib.assert_results_match(jr, tr)
    for leaf in jax.tree_util.tree_leaves(lib.bridge_numpy(tr.best_params)):
        assert np.isfinite(leaf).all()


def test_check_nans_raises_at_the_first_bad_step():
    data = [lib.data_of(s) for s in lib.splits(lib.PER_STEP_DIMS)]
    trainer = ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(
        ttr, learning_rate=1e25, optimizer="momentum", check_nans=True), device="cpu")
    # the first step moves the parameters by about 1e25 x the gradient,
    # still finite in float32; the second overflows
    with pytest.raises(FloatingPointError, match="epoch 1, step 2$"):
        trainer.fit(*data)
    # without check_nans the same run goes on to its end
    ok = ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(
        ttr, learning_rate=1e25, optimizer="momentum"), device="cpu").fit(*data)
    assert ok.epochs_run == 3


def test_profile_dir_writes_a_trace_even_when_fit_raises(tmp_path):
    data = [lib.data_of(s) for s in lib.splits(lib.PER_STEP_DIMS)]
    good = tmp_path / "good"
    ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(
        ttr, num_epoch=1, epochsize=1, profile_dir=str(good)), device="cpu").fit(*data)
    assert os.path.getsize(good / "trace.json") > 0
    with open(good / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {f"ip_avsr::train.{part}" for part in ("step", "forward", "backward",
                                                 "optimizer")} <= names
    bad = tmp_path / "bad"
    with pytest.raises(FloatingPointError):
        ttr.Trainer(lib.per_step_config(tzoo), lib.quiet_options(
            ttr, learning_rate=1e25, optimizer="momentum", check_nans=True,
            profile_dir=str(bad)), device="cpu").fit(*data)
    assert os.path.getsize(bad / "trace.json") > 0
    # the profiler was stopped: a new one can start
    with torch.profiler.profile():
        pass


@pytest.fixture(scope="module")
def start():
    jt = jtr.Trainer(lib.per_step_config(jzoo), lib.quiet_options(jtr))
    return lib.jax_params(jt)


def _decay_options(**kw):
    return lib.quiet_options(ttr, learning_rate=0.04, decay_start=1, decay_rate=0.5,
                             epochsize=2, **kw)


def test_resume_continues_history_and_lr_decay(tmp_path, start):
    data = [lib.data_of(s) for s in lib.splits(lib.PER_STEP_DIMS)]
    straight = lib.port_trainer(ttr, lib.per_step_config(tzoo),
                                _decay_options(num_epoch=5), start).fit(*data)
    ck = str(tmp_path / "ck")
    first = lib.port_trainer(ttr, lib.per_step_config(tzoo),
                             _decay_options(num_epoch=2, checkpoint_dir=ck), start).fit(*data)
    assert tckpt.latest_step(ck) == 2
    resumed = lib.port_trainer(ttr, lib.per_step_config(tzoo),
                               _decay_options(num_epoch=5, checkpoint_dir=ck, resume=True),
                               start).fit(*data)
    assert tckpt.latest_step(ck) == 5
    assert first.cost_train == straight.cost_train[:2]
    assert resumed.cost_train[:2] == straight.cost_train[:2]
    assert resumed.cost_val[:2] == straight.cost_val[:2]
    assert len(resumed.cost_val) == 5 and resumed.epochs_run == 5
    # the decay continued from the restored rate, not the base rate
    assert resumed.final_lr == straight.final_lr == 0.04 * 0.5 ** 5


def test_jax_train_state_resumes_in_port(tmp_path, start):
    """A JAX fit's orbax checkpoint, restored by the JAX package, carried
    across with bridge.params_from_jax and saved by the port: the port's
    resume equals the JAX package's resume from the same state (adadelta
    with decay, so the optimizer state and the rate carry over too)."""
    data = [lib.data_of(s) for s in lib.splits(lib.PER_STEP_DIMS)]
    kw = dict(optimizer="adadelta", learning_rate=1.0, decay_start=1, decay_rate=0.1)
    jck = str(tmp_path / "jax")
    jtr.Trainer(lib.per_step_config(jzoo),
                lib.quiet_options(jtr, num_epoch=2, checkpoint_dir=jck, **kw)).fit(*data)
    state = bridge.params_from_jax(jckpt.restore_train_state(jck), device="cpu")
    assert set(state["opt_state"]) == {"accu", "delta_accu"}
    tck = str(tmp_path / "port")
    tckpt.save_train_state(tck, int(state["step"]), state["params"], state["opt_state"],
                           state["extra"])
    jr = jtr.Trainer(lib.per_step_config(jzoo), lib.quiet_options(
        jtr, num_epoch=4, checkpoint_dir=jck, resume=True, **kw)).fit(*data)
    tr = lib.port_trainer(ttr, lib.per_step_config(tzoo), lib.quiet_options(
        ttr, num_epoch=4, checkpoint_dir=tck, resume=True, **kw), start).fit(*data)
    assert len(tr.cost_train) == 4
    lib.assert_results_match(jr, tr)


def test_best_params_is_a_snapshot(tmp_path, start):
    """On the CPU path best_params must not alias the live parameters: with a
    validation split whose cost rises from the first epoch, the best
    parameters are epoch 1's, as checkpointed, not the last epoch's."""
    data = [lib.data_of(s) for s in lib.splits(lib.PER_STEP_DIMS, val_shift=1)]
    ck = str(tmp_path / "ck")
    result = lib.port_trainer(ttr, lib.per_step_config(tzoo), lib.quiet_options(
        ttr, checkpoint_dir=ck, learning_rate=0.05), start).fit(*data)
    assert result.cost_val[0] == result.best_val < min(result.cost_val[1:])
    first = tckpt.restore_train_state(ck, step=1, map_location="cpu")["params"]
    last = tckpt.restore_train_state(ck, step=3, map_location="cpu")["params"]
    lib.assert_params_close(result.best_params, lib.bridge_numpy(first), tol=0.0)
    diffs = []
    jax.tree_util.tree_map(lambda a, b: diffs.append(np.abs(a - b).max()),
                           lib.bridge_numpy(result.best_params), lib.bridge_numpy(last))
    assert max(diffs) > 0
