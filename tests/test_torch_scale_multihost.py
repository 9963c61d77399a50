"""Two-process runs of the port (tests/test_multiprocess.py's case, tier-1
here: gloo ranks start in about a second), served scores over a mesh, the
``nstream`` CLI's mesh flags, and the launcher itself.

* The JAX worker's multihost case (``parallel/_multiprocess_worker``): each
  rank contributes its rows of the global batch through
  ``TrainOptions(multihost=True)``; the step's and the eval's losses equal
  one process's and the JAX package's (1e-5 relative), and a short multihost
  fit (device-side evaluation) runs.
* ``serve.make_server(mesh=)``: the scores equal one device's and JAX's
  (2e-5), and a batch the mesh does not divide raises JAX's error.
* ``cli.nstream --mesh`` and the other mesh flags reach ``TrainOptions`` and
  train on the ranks; the data-parallel fit equals the one-process fit.
* ``utils/cpu_mesh``: a rank that raises, and a task past its deadline,
  make the call raise and end the ranks.
"""

import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu import serve as jserve
from ip_avsr_tpu.models import adenet as jadenet
from ip_avsr_tpu.parallel import _multiprocess_worker as jworker
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch import serve as tserve
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.parallel import _multiprocess_worker as worker
from ip_avsr_torch.utils import cpu_mesh
from tests import torch_scale_lib as lib

torch.set_num_threads(1)
RANKS = 2


@pytest.fixture(scope="module")
def ranks():
    with lib.pool(RANKS) as p:
        yield p


def test_two_process_multihost_step_matches_single_process(ranks):
    cfg, jparams, (x, y, mask) = jworker.make_case()
    params = lib.np_tree(jparams)
    np.testing.assert_array_equal(worker.make_case(params)[2][0], x)
    jt = jtr.Trainer(cfg, jtr.TrainOptions(optimizer="momentum", learning_rate=1e-3,
                                           log_fn=lambda *_: None))
    dev = jt._device_batch([x], y, mask)
    eval_loss = float(jt.eval_cost(jparams, *dev))
    p0 = jax.tree_util.tree_map(jnp.array, jparams)
    _, _, train_loss = jt.train_step(p0, jt.optimizer.init(p0), *dev, jax.random.PRNGKey(3),
                                     jnp.asarray(1e-3, jnp.float32))
    single = worker.multihost_step(params)
    assert single["process_count"] == 1 and single["local_rows"] == 16
    got = ranks.run(worker.multihost_step, params)
    for r, res in enumerate(got):
        assert res["process_count"] == RANKS and res["local_rows"] == 16 // RANKS
        for ref in (single, {"train_loss": float(train_loss), "eval_loss": eval_loss}):
            assert res["train_loss"] == pytest.approx(ref["train_loss"], rel=1e-5)
            assert res["eval_loss"] == pytest.approx(ref["eval_loss"], rel=1e-5)
        assert np.isfinite(res["fit_cost_val"]).all() and len(res["fit_cost_val"]) == 2
        np.testing.assert_allclose(res["fit_cost_val"], single["fit_cost_val"], rtol=1e-4)
        assert res["fit_test_cr"] == got[0]["fit_test_cr"]
    # the JAX worker's corpus, seeds included
    for a, b in zip(jax.tree_util.tree_leaves(jworker.make_corpus()),
                    jax.tree_util.tree_leaves(worker.make_corpus())):
        np.testing.assert_array_equal(a, b)


def test_multihost_rows_per_process(ranks):
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    for r, got in enumerate(ranks.run(worker.multihost_rows, 16)):
        assert got["slice"] == (8 * r, 8 * r + 8)
        np.testing.assert_array_equal(got["local"], x[8 * r: 8 * r + 8])
        assert got["error"].startswith("global batch 17 must be a multiple of the process "
                                       "count 2")


def test_make_server_over_two_ranks(ranks):
    jcfg = jworker.make_case()[0]
    tcfg = tzoo.lstm_classifier_majority_vote(10, lstm_size=8, output_classes=4)
    jparams = jadenet.init_adenet_params(jax.random.PRNGKey(1), jcfg)
    params = lib.np_tree(jparams)
    streams, _, mask = lib.ragged_batch(6, 7, (10,), 4, seed=2)
    want = tserve.make_server(lib.torch_tree(params), tcfg, device="cpu")(streams, mask).numpy()
    jwant = np.asarray(jserve.make_server(jparams, jcfg)(streams, mask))
    np.testing.assert_allclose(want, jwant, rtol=0, atol=2e-5)
    for got in ranks.run(worker.serve, tcfg, params, streams, mask):
        np.testing.assert_allclose(got["scores"], want, rtol=0, atol=2e-5)
        assert got["error"] == ("batch 3 must be divisible by the mesh size 2 (pad rows with "
                                "a zero mask)")


NSTREAM = ["--config", "configs/synthetic_1stream.ini", "--synthetic", "30", "--num_epoch", "2",
           "--device", "cpu"]
FLAGS = {"mesh": (["--mesh"], {"data": 2}),
         "shard_map": (["--mesh", "--mesh_mode", "shard_map"], {"data": 2}),
         "zero1": (["--zero1"], {"data": 2}),
         "model_parallel": (["--model_parallel", "2"], {"data": 1, "model": 2}),
         "sequence_parallel": (["--sequence_parallel", "2"], {"data": 1, "seq": 2})}


@pytest.fixture(scope="module")
def nstream_one_process():
    return worker.nstream_options(NSTREAM)


@pytest.mark.parametrize("flag", sorted(FLAGS))
def test_nstream_mesh_flags_train(ranks, nstream_one_process, flag):
    """Each mesh flag reaches the Trainer's options, the ranks train on the
    mesh it builds, and the fit tracks the one-process fit (the data-parallel
    ones within 1e-5)."""
    argv, mesh = FLAGS[flag]
    got = ranks.run(worker.nstream_options, NSTREAM + argv)
    opts = got[0]["options"]
    assert opts["use_mesh"] == ("--mesh" in argv)
    assert opts["zero1"] == ("--zero1" in argv)
    assert opts["mesh_mode"] == (argv[2] if "--mesh_mode" in argv else "gspmd")
    assert opts["model_parallel"] == mesh.get("model", 1)
    assert opts["sequence_parallel"] == mesh.get("seq", 1)
    ref = nstream_one_process["cost_val"]
    for res in got:
        assert res["mesh"] == mesh and res["cost_val"] == got[0]["cost_val"]
        tol = 1e-5 if flag in ("mesh", "shard_map") else 1e-3
        np.testing.assert_allclose(res["cost_val"], ref, rtol=tol)


def test_nstream_mesh_flag_on_one_process(nstream_one_process):
    """Without torchrun's environment ``--mesh`` runs the one-process mesh."""
    got = worker.nstream_options(NSTREAM + ["--mesh"])
    assert got["options"]["use_mesh"] and got["mesh"] == {"data": 1}
    np.testing.assert_allclose(got["cost_val"], nstream_one_process["cost_val"], rtol=1e-6)


def test_launcher_raises_for_a_failed_or_late_rank():
    with pytest.raises(RuntimeError, match="failed on rank"):
        cpu_mesh.spawn_ranks(2, math.sqrt, -1.0, backend="gloo", timeout_s=30)
    with cpu_mesh.RankPool(2, backend="gloo", timeout_s=30) as pool:
        assert pool.run(torch.distributed.get_rank) == [0, 1]
        pool.timeout_s = 1.0
        with pytest.raises(TimeoutError, match="not every rank of 2 answered"):
            pool.run(time.sleep, 20)
        assert pool._procs is None  # the ranks were ended
