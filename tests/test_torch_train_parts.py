"""The port's copies of the trainer's host-side parts against the JAX
package's originals, on the CPU: ``utils/data_structures``,
``utils/regularization``, ``data/datagen``, ``data/prefetch``,
``train/evaluation``, ``ops/voting.masked_majority_vote``, the losses'
``return_parts``, and ``train/checkpoints``.

The numpy copies must give bitwise the JAX package's arrays and decisions
for the same inputs and ``RandomState``; the losses' parts agree within
1e-6 relative (float32).  A subprocess checks that none of these modules
pulls ``jax`` or ``ip_avsr_tpu`` in.
"""

import subprocess
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from ip_avsr_tpu.data import datagen as jdata, prefetch as jprefetch
from ip_avsr_tpu.ops import losses as jlosses, voting as jvoting
from ip_avsr_tpu.train import evaluation as jeval
from ip_avsr_tpu.utils import data_structures as jds, regularization as jreg
from ip_avsr_torch.data import datagen as tdata, prefetch as tprefetch
from ip_avsr_torch.ops import losses as tlosses, voting as tvoting
from ip_avsr_torch.train import checkpoints as tckpt, evaluation as teval
from ip_avsr_torch.utils import data_structures as tds, regularization as treg

torch.set_num_threads(1)
costs = st.lists(st.floats(0.0, 3.0, allow_nan=False, width=32), max_size=12)


@settings(max_examples=60, deadline=None)
@given(size=st.integers(1, 7), items=costs, init=st.one_of(st.none(), st.floats(0, 1)),
       pops=st.integers(0, 3), index=st.integers(-3, 2))
def test_circular_list_matches_jax(size, items, init, pops, index):
    a, b = tds.CircularList(size, init), jds.CircularList(size, init)
    for v in items:
        a.push(v)
        b.push(v)
    for _ in range(pops):
        assert a.pop() == b.pop()
    assert list(a) == list(b) and len(a) == len(b) and a.max_size == b.max_size
    if -len(b) <= index < len(b):
        assert a[index] == b[index]
        a[index] = b[index] = -1.0
        assert list(a) == list(b)


@settings(max_examples=100, deadline=None)
@given(window=costs, best=st.floats(0.0, 3.0, width=32), threshold=st.integers(1, 8))
def test_early_stop_rules_match_jax(window, best, threshold):
    w = tds.CircularList(max(len(window), 1))
    for v in window:
        w.push(v)
    assert treg.early_stop(w) == jreg.early_stop(window)
    assert treg.early_stop2(w, best, threshold) == jreg.early_stop2(window, best, threshold)


@pytest.mark.parametrize("threshold", [1, 2, 3, 6])
def test_early_stop2_sweep_of_windows(threshold):
    """Every window of 6 over a rising-then-falling cost curve."""
    curve = [1.0, 0.8, 0.7, 0.75, 0.9, 1.1, 0.6, 0.65, 0.7, 0.72, 0.8, 0.5]
    for end in range(len(curve) + 1):
        window = curve[max(0, end - 6):end]
        best = min(curve[:end]) if end else float("inf")
        assert treg.early_stop2(window, best, threshold) == jreg.early_stop2(window, best,
                                                                            threshold)
        assert treg.early_stop(window) == jreg.early_stop(window)


def _split(seed, n=13, dims=(5, 3)):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, 10, n)
    streams = [rng.randn(int(lens.sum()), D).astype(np.float32) for D in dims]
    y = np.repeat(rng.randint(0, 4, n), lens)
    return streams, y, lens


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        elif x is None:
            assert y is None
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("max_timesteps", [None, 6])
@pytest.mark.parametrize("pad_to", [None, 9])
def test_padded_dataset_matches_jax(max_timesteps, pad_to):
    streams, y, lens = _split(0)
    a = tdata.PaddedDataset(streams, y, lens, max_timesteps=max_timesteps)
    b = jdata.PaddedDataset(streams, y, lens, max_timesteps=max_timesteps)
    _same([a.dense, a.y, a.mask], [b.dense, b.y, b.mask])
    idxs = np.random.RandomState(1).permutation(13)[:7]
    _same(list(a.gather(idxs, pad_to=pad_to)), list(b.gather(idxs, pad_to=pad_to)))
    ra, rb = np.random.RandomState(2), np.random.RandomState(2)
    for ba, bb in zip(a.epoch_batches(4, rng=ra), b.epoch_batches(4, rng=rb)):
        _same(list(ba), list(bb))
    assert tdata.compute_integral_len(lens) == jdata.compute_integral_len(lens)


@pytest.mark.parametrize("boundaries", [None, [4, 7, 9], [3, 5]])
@pytest.mark.parametrize("pad_to", [None, 6])
def test_bucketed_dataset_matches_jax(boundaries, pad_to):
    streams, y, lens = _split(3, n=20)
    a = tdata.BucketedDataset(streams, y, lens, boundaries=boundaries)
    b = jdata.BucketedDataset(streams, y, lens, boundaries=boundaries)
    assert a.boundaries == b.boundaries and a.n == b.n
    assert a.padded_frame_fraction() == b.padded_frame_fraction()
    ra, rb = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(2):  # two epochs from one RandomState
        got = list(a.epoch_batches(5, rng=ra, pad_to=pad_to))
        ref = list(b.epoch_batches(5, rng=rb, pad_to=pad_to))
        assert len(got) == len(ref)
        for ga, gb in zip(got, ref):
            assert ga[0] == gb[0]
            _same(list(ga[1:]), list(gb[1:]))
    with pytest.raises(ValueError, match="ascending"):
        tdata.BucketedDataset(streams, y, lens, boundaries=[5, 3])


def test_prefetch_keeps_order_and_forwards_an_exception():
    def items():
        for i in range(7):
            yield i
        yield ValueError("a value, not an error")
        raise KeyError("producer failed")

    got, ref = [], []
    for out, module in ((got, tprefetch), (ref, jprefetch)):
        with pytest.raises(KeyError, match="producer failed"):
            for item in module.prefetch(items(), buffer_size=2):
                out.append(item)
    assert got[:7] == list(range(7)) and isinstance(got[7], ValueError)
    assert [type(x) for x in got] == [type(x) for x in ref]
    assert list(tprefetch.prefetch(iter(range(50)), buffer_size=3)) == list(range(50))
    with pytest.raises(ValueError):
        next(tprefetch.prefetch([1], buffer_size=0))


def test_prefetch_stops_the_producer_when_abandoned():
    done = threading.Event()

    def forever():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            done.set()

    it = tprefetch.prefetch(forever(), buffer_size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert done.wait(timeout=10)


def _probs(seed, B=9, T=6, C=4):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(C), size=(B, T)).astype(np.float32)
    probs[0, :, 1] = probs[0, :, 2] = 0.9  # ties go to the lower class
    lens = rng.randint(0, T + 1, B)
    lens[1] = 0
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    y = rng.randint(0, C, B)
    return probs, mask, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluation_matches_jax(seed):
    probs, mask, y = _probs(seed)
    np.testing.assert_array_equal(tvoting.masked_majority_vote(probs, mask),
                                  jvoting.masked_majority_vote(probs, mask))
    for got, ref in ((teval.evaluate_majority_vote(probs, y, mask),
                      jeval.evaluate_majority_vote(probs, y, mask)),
                     (teval.evaluate_last_step(probs[:, -1], y),
                      jeval.evaluate_last_step(probs[:, -1], y))):
        assert got[0] == ref[0]
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    conf = teval.confusion_matrix(y, probs[:, 0].argmax(-1), 4)
    np.testing.assert_array_equal(conf, jeval.confusion_matrix(y, probs[:, 0].argmax(-1), 4))
    assert teval.cr_from_confusion(conf) == jeval.cr_from_confusion(conf)
    assert teval.cr_from_confusion(np.zeros((3, 3))) == 0.0
    names = ["a", "b", "c", "d"]
    for fmt in ("pipe", "latex"):
        assert (teval.plot_confusion_matrix(conf, names, fmt)
                == jeval.plot_confusion_matrix(conf, names, fmt))
    with pytest.raises(ValueError):
        teval.plot_confusion_matrix(conf, names, "html")


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_on_device_equals_host_matrix(seed):
    probs, mask, y = _probs(seed)
    preds = jvoting.masked_majority_vote(probs, mask)
    valid = (mask.sum(1) > 0).astype(np.float32)
    got = teval.confusion_on_device(torch.from_numpy(preds), torch.from_numpy(y),
                                    torch.from_numpy(valid), 4)
    ref = np.asarray(jeval.confusion_on_device(jnp.asarray(preds), jnp.asarray(y),
                                               jnp.asarray(valid), 4))
    np.testing.assert_array_equal(got.numpy(), ref)
    host = teval.confusion_matrix(y[valid > 0], preds[valid > 0], 4)
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("parts", [False, True])
def test_loss_parts_match_jax(parts):
    probs, mask, y = _probs(5)
    y2d = np.repeat(y[:, None], probs.shape[1], axis=1)
    got = tlosses.temporal_softmax_loss(torch.from_numpy(probs), torch.from_numpy(y2d),
                                        torch.from_numpy(mask), return_parts=parts)
    ref = jlosses.temporal_softmax_loss(jnp.asarray(probs), jnp.asarray(y2d),
                                        jnp.asarray(mask), return_parts=parts)
    np.testing.assert_allclose(np.array([float(v) for v in np.atleast_1d(got)]),
                               np.array([float(v) for v in np.atleast_1d(ref)]), rtol=1e-6)
    last = probs[:, -1]
    last[1] = np.eye(4)[(y[1] + 1) % 4]  # an all-pad row whose p[y] is 0
    w = (mask.sum(1) > 0)
    got = tlosses.categorical_crossentropy_masked(torch.from_numpy(last), torch.from_numpy(y),
                                                  torch.from_numpy(w), return_parts=parts)
    ref = jlosses.categorical_crossentropy_masked(jnp.asarray(last), jnp.asarray(y),
                                                  jnp.asarray(w), return_parts=parts)
    got = [float(v) for v in (got if parts else [got])]
    ref = [float(v) for v in (ref if parts else [ref])]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_checkpoint_round_trip(tmp_path):
    params = {"streams": {"s1": {"w": torch.randn(3, 4)}},
              "aggregator": [{"fwd": {"b": torch.zeros(5)}}]}
    state = {"m": {"streams": {"s1": {"w": torch.ones(3, 4)}},
                   "aggregator": [{"fwd": {"b": torch.ones(5)}}]},
             "t": torch.tensor(3.0)}
    extra = {"best_val": float("inf"), "best_cr": 0.5, "lr": np.float64(0.25),
             "cost_train": np.asarray([1.0, 0.5]), "val_window": np.asarray([0.7]),
             "train_strip": np.zeros(3), "best_params": params}
    d = str(tmp_path / "ck")
    path = tckpt.save_train_state(d, 4, params, state, extra)
    tckpt.save_train_state(d, 2, params, state)
    assert path.endswith("step_4") and tckpt.latest_step(d) == 4
    got = tckpt.restore_train_state(d, map_location="cpu")
    assert got["step"] == 4 and isinstance(got["step"], int)
    assert isinstance(got["params"]["aggregator"], list)
    torch.testing.assert_close(got["params"]["streams"]["s1"]["w"],
                               params["streams"]["s1"]["w"])
    torch.testing.assert_close(got["opt_state"]["t"], torch.tensor(3.0))
    assert got["extra"]["best_val"] == float("inf") and got["extra"]["lr"] == 0.25
    np.testing.assert_array_equal(got["extra"]["cost_train"].numpy(), [1.0, 0.5])
    assert tckpt.restore_train_state(d, step=2)["extra"] == {}
    # the file loads with weights_only=True, as restore_train_state reads it
    torch.load(f"{path}/state.pt", weights_only=True)


def test_missing_checkpoints_return_none(tmp_path):
    assert tckpt.restore_train_state(str(tmp_path), step=99) is None
    assert tckpt.restore_train_state(str(tmp_path / "absent")) is None
    assert tckpt.latest_step(str(tmp_path / "absent")) is None
    (tmp_path / "step_x").mkdir()
    assert tckpt.latest_step(str(tmp_path)) is None


def test_trainer_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import ip_avsr_torch.train.trainer, ip_avsr_torch.train.checkpoints, "
        "ip_avsr_torch.train.evaluation, ip_avsr_torch.train.optimizers, "
        "ip_avsr_torch.data.datagen, ip_avsr_torch.data.prefetch, "
        "ip_avsr_torch.utils.data_structures, ip_avsr_torch.utils.regularization, "
        "ip_avsr_torch.io.matio, ip_avsr_torch.data.preprocessing, "
        "ip_avsr_torch.cli.nstream, ip_avsr_torch.cli.trimodal, "
        "ip_avsr_torch.cli.separate_train, ip_avsr_torch.cli.extract_weights, "
        "ip_avsr_torch.cli.evaluate_delta_features, ip_avsr_torch.cli.leave_one_out, "
        "ip_avsr_torch.cli.audio_visual, ip_avsr_torch.models.avnet, "
        "ip_avsr_torch.models.zoo, ip_avsr_torch.ops.normalization, "
        "ip_avsr_torch.ops.pooling, ip_avsr_torch.ops.lcn, ip_avsr_torch.serve, "
        "ip_avsr_torch.export, ip_avsr_torch.pretrain.rbm, ip_avsr_torch.pretrain.dbn, "
        "ip_avsr_torch.pretrain.unfold, ip_avsr_torch.pretrain.finetune, "
        "ip_avsr_torch.pretrain.sde, ip_avsr_torch.models.convae, "
        "ip_avsr_torch.cli.pretrain_dbn, ip_avsr_torch.cli.ae_finetuner, "
        "ip_avsr_torch.cli.convae, ip_avsr_torch.native, ip_avsr_torch.utils.plotting, "
        "ip_avsr_torch.utils.draw_net, ip_avsr_torch.utils.ffmpeg, "
        "ip_avsr_torch.data.segmentation, ip_avsr_torch.data.dct_matlab, "
        "ip_avsr_torch.data.landmarking, ip_avsr_torch.cli.confusion_visualizer, "
        "ip_avsr_torch.cli.parity_check, ip_avsr_torch.cli.prepare_data, "
        "ip_avsr_torch.cli.landmark, ip_avsr_torch.cli.playvid, "
        "ip_avsr_torch.reference_impl, ip_avsr_torch.models.resnet, "
        "ip_avsr_torch.reference_lipread\n"
        "import sys\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('jaxlib') or m.startswith('ip_avsr_tpu')]\n"
        "assert not bad, bad\n")
    root = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the numpy oracle, loaded from its file alone, imports no other module
    # of the port (and no torch until torch_tree_to_np meets a tensor)
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('oracle', "
        "'ip_avsr_torch/reference_impl.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('ip_avsr_torch', 'ip_avsr_tpu', 'jax', 'jaxlib', 'torch')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # the lipreader's plain reference, loaded from its file alone, imports
    # no module of the port (torch alone)
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('lipread_ref', "
        "'ip_avsr_torch/reference_lipread.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('ip_avsr_torch', 'ip_avsr_tpu', 'jax', 'jaxlib')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
