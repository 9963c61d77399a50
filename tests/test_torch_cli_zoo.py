"""The port's ``cli.leave_one_out`` and ``cli.audio_visual`` against the JAX
package's, on the CPU at tiny widths.

* ``loo_split_ids`` equal to JAX's, and its refusal;
* what reaches ``Trainer.fit`` (every split's streams, targets and lengths,
  and the pretrained encoders in the initial parameters) equal bit for
  bit, with ``--synthetic`` and from ``.mat`` files (``chip_smoke.py``'s
  seeded corpus at 6 x 8 pixels: the trimodal INI pointed at it for
  leave_one_out, the images, MFCC (other lengths, so force-align pads),
  one autoencoder and the subject files for audio_visual);
* a whole ``--synthetic`` fit of each from JAX's initial parameters
  (``bridge.params_from_jax``; adenet_v5 at dropout 0 in both packages,
  avnet has none) within tests/torch_trainer_lib.py's tolerances, and the
  ``--results`` / ``--write_results`` lines: the same rates, the costs
  within 1e-5 relative.  The audio_visual CLI trains with Adam, whose
  step is about lr whatever a gradient's size: the visual encoder's first
  two biases take gradients of 1e-7 and below (sums that cancel) whose
  sign is float32 noise, so those elements part by up to 2 lr a step (6.8e-4
  after 12 steps at lr 1e-4, measured) and are held to that bound; every
  other leaf of the best parameters within 1e-3 of its max abs (5.2e-4
  measured on the visual LSTM's bias, a leaf of max abs 1e-3 that only
  Adam's steps moved).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu.cli import audio_visual as jav
from ip_avsr_tpu.cli import leave_one_out as jloo
from ip_avsr_tpu.models import zoo as jzoo
from ip_avsr_torch.cli import audio_visual as tav
from ip_avsr_torch.cli import leave_one_out as tloo
from ip_avsr_torch.models import zoo as tzoo
from tests import torch_trainer_lib as lib
from tests.test_torch_cli_train import assert_same, fit_inputs, run

torch.set_num_threads(1)

TINY = dict(n=30, imagesize=(6, 8), dct=10, mfcc=7)
AV_NOISE_LEAVES = ("/streams/visual/encoder/fc1/b", "/streams/visual/encoder/fc2/b")
AV_PARAM_TOL = 1e-3
LOO_SETS = [("models", "lstm_size", 4), ("training", "windowsize", 3),
            ("training", "num_epoch", 2), ("training", "epochsize", 3),
            ("training", "batchsize", 6)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(corpus paths, the trimodal INI pointed at them)."""
    root = tmp_path_factory.mktemp("zoo_cli")
    paths = chip_smoke.write_cli_corpus(str(root), TINY)
    ini = str(root / "loo.ini")
    chip_smoke.write_cli_ini(ini, "trimodal", chip_smoke.cli_sets("trimodal", paths, TINY)
                             + LOO_SETS)
    return paths, ini


@pytest.mark.parametrize("test_subj", [1, 4, 7])
def test_loo_split_ids_match_jax(test_subj):
    subjects = np.repeat(np.arange(1, 8), 3)[::-1]
    assert tloo.loo_split_ids(subjects, test_subj) == jloo.loo_split_ids(subjects, test_subj)
    train, test = tloo.loo_split_ids(subjects.reshape(-1, 1), test_subj)
    assert test == [test_subj] and test_subj not in train and len(train) == 6
    with pytest.raises(ValueError, match="not among subjects 1..7"):
        tloo.loo_split_ids(subjects, 9)


def _av_argv(paths):
    return ["--visual", paths["images"], "--audio", paths["mfcc"], "--encoder", paths["ae"],
            "--train_subjects_file", paths["train"], "--val_subjects_file", paths["val"],
            "--test_subjects_file", paths["test"], "--lstm_size", "4", "--windowsize", "3",
            "--num_epoch", "2", "--epochsize", "3", "--batchsize", "6"]


@pytest.mark.parametrize("case", ["loo_synthetic", "loo_mat", "av_synthetic", "av_mat"])
def test_fit_inputs_match_jax_bit_for_bit(corpus, monkeypatch, case):
    paths, ini = corpus
    mains = (jloo.main, tloo.main) if case.startswith("loo") else (jav.main, tav.main)
    argv = {"loo_synthetic": ["--synthetic", "40", "--test_subj", "2"],
            "loo_mat": ["--config", ini, "--test_subj", "3"],
            "av_synthetic": ["--synthetic", "40"],
            "av_mat": _av_argv(paths)}[case]
    ref_data, ref_params = fit_inputs(monkeypatch, mains[0], argv, "jax")
    data, params = fit_inputs(monkeypatch, mains[1], argv + ["--device", "cpu"], "port")
    assert_same(data, ref_data)
    if case.startswith("loo"):  # the held-out subject is validation and test
        assert_same(data[1], data[2])
    if case.endswith("mat"):
        layers = 4
        enc = params["streams"]["raw" if case.startswith("loo") else "visual"]["encoder"]
        ref_enc = ref_params["streams"]["raw" if case.startswith("loo") else "visual"][
            "encoder"]
        assert len(enc) == layers
        for name in ref_enc:
            for k in ("w", "b"):
                np.testing.assert_array_equal(enc[name][k], ref_enc[name][k])
    if case == "av_mat":  # force-align padded the shorter stream of each utterance
        lens = np.concatenate([np.asarray(split[2]).reshape(-1) for split in data])
        video, audio = (_video_lengths(paths[k]) for k in ("images", "mfcc"))
        assert lens.sum() == np.maximum(video, audio).sum() > video.sum()


def _video_lengths(path):
    from ip_avsr_torch.io import matio

    return matio.load_mat_file(path)["videoLengthVec"].ravel()


def test_leave_one_out_fit_and_results_line_match_jax(monkeypatch, tmp_path):
    for zoo in (jzoo, tzoo):
        monkeypatch.setattr(zoo, "adenet_v5",
                            lambda *a, _f=zoo.adenet_v5, **kw: chip_smoke.no_dropout(_f(*a, **kw)))
    lib.CarryInit(monkeypatch)
    out = {k: str(tmp_path / f"{k}.csv") for k in ("jax", "port")}
    argv = ["--synthetic", "40", "--test_subj", "3", "--num_epoch", "2"]
    jr, jout = run(jloo.main, argv + ["--results", out["jax"]])
    tr, tout = run(tloo.main, argv + ["--device", "cpu", "--results", out["port"]])
    lib.assert_results_match(jr, tr)
    assert open(out["port"]).read() == open(out["jax"]).read() == f"3,{tr.test_cr}\n"
    # the same report lines and pipe table
    for text in (jout, tout):
        assert "train subjects: [1, 2, 4, 5, 6, 7, 8, 9, 10]" in text
    assert tout[tout.index("Final Model"):] == jout[jout.index("Final Model"):]


def _results(path):
    lines = open(path).read().splitlines()
    head = [float(v) for v in lines[0].split(",")]
    curves = {line.split(",")[0]: [float(v) for v in line.split(",")[1:]] for line in lines[1:]}
    return head, curves


def test_audio_visual_fit_and_write_results_match_jax(monkeypatch, tmp_path):
    lib.CarryInit(monkeypatch)
    out = {k: str(tmp_path / f"{k}.csv") for k in ("jax", "port")}
    argv = ["--synthetic", "40"]
    jr, jout = run(jav.main, argv + ["--write_results", out["jax"]])
    tr, _ = run(tav.main, argv + ["--device", "cpu", "--write_results", out["port"],
                                  "--save_best", str(tmp_path / "best.pkl")])
    np.testing.assert_allclose(tr.cost_train, jr.cost_train, rtol=lib.COST_RTOL)
    np.testing.assert_allclose(tr.cost_val, jr.cost_val, rtol=lib.COST_RTOL)
    assert (tr.class_rate, tr.best_cr, tr.test_cr, tr.epochs_run) == (
        jr.class_rate, jr.best_cr, jr.test_cr, jr.epochs_run)
    np.testing.assert_array_equal(tr.test_conf, np.asarray(jr.test_conf))
    got, ref = dict(_leaves(tr.best_params)), dict(_leaves(jr.best_params))
    steps = 2 * 6  # the synthetic run's 2 epochs of 6 steps, Adam at lr 1e-4
    for k, r in ref.items():
        err = np.abs(got[k] - r).max()
        if k in AV_NOISE_LEAVES:
            assert err <= 2 * 1e-4 * steps, (k, err)
        else:
            assert err <= AV_PARAM_TOL * np.abs(r).max(), (k, err)
    (head, curves), (ref_head, ref_curves) = _results(out["port"]), _results(out["jax"])
    assert head[:2] == ref_head[:2] == [tr.test_cr, tr.best_cr]
    np.testing.assert_allclose(head[2], ref_head[2], rtol=lib.COST_RTOL)
    assert list(curves) == list(ref_curves) == ["train_costs", "val_costs"]
    for k in curves:
        np.testing.assert_allclose(curves[k], ref_curves[k], rtol=lib.COST_RTOL, atol=2e-6)
    from ip_avsr_torch.io import matio

    best = matio.load_model_params(str(tmp_path / "best.pkl"))
    lib.assert_params_close(tr.best_params, best, tol=0.0)


def _leaves(tree):
    """[(path, numpy leaf)] of a tensor or numpy tree."""
    return [(path, np.asarray(t.detach().cpu() if hasattr(t, "detach") else t))
            for path, t in chip_smoke.named_leaves(tree)]
