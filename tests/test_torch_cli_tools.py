"""The port's ``cli.parity_check`` and ``cli.confusion_visualizer`` against
the JAX package's, on the CPU.

* ``resolve_config`` writes the same INI text; ``make_rehearsal_corpus``
  at scale 0.1 writes the same ``.mat`` files bit for bit (one
  ``RandomState`` drawn in the same order) and the same AE checkpoint.
* ``parity_check.run --rehearse --rehearse-scale 0.1 --num_epoch 2``: JAX's
  initial parameters carried into the port (``lib.CarryInit``), the fits
  held as tests/test_torch_cli_train.py holds them (tests/
  torch_trainer_lib.py: costs within 1e-5 relative, rates, confusion
  matrices and epochs equal, best parameters within 1e-5 of each leaf's
  max abs) and the reports' costs and rates the same.
* ``map_confusion`` on per-step (B, T, C) and last-step (B, C)
  probabilities: JAX's triples and predictions.
* ``confusion_visualizer.main`` with a JAX-written ``--model`` pickle, on
  ``--synthetic`` data and on the rehearsal's ``.mat`` corpus: the same
  confusions, matrix and printed table, the PNGs written.
* Without ``--device`` both CLIs run on CUDA, so here they raise.
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from ip_avsr_tpu.cli import confusion_visualizer as jcv
from ip_avsr_tpu.cli import nstream as jnstream
from ip_avsr_tpu.cli import parity_check as jpc
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_tpu.models import adenet as jadenet
from ip_avsr_tpu.train import config as jconfig
from ip_avsr_torch.cli import confusion_visualizer as tcv
from ip_avsr_torch.cli import nstream as tnstream
from ip_avsr_torch.cli import parity_check as tpc
from tests import torch_trainer_lib as lib

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVLETTERS = os.path.join(ROOT, "configs", "avletters_1stream.ini")
SYNTHETIC = os.path.join(ROOT, "configs", "synthetic_1stream.ini")


def quiet(fn, *args):
    """``fn(*args)`` and its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue()


def _same_mat(got_path, ref_path):
    got, ref = sio.loadmat(got_path), sio.loadmat(ref_path)
    keys = sorted(k for k in ref if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys
    for k in keys:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("overrides", [None, "scaled"])
def test_resolve_config_writes_the_jax_text(tmp_path, overrides):
    if overrides:
        overrides = {"stream1": {"input_dimensions": "120", "shape": "200,100,50,8",
                                 "imagesize": "", "reorderdata": "false"},
                     "training": {"num_epoch": "3"}}
    texts = []
    for name, module in (("port", tpc), ("jax", jpc)):
        out = tmp_path / name
        out.mkdir()
        path = module.resolve_config(AVLETTERS, "/corpora/avletters", str(out), overrides)
        assert os.path.basename(path) == "resolved_avletters_1stream.ini"
        texts.append(open(path).read())
    assert texts[0] == texts[1]
    assert "data = /corpora/avletters/allData_mouthROIs.mat" in texts[0]


def test_rehearsal_corpus_matches_jax(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = tpc.make_rehearsal_corpus(str(tmp_path / "port"), scale=0.1)
    ref = jpc.make_rehearsal_corpus(str(tmp_path / "jax"), scale=0.1)
    assert got[2] == ref[2] == {"n_utterances": 156, "dim": 120, "encoder": [200, 100, 50, 8]}
    for g, r in zip(got[:2], ref[:2]):
        assert os.path.basename(g) == os.path.basename(r)
        _same_mat(g, r)


@pytest.fixture(scope="module")
def rehearsals(tmp_path_factory):
    """Both packages' ``parity_check.run`` at scale 0.1 for 2 epochs, the
    port from JAX's initial parameters: {package: (report, the nstream fit's
    result, its rehearsal directory)}."""
    root = tmp_path_factory.mktemp("rehearsal")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        lib.CarryInit(mp)
        for name, module, nstream, extra in (("jax", jpc, jnstream, []),
                                             ("port", tpc, tnstream, ["--device", "cpu"])):
            results = []
            main = nstream.main
            mp.setattr(nstream, "main", lambda argv, _m=main: results.append(_m(argv))
                       or results[-1])
            report, _ = quiet(module.run, [
                "--rehearse", "--rehearse-scale", "0.1", "--num_epoch", "2",
                "--rehearse-dir", str(root / name), "--reference-cr", "0.30",
                "--budget", "0.5", "--out", str(root / f"{name}.json")] + extra)
            out[name] = (report, results[0], root / name)
    return out


def test_rehearsal_fit_matches_jax(rehearsals):
    jreport, jr, _ = rehearsals["jax"]
    treport, tr, tdir = rehearsals["port"]
    lib.assert_results_match(jr, tr)
    assert tr.epochs_run == 2
    assert sorted(treport) == sorted(jreport)
    for key in ("test_cr", "best_cr", "delta", "within_budget", "rehearsal", "rehearsal_corpus",
                "split", "reference_cr", "budget"):
        assert treport[key] == jreport[key], key
    np.testing.assert_allclose(treport["best_val"], jreport["best_val"], rtol=lib.COST_RTOL)
    assert json.loads(open(str(tdir) + ".json").read()) == treport
    _same_mat(os.path.join(tdir, "allData_mouthROIs.mat"),
              os.path.join(rehearsals["jax"][2], "allData_mouthROIs.mat"))


@pytest.mark.parametrize("head", ["per_step", "last_step"])
def test_map_confusion_matches_jax(head):
    rng = np.random.RandomState(0)
    B, T, C = 40, 9, 5
    probs = rng.rand(B, T, C) if head == "per_step" else rng.rand(B, C)
    mask = (np.arange(T)[None, :] < rng.randint(1, T + 1, B)[:, None]).astype(np.uint8)
    y = rng.randint(0, C, B)
    got, ref = tcv.map_confusion(probs, y, mask), jcv.map_confusion(probs, y, mask)
    assert got[0] == ref[0] and 0 < len(got[0]) < B
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


def _jax_pickle(config_path, path, seed=1):
    """A JAX-written ``--model`` pickle: the INI's model at a seeded init."""
    cp = jconfig.load_config(config_path)
    cfg = jconfig.build_model_config(jconfig.parse_streams(cp), jconfig.parse_classifier(cp))
    params = jadenet.init_adenet_params(jax.random.PRNGKey(seed), cfg)
    jmatio.save_model_params(jax.tree_util.tree_map(np.asarray, params), path)
    return path


def _both_visualizers(tmp_path, argv):
    """(port's (confusions, matrix), its output, JAX's, its output)."""
    got, gout = quiet(tcv.main, argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
    ref, rout = quiet(jcv.main, argv + ["--outdir", str(tmp_path / "jax")])
    return got, gout.replace(str(tmp_path / "port"), "OUT"), ref, rout.replace(
        str(tmp_path / "jax"), "OUT")


def test_confusion_visualizer_synthetic_with_a_jax_pickle(tmp_path):
    model = _jax_pickle(SYNTHETIC, str(tmp_path / "best.pkl"))
    got, gout, ref, rout = _both_visualizers(tmp_path, [
        "--config", SYNTHETIC, "--model", model, "--synthetic", "30", "--max_renders", "2"])
    assert got[0] == ref[0] and len(got[0]) > 0
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    assert got[1].sum() == 30 and gout == rout
    pngs = sorted(os.listdir(tmp_path / "port"))
    assert pngs == sorted(os.listdir(tmp_path / "jax")) and "confusion_matrix.png" in pngs
    assert len([p for p in pngs if "_truth_" in p]) == 2


def test_confusion_visualizer_on_the_rehearsal_corpus(tmp_path, rehearsals):
    """The ``.mat`` branch: the JAX rehearsal's resolved INI and a pickle of
    its best parameters; one forward over every utterance."""
    _, jr, jdir = rehearsals["jax"]
    ini = os.path.join(jdir, "resolved_avletters_1stream.ini")
    model = str(tmp_path / "rehearsal.pkl")
    jmatio.save_model_params(jax.tree_util.tree_map(np.asarray, jr.best_params), model)
    got, gout, ref, rout = _both_visualizers(tmp_path, ["--config", ini, "--model", model,
                                                        "--max_renders", "1"])
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    assert got[1].shape == (26, 26) and got[1].sum() == 156 and gout == rout
    evaluated = tcv.evaluate(tcv.parse_args(["--config", ini, "--model", model,
                                             "--device", "cpu"]))
    assert evaluated[0] == got[0] and np.array_equal(evaluated[1], got[1])
    assert evaluated[2]["classnames"][:3] == ["A", "B", "C"]


@pytest.mark.parametrize("cli", ["parity_check", "confusion_visualizer"])
def test_default_device_is_cuda(tmp_path, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if cli == "parity_check":
            tpc.run(["--rehearse", "--rehearse-dir", str(tmp_path / "c"),
                     "--out", str(tmp_path / "r.json")])
        else:
            tcv.main(["--config", SYNTHETIC, "--synthetic", "4", "--outdir", str(tmp_path)])
    assert not (tmp_path / "c").exists()  # refused before the corpus is written
