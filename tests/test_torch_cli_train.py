"""The port's training CLIs against the JAX package's, on the CPU at a tiny
width, from ``.mat`` and INI files.

The corpus and the INI copies are ``chip_smoke.py``'s own
(``write_cli_corpus``, ``cli_sets``, ``write_cli_ini``: configs/
oulu_trimodal.ini and configs/oulu_4stream.ini pointed at the files), at
6 x 8 pixels, DCT 10, MFCC 7 (other lengths, so force-align pads), 30
utterances over 10 subjects.  Two checks:

* what reaches ``Trainer.fit`` (every split's streams, targets and lengths)
  is equal bit for bit, and so are the pretrained encoders in the initial
  parameters (the rest of them is drawn from each package's own generator);
* a whole fit matches: JAX's initial parameters are carried into the port
  (``bridge.params_from_jax``), dropout is 0, and the costs, rates,
  confusion matrix and best parameters agree within
  tests/torch_trainer_lib.py's 1e-5.

Cases: ``cli.nstream`` on configs/synthetic_1stream.ini and on the 4-stream
corpus (force-align, pretrained ``model`` files, the report files);
``cli.trimodal`` with both autoencoders, with ``--test_subj`` and with the
reference's key names, and its dropout-0 fit (``zoo.adenet_v3`` patched in
both packages); ``separate_train`` (its encodings and its fit);
``extract_weights`` (the ``.mat`` it writes read by the JAX package, and
the extracted encoder fed a probe against the port's numpy oracle
``reference_impl.encoder_forward_np``);
``evaluate_delta_features`` (both fits and the report).
"""

import configparser
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu.cli import evaluate_delta_features as jedf
from ip_avsr_tpu.cli import extract_weights as jext
from ip_avsr_tpu.cli import nstream as jnstream
from ip_avsr_tpu.cli import separate_train as jsep
from ip_avsr_tpu.cli import trimodal as jtrimodal
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_tpu.models import zoo as jzoo
from ip_avsr_tpu.train import trainer as jtr
from ip_avsr_torch import bridge
from ip_avsr_torch.cli import evaluate_delta_features as tedf
from ip_avsr_torch.cli import extract_weights as text
from ip_avsr_torch.cli import nstream as tnstream
from ip_avsr_torch.cli import separate_train as tsep
from ip_avsr_torch.cli import trimodal as ttrimodal
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.train import trainer as ttr
from tests import torch_trainer_lib as lib

torch.set_num_threads(1)

TINY = dict(n=30, imagesize=(6, 8), dct=10, mfcc=7)
# the trimodal CLI builds adenet_v3's own 2000-1000-500-50 encoders
TRIMODAL_CORPUS = dict(TINY)
NSTREAM_CORPUS = dict(TINY, ae=(16, 8))
CUTS = [("training", "num_epoch", 2), ("training", "epochsize", 3),
        ("training", "batchsize", 6)]
TRIMODAL_SETS = [("models", "lstm_size", 4), ("training", "windowsize", 3),
                 ("training", "decay_start", 1)] + CUTS
NSTREAM_SETS = [("lstm_classifier", "lstm_size", 6), ("lstm_classifier", "windowsize", 3)] + CUTS


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{kind: (corpus paths, ini path)} for the trimodal and nstream CLIs."""
    out = {}
    for kind, corpus, sets in (("trimodal", TRIMODAL_CORPUS, TRIMODAL_SETS),
                               ("nstream", NSTREAM_CORPUS, NSTREAM_SETS)):
        root = tmp_path_factory.mktemp(kind)
        paths = chip_smoke.write_cli_corpus(str(root), corpus)
        ini = str(root / f"{kind}.ini")
        chip_smoke.write_cli_ini(ini, kind, chip_smoke.cli_sets(kind, paths, corpus) + sets)
        out[kind] = (paths, ini)
    return out


def run(main, argv):
    """``main(argv)`` and its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


class Stop(Exception):
    pass


def fit_inputs(monkeypatch, main, argv, package):
    """(data, initial parameters as numpy) that ``main(argv)`` hands
    ``Trainer.fit``, the fit itself not run."""
    got = {}

    def jfit(self, *data):
        got["v"] = data, jax.tree_util.tree_map(
            np.asarray, self.init_params(jax.random.PRNGKey(self.options.seed)))
        raise Stop

    def tfit(self, *data):
        got["v"] = data, lib.bridge_numpy(
            self.init_params(torch.Generator().manual_seed(self.options.seed)))
        raise Stop

    if package == "jax":
        monkeypatch.setattr(jtr.Trainer, "fit", jfit)
    else:
        monkeypatch.setattr(ttr.Trainer, "fit", tfit)
    with pytest.raises(Stop), contextlib.redirect_stdout(io.StringIO()):
        main(argv)
    return got["v"]


def assert_same(got, ref, path="data"):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    else:
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
        assert np.array_equal(got, ref), path


def _reference_keys_ini(paths, ini, tmp_path):
    """The trimodal INI with the reference's [models] key names."""
    cp = configparser.ConfigParser()
    cp.read(ini)
    del cp["models"]["ae_pretrained"], cp["models"]["ae_diff_pretrained"]
    cp["models"]["finetuned"] = paths["ae"]
    cp["models"]["finetuned_diff"] = paths["ae_diff"]
    cp["training"]["do_finetune"] = "True"
    path = str(tmp_path / "refkeys.ini")
    with open(path, "w") as f:
        cp.write(f)
    return path


@pytest.mark.parametrize("case", ["trimodal", "trimodal_test_subj", "trimodal_reference_keys",
                                  "nstream_4stream"])
def test_fit_inputs_match_jax_bit_for_bit(corpora, monkeypatch, tmp_path, case):
    kind = case.split("_")[0]
    paths, ini = corpora[kind]
    if case == "trimodal_reference_keys":
        ini = _reference_keys_ini(paths, ini, tmp_path)
    extra = ["--test_subj", "3"] if case == "trimodal_test_subj" else []
    mains = {"trimodal": (jtrimodal.main, ttrimodal.main),
             "nstream": (jnstream.main, tnstream.main)}[kind]
    ref_data, ref_params = fit_inputs(monkeypatch, mains[0], ["--config", ini] + extra, "jax")
    data, params = fit_inputs(monkeypatch, mains[1],
                              ["--config", ini, "--device", "cpu"] + extra, "port")
    assert_same(data, ref_data)
    # the same tree of the same shapes; the pretrained encoders equal
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    assert [(p, v.shape) for p, v in flat] == [(p, v.shape) for p, v in ref_flat]
    encoders = [(p, v, r) for (p, v), (_, r) in zip(flat, ref_flat)
                if "encoder" in jax.tree_util.keystr(p)]
    layers = 4 if kind == "trimodal" else len(NSTREAM_CORPUS["ae"])
    assert len(encoders) == 2 * layers * 2  # two streams' dense layers, w and b
    for p, v, r in encoders:
        np.testing.assert_array_equal(v, r, err_msg=jax.tree_util.keystr(p))
    ae = jmatio.load_dbn_mat(paths["ae"], n_layers=layers)
    stream = "raw" if kind == "trimodal" else "s1"
    np.testing.assert_array_equal(params["streams"][stream]["encoder"]["fc1"]["w"], ae[0][0])
    n_test = int(np.asarray(data[2][2]).size)
    if case == "trimodal_test_subj":
        assert n_test == 3  # subject 3's utterances only
    else:
        assert n_test == 6  # subjects 9 and 10
    if kind == "nstream":  # force-align padded each utterance to its longest stream
        lens = np.concatenate([np.asarray(split[2]).reshape(-1) for split in data])
        video, audio = (jmatio.load_mat_files([paths[k]])[0]["videoLengthVec"].ravel()
                        for k in ("images", "mfcc"))
        assert lens.sum() == np.maximum(video, audio).sum() > video.sum()


def test_nstream_synthetic_fit_matches_jax(monkeypatch):
    lib.CarryInit(monkeypatch)
    argv = ["--config", "configs/synthetic_1stream.ini", "--synthetic", "40",
            "--num_epoch", "2"]
    jr, jout = run(jnstream.main, argv)
    tr, tout = run(tnstream.main, argv + ["--device", "cpu"])
    lib.assert_results_match(jr, tr)
    # the same confusion table
    assert tout.split("confusion matrix:")[1] == jout.split("confusion matrix:")[1]


def test_nstream_4stream_fit_matches_jax(corpora, monkeypatch, tmp_path):
    paths, ini = corpora["nstream"]
    lib.CarryInit(monkeypatch)
    outs = {k: [str(tmp_path / f"{k}.csv"), str(tmp_path / f"{k}.pkl")]
            for k in ("jax", "port")}
    jr, _ = run(jnstream.main, ["--config", ini, "--write_results", outs["jax"][0],
                                "--save_best", outs["jax"][1]])
    tr, tout = run(tnstream.main, ["--config", ini, "--device", "cpu", "--write_results",
                                   outs["port"][0], "--save_best", outs["port"][1],
                                   "--save_plot", str(tmp_path / "port")])
    lib.assert_results_match(jr, tr)
    # the report files: the results line, the best parameters for either package
    assert open(outs["port"][0]).read() == f"{tr.test_cr},{tr.best_cr},{tr.best_val}\n"
    best = jmatio.load_model_params(outs["port"][1])
    lib.assert_params_close(bridge.params_from_jax(best, device="cpu"), jr.best_params)
    assert (tmp_path / "port.confmat.txt").read_text().startswith("| |p0|p1|")
    assert "best model saved to" in tout


def test_trimodal_dropout0_fit_matches_jax(corpora, monkeypatch):
    paths, ini = corpora["trimodal"]
    for zoo in (jzoo, tzoo):
        monkeypatch.setattr(zoo, "adenet_v3",
                            lambda *a, _f=zoo.adenet_v3, **kw: chip_smoke.no_dropout(_f(*a, **kw)))
    lib.CarryInit(monkeypatch)
    jr, jout = run(jtrimodal.main, ["--config", ini])
    tr, tout = run(ttrimodal.main, ["--config", ini, "--device", "cpu"])
    assert tr.epochs_run == 2 and tr.final_lr == pytest.approx(0.9 ** 2, rel=1e-12)
    lib.assert_results_match(jr, tr)
    # the same LaTeX confusion table
    assert tout[tout.index("\\begin{tabular}"):] == jout[jout.index("\\begin{tabular}"):]


def test_separate_train_matches_jax(monkeypatch):
    rng = np.random.RandomState(0)
    weights = [rng.randn(24, 16).astype(np.float32), rng.randn(16, 8).astype(np.float32)]
    biases = [rng.randn(16).astype(np.float32), rng.randn(8).astype(np.float32)]
    X = rng.randn(5000, 24).astype(np.float32)  # two batches of up to 4096 frames
    nls = ["sigmoid", "linear"]
    got = tsep.encode_frames(weights, biases, nls, X, device="cpu")
    ref = jsep.encode_frames(weights, biases, nls, X)
    assert got.dtype == np.float32 and got.shape == (5000, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    lib.CarryInit(monkeypatch)
    argv = ["--synthetic", "24", "--num_epoch", "2"]
    jr, _ = run(jsep.main, argv)
    tr, _ = run(tsep.main, argv + ["--device", "cpu"])
    lib.assert_results_match(jr, tr)


def test_extract_weights_written_mat_reads_in_jax(tmp_path):
    cfg = jzoo.deltanet_majority_vote(6, (5, 4, 3), ("sigmoid", "sigmoid", "linear"),
                                      lstm_size=4, window=2, output_classes=3)
    params = jax.tree_util.tree_map(
        np.asarray, jtr.Trainer(cfg, jtr.TrainOptions()).init_params(jax.random.PRNGKey(1)))
    model = str(tmp_path / "best.pkl")
    jmatio.save_model_params(params, model)
    argv = ["--model", model, "--encoder-stream", "s1",
            "--lstm", "aggregator/0/fwd:agg_fwd", "--lstm", "aggregator/0/bwd:agg_bwd"]
    run(text.main, argv + ["--out", str(tmp_path / "port.mat")])
    run(jext.main, argv + ["--out", str(tmp_path / "jax.mat")])
    got = jmatio.load_mat_files([str(tmp_path / "port.mat")])[0]
    ref = jmatio.load_mat_files([str(tmp_path / "jax.mat")])[0]
    keys = sorted(k for k in ref if not k.startswith("__"))
    assert sorted(k for k in got if not k.startswith("__")) == keys and len(keys) == 6 + 24
    for k in keys:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    w, b = jmatio.load_dbn_mat(str(tmp_path / "port.mat"), n_layers=3)
    np.testing.assert_array_equal(w[2], params["streams"]["s1"]["encoder"]["fc3"]["w"])
    fwd = jmatio.lstm_params_from_mat_dict(got, "agg_fwd")
    np.testing.assert_array_equal(fwd["w_hid"], params["aggregator"][0]["fwd"]["w_hid"])
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        text.main(["--model", model, "--out", str(tmp_path / "x.mat"),
                   "--encoder-stream", "s9"])


def test_extract_weights_encoder_matches_the_oracle(tmp_path):
    """The JAX check of tests/test_cli_and_checkpoints.py:288-324 in the
    port: an encoder written by ``extract_weights`` and read back through
    the CLI loader path (``load_decoder``, ``pretrained_encoder_params``)
    gives, on a probe, what the independent numpy forward gives for the
    model's own encoder; six layers, so fc5 and fc6 sort after bottleneck."""
    from ip_avsr_torch import reference_impl
    from ip_avsr_torch.io import matio as tmatio
    from ip_avsr_torch.models import adenet as tadenet, encoder as tencoder

    shapes, nls = (9, 8, 7, 6, 5, 4), ("sigmoid",) * 5 + ("linear",)
    cfg = tzoo.deltanet_majority_vote(10, shapes, nls, lstm_size=4, window=2,
                                      output_classes=3)
    params = tadenet.init_adenet_params(torch.Generator().manual_seed(2), cfg, device="cpu")
    model = str(tmp_path / "best.pkl")
    tmatio.save_model_params(params, model)
    run(text.main, ["--model", model, "--encoder-stream", "s1",
                    "--out", str(tmp_path / "enc.mat")])
    w, b, got_shapes, got_nls = tmatio.load_decoder(
        str(tmp_path / "enc.mat"), ",".join(map(str, shapes)), ",".join(nls))
    assert [wi.shape[1] for wi in w] == list(got_shapes) == list(shapes)
    enc = tencoder.pretrained_encoder_params(w, b)
    assert sorted(enc, key=tencoder._layer_sort_key)[4:] == ["fc5", "fc6"]
    probe = np.random.RandomState(3).randn(5, 10).astype(np.float32)
    with torch.no_grad():
        got = tencoder.encoder_forward(enc, torch.from_numpy(probe), got_nls).numpy()
    want = reference_impl.encoder_forward_np(
        reference_impl.torch_tree_to_np(params["streams"]["s1"]["encoder"]), probe, nls)
    assert got.shape == (5, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ablation(report):
    """The report's two rows: (val CR, test CR, best val cost) each."""
    lines = report.split("=== delta-feature ablation ===")[1].strip().splitlines()
    return lines[0], [[float(v) for v in line.split()[-3:]] for line in lines[1:3]]


def test_evaluate_delta_features_matches_jax(monkeypatch):
    lib.CarryInit(monkeypatch)
    argv = ["--config", "configs/synthetic_1stream.ini", "--synthetic", "24",
            "--num_epoch", "2"]
    jres, jout = run(jedf.main, argv)
    tres, tout = run(tedf.main, argv + ["--device", "cpu"])
    for jr, tr in zip(jres, tres):
        # the report's numbers as every fit here; the best parameters within
        # 1e-4 of each leaf's max abs: the no-delta model's learned
        # aggregator/0/fwd/cell_init, whose gradient sums terms that cancel,
        # ends 1.25e-5 of its max abs from JAX's after 10 Adam steps
        np.testing.assert_allclose(tr.cost_train, jr.cost_train, rtol=lib.COST_RTOL)
        np.testing.assert_allclose(tr.cost_val, jr.cost_val, rtol=lib.COST_RTOL)
        assert (tr.class_rate, tr.best_cr, tr.test_cr, tr.epochs_run) == (
            jr.class_rate, jr.best_cr, jr.test_cr, jr.epochs_run)
        np.testing.assert_array_equal(tr.test_conf, np.asarray(jr.test_conf))
        lib.assert_params_close(tr.best_params, jr.best_params, tol=1e-4)
    header, rows = _ablation(tout)
    ref_header, ref_rows = _ablation(jout)
    assert header == ref_header
    np.testing.assert_allclose(rows, ref_rows, atol=2e-3)
    assert tout.count("=== run") == 2
