"""The port's pretraining CLIs (``cli.pretrain_dbn``, ``cli.ae_finetuner``,
``cli.convae``) on the CPU: their synthetic modes, their real-data paths
from a small ``.mat`` (a frames x pixels ``dataMatrix`` with
``videoLengthVec`` and ``iterVec``), the files they write read by the JAX
package and the JAX package's files read by the port, and a
``pretrain_dbn`` autoencoder driving the port's ``cli.trimodal``.

``ae_finetuner`` draws nothing, so the port's output equals the JAX CLI's
within 1e-5; the RBMs and the conv-AE draw from each package's own
generator, so their files are held by structure and by what reached the
training functions (bit for bit).
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ip_avsr_tpu.cli import ae_finetuner as jaef
from ip_avsr_tpu.cli import convae as jconvae_cli
from ip_avsr_tpu.cli import pretrain_dbn as jpretrain
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_tpu.models import convae as jconvae
from ip_avsr_tpu.pretrain import dbn as jdbn
from ip_avsr_torch import bridge
from ip_avsr_torch.cli import ae_finetuner as taef
from ip_avsr_torch.cli import convae as tconvae_cli
from ip_avsr_torch.cli import pretrain_dbn as tpretrain
from ip_avsr_torch.cli import trimodal as ttrimodal
from ip_avsr_torch.io import matio as tmatio
from ip_avsr_torch.models import convae as tconvae
from ip_avsr_torch.pretrain import dbn as tdbn
from ip_avsr_torch.train import trainer as ttr

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=0)
SMALL_DBN = ["--hidden", "12,8,3", "--activations", "sigm,sigm,linear"]


def run(main, argv):
    """``main(argv)`` and its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def write_frames(path, pixels, videos=12, seed=0):
    """A ``.mat`` of uint8 frames: ``videos`` utterances of 3-6 frames,
    iterations 1-3 in turn (1 and 2 train)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 7, videos)
    frames = rng.randint(0, 256, (int(lens.sum()), pixels)).astype(np.uint8)
    tmatio.save_mat({"dataMatrix": frames, "videoLengthVec": lens.reshape(-1, 1),
                     "iterVec": (np.arange(videos) % 3 + 1).reshape(-1, 1)}, str(path))
    return frames, lens


def test_pretrain_dbn_synthetic_writes_a_mat_both_packages_read(tmp_path):
    out, jout = tmp_path / "port.mat", tmp_path / "jax.mat"
    args = ["--synthetic", "120", "--input-dim", "16", "--epochs", "2", "--batchsize", "20",
            *SMALL_DBN, "--finetune-epochs", "1"]
    _, text = run(tpretrain.main, args + ["--out", str(out), "--device", "cpu"])
    run(jpretrain.main, args + ["--out", str(jout)])
    assert "Pretraining Layer 3 with RBM: 8-3 (sigm->linear)" in text
    assert "AE finetune epoch 1: loss = " in text
    assert text.rstrip().endswith(f"saved 6-layer AE to {out}")
    for reader in (jmatio.load_dbn_mat, tmatio.load_dbn_mat):
        got = reader(str(out), n_layers=6)
        ref = reader(str(jout), n_layers=6)
        assert [w.shape for w in got[0]] == [w.shape for w in ref[0]] == \
            [(16, 12), (12, 8), (8, 3), (3, 8), (8, 12), (12, 16)]
        assert [b.shape for b in got[1]] == [b.shape for b in ref[1]]
        assert all(np.isfinite(w).all() for w in got[0])
    # a classifier unfolding: the softmax layer is drawn by numpy in both
    cls = tmp_path / "cls.mat"
    run(tpretrain.main, args[:-2] + ["--dbn-type", "2", "--output-classes", "4", "--out",
                                     str(cls), "--device", "cpu"])
    w, _ = jmatio.load_dbn_mat(str(cls), n_layers=4)
    assert w[-1].shape == (3, 4)


def test_pretrain_dbn_real_data_path_normalises_and_trains_on_the_frames(tmp_path,
                                                                         monkeypatch):
    """``--data``: the frames as float32, divided by their max ('sigm'),
    reach ``train_dbn`` bit for bit as in the JAX CLI."""
    frames, _ = write_frames(tmp_path / "frames.mat", 20)
    seen = {}
    for name, mod in (("port", tdbn), ("jax", jdbn)):
        train = mod.train_dbn

        def spy(key, data, *a, _train=train, _name=name, **kw):
            seen[_name] = np.array(data)
            return _train(key, data, *a, **kw)

        monkeypatch.setattr(mod, "train_dbn", spy)
    args = ["--data", str(tmp_path / "frames.mat"), "--epochs", "1", "--batchsize", "16",
            "--hidden", "6,4", "--activations", "sigm,linear"]
    run(tpretrain.main, args + ["--out", str(tmp_path / "p.mat"), "--device", "cpu"])
    run(jpretrain.main, args + ["--out", str(tmp_path / "j.mat")])
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    np.testing.assert_array_equal(seen["port"], frames.astype(np.float32) / 255.0)
    weights, _ = tmatio.load_dbn_mat(str(tmp_path / "j.mat"), n_layers=4)
    assert [w.shape for w in weights] == [(20, 6), (6, 4), (4, 6), (6, 20)]


def test_ae_finetuner_synthetic_equals_jax(tmp_path):
    args = ["--synthetic", "150", "--epochs", "2", "--batchsize", "32"]
    _, text = run(taef.main, args + ["--out", str(tmp_path / "p.mat"), "--device", "cpu"])
    _, jtext = run(jaef.main, args + ["--out", str(tmp_path / "j.mat")])
    assert text.splitlines()[-1] == f"saved finetuned 4-layer AE to {tmp_path / 'p.mat'}"
    got = tmatio.load_dbn_mat(str(tmp_path / "p.mat"), n_layers=4)
    ref = jmatio.load_dbn_mat(str(tmp_path / "j.mat"), n_layers=4)
    for a, b in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_allclose(a, b, **TOL)
    # the same loss lines, to the printed digits
    assert [line for line in text.splitlines() if "epoch" in line] == \
        [line for line in jtext.splitlines() if "epoch" in line]


@pytest.mark.parametrize("optimizer", ["adadelta", "nesterov"])
def test_ae_finetuner_on_a_jax_pretrained_mat_equals_jax(tmp_path, optimizer):
    """The JAX ``pretrain_dbn``'s ``.mat`` finetuned by both packages' CLIs
    on the training frames (iterations 1 and 2) of a ``.mat`` corpus; each
    package reads the other's output."""
    write_frames(tmp_path / "frames.mat", 16)
    ae = tmp_path / "ae.mat"
    run(jpretrain.main, ["--data", str(tmp_path / "frames.mat"), "--hidden", "10,4",
                         "--activations", "sigm,linear", "--epochs", "1", "--batchsize", "8",
                         "--out", str(ae)])
    args = ["--ae", str(ae), "--layers", "4", "--activations", "sigmoid,linear,sigmoid,linear",
            "--data", str(tmp_path / "frames.mat"), "--epochs", "2", "--batchsize", "8",
            "--optimizer", optimizer]
    run(taef.main, args + ["--out", str(tmp_path / "p.mat"), "--device", "cpu"])
    run(jaef.main, args + ["--out", str(tmp_path / "j.mat")])
    got = jmatio.load_dbn_mat(str(tmp_path / "p.mat"), n_layers=4)
    ref = tmatio.load_dbn_mat(str(tmp_path / "j.mat"), n_layers=4)
    start = tmatio.load_dbn_mat(str(ae), n_layers=4)
    for a, b, s in zip(got[0] + got[1], ref[0] + ref[1], start[0] + start[1]):
        np.testing.assert_allclose(a, b, **TOL)
    assert max(np.abs(a - s).max() for a, s in zip(got[0], start[0])) > 1e-5


@pytest.mark.parametrize("model", ["plain", "batchnorm", "dropout", "bndrop"])
def test_convae_synthetic_pickle_reads_in_jax(tmp_path, model):
    out = tmp_path / f"{model}.pkl"
    _, text = run(tconvae_cli.main, ["--synthetic", "24", "--model", model, "--epochs", "1",
                                     "--batchsize", "12", "--bottleneck", "4", "--dense", "8",
                                     "--out", str(out), "--device", "cpu"])
    assert text.splitlines()[-1].startswith(f"saved conv-AE ({model}) to {out}; final loss ")
    saved = jmatio.load_model(str(out))
    cfg = jconvae.ConvAEConfig(**saved["config"])
    assert cfg.use_batchnorm == (model in ("batchnorm", "bndrop"))
    assert cfg.use_dropout == (model in ("dropout", "bndrop"))
    assert len(saved["history"]) == 1 and np.isfinite(saved["history"][0])
    ref = jax.eval_shape(lambda k: jconvae.init_convae_params(k, cfg), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(np.shape, saved["params"]) == \
        jax.tree_util.tree_map(lambda a: a.shape, ref)
    # the saved parameters run in both packages' forwards and agree
    x = np.random.RandomState(1).randn(2, 1200).astype(np.float32)
    got = tconvae.convae_forward(bridge.params_from_jax(saved["params"], device="cpu"),
                                 tconvae.ConvAEConfig(**saved["config"]), torch.from_numpy(x))
    want = jax.jit(jconvae.convae_forward, static_argnums=1)(saved["params"], cfg, x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_convae_reads_a_jax_pickle_and_resizes_60x80_frames(tmp_path, monkeypatch):
    """A pickle in the JAX CLI's format (config dict, numpy parameters,
    history) loads in the port; the real-data path resizes 60 x 80 frames
    to 30 x 40 and hands ``train_convae`` the same images as the JAX CLI."""
    cfg = jconvae.ConvAEConfig(bottleneck=4, dense=8, use_batchnorm=True)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jconvae.init_convae_params, static_argnums=1)(
            jax.random.PRNGKey(2), cfg))
    jmatio.save_model({"config": cfg.__dict__, "params": params, "history": [1.0]},
                      str(tmp_path / "jax.pkl"))
    loaded = tmatio.load_model(str(tmp_path / "jax.pkl"))
    tcfg = tconvae.ConvAEConfig(**loaded["config"])
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 1200).astype(np.float32))
    assert tconvae.convae_encode(bridge.params_from_jax(loaded["params"], device="cpu"), tcfg,
                                 x).shape == (2, 4)

    write_frames(tmp_path / "frames.mat", 4800, videos=6)
    seen = {}
    for name, mod in (("port", tconvae_cli), ("jax", jconvae_cli)):
        def spy(train_X, cfg, *a, _name=name, **kw):
            seen[_name] = np.array(train_X)
            raise KeyboardInterrupt  # stop after the preprocessing

        monkeypatch.setattr(mod, "train_convae", spy)
    for name, main, extra in (("port", tconvae_cli.main, ["--device", "cpu"]),
                              ("jax", jconvae_cli.main, [])):
        with pytest.raises(KeyboardInterrupt):
            run(main, ["--data", str(tmp_path / "frames.mat"), "--out",
                       str(tmp_path / "x.pkl"), *extra])
    assert seen["port"].shape[1] == 1200
    np.testing.assert_array_equal(seen["port"], seen["jax"])


def test_a_pretrain_dbn_mat_trains_the_flagship_through_cli_trimodal(tmp_path, monkeypatch):
    """``pretrain_dbn`` on a tiny corpus's pixels at the flagship's
    2000-1000-500-50 widths (1 epoch), its ``.mat`` as both autoencoders
    of the trimodal INI, and ``cli.trimodal`` fits from it: the encoders
    that reach the fit are the file's w1..w4 and b1..b4."""
    corpus = dict(n=30, imagesize=(6, 8), dct=10, mfcc=7)
    paths = chip_smoke.write_cli_corpus(str(tmp_path), corpus)
    ae = tmp_path / "dbn.mat"
    _, text = run(tpretrain.main, ["--data", paths["images"], "--epochs", "1", "--out",
                                   str(ae), "--device", "cpu"])
    assert "Pretraining Layer 4 with RBM: 500-50 (sigm->linear)" in text
    sets = chip_smoke.cli_sets("trimodal", paths, corpus) + [
        ("models", "ae_pretrained", str(ae)), ("models", "ae_diff_pretrained", str(ae)),
        ("models", "lstm_size", 4), ("training", "windowsize", 3),
        ("training", "num_epoch", 1), ("training", "epochsize", 2),
        ("training", "batchsize", 6)]
    ini = str(tmp_path / "trimodal.ini")
    chip_smoke.write_cli_ini(ini, "trimodal", sets)
    seen = {}
    init = ttr.Trainer.init_params

    def spy(self, generator, **kw):
        seen.update(kw)
        return init(self, generator, **kw)

    monkeypatch.setattr(ttr.Trainer, "init_params", spy)
    result, _ = run(ttrimodal.main, ["--config", ini, "--device", "cpu"])
    assert result.epochs_run == 1 and np.isfinite(result.cost_train).all()
    weights, biases = tmatio.load_dbn_mat(str(ae), n_layers=4)
    raw, dct, diff = seen["pretrained_encoders"]
    assert dct is None
    for got_w, got_b in (raw, diff):
        for a, b in zip(list(got_w) + list(got_b), weights + biases):
            np.testing.assert_array_equal(np.asarray(a).reshape(-1), b.reshape(-1))


def test_clis_raise_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((tpretrain.main, ["--synthetic", "20", "--input-dim", "8", "--hidden",
                                         "4", "--activations", "sigm", "--epochs", "1"]),
                       (taef.main, ["--synthetic", "20", "--epochs", "1"]),
                       (tconvae_cli.main, ["--synthetic", "4", "--epochs", "1",
                                           "--bottleneck", "2", "--dense", "4"])):
        out = str(tmp_path / "out")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(main, args + ["--out", out])
        run(main, args + ["--out", out, "--device", "cpu"])
