"""The port's demo CLI (ip_avsr_torch.cli.demo) against the JAX package's
(ip_avsr_tpu.cli.demo), on the CPU.

A forward-only-head copy of configs/synthetic_1stream.ini (``use_blstm =
false``, so ``--streaming`` applies) is trained one short epoch by the JAX
trainer CLI, which writes its best parameters as a numpy pickle
(``ip_avsr_tpu.io.matio.save_model_params``); both demos load that file and
must print the same per-utterance predictions in the sync, ``--streaming``
and ``--pipelined --batch 2`` modes.  The port's ``export_model`` CLI
exports that pickle (batch and streaming, ``--check`` on the CPU), and the
demo's ``--artifact`` serves it in all three modes with the JAX demo's
predictions.  Also: the port's pickles round-trip and load in JAX's reader,
a foreign artifact is refused, and the CLIs' modules import no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from ip_avsr_tpu.cli import nstream

    tmp = tmp_path_factory.mktemp("demo")
    base = open(os.path.join(ROOT, "configs", "synthetic_1stream.ini")).read()
    cfg_path = tmp / "stream.ini"
    cfg_path.write_text(base.replace("[training]", "use_blstm = false\n\n[training]"))
    best = tmp / "best.pkl"
    nstream.main(["--config", str(cfg_path), "--synthetic", "24", "--num_epoch", "1",
                  "--save_best", str(best)])
    return str(cfg_path), str(best)


def _preds(text):
    return [line.split("predicted")[1] for line in text.splitlines() if "predicted" in line]


@pytest.mark.parametrize("mode", [[], ["--streaming"], ["--pipelined", "--batch", "2"]],
                         ids=["sync", "streaming", "pipelined"])
def test_demo_prints_the_jax_demos_predictions(trained, capsys, mode):
    from ip_avsr_tpu.cli import demo as jdemo
    from ip_avsr_torch.cli import demo as tdemo

    cfg_path, best = trained
    capsys.readouterr()
    jdemo.main(["--config", cfg_path, "--model", best, "--synthetic", "6", *mode])
    ref = _preds(capsys.readouterr().out)
    tdemo.main(["--config", cfg_path, "--model", best, "--synthetic", "6", "--device", "cpu",
                *mode])
    out = capsys.readouterr().out
    assert len(ref) == 6 and _preds(out) == ref
    assert "accuracy:" in out


def test_demo_refuses_artifact_and_mixed_modes(trained, tmp_path):
    """A file that is not one of the port's artifacts is refused by name,
    as are the two exclusive serving modes together."""
    import zipfile

    from ip_avsr_torch.cli import demo as tdemo

    cfg_path, best = trained
    bogus = tmp_path / "x.ipax"
    with zipfile.ZipFile(bogus, "w") as z:
        z.writestr("meta.json", "{\"format\": \"ipavsr-export/1\"}")
    with pytest.raises(ValueError, match="ip_avsr_tpu"):
        tdemo.main(["--config", cfg_path, "--artifact", str(bogus), "--device", "cpu"])
    with pytest.raises(SystemExit):
        tdemo.main(["--config", cfg_path, "--streaming", "--pipelined", "--device", "cpu"])


def test_params_pickles_cross_packages(trained, tmp_path):
    """A JAX pickle loads through the port's reader into the bridge, and a
    pickle the port writes loads in JAX's reader with the same arrays."""
    from ip_avsr_tpu.io import matio as jmatio
    from ip_avsr_torch import bridge
    from ip_avsr_torch.device import tree_map
    from ip_avsr_torch.io import matio as tmatio

    _, best = trained
    tree = tmatio.load_model_params(best)
    params = bridge.params_from_jax(tree, device="cpu")
    out = tmp_path / "port.pkl"
    tmatio.save_model_params(params, str(out))
    back = jmatio.load_model_params(str(out))
    tree_map(lambda a, b: np.testing.assert_array_equal(a, b), tree, back)
    assert isinstance(back["output"]["w"], np.ndarray)


def test_synthesize_dataset_matches_jax():
    from ip_avsr_tpu.cli import nstream as jn
    from ip_avsr_torch.cli import nstream as tn

    for args in ((7, 24, 5, 0), (3, 11, 10, 2)):
        a, b = jn.synthesize_dataset(*args), tn.synthesize_dataset(*args)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_serving_modules_import_no_jax():
    code = ("import sys, ip_avsr_torch, ip_avsr_torch.serve, ip_avsr_torch.cli.demo, "
            "ip_avsr_torch.io.matio; "
            "assert 'jax' not in sys.modules and 'ip_avsr_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


@pytest.fixture(scope="module")
def artifacts(trained, tmp_path_factory):
    """The JAX-trained pickle exported by the port's CLI with --check on the
    CPU: a symbolic batch artifact and a streaming one."""
    from ip_avsr_torch.cli import export_model

    cfg_path, best = trained
    tmp = tmp_path_factory.mktemp("artifacts")
    paths = {"batch": str(tmp / "model.ipax"), "streaming": str(tmp / "stream.ipax")}
    for kind, path in paths.items():
        export_model.main(["--config", cfg_path, "--model", best, "--out", path, "--check",
                           "--device", "cpu", *(["--streaming"] if kind == "streaming" else [])])
    return paths


@pytest.mark.parametrize("kind,flags", [("batch", []), ("batch", ["--per_step"]),
                                        ("batch", ["--weights_dtype", "bfloat16"]),
                                        ("streaming", ["--streaming"])],
                         ids=["batch", "per_step", "bf16", "streaming"])
def test_export_model_cli_checks_the_artifact(trained, tmp_path, capsys, kind, flags):
    from ip_avsr_torch.cli import export_model

    cfg_path, best = trained
    out = str(tmp_path / "m.ipax")
    export_model.main(["--config", cfg_path, "--model", best, "--out", out, "--check",
                       "--device", "cpu", *flags])
    text = capsys.readouterr().out
    assert "check OK" in text and kind in text
    tol = "0.05" if "bfloat16" in flags else "2e-05"
    assert f"tolerance {tol}" in text


def test_export_model_cli_refuses_time_for_streaming(trained, tmp_path):
    from ip_avsr_torch.cli import export_model

    cfg_path, _ = trained
    with pytest.raises(SystemExit):
        export_model.main(["--config", cfg_path, "--out", str(tmp_path / "m.ipax"),
                           "--streaming", "--time", "9", "--device", "cpu"])


@pytest.mark.parametrize("mode", [[], ["--streaming"], ["--pipelined", "--depth", "2"]],
                         ids=["sync", "streaming", "pipelined"])
def test_demo_artifact_prints_the_jax_demos_predictions(trained, artifacts, capsys, mode):
    from ip_avsr_tpu.cli import demo as jdemo
    from ip_avsr_torch.cli import demo as tdemo

    cfg_path, best = trained
    capsys.readouterr()
    jdemo.main(["--config", cfg_path, "--model", best, "--synthetic", "6", *mode])
    ref = _preds(capsys.readouterr().out)
    art = artifacts["streaming" if "--streaming" in mode else "batch"]
    tdemo.main(["--config", cfg_path, "--artifact", art, "--synthetic", "6", "--device", "cpu",
                *mode])
    out = capsys.readouterr().out
    assert len(ref) == 6 and _preds(out) == ref


def test_export_modules_import_no_jax():
    code = ("import sys, ip_avsr_torch.export, ip_avsr_torch.cli.export_model; "
            "assert 'jax' not in sys.modules and 'ip_avsr_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)
