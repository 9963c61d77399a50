"""The port's config values it does not run, and the legacy INI schema.

``lstm_remat`` and ``lstm_residual_dtype`` change the JAX package's LSTM
training residuals, so the port refuses them (naming ROADMAP Queue 1 item
5) rather than train without them; ``matmul_dtype`` names Queue 2 item 4.
Each is refused by ``models/adenet.check_supported`` and when an INI's
``[lstm_classifier]`` (or ``[training]``) value reaches
``init_adenet_params`` through ``train.config.build_model_config``.
``parse_legacy_config`` reads the trimodal CLI's [data]/[models]/[training]
schema as the JAX package reads it.
"""

import dataclasses
import os

import pytest
import torch

from ip_avsr_tpu.train import config as jconfig
from ip_avsr_torch.models import adenet as tadenet
from ip_avsr_torch.models import zoo as tzoo
from ip_avsr_torch.train import config as tconfig

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ini_config(tmp_path, section, key, value):
    """configs/synthetic_1stream.ini with ``[section] key = value`` set,
    through the port's build_model_config."""
    cp = tconfig.load_config(os.path.join(ROOT, "configs", "synthetic_1stream.ini"))
    cp.set(section, key, str(value))
    path = tmp_path / "cfg.ini"
    with open(path, "w") as f:
        cp.write(f)
    cp = tconfig.load_config(str(path))
    cfg = tconfig.build_model_config(tconfig.parse_streams(cp), tconfig.parse_classifier(cp))
    dtype = tconfig.parse_training(cp).matmul_dtype
    return dataclasses.replace(cfg, matmul_dtype=dtype) if dtype else cfg


@pytest.mark.parametrize("key,value,section,item", [
    ("lstm_remat", True, "lstm_classifier", "Queue 1 item 5"),
    ("lstm_residual_dtype", "bfloat16", "lstm_classifier", "Queue 1 item 5"),
    ("matmul_dtype", "bfloat16", "training", "Queue 2 item 4"),
])
def test_unported_lstm_keys_raise(tmp_path, key, value, section, item):
    direct = dataclasses.replace(tzoo.adenet_v3(16, 4, 16, lstm_size=4), **{key: value})
    with pytest.raises(NotImplementedError, match=f"{key}.*{item}"):
        tadenet.check_supported(direct)
    cfg = _ini_config(tmp_path, section, key, value)
    assert getattr(cfg, key) == value  # the INI value reached the model config
    with pytest.raises(NotImplementedError, match=f"{key}.*{item}"):
        tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    # with the key at its default the same file builds
    default = tadenet.AdeNetConfig.__dataclass_fields__[key].default
    tadenet.init_adenet_params(torch.Generator().manual_seed(0),
                               dataclasses.replace(cfg, **{key: default}), device="cpu")


@pytest.mark.parametrize("ini", ["oulu_trimodal.ini", "oulu_4stream.ini"])
def test_parse_legacy_config_matches_jax(ini):
    path = os.path.join(ROOT, "configs", ini)
    got = tconfig.parse_legacy_config(tconfig.load_config(path))
    ref = jconfig.parse_legacy_config(jconfig.load_config(path))
    assert got == ref
    assert list(got) == ["data", "models", "training"]
    if ini == "oulu_trimodal.ini":
        assert got["training"]["decay_start"] == "8"
        assert got["models"]["lstm_size"] == "250"
        assert got["data"]["imagesize"] == "26,44"
    else:  # no legacy section: every part empty
        assert got["data"] == got["models"] == {}
