"""The config values of the LSTM levers and the legacy INI schema.

``lstm_remat``, ``lstm_residual_dtype`` and ``matmul_dtype`` are ported: an
INI's ``[lstm_classifier]`` value (``[training]`` for ``matmul_dtype``, which
the CLIs copy into the model config as the JAX CLIs do) reaches the model
config, the model builds, and its training gradients equal the JAX
package's for the same setting.  A ``matmul_dtype`` the kernels have no
instantiation for is still refused, naming ROADMAP Queue 2 item 4, by
``models/adenet.check_supported``.  ``parse_legacy_config`` reads the
trimodal CLI's [data]/[models]/[training] schema as the JAX package reads
it.
"""

import dataclasses
import os

import numpy as np
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


def _jax_ini_config(tmp_path, section, key, value):
    """The same INI through the JAX package's build_model_config, its
    ``[training] matmul_dtype`` applied as the JAX CLIs apply it
    (ip_avsr_tpu/cli/nstream.py:252)."""
    cp = jconfig.load_config(str(tmp_path / "cfg.ini"))
    cfg = jconfig.build_model_config(jconfig.parse_streams(cp), jconfig.parse_classifier(cp))
    dtype = jconfig.parse_training(cp).matmul_dtype
    return dataclasses.replace(cfg, matmul_dtype=dtype) if dtype else cfg


def _grads_match_jax(jcfg, tcfg, tol=1e-5):
    """One training loss and gradient of both packages on the same
    parameters and batch: loss 1e-5 relative, each gradient within ``tol``
    of its max abs (the levers' own tolerances: tests/test_torch_lstm_
    residuals.py, tests/test_torch_bf16_lstm.py).  Returns the port's
    gradient leaves, JAX's, and the parameters and batch used."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ip_avsr_tpu.models import adenet as jadenet
    from ip_avsr_tpu.train import trainer as jtr
    from ip_avsr_torch import bridge
    from ip_avsr_torch.train import trainer as ttr

    jp = jadenet.init_adenet_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    streams = [rng.randn(3, 7, s.input_dim).astype(np.float32) for s in jcfg.streams]
    mask = (np.arange(7)[None] < np.array([7, 5, 2])[:, None]).astype(np.float32)
    y = np.array([0, 3, 1], np.int32)
    jt = jtr.Trainer(jcfg, jtr.TrainOptions(log_fn=lambda s: None))
    jloss, jg = jax.value_and_grad(jt._loss)(jp, [jnp.asarray(x) for x in streams],
                                             jnp.asarray(y), jnp.asarray(mask), True,
                                             jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tloss, tg = ttr.loss_and_grads(tp, tcfg, [torch.from_numpy(x) for x in streams],
                                   torch.from_numpy(y).long(), torch.from_numpy(mask))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), tg))
    ref = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jg))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=tol * max(np.abs(r).max(), 1e-3))
    return got, ref, (tp, streams, y, mask)


@pytest.mark.parametrize("key,value,section,item", [
    ("lstm_remat", True, "lstm_classifier", "Queue 1 item 5"),
    ("lstm_residual_dtype", "bfloat16", "lstm_classifier", "Queue 1 item 5"),
    ("matmul_dtype", "bfloat16", "training", "Queue 2 item 4"),
])
def test_unported_lstm_keys_raise(tmp_path, key, value, section, item):
    """The three keys, which ``item`` names as the ROADMAP item that brought
    each, build from the INI and train with JAX's gradients.  For
    ``matmul_dtype = bfloat16`` the gradients are held at the bf16 LSTM
    tests' 1e-5 of max abs (measured 2.3e-7 here), and the same parameters'
    float32 gradients lie more than ten times that from JAX's bf16 ones;
    a dtype with no kernel instantiation still raises naming the item."""
    direct = dataclasses.replace(tzoo.adenet_v3(16, 4, 16, lstm_size=4), **{key: value})
    cfg = _ini_config(tmp_path, section, key, value)
    assert getattr(cfg, key) == value  # the INI value reached the model config
    assert item == ("Queue 2 item 4" if key == "matmul_dtype" else "Queue 1 item 5")
    tadenet.check_supported(direct)
    tadenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    jcfg = _jax_ini_config(tmp_path, section, key, value)
    assert getattr(jcfg, key) == value
    got, ref, (tp, streams, y, mask) = _grads_match_jax(jcfg, cfg)
    if key != "matmul_dtype":
        return
    import jax
    from ip_avsr_torch.train import trainer as ttr

    f32 = ttr.loss_and_grads(tp, dataclasses.replace(cfg, matmul_dtype=None),
                             [torch.from_numpy(x) for x in streams], torch.from_numpy(y).long(),
                             torch.from_numpy(mask))[1]
    f32 = jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), f32))
    gap = max(np.abs(f - r).max() / max(np.abs(r).max(), 1e-3) for f, r in zip(f32, ref))
    assert gap > 10 * 1e-5, gap
    with pytest.raises(NotImplementedError, match=f"{key}.*{item}"):
        tadenet.check_supported(dataclasses.replace(direct, matmul_dtype="float16"))


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
