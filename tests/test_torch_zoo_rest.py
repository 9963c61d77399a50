"""The whole model zoo of the port against the JAX package's: every case of
tests/zoo_cases.py::ZOO_CASES built by the port's builders (``models/zoo``,
``models/avnet``) equals the JAX config field for field, and each case of
NEW (the builders no other test file runs: batch norm, the bimodal and
trimodal variants, avnet) runs a tiny forward equal to JAX's
``adenet_forward`` within 2e-5 on the same parameters
(``bridge.params_from_jax``; the batch-norm running statistics set away
from their init, so evaluation mode normalizes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ip_avsr_tpu import export as jexport
from ip_avsr_tpu.models import adenet as jadenet
from ip_avsr_torch import bridge
from ip_avsr_torch.models import adenet as tadenet
from tests import zoo_cases
from tests.torch_trainer_lib import jax_fields, zoo_case as port_case

torch.set_num_threads(1)
FWD_TOL = 2e-5
# the cases whose builders no other test file runs
NEW = ["deltanet", "baseline_end2end", "adenet_v1", "adenet_v1_1", "adenet_v2_2",
       "adenet_v2_nodelta", "adenet_v5_adascale", "adenet_v6", "adenet_v6_adascale", "avnet"]


@pytest.mark.parametrize("name", sorted(zoo_cases.ZOO_CASES))
def test_builder_matches_jax_field_for_field(name):
    got, ref = port_case(name), zoo_cases.ZOO_CASES[name]()
    assert isinstance(got, tadenet.AdeNetConfig)
    assert jax_fields(got) == jexport.config_to_dict(ref)
    assert got.fused_dim() == ref.fused_dim()
    assert got.classifier_in_dim() == ref.classifier_in_dim()
    tadenet.check_supported(got)


def _jax_params(cfg, seed):
    """JAX's initial parameters as numpy, every batch-norm leaf moved off
    its init."""
    params = jax.tree_util.tree_map(
        np.asarray, jadenet.init_adenet_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    for spec in cfg.streams:
        sp = params["streams"][spec.name]
        if spec.use_batchnorm:
            d = spec.encoded_dim()
            sp["bn"] = {"gamma": (1 + 0.2 * rng.randn(d)).astype(np.float32),
                        "beta": (0.2 * rng.randn(d)).astype(np.float32)}
            sp["bn_state"] = {"mean": (0.3 * rng.randn(d)).astype(np.float32),
                              "var": (0.5 + rng.rand(d)).astype(np.float32)}
    return params


@pytest.mark.parametrize("name", NEW)
def test_forward_matches_jax(name):
    jcfg, tcfg = zoo_cases.ZOO_CASES[name](), port_case(name)
    params = _jax_params(jcfg, 3)
    rng = np.random.RandomState(0)
    B, T = 3, 9
    xs = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in jcfg.streams]
    mask = (np.arange(T)[None] < np.array([T, 5, 1])[:, None]).astype(np.float32)
    ref = jax.jit(lambda p, x, m: jadenet.adenet_forward(p, jcfg, x, m))(
        params, [jnp.asarray(x) for x in xs], jnp.asarray(mask))
    got = tadenet.adenet_forward(bridge.params_from_jax(params, device="cpu"), tcfg,
                                 [torch.from_numpy(x) for x in xs], torch.from_numpy(mask))
    assert got.shape == ref.shape and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)
