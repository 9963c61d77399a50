"""The JAX package's small public helpers in the port, each against its JAX
twin on seeded inputs: ``ops/voting.majority_voting_layer``,
``ops/lstm.grad_clip``, ``ops/lstm.last_valid_step_gathered``,
``ops/lstm.blstm_forward(grad_clipping=)``, ``ops/delta.delta_filter_weights``,
``ops/losses.categorical_crossentropy``, ``ops/dct.dct2_ortho``,
``models/encoder.encoder_output_dim`` and ``native.load_many(fallback=)``.

Tolerances, float32: values 1e-6 absolute (one rounding of a few terms),
the DCT 1e-5 of the largest coefficient (a product with the float64-built
basis against XLA's FFT), the BLSTM gradients 1e-5 of each gradient's
largest entry (tests/test_torch_lstm_train.py's limit); the vote, the taps,
the widths and the rejected files exactly.
"""

import jax
import jax.numpy as jnp
import jax.scipy.fft as jfft
import numpy as np
import pytest
import scipy.fft
import scipy.io as sio
import torch

from ip_avsr_tpu import native as jnative
from ip_avsr_tpu.models import encoder as jencoder
from ip_avsr_tpu.ops import delta as jdelta
from ip_avsr_tpu.ops import losses as jlosses
from ip_avsr_tpu.ops import lstm as jlstm
from ip_avsr_tpu.ops import voting as jvoting
from ip_avsr_torch import native
from ip_avsr_torch.models import encoder as tencoder
from ip_avsr_torch.ops import dct as tdct
from ip_avsr_torch.ops import delta as tdelta
from ip_avsr_torch.ops import losses as tlosses
from ip_avsr_torch.ops import lstm as tlstm
from ip_avsr_torch.ops import voting as tvoting
from tests.test_torch_lstm_train import KEYS, _case, _t

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=0)


def test_majority_voting_layer_with_ties():
    rng = np.random.RandomState(0)
    probs = rng.rand(4, 7, 5).astype(np.float32)
    probs[0, :, :] = 0.2  # every frame a five-way tie: all votes to class 0
    probs[1, 3, 1] = probs[1, 3, 4] = 2.0  # a two-way tie in one frame
    probs[2] = probs[2, :, ::-1]
    probs[3, :4, 2] = probs[3, 4:, 3] = 5.0  # 4 votes against 3
    got = tvoting.majority_voting_layer(torch.from_numpy(probs), 5)
    ref = np.asarray(jvoting.majority_voting_layer(jnp.asarray(probs), 5))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    assert got[0].argmax() == 0 and got[3].argmax() == 2
    np.testing.assert_array_equal(got.argmax(-1).numpy(), ref.argmax(-1))


@pytest.mark.parametrize("bound", [0.5, 5.0])
def test_grad_clip_against_jax_grad(bound):
    rng = np.random.RandomState(1)
    x = rng.randn(6, 4).astype(np.float32)
    w = 100.0 * rng.randn(6, 4).astype(np.float32)  # the upstream, x100

    ref = jax.grad(lambda a: jnp.sum(jnp.sin(jlstm.grad_clip(a, bound)) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tlstm.grad_clip(xt, bound)
    torch.testing.assert_close(out, xt)
    (torch.sin(out) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-6)
    assert np.abs(xt.grad.numpy()).max() == pytest.approx(bound)


def test_last_valid_step_gathered_with_an_all_pad_row():
    rng = np.random.RandomState(2)
    out = rng.randn(4, 6, 3).astype(np.float32)
    mask = (np.arange(6)[None] < np.array([6, 2, 0, 1])[:, None]).astype(np.float32)
    got = tlstm.last_valid_step_gathered(torch.from_numpy(out), torch.from_numpy(mask))
    ref = np.asarray(jlstm.last_valid_step_gathered(jnp.asarray(out), jnp.asarray(mask)))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[[0, 1, 2, 3]], out[[0, 1, 2, 3], [5, 1, 0, 0]])


@pytest.mark.parametrize("clip", [0.0, 5.0])
def test_blstm_forward_grad_clipping_against_jax_grad(clip):
    pf, x, mask, g = _case(8)
    pb, _, _, _ = _case(9)
    g = 100.0 * np.concatenate([g, g[:, ::-1]], axis=-1)  # x100: the clip bites

    def jloss(pf_, pb_, x_):
        out = jlstm.blstm_forward(pf_, pb_, x_, jnp.asarray(mask), "concat", clip)
        return jnp.sum(out * jnp.asarray(g))

    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}  # noqa: E731
    ref = jax.grad(jloss, argnums=(0, 1, 2))(jp(pf), jp(pb), jnp.asarray(x))
    tf = {k: _t(v).requires_grad_(True) for k, v in pf.items()}
    tb = {k: _t(v).requires_grad_(True) for k, v in pb.items()}
    xt = _t(x).requires_grad_(True)
    out = tlstm.blstm_forward(tf, tb, xt, _t(mask), "concat", clip)
    (out * _t(g)).sum().backward()
    got = [{k: tf[k].grad.numpy() for k in KEYS}, {k: tb[k].grad.numpy() for k in KEYS},
           {"x": xt.grad.numpy()}]
    want = [{k: np.asarray(ref[0][k]) for k in KEYS}, {k: np.asarray(ref[1][k]) for k in KEYS},
            {"x": np.asarray(ref[2])}]
    for gd, rd in zip(got, want):
        for k, r in rd.items():
            np.testing.assert_allclose(gd[k], r, atol=1e-5 * np.abs(r).max(), rtol=0,
                                       err_msg=k)
    # the argument reaches both directions: clip 5 and no clip differ
    other = tlstm.blstm_forward(*({k: _t(v).requires_grad_(True) for k, v in p.items()}
                                  for p in (pf, pb)), xt, _t(mask), "concat", 5.0 - clip)
    gx = torch.autograd.grad((other * _t(g)).sum(), xt)[0].numpy()
    assert np.abs(gx - got[2]["x"]).max() > 1e-2 * np.abs(got[2]["x"]).max()


@pytest.mark.parametrize("normalized", [True, False])
@pytest.mark.parametrize("window", [0, 1, 9])
def test_delta_filter_weights_bitwise(window, normalized):
    got = tdelta.delta_filter_weights(window, normalized)
    ref = jdelta.delta_filter_weights(window, normalized)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    # the taps are the plain DeltaLayer's FIR
    if window and normalized:
        x = torch.from_numpy(np.random.RandomState(3).randn(1, 20, 2).astype(np.float32))
        padded = tdelta._edge_pad_time(x, window)
        fir = sum(float(got[window + o]) * padded[:, window + o: window + o + 20]
                  for o in range(-window, window + 1))
        np.testing.assert_allclose(fir.numpy(), tdelta.delta_coeff(x, window).numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_categorical_crossentropy_against_jax(eps):
    rng = np.random.RandomState(4)
    probs = rng.dirichlet(np.ones(5), size=6).astype(np.float32)
    y = rng.randint(0, 5, 6)
    probs[2, y[2]] = 1e-6  # below eps: the clip bites
    got = tlosses.categorical_crossentropy(torch.from_numpy(probs), torch.from_numpy(y), eps)
    ref = jlosses.categorical_crossentropy(jnp.asarray(probs), jnp.asarray(y), eps)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    if eps:
        assert float(got) < float(tlosses.categorical_crossentropy(
            torch.from_numpy(probs), torch.from_numpy(y)))


@pytest.mark.parametrize("n", [1, 17, 90, 1144])
def test_dct2_ortho_against_jax(n):
    x = np.random.RandomState(n).randn(3, 2, n).astype(np.float32)
    got = tdct.dct2_ortho(torch.from_numpy(x)).numpy()
    ref = np.asarray(jfft.dct(jnp.asarray(x), type=2, norm="ortho", axis=-1))
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    # cached per (n, dtype, device); float64 against the float64 transform
    assert tdct._dct_matrix(n, torch.float32, torch.device("cpu")) is tdct._dct_matrix(
        n, torch.float32, torch.device("cpu"))
    x64 = tdct.dct2_ortho(torch.from_numpy(x.astype(np.float64))).numpy()
    np.testing.assert_allclose(x64, scipy.fft.dct(x.astype(np.float64), norm="ortho"),
                               atol=1e-12 * np.sqrt(n))


def test_encoder_output_dim_against_jax():
    rng = np.random.RandomState(5)
    names = ["fc1", "fc2", "fc3", "bottleneck", "fc5", "fc10", "fc6"]
    widths = {n: int(w) for n, w in zip(names, rng.randint(2, 30, len(names)))}
    params = {n: {"w": np.zeros((4, widths[n]), np.float32)} for n in names}
    tparams = {n: {"w": torch.zeros(4, widths[n])} for n in names}
    for sel in (None, ["fc1", "fc2", "fc3", "bottleneck"], ["fc2", "fc6"]):
        got = tencoder.encoder_output_dim(tparams, sel)
        assert got == jencoder.encoder_output_dim(params, sel)
        assert got == widths[sel[-1] if sel else "fc10"]


def test_load_many_fallback_against_jax(tmp_path, monkeypatch):
    # a build that raced another process when the JAX module was first
    # imported leaves it marked failed for the life of this process
    monkeypatch.setattr(jnative, "_build_failed", False)
    assert jnative.available(), "the JAX package's native reader did not build"
    rng = np.random.RandomState(6)
    paths = []
    for i in range(7):
        p = str(tmp_path / f"f{i}.mat")
        if i in (2, 5):  # char and logical arrays: the parser rejects them
            sio.savemat(p, {"s": "text", "m": np.array([[True]]), "i": np.array([[i]])})
        else:
            sio.savemat(p, {"x": rng.randn(3, 4).astype(np.float32), "i": np.array([[i]])})
        paths.append(p)
    for workers in (1, 3):
        seen = {"port": [], "jax": []}

        def recorder(key):
            def fallback(path):
                seen[key].append(path)
                return {"i": sio.loadmat(path)["i"], "from": key}
            return fallback

        got = native.load_many(paths, workers=workers, fallback=recorder("port"))
        ref = jnative.load_many(paths, workers=workers, fallback=recorder("jax"))
        assert sorted(seen["port"]) == sorted(seen["jax"]) == [paths[2], paths[5]]
        for i, (g, r) in enumerate(zip(got, ref)):
            assert int(g["i"].ravel()[0]) == int(r["i"].ravel()[0]) == i
            if i in (2, 5):
                assert g["from"] == "port" and r["from"] == "jax"
            else:
                np.testing.assert_array_equal(g["x"], r["x"])
    # with the reader off every file goes to the fallback, as in JAX
    monkeypatch.setenv("IP_AVSR_NATIVE", "0")
    seen = []
    native.load_many(paths[:3], fallback=lambda p: seen.append(p) or {})
    assert seen == paths[:3]


# the JAX package's public names and arguments that the port lacks by
# design (ROADMAP.md lists them with the reasons); the PRNG arguments, whose
# counterparts are torch generators, are left out of the comparison
PRNG_ARGS = {"key", "rng", "rngs", "dropout_rng", "agg_rngs"}
BY_DESIGN = {
    ("module", "utils/compilation_cache.py", None),
    ("name", "utils/cpu_mesh.py", "cpu_mesh_env"),
    ("name", "parallel/_multiprocess_worker.py", "main"),
    ("name", "reference_impl.py", "jax_tree_to_np"),
    ("arg", "ops/delta.py", "delta_layer/use_pallas"),
    ("arg", "ops/lstm.py", "lstm_forward/use_custom_vjp"),
    ("arg", "ops/lstm.py", "lstm_forward_grouped/use_custom_vjp"),
    ("arg", "export.py", "resolved_platforms/batch"),
    ("arg", "export.py", "resolved_platforms/time"),
    ("arg", "io/matio.py", "save_model_params/params_pytree"),
    ("arg", "parallel/mesh.py", "make_mesh_nd/devices"),
    ("arg", "pretrain/rbm.py", "cd1_step/row_mask"),
}


def _public(root, imported):
    """{module path: {public top-level name: argument names or None}}; with
    ``imported``, names a module imports count as its own."""
    import ast
    import os

    out = {}
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath or "_build" in dirpath:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = {}
            for node in ast.parse(open(path).read()).body:
                if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                    names[node.name] = [a.arg for a in node.args.args + node.args.kwonlyargs]
                elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                    names[node.name] = None
                elif imported and isinstance(node, ast.ImportFrom):
                    names.update({a.asname or a.name: None for a in node.names})
            out[os.path.relpath(path, root)] = names
    return out


def test_public_names_differ_from_the_jax_package_only_by_design():
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_names = _public(os.path.join(root, "ip_avsr_tpu"), imported=False)
    port_names = _public(os.path.join(root, "ip_avsr_torch"), imported=True)
    gaps = set()
    for module, names in jax_names.items():
        if module.startswith("ops/pallas/"):  # the kernels: ip_avsr_torch/csrc
            continue
        if module not in port_names:
            gaps.add(("module", module, None))
            continue
        for name, args in names.items():
            if name not in port_names[module]:
                gaps.add(("name", module, name))
            elif args and port_names[module][name] is not None:
                gaps |= {("arg", module, f"{name}/{a}") for a in args
                         if a not in port_names[module][name] and a not in PRNG_ARGS}
    assert gaps == BY_DESIGN
