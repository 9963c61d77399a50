"""The port's native ``.mat`` reader (ip_avsr_torch/native, reached through
``ip_avsr_torch/io/matio``) against ``scipy.io.loadmat`` and against the
JAX package's native reader, on the same files: every key equal bit for
bit in value, dtype, shape and Fortran order.  The cases of
tests/test_native_matio.py, run on the port: compressed and uncompressed
numeric arrays, Fortran order, unsupported content and a corrupt file going
to scipy, the thread pool's input order, the DBN checkpoint, the
``IP_AVSR_NATIVE=0`` switch, logical arrays and the fuzzed mutations
(hypothesis, ``derandomize=True``, in a process of their own:
tests/torch_matread_fuzz.py).  Added: the port's dicts against JAX's
native reader's, and a build that fails (no compiler, a broken source)
raises instead of turning into scipy.

The reader is built here with ``g++`` and zlib; a missing toolchain fails
these tests, it does not skip them.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio
import torch

import chip_smoke
from ip_avsr_tpu import native as jnative
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_torch import native
from ip_avsr_torch.io import matio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cases():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(29, 40).astype(np.float32),
        "f64": rng.randn(5, 7),
        "u8": rng.randint(0, 255, (30, 40)).astype(np.uint8),
        "i16": rng.randint(-99, 99, (4, 4)).astype(np.int16),
        "i32": rng.randint(-5, 5, (10,)).astype(np.int32),
        "i64": rng.randint(-5, 5, (3, 2)).astype(np.int64),
        "empty": np.zeros((0, 3), np.float64),
        "scalar": np.array([[3.5]]),
        "three_d": rng.randn(3, 4, 5).astype(np.float32),
    }


def _arrays(d):
    return {k: v for k, v in d.items() if not k.startswith("__")}


def _assert_same(got, ref):
    """Equal keys; each array equal in dtype, shape, Fortran order and value."""
    got, ref = _arrays(got), _arrays(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert got[k].flags["F_CONTIGUOUS"] == ref[k].flags["F_CONTIGUOUS"], k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("compress", [False, True])
def test_numeric_parity_with_scipy(tmp_path, compress):
    p = str(tmp_path / "t.mat")
    sio.savemat(p, _cases(), do_compression=compress)
    got = native.load_mat_native(p)
    assert got is not None
    _assert_same(got, sio.loadmat(p))
    _assert_same(matio.load_mat_file(p), sio.loadmat(p))
    got["f32"][0, 0] = 1.0  # writable, as scipy's arrays are


def test_fortran_order_semantics(tmp_path):
    """The loader hands back scipy's element order for a transposed
    (non-C-contiguous) save; reorder_data's F-vs-C handling is downstream."""
    p = str(tmp_path / "f.mat")
    sio.savemat(p, {"x": np.arange(12, dtype=np.float32).reshape(3, 4).T})
    _assert_same(native.load_mat_native(p), sio.loadmat(p))


def test_unsupported_content_goes_to_scipy(tmp_path):
    p = str(tmp_path / "s.mat")
    sio.savemat(p, {"s": "hello", "x": np.ones((2, 2))})
    assert native.load_mat_native(p) is None
    d = matio.load_mat_file(p)
    np.testing.assert_array_equal(d["x"], np.ones((2, 2)))
    assert "hello" in str(d["s"])


def test_corrupt_file_raises_scipys_error(tmp_path):
    p = str(tmp_path / "bad.mat")
    with open(p, "wb") as f:
        f.write(b"not a mat file at all" * 10)
    assert native.load_mat_native(p) is None
    with pytest.raises(Exception) as port_err:
        matio.load_mat_file(p)
    with pytest.raises(Exception) as scipy_err:
        sio.loadmat(p)
    assert type(port_err.value) is type(scipy_err.value)


def test_load_mat_files_parallel_order_and_fallback(tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for i in range(12):
        p = str(tmp_path / f"v{i}.mat")
        if i == 5:  # one scipy-only file in the middle
            sio.savemat(p, {"s": "text", "targetsVec": np.array([[i]])})
        else:
            sio.savemat(p, {"dataMatrix": rng.randn(7, 9).astype(np.float32),
                            "targetsVec": np.array([[i]])}, do_compression=True)
        paths.append(p)
    outs = matio.load_mat_files(paths, workers=4)
    for i, (d, p) in enumerate(zip(outs, paths)):
        assert int(np.asarray(d["targetsVec"]).ravel()[0]) == i
        if i != 5:
            _assert_same(d, sio.loadmat(p))
    assert b"native reader" in outs[0]["__header__"]
    assert b"native reader" not in outs[5]["__header__"]


def test_dbn_checkpoint_roundtrip_through_native(tmp_path):
    """The w1..wN ABI (dbn/extractNN.m:86-105) read back natively, bit for bit."""
    rng = np.random.RandomState(2)
    weights = [rng.randn(8, 6).astype(np.float32), rng.randn(6, 4).astype(np.float32)]
    biases = [rng.randn(6).astype(np.float32), rng.randn(4).astype(np.float32)]
    p = str(tmp_path / "dbn.mat")
    matio.save_dbn_mat(weights, biases, p)
    assert native.load_mat_native(p) is not None
    w2, b2 = matio.load_dbn_mat(p, n_layers=2)
    for a, b in zip(weights + biases, w2 + b2):
        np.testing.assert_array_equal(a, b)


def test_env_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("IP_AVSR_NATIVE", "0")
    assert not native.available()
    p = str(tmp_path / "t.mat")
    sio.savemat(p, {"x": np.ones((2, 2))})
    assert native.load_mat_native(p) is None
    for d in (matio.load_mat_file(p), matio.load_mat_files([p, p])[1]):
        assert b"native reader" not in d["__header__"]
        np.testing.assert_array_equal(d["x"], np.ones((2, 2)))


def test_logical_arrays_go_to_scipy(tmp_path):
    """MATLAB logical arrays load as bool through scipy; the strict parser
    defers rather than return uint8 for them."""
    p = str(tmp_path / "l.mat")
    sio.savemat(p, {"m": np.array([[True, False], [False, True]])})
    if sio.loadmat(p)["m"].dtype == np.bool_:
        assert native.load_mat_native(p) is None
    assert matio.load_mat_file(p)["m"].dtype == sio.loadmat(p)["m"].dtype


def test_fuzz_mutations_never_crash_or_diverge():
    """200 hypothesis mutants of two valid files (byte flips, truncations,
    splices; derandomized): no crash, and wherever both the native reader and
    scipy parse a mutant they agree (tests/torch_matread_fuzz.py).  Run in a
    subprocess so a crash fails this test instead of the worker."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_matread_fuzz.py"),
                           "200"], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, (
        f"fuzzer failed (rc={proc.returncode}; negative = signal):\n{proc.stdout}\n{proc.stderr}")
    assert "fuzzed 200 mutants" in proc.stdout
    assert "both_parse_equal=" in proc.stdout and "native_fallback=" in proc.stdout


def test_v4_header_goes_to_scipy(tmp_path):
    """A zero in the first 4 bytes makes scipy read the file as MAT v4; the
    native reader defers it rather than parse it as v5 (the divergence the
    fuzzer found: a one-byte flip of the header text)."""
    p = str(tmp_path / "t.mat")
    sio.savemat(p, {"x": np.ones((2, 2))})
    blob = bytearray(open(p, "rb").read())
    blob[1] = 0
    with open(p, "wb") as f:
        f.write(blob)
    assert native.load_mat_native(p) is None


def _files(tmp_path):
    """{name: path} of the files both native readers are held on: the
    numeric cases compressed and not, a DBN checkpoint, and a seeded corpus
    (chip_smoke.write_cli_corpus: uint8 pixels, float64 features, the
    vectors, two autoencoders)."""
    files = {}
    for compress in (False, True):
        files[f"cases_{int(compress)}"] = str(tmp_path / f"cases_{int(compress)}.mat")
        sio.savemat(files[f"cases_{int(compress)}"], _cases(), do_compression=compress)
    rng = np.random.RandomState(3)
    files["dbn"] = str(tmp_path / "dbn.mat")
    matio.save_dbn_mat([rng.randn(12, 8), rng.randn(8, 4)], [rng.randn(8), rng.randn(4)],
                       files["dbn"])
    corpus = chip_smoke.write_cli_corpus(str(tmp_path), dict(n=12, imagesize=(6, 8), dct=10,
                                                             mfcc=7, ae=(16, 8)))
    files.update({k: v for k, v in corpus.items() if v.endswith(".mat")})
    return files


def test_port_reads_as_the_jax_native_reader(tmp_path, monkeypatch):
    # a build that raced another process when the JAX module was first
    # imported leaves it marked failed for the life of this process
    monkeypatch.setattr(jnative, "_build_failed", False)
    assert jnative.available(), "the JAX package's native reader did not build"
    files = _files(tmp_path)
    paths = sorted(files.values())
    for path in paths:
        ref = jnative.load_mat_native(path)
        assert ref is not None, path
        _assert_same(native.load_mat_native(path), ref)
        _assert_same(native.load_mat_native(path), sio.loadmat(path))
    for got, ref in zip(matio.load_mat_files(paths, workers=3), jmatio.load_mat_files(paths)):
        _assert_same(got, ref)


@pytest.mark.parametrize("fault", ["no compiler", "broken source"])
def test_failed_build_raises(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    if fault == "no compiler":
        monkeypatch.setattr(native, "CXX", str(tmp_path / "absent-g++"))
        match = "cannot run"
    else:
        src = tmp_path / "matread.cc"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(native, "SOURCE", str(src))
        match = "failed with exit"
    p = str(tmp_path / "t.mat")
    sio.savemat(p, {"x": np.ones((2, 2))})
    with pytest.raises(RuntimeError, match=match):
        native.available()
    with pytest.raises(RuntimeError, match=match):
        matio.load_mat_file(p)
    with pytest.raises(RuntimeError, match=match):
        matio.load_mat_files([p])
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]


def test_build_is_named_by_source_and_flags(tmp_path, monkeypatch):
    """The library's name carries a hash of the source and the flags, so an
    edited source is rebuilt beside the old library; a build leaves no
    temporary file behind."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    first = native.build()
    assert os.path.basename(first).startswith("matread-") and first.endswith(".so")
    assert native.build() == first  # up to date: not rebuilt
    src = tmp_path / "matread.cc"
    src.write_text(open(native.SOURCE).read() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCE", str(src))
    second = native.build()
    assert second != first and os.path.exists(first) and os.path.exists(second)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(p) for p in (first, second))
