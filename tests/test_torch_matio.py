"""The port's ``.mat`` ABI (``ip_avsr_torch/io/matio.py``) against the JAX
package's (``ip_avsr_tpu/io/matio.py``): a dataset, a DBN checkpoint and an
LSTM bundle written by either package read by the other, equal bit for bit
(values, dtypes, Fortran-order 2-D shapes, as ``scipy.io.loadmat`` gives
them); the subject split files; ``load_decoder``; and the file-backed
generators of ``data/datagen.py`` under the same ``RandomState``, a missing
shard included (it gives a zero sequence in both packages).
"""

import numpy as np
import pytest
import torch

from ip_avsr_tpu.data import datagen as jdg
from ip_avsr_tpu.io import matio as jmatio
from ip_avsr_torch.data import datagen as tdg
from ip_avsr_torch.io import matio as tmatio

torch.set_num_threads(1)

MODULES = {"jax": jmatio, "port": tmatio}
DIRECTIONS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def _dataset(seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 9, 6)
    return {
        "dataMatrix": (rng.rand(int(lens.sum()), 12) * 255).astype(np.uint8),
        "dctFeatures": rng.randn(int(lens.sum()), 5),
        "targetsVec": np.repeat(rng.randint(1, 4, 6), lens).reshape(-1, 1),
        "subjectsVec": (np.arange(6) % 3 + 1).reshape(-1, 1),
        "videoLengthVec": lens.reshape(-1, 1).astype(np.int32),
        "iterVec": rng.randint(1, 4, (6, 1)).astype(np.uint8),
    }


def _arrays(d):
    return {k: v for k, v in d.items() if not k.startswith("__")}


def _assert_dicts_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_dataset_cross_read(tmp_path, writer, reader):
    path = str(tmp_path / "ds.mat")
    MODULES[writer].save_mat(_dataset(), path)
    got = _arrays(MODULES[reader].load_mat_file(path))
    ref = _arrays(jmatio.load_mat_files([path])[0])
    _assert_dicts_equal(got, ref)
    np.testing.assert_array_equal(got["dataMatrix"], _dataset()["dataMatrix"])
    # many files, in order
    MODULES[writer].save_mat(_dataset(1), str(tmp_path / "ds1.mat"))
    many = MODULES[reader].load_mat_files([str(tmp_path / "ds1.mat"), path])
    _assert_dicts_equal(_arrays(many[1]), ref)
    np.testing.assert_array_equal(many[0]["videoLengthVec"], _dataset(1)["videoLengthVec"])


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_dbn_checkpoint_cross_read(tmp_path, writer, reader):
    rng = np.random.RandomState(3)
    shapes = [(12, 9), (9, 7), (7, 4), (4, 2)]
    weights = [rng.randn(*s) for s in shapes]  # float64 in, float32 on disk
    biases = [rng.randn(s[1]) for s in shapes]
    path = str(tmp_path / "ae.mat")
    MODULES[writer].save_dbn_mat(weights, biases, path)
    got_w, got_b = MODULES[reader].load_dbn_mat(path, n_layers=4)
    ref_w, ref_b = jmatio.load_dbn_mat(path, n_layers=4)
    for g, r, src in zip(got_w + got_b, ref_w + ref_b, weights + biases):
        assert g.dtype == r.dtype == np.float32 and g.shape == r.shape == src.shape
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, src.astype(np.float32))
    # a dict goes through as it is; load_decoder parses the config strings
    got = tmatio.load_decoder(tmatio.load_mat_file(path), "9,7,4,2", "sigmoid,linear,a,b")
    ref = jmatio.load_decoder(jmatio.load_mat_files([path])[0], "9,7,4,2",
                              "sigmoid,linear,a,b")
    assert got[2:] == ref[2:] == ([9, 7, 4, 2], ["sigmoid", "linear", "a", "b"])
    for g, r in zip(got[0] + got[1], ref[0] + ref[1]):
        np.testing.assert_array_equal(g, r)
    assert tmatio.load_decoder(path, [9, 7], ["x", "y"], str.upper)[3] == ["X", "Y"]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_lstm_bundle_cross_read(tmp_path, writer, reader):
    rng = np.random.RandomState(4)
    D, H = 6, 5
    params = {"w_in": rng.randn(D, 4 * H).astype(np.float32),
              "w_hid": rng.randn(H, 4 * H).astype(np.float32),
              "b": rng.randn(4 * H).astype(np.float32)}
    if writer == "port":  # the port's writer takes its own tensors too
        params = {k: torch.as_tensor(v) for k, v in params.items()}
    bundle = MODULES[writer].lstm_params_to_mat_dict(params, "lstm_s1")
    ref_bundle = jmatio.lstm_params_to_mat_dict(
        {k: np.asarray(v) for k, v in params.items()}, "lstm_s1")
    assert len(bundle) == 12
    _assert_dicts_equal(bundle, ref_bundle)
    path = str(tmp_path / "lstm.mat")
    MODULES[writer].save_mat(bundle, path)
    got = MODULES[reader].lstm_params_from_mat_dict(
        MODULES[reader].load_mat_file(path), "lstm_s1")
    ref = jmatio.lstm_params_from_mat_dict(jmatio.load_mat_files([path])[0], "lstm_s1")
    _assert_dicts_equal(got, ref)
    for k in ("w_in", "w_hid", "b"):
        np.testing.assert_array_equal(got[k], np.asarray(params[k]))


def test_read_data_split_file(tmp_path):
    (tmp_path / "train.txt").write_text("1,2,13,4\nignored\n")
    (tmp_path / "semi.txt").write_text("7;8\n")
    for name, sep in (("train.txt", ","), ("semi.txt", ";")):
        path = str(tmp_path / name)
        assert (tmatio.read_data_split_file(path, sep)
                == jmatio.read_data_split_file(path, sep))
    assert tmatio.read_data_split_file(str(tmp_path / "train.txt")) == [1, 2, 13, 4]


def _shards(tmp_path):
    """Per-video .mat shards of float64 frames, one path missing and one
    file without the data key."""
    rng = np.random.RandomState(5)
    lens = np.array([4, 7, 3, 6, 5, 2])
    paths = []
    for i, n in enumerate(lens):
        path = str(tmp_path / f"v{i}.mat")
        if i == 2:
            path = str(tmp_path / "missing.mat")  # never written
        elif i == 4:
            tmatio.save_mat({"otherField": rng.randn(n, 3)}, path)
        else:
            tmatio.save_mat({"dataMatrix": rng.randn(n, 3)}, path)
        paths.append(path)
    return paths, np.arange(len(lens)) % 3, lens


@pytest.mark.parametrize("shuffle", [True, False])
def test_gen_batch_from_file_matches_jax(tmp_path, capsys, shuffle):
    paths, y, lens = _shards(tmp_path)
    out = {}
    for name, dg in (("jax", jdg), ("port", tdg)):
        gen = dg.gen_batch_from_file(paths, y, lens, 3, batchsize=4, shuffle=shuffle,
                                     rng=np.random.RandomState(6))
        out[name] = [next(gen) for _ in range(4)]
    for got, ref in zip(out["port"], out["jax"]):
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
    printed = capsys.readouterr().out
    assert "missing.mat" in printed and "v4.mat" in printed
    # the missing shard's rows are zeros (its mask still marks its length)
    X, _, mask, idxs = out["port"][0]
    for row, vid in enumerate(idxs):
        if vid == 2:
            assert not X[row].any() and mask[row].sum() == 3


def test_gen_file_batch_from_idx_matches_jax(tmp_path, capsys):
    paths, _, lens = _shards(tmp_path)
    idxs = [5, 2, 0, 4, 1]
    got = tdg.gen_file_batch_from_idx(paths, idxs, lens, 7, 3)
    ref = jdg.gen_file_batch_from_idx(paths, idxs, lens, 7, 3)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    assert not got[1].any() and not got[3].any() and got[0, :2].all()
    assert capsys.readouterr().out.count("Error reading file") == 4  # 2 per package
