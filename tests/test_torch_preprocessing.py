"""The port's host-side data modules against the JAX package's, bit for bit.

``ip_avsr_torch/data/preprocessing.py`` and the reference generators of
``ip_avsr_torch/data/datagen.py`` are numpy copies of the JAX package's
modules, so every function must give the same arrays (values and dtypes,
``np.array_equal``) on the same seeded inputs; the generators under the same
``RandomState``.  Each case builds its inputs afresh for each package,
because some functions write into their input (``normalize_input``,
``apply_zca_whitening``).  ``zigzag_indices`` has one copy in the port
(``ops/dct.py``), which preprocessing imports.
"""

import itertools

import numpy as np
import pytest
import torch

from ip_avsr_tpu.data import datagen as jdg
from ip_avsr_tpu.data import preprocessing as jpp
from ip_avsr_torch.data import datagen as tdg
from ip_avsr_torch.data import preprocessing as tpp
from ip_avsr_torch.ops import dct as tdct

torch.set_num_threads(1)

PACKAGES = {"jax": (jpp, jdg), "port": (tpp, tdg)}


def _seqs(seed=0, n=7, d=5, lo=3, hi=9, dtype=np.float32):
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi, n)
    X = rng.randn(int(lens.sum()), d).astype(dtype)
    y = np.repeat(rng.randint(0, 4, n), lens)
    return X, y, lens


def _images(seed=1, n=6, shape=(6, 8)):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, shape[0] * shape[1]) * 255).astype(np.float64)


def _streams(seed=2):
    """Three (X, targets, lens) streams whose lengths differ per sequence."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, 8, 5)
    out = []
    for d, shift in ((4, 0), (3, 1), (2, -1)):
        l = np.maximum(lens + rng.randint(-1, 2, 5) * abs(shift), 1)
        out.append((rng.randn(int(l.sum()), d).astype(np.float32),
                    np.repeat(np.arange(5), l), l.reshape(-1, 1)))
    return out


def _take(gen, n):
    return list(itertools.islice(gen, n))


CASES = {
    "deltas_python_ref": lambda pp, dg: pp.deltas(_seqs()[0].T, 9),
    "deltas_matlab": lambda pp, dg: pp.deltas(_seqs()[0].T, 5, pad_mode="matlab"),
    "deltas_w1": lambda pp, dg: pp.deltas(_seqs()[0].T, 1),
    "concat_first_second_deltas": lambda pp, dg: pp.concat_first_second_deltas(
        _seqs()[0], _seqs()[2], 5),
    "create_split_index": lambda pp, dg: pp.create_split_index(
        60, [4, 5, 6, 7], [1, 3, 2, 4]),
    "split_videolen": lambda pp, dg: pp.split_videolen([4, 5, 6, 7], [1, 3, 2, 4]),
    "split_seq_data": lambda pp, dg: pp.split_seq_data(
        *_seqs()[:2], [1, 2, 3, 1, 2, 4, 5], _seqs()[2], [1, 4], [2], [3, 5]),
    "bytescale": lambda pp, dg: pp._bytescale(_images()[0]),
    "bytescale_constant": lambda pp, dg: pp._bytescale(np.full((3, 4), 7.0)),
    "resize_img": lambda pp, dg: pp.resize_img(_images()[0], (6, 8), (3, 5)),
    "resize_images": lambda pp, dg: pp.resize_images(_images(), (6, 8), (4, 4)),
    "resize_images_c_order": lambda pp, dg: pp.resize_images(
        _images(), (6, 8), (3, 4), order="C"),
    "normalize_input": lambda pp, dg: pp.normalize_input(_seqs()[0]),
    "normalize_input_quantize": lambda pp, dg: pp.normalize_input(
        _images(), centralize=False, quantize=True),
    "featurewise_normalize_sequence": lambda pp, dg: pp.featurewise_normalize_sequence(
        _seqs()[0]),
    "sequencewise_mean_image_subtraction": lambda pp, dg:
        pp.sequencewise_mean_image_subtraction(_seqs()[0], _seqs()[2]),
    "sequencewise_mean_image_subtraction_int": lambda pp, dg:
        pp.sequencewise_mean_image_subtraction(
            (_images() // 1).astype(np.int64), [2, 4]),
    "zigzag": lambda pp, dg: pp.zigzag(np.arange(35).reshape(5, 7)),
    "fill_zigzag": lambda pp, dg: pp.fill_zigzag((4, 6)),
    "zigzag_indices": lambda pp, dg: (pp.zigzag_indices((26, 44)), pp.zigzag_indices((3, 1))),
    "compute_dct_features_zigzag": lambda pp, dg: pp.compute_dct_features(
        _images(), (6, 8), 10),
    "compute_dct_features_variance": lambda pp, dg: pp.compute_dct_features(
        _images(), (6, 8), 7, method="variance"),
    "compute_dct_features_rel_variance": lambda pp, dg: pp.compute_dct_features(
        _images(), (6, 8), 7, method="rel_variance"),
    "compute_dct_features_energy": lambda pp, dg: pp.compute_dct_features(
        _images(), (6, 8), 7, method="energy"),
    "reorder_data": lambda pp, dg: pp.reorder_data(_images(), (6, 8)),
    "reorder_data_back": lambda pp, dg: pp.reorder_data(_images(), (6, 8), "c", "f"),
    "compute_diff_images": lambda pp, dg: pp.compute_diff_images(_seqs()[0], _seqs()[2]),
    "zca_whiten": lambda pp, dg: pp.zca_whiten(_images()[:1]),
    "apply_zca_whitening": lambda pp, dg: pp.apply_zca_whitening(_images()),
    "factorize": lambda pp, dg: pp.factorize(*_seqs(), 3, rng=np.random.RandomState(4)),
    "embed_temporal_info_odd": lambda pp, dg: pp.embed_temporal_info(
        *pp.factorize(*_seqs(lo=6, hi=12), 3, rng=np.random.RandomState(5)), 2, 3),
    "embed_temporal_info_even": lambda pp, dg: pp.embed_temporal_info(
        *pp.factorize(*_seqs(lo=6, hi=12), 2, rng=np.random.RandomState(6)), 1, 2),
    "force_align": lambda pp, dg: pp.force_align(
        (_streams()[0][0], _streams()[0][1], _streams()[0][2].ravel()),
        (_streams()[1][0], _streams()[1][1], _streams()[1][2].ravel())),
    "multistream_force_align": lambda pp, dg: pp.multistream_force_align(_streams()),
    "extract_stream_elements": lambda pp, dg: pp.extract_stream_elements(_streams()),
    "compute_integral_len": lambda pp, dg: dg.compute_integral_len(_seqs()[2]),
    "pack_batch": lambda pp, dg: dg._pack_batch(
        _seqs()[0], _seqs()[1], _seqs()[2], dg.compute_integral_len(_seqs()[2]),
        [3, 0, 6], 9),
    "gen_lstm_seq_random": lambda pp, dg: _take(dg.gen_lstm_seq_random(
        *_seqs(), rng=np.random.RandomState(7)), 10),
    "gen_lstm_batch_random": lambda pp, dg: _take(dg.gen_lstm_batch_random(
        *_seqs(dtype=np.float64), batchsize=3, rng=np.random.RandomState(8)), 6),
    "gen_lstm_batch_random_ordered": lambda pp, dg: _take(dg.gen_lstm_batch_random(
        *_seqs(), batchsize=4, shuffle=False), 3),
    "gen_lstm_batch_seq": lambda pp, dg: _take(dg.gen_lstm_batch_seq(
        *_seqs(), batchsize=3), 5),
    "sequence_batch_iterator": lambda pp, dg: _take(dg.sequence_batch_iterator(
        *_seqs(), batchsize=4), 3),
    "gen_seq_batch_from_idx": lambda pp, dg: dg.gen_seq_batch_from_idx(
        _seqs()[0], [5, 1], _seqs()[2], dg.compute_integral_len(_seqs()[2]), 9),
    "batch_iterator": lambda pp, dg: _take(dg.batch_iterator(
        _images(), np.arange(6), batchsize=4, rng=np.random.RandomState(9)), 4),
}


def assert_same(got, ref, path="out"):
    """Equal structure, and arrays equal in dtype and value (NaN in the same
    places)."""
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same(g, r, f"{path}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
        assert np.array_equal(got, ref, equal_nan=got.dtype.kind == "f"), path
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_function_matches_jax_bit_for_bit(name):
    ref = CASES[name](*PACKAGES["jax"])
    got = CASES[name](*PACKAGES["port"])
    assert_same(got, ref)


def test_one_zigzag_copy():
    assert tpp.zigzag_indices is tdct.zigzag_indices
