"""The yardsticks against hand sums, and the configuration files against the
program's own builders."""

import dataclasses
import json
import math
import os

import pytest
import torch

from avsr_bench.harness import drive, inputs, yardstick
from conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "avsr_bench", "configs", f"{name}.json")) as f:
        return json.load(f)


FLAGSHIP = _config("adenet_v3-oulu-trimodal")
FOUR = _config("adenet-oulu-4stream")


def test_flagship_flops_per_frame_by_hand():
    enc = 2 * (1144 * 2000 + 2000 * 1000 + 1000 * 500 + 500 * 50)
    streams = 2 * (150 * 2000 + 500 * 2000) * 2 + 2 * (90 * 2000 + 500 * 2000)
    blstm = 2 * 2 * (500 * 2000 + 500 * 2000)
    per_frame, per_utt = yardstick.model_flops(FLAGSHIP["model"])
    assert 2 * enc == 19_252_000 and streams == 7_560_000 and blstm == 8_000_000
    assert per_frame == 2 * enc + streams + blstm == 34_812_000
    assert per_utt == 2 * 500 * 10


def test_four_stream_flops_per_frame_by_hand():
    enc = 2 * 2 * (1144 * 2000 + 2000 * 1000 + 1000 * 500 + 500 * 50)
    lstm = sum(2 * (d * 1000 + 250 * 1000) for d in (150, 150, 270, 117))
    blstm = 2 * 2 * (250 * 1000 + 250 * 1000)
    per_frame, per_utt = yardstick.model_flops(FOUR["model"])
    assert per_frame == enc + lstm + blstm + 2 * 250 * 10 and per_utt == 0


def test_lstm_layers_of_both_configs():
    assert yardstick.lstm_layers(FLAGSHIP["model"]) == [
        ("raw", 150, 500, False), ("dct", 90, 500, False), ("diff", 150, 500, False),
        ("aggregator0.fwd", 500, 500, False), ("aggregator0.bwd", 500, 500, False)]
    assert [layer[1:] for layer in yardstick.lstm_layers(FOUR["model"])] == [
        (150, 250, True), (150, 250, True), (270, 250, True), (117, 250, True),
        (250, 250, True), (250, 250, True)]


@pytest.mark.parametrize("peep", [False, True])
def test_lstm_costs_by_hand(peep):
    B, T, H = 10, 29, 500
    nbytes, flops = yardstick.lstm_cost(B, T, H, peep)
    assert nbytes == 4 * (B * T * 4 * H + B * T + 2 * B * H + B * T * H + H * 4 * H
                          + (3 * H if peep else 0))
    assert flops == 2 * B * T * H * 4 * H + (20 + (6 if peep else 0)) * B * T * H
    tb, tf = yardstick.lstm_train_cost(B, T, H, peep)
    assert tb == nbytes + 4 * (B * T * H + B * T * 4 * H) and tf == flops
    bb, bf = yardstick.lstm_bwd_cost(B, T, H, peep)
    assert bf == 2 * B * T * 4 * H * H + 40 * B * T * H + (18 * B * T * H + 3 * B * H if peep
                                                           else 0)
    assert bb > nbytes


def test_bound_takes_the_larger_time():
    assert yardstick.bound(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound(0, 67e12) == pytest.approx(1.0)
    assert yardstick.bound(3.35e9, 67e12) == pytest.approx(1.0)
    nbytes, flops = yardstick.gemm_cost(7424, 1144, 2000)
    assert flops == 2 * 7424 * 1144 * 2000 and nbytes == 4 * (7424 * 1144 + 1144 * 2000
                                                               + 7424 * 2000)


@pytest.mark.parametrize("cfg", [FLAGSHIP, FOUR], ids=["flagship", "4stream"])
def test_weights_have_the_programs_layout(cfg):
    from ip_avsr_torch.models import adenet

    config = dataclasses.replace(drive.adenet_config(cfg["model"]), w_init="glorot")
    theirs = adenet.init_adenet_params(torch.Generator().manual_seed(0), config, device="cpu")
    ours = inputs.make_weights(cfg["model"], 2**31 + 5, torch.device("cpu"))

    def flat(tree, path=()):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in flat(v, path + (k,))]
        if isinstance(tree, list):
            return [x for i, v in enumerate(tree) for x in flat(v, path + (i,))]
        return [(path, tuple(tree.shape), tree.dtype)]

    assert flat(ours) == flat(theirs)
    if cfg is FLAGSHIP:
        # the mesh step's flat all-reduce is these plus the loss's two
        # parts: 69,732,448 bytes
        assert 4 * (sum(math.prod(s) for _, s, _ in flat(ours)) + 2) == 69_732_448


def test_weights_repeat_for_a_seed_and_stay_in_range():
    a = inputs.make_weights(FLAGSHIP["model"], 2**33 + 1, torch.device("cpu"))
    b = inputs.make_weights(FLAGSHIP["model"], 2**33 + 1, torch.device("cpu"))
    c = inputs.make_weights(FLAGSHIP["model"], 2**33 + 2, torch.device("cpu"))
    w = a["streams"]["raw"]["encoder"]["fc1"]["w"]
    assert torch.equal(w, b["streams"]["raw"]["encoder"]["fc1"]["w"])
    assert not torch.equal(w, c["streams"]["raw"]["encoder"]["fc1"]["w"])
    assert float(w.abs().max()) <= math.sqrt(6 / (1144 + 2000))
    assert float(a["streams"]["raw"]["lstm"]["b"].abs().max()) <= inputs.VECTOR_RANGE


def test_flagship_config_is_zoo_adenet_v3():
    from ip_avsr_torch.models import zoo

    assert drive.adenet_config(FLAGSHIP["model"]) == zoo.adenet_v3(
        1144, 90, 1144, lstm_size=250, window=9, output_classes=10)


def test_four_stream_config_is_the_ini_through_build_model_config():
    from ip_avsr_torch.train import config as cfg_lib

    cp = cfg_lib.load_config(os.path.join(ROOT, "configs", "oulu_4stream.ini"))
    built = cfg_lib.build_model_config(cfg_lib.parse_streams(cp), cfg_lib.parse_classifier(cp))
    assert drive.adenet_config(FOUR["model"]) == built
    assert cfg_lib.parse_training(cp).learning_rate == pytest.approx(1e-4)


def test_lengths_are_one_multiset_in_each_seeds_order():
    a, b = inputs.lengths(2048, 5, 29, 1), inputs.lengths(2048, 5, 29, 2**31 + 3)
    assert sorted(a) == sorted(b) and not (a == b).all()
    assert a.min() == 5 and a.max() == 29
