"""The readers of the program's spans (``avsr_bench/harness/spans.py`` and
the eight ``*_ms.*`` metrics) on synthetic records of two traced windows,
the second slower: each reads the first window's mean per step or request,
and None untraced, off the card, without records or without the whole
window."""

import sys
import types

import pytest
import torch

from avsr_bench.harness import spans, spec

STEPS, REQUESTS, DEPTH = 5, 8, 4
# per step or request in the first window; the second reads twice as much
TRAIN = {"forward_ms.train": ("train.forward", 11.0),
         "backward_ms.train": ("train.backward", 19.0),
         "optimizer_ms.train": ("train.optimizer", 2.5)}
SCORE = {"pipeline_ms.score": ("serve.pipeline", 0.6),
         "streams_ms.score": ("model.streams", 4.0), "head_ms.score": ("model.head", 9.0),
         "stage_host_ms.score": ("serve.stage", 1.5), "wait_host_ms.score": ("serve.wait", 10.0)}


def _rec(recs, name, ident, ms, parent=None, host=False, count=None, ids=None):
    recs.append({"name": name, "parent": parent, "id": ident, "start_ns": 0,
                 "end_ns": int(ms * 1e6), "host_ms": ms if host else 0.01,
                 "device_ms": None if host else ms, "count": count, "ids": ids,
                 "nbytes": None})
    return len(recs) - 1


def train_records(steps=STEPS):
    recs = []
    for i in range(2 * steps):
        slow = 1 if i < steps else 2
        root = _rec(recs, "train.step", i, 40.0 * slow)
        fwd = _rec(recs, "train.forward", i, TRAIN["forward_ms.train"][1] * slow, root)
        _rec(recs, "model.streams", i, 3.0 * slow, fwd)
        _rec(recs, "model.head", i, 6.0 * slow, fwd)
        _rec(recs, "train.backward", i, TRAIN["backward_ms.train"][1] * slow, root)
        _rec(recs, "train.optimizer", i, TRAIN["optimizer_ms.train"][1] * slow, root)
    return recs


def score_records(requests=REQUESTS):
    recs, block = [], []
    for i in range(100, 100 + 2 * requests):  # ids need not start at 0
        slow = 1 if i < 100 + requests else 2
        _rec(recs, "serve.stage", i, SCORE["stage_host_ms.score"][1] * slow, host=True)
        fwd = _rec(recs, "serve.forward", i, 14.0 * slow, count=1)
        for metric in ("pipeline_ms.score", "streams_ms.score", "head_ms.score"):
            name, ms = SCORE[metric]
            _rec(recs, name, i, ms * slow, fwd)
        block.append(i)
        if len(block) == DEPTH:
            _rec(recs, "serve.wait", None, SCORE["wait_host_ms.score"][1] * DEPTH * slow,
                 host=True, ids=list(block))
            block = []
    return recs


def _run(kind, traced=True, device="cuda"):
    traffic = {"trace_steps": STEPS} if kind == "train" else {"trace_requests": REQUESTS}
    return types.SimpleNamespace(kind=kind, traced=traced, device=torch.device(device, 0),
                                 traffic=traffic)


CASES = [(m, "train", ms) for m, (_, ms) in TRAIN.items()] + [
    (m, "score", ms) for m, (_, ms) in SCORE.items()]


@pytest.fixture
def records(monkeypatch):
    held = {}
    monkeypatch.setattr(spans, "program_records", lambda: held.get("recs"))
    return held


@pytest.mark.parametrize("metric,kind,want", CASES)
def test_each_reader_reads_the_first_windows_mean(records, metric, kind, want):
    records["recs"] = train_records() if kind == "train" else score_records()
    assert spec.metric_reader(metric)(_run(kind)) == pytest.approx(want)


@pytest.mark.parametrize("metric,kind,want", CASES)
def test_each_reader_is_none_untraced_off_the_card_or_for_the_other_kind(records, metric,
                                                                          kind, want):
    records["recs"] = train_records() if kind == "train" else score_records()
    read = spec.metric_reader(metric)
    assert read(_run(kind, traced=False)) is None
    assert read(_run(kind, device="cpu")) is None
    assert read(_run("score" if kind == "train" else "train")) is None


@pytest.mark.parametrize("metric,kind,want", CASES)
def test_each_reader_is_none_without_records_or_a_whole_window(records, metric, kind, want):
    read = spec.metric_reader(metric)
    assert read(_run(kind)) is None  # the program gave none
    records["recs"] = []
    assert read(_run(kind)) is None
    # fewer steps or requests recorded than the first window holds
    half = train_records(STEPS)[:6 * (STEPS - 1)] if kind == "train" else (
        score_records(REQUESTS)[:5 * (REQUESTS - 1)])
    records["recs"] = half
    assert read(_run(kind)) is None


def test_a_layer_without_the_cards_times_reads_none():
    recs = train_records()
    recs[1]["device_ms"] = None
    assert spans.layer_ms(_run("train"), "train", "train.forward", "device", recs) is None
    assert spans.layer_ms(_run("train"), "train", "train.backward", "device", recs) == 19.0


def test_a_stacked_dispatch_counts_its_requests():
    recs = []
    for i in range(4):  # 4 dispatches of 2 requests: the first window of 8 requests
        fwd = _rec(recs, "serve.forward", i, 20.0, count=2)
        _rec(recs, "model.head", i, 10.0, fwd)
    for i in range(4, 8):
        fwd = _rec(recs, "serve.forward", i, 40.0, count=2)
        _rec(recs, "model.head", i, 20.0, fwd)
    assert spans.first_window(recs, "score", REQUESTS) == {0, 1, 2, 3}
    assert spans.layer_ms(_run("score"), "score", "model.head", "device", recs) == 5.0


def test_a_program_without_spans_reads_none(monkeypatch):
    import ip_avsr_torch.utils

    monkeypatch.setitem(sys.modules, "ip_avsr_torch.utils.spans", None)
    monkeypatch.delattr(ip_avsr_torch.utils, "spans", raising=False)
    assert spans.program_records() is None
