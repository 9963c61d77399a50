"""The port's spans (``ip_avsr_torch/utils/spans.py``) on the CPU.

* Disarmed (no ``enable()``, no profiler) a training step and a served
  request keep no record; while ``torch.export`` traces, a profiler's trace
  holds none of the spans.
* One ``Trainer.train_step`` and one request through ``PipelinedServer``
  over a ``TrimodalServer`` under a CPU profiler give exactly the spans of
  their layers, nested by parent under one id per step or request; a
  stacked dispatch carries its request count and the wait its block's ids.
* Each record's host interval lies within 100 us of its trace event's; the
  card's milliseconds are None on the CPU.
* ``torch.export`` of the server gives the same graph with the spans
  enabled as without, and no profiler operator in it.
* The flat collectives record their buffer's bytes on every rank of a gloo
  group.
"""

import collections
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ip_avsr_torch import serve
from ip_avsr_torch.models import adenet, zoo
from ip_avsr_torch.parallel import collectives
from ip_avsr_torch.train.trainer import Trainer, TrainOptions
from ip_avsr_torch.utils import cpu_mesh, spans

IMAGE, DCT, B, T = (4, 6), 8, 3, 7
TRAIN = ["train.step", "train.forward", "model.streams", "model.head", "train.backward",
         "train.optimizer"]
SERVE = ["serve.stage", "serve.forward", "serve.pipeline", "model.streams", "model.head",
         "serve.wait"]
# each span's parent, by name (None: a root)
TRAIN_PARENTS = {"train.step": None, "train.forward": "train.step",
                 "model.streams": "train.forward", "model.head": "train.forward",
                 "train.backward": "train.step", "train.optimizer": "train.step"}
SERVE_PARENTS = {"serve.stage": None, "serve.forward": None, "serve.pipeline": "serve.forward",
                 "model.streams": "serve.forward", "model.head": "serve.forward",
                 "serve.wait": None}


def _config():
    cfg = zoo.adenet_v3(IMAGE[0] * IMAGE[1], DCT, IMAGE[0] * IMAGE[1], lstm_size=3, window=2,
                        output_classes=4)
    streams = [dataclasses.replace(s, encoder_shapes=(8, 6, 5, 4)) if s.encoder_shapes else s
               for s in cfg.streams]
    return dataclasses.replace(cfg, streams=streams)


@pytest.fixture(scope="module")
def model():
    cfg = _config()
    return cfg, adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg, device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    raw = torch.rand((B, T, IMAGE[0] * IMAGE[1]), generator=g)
    mask = torch.ones(B, T)
    mask[0, 5:] = 0
    return raw, mask


def _train_step(model):
    cfg, params = model
    trainer = Trainer(cfg, TrainOptions(batchsize=B, log_fn=lambda _: None), device="cpu")
    raw, mask = _batch()
    streams = [raw, torch.rand(B, T, DCT), raw.flip(1)]
    y = torch.tensor([0, 1, 2])
    opt_state = trainer.optimizer.init(params)
    return trainer.train_step(params, opt_state, streams, y, mask,
                              torch.Generator().manual_seed(1), 0.01)


def _pipelined(model, batch=1):
    cfg, params = model
    fn = serve.make_trimodal_server(params, cfg, IMAGE, DCT, device="cpu")
    return serve.PipelinedServer(serve_fn=fn, depth=2, batch=batch, device="cpu")


def _serve_one(model):
    return list(_pipelined(model).map([_batch()]))


def _span_events(prof):
    """The trace's span ranges (``ip_avsr::<layer>.<part>``; the port's
    ``ip_avsr::`` operators carry no dot)."""
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(spans.PREFIX) and "." in e.name()[len(spans.PREFIX):]]


def _names(recs):
    return [r["name"] for r in recs]


def test_disarmed_spans_keep_nothing(model):
    assert not spans.armed() and spans.new_id() is None
    assert spans.span("train.step") is spans.span("serve.wait")  # the shared no-op
    _train_step(model)
    _serve_one(model)
    assert spans.records() == []


def test_export_tracing_disarms_spans_under_a_profiler(model):
    cfg, params = model
    program = serve.TrimodalServer(params, cfg, IMAGE, DCT)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert spans.armed()
        torch.export.export(program, _batch(), strict=False)
    assert _span_events(prof) == [] and spans.records() == []


def _check_tree(recs, parents):
    by_index = dict(enumerate(recs))
    for r in recs:
        want = parents[r["name"]]
        got = None if r["parent"] is None else by_index[r["parent"]]["name"]
        assert got == want, (r["name"], got, want)


def test_a_train_step_under_a_profiler_gives_the_steps_spans(model):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _train_step(model)
    recs = spans.records()
    assert _names(recs) == TRAIN
    _check_tree(recs, TRAIN_PARENTS)
    assert len({r["id"] for r in recs}) == 1 and recs[0]["id"] is not None
    assert all(r["device_ms"] is None and r["host_ms"] > 0 for r in recs)


def test_a_request_under_a_profiler_gives_the_requests_spans(model):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _serve_one(model)
    recs = spans.records()
    assert _names(recs) == SERVE
    _check_tree(recs, SERVE_PARENTS)
    ident = recs[0]["id"]
    assert ident is not None and all(r["id"] == ident for r in recs[:-1])
    assert recs[1]["count"] == 1 and recs[-1]["ids"] == [ident]
    assert all(r["device_ms"] is None for r in recs)


def test_a_stacked_dispatch_carries_its_count_and_the_wait_its_ids(model):
    spans.enable()
    got = list(_pipelined(model, batch=2).map([_batch(0), _batch(1), _batch(2)]))
    assert len(got) == 3
    recs = spans.records()
    forwards = [r for r in recs if r["name"] == "serve.forward"]
    assert [r["count"] for r in forwards] == [2, 1]
    assert len({r["id"] for r in forwards}) == 2
    waits = [r for r in recs if r["name"] == "serve.wait"]
    assert [i for w in waits for i in w["ids"]] == [r["id"] for r in forwards]


@pytest.mark.parametrize("path", ["train", "serve"])
def test_host_intervals_match_the_trace_events(model, path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        (_train_step if path == "train" else _serve_one)(model)
    recs = spans.records()
    events = collections.defaultdict(list)
    for e in sorted(_span_events(prof), key=lambda e: e.start_ns()):
        events[e.name()[len(spans.PREFIX):]].append(e)
    seen = collections.Counter()
    for r in recs:
        e = events[r["name"]][seen[r["name"]]]
        seen[r["name"]] += 1
        assert abs(r["start_ns"] - e.start_ns()) < 100_000, r["name"]
        assert abs(r["end_ns"] - e.end_ns()) < 100_000, r["name"]
    assert sum(seen.values()) == sum(len(v) for v in events.values())


def test_enable_arms_without_a_profiler_and_disable_disarms(model):
    spans.enable()
    _train_step(model)
    spans.disable()
    _train_step(model)
    recs = spans.records()
    assert _names(recs) == TRAIN
    spans.enable()
    _train_step(model)
    ids = [r["id"] for r in spans.records() if r["name"] == "train.step"]
    assert len(ids) == 2 and ids[0] < ids[1]


def test_records_are_bounded(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)
    spans.enable()
    with spans.span("train.step", ident=spans.new_id()):
        for _ in range(2):
            with spans.span("train.forward"):
                with spans.span("model.head"):
                    pass
    recs = spans.records()
    assert _names(recs) == ["train.step", "train.forward", "model.head"]
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)


def _graph(program, args):
    ep = torch.export.export(program, args, strict=False)
    return str(ep.graph), [str(n.target) for n in ep.graph.nodes]


def test_export_is_the_same_with_spans_enabled(model):
    cfg, params = model
    program = serve.TrimodalServer(params, cfg, IMAGE, DCT)
    off, _ = _graph(program, _batch())
    spans.enable()
    on, targets = _graph(program, _batch())
    assert on == off
    assert not any("profiler" in t or "record_function" in t for t in targets)
    assert spans.records() == []


def _collective_task():
    spans.enable()
    spans.clear()
    rank = dist.get_rank()
    summed = collectives.flat_all_reduce([torch.full((5,), float(rank)), torch.ones(2, 3)],
                                         dist.group.WORLD)
    gathered = collectives.flat_all_gather([torch.full((4,), float(rank))], dist.group.WORLD)
    recs = spans.records()
    return ([(r["name"], r["nbytes"], r["device_ms"]) for r in recs],
            summed[0].tolist(), [t.tolist() for t in gathered[0]])


def test_collectives_record_their_bytes_on_every_rank():
    got = cpu_mesh.spawn_ranks(2, _collective_task, backend="gloo", timeout_s=90)
    for recs, summed, gathered in got:
        assert recs == [("collective.all_reduce", 11 * 4, None),
                        ("collective.all_gather", 4 * 4, None)]
        assert summed == [1.0] * 5 and gathered == [[0.0] * 4, [1.0] * 4]
    assert np.all([g[0] == got[0][0] for g in got])
