"""The ``score`` driver: offline scoring, a closed loop of requests, each a
batch of utterances, through ``serve.PipelinedServer`` over the
configuration's server (``serve.make_trimodal_server`` for raw pixels,
``serve.make_server`` for feature streams).

Its traffic file gives ``batch`` (utterances a request), ``min_len`` and
``max_len`` (frames), ``pool_batches`` (distinct requests, sent in a seeded
order), ``depth`` and ``stack`` (the server's), ``warmup_requests``,
``trace_requests`` and ``check_requests`` (requests the reference checks).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from avsr_bench.harness import check, drive, guard, inputs, spec
from avsr_bench.reference import adenet_ref as ref


def _server(config: dict, params, device):
    from ip_avsr_torch import serve

    cfg = drive.adenet_config(config["model"])
    inp = config["input"]
    if inp["kind"] == "trimodal_raw":
        return serve.make_trimodal_server(params, cfg, tuple(inp["image_shape"]),
                                          int(inp["dct_coeffs"]), device=device)
    return serve.make_server(params, cfg, vote=True, device=device)


def _request(config: dict, pool: list, mask, rows: slice):
    if config["input"]["kind"] == "trimodal_raw":
        return pool[0][rows], mask[rows]
    return [s[rows] for s in pool], mask[rows]


def _ref_streams(config: dict, pool: list, mask, rows: slice, device):
    m = torch.as_tensor(mask[rows], device=device)
    inp = config["input"]
    if inp["kind"] == "trimodal_raw":
        return ref.trimodal_streams(torch.as_tensor(pool[0][rows], device=device), m,
                                    tuple(inp["image_shape"]), int(inp["dct_coeffs"])), m
    return [torch.as_tensor(s[rows], device=device) for s in pool], m


def reference_scores(config: dict, seed: int, pool: list, mask, batches: list, B: int,
                     device, tf32: bool) -> list:
    """The reference's probabilities of each request ``batches[i]`` (its
    index in the pool), in float32 or, with ``tf32``, in the control's
    precision."""
    model = config["model"]
    params = inputs.make_weights(model, seed, device)
    out = []
    with torch.no_grad(), ref.precision(tf32):
        for k in batches:
            streams, m = _ref_streams(config, pool, mask, slice(k * B, (k + 1) * B), device)
            probs = ref.forward(model, params, streams, m)
            if probs.dim() == 3:  # a per-step head's masked vote, as the server's
                C = probs.shape[-1]
                votes = (torch.nn.functional.one_hot(probs.argmax(-1), C).to(probs.dtype)
                         * m[..., None]).sum(1)
                probs = torch.softmax(votes, dim=-1)
            out.append(probs)
    return out


def score_pool(config: dict, traffic: dict, seed: int, device):
    B, P = int(traffic["batch"]), int(traffic["pool_batches"])
    T = int(config["input"]["frames"])
    lens = inputs.lengths(P * B, int(traffic["min_len"]), int(traffic["max_len"]), seed)
    return inputs.frames_pool(config, P * B, lens, seed, device), inputs.masks(lens, T), lens


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float,
        world: int = 1, rank: int = 0, flag_group=None, wrap_server=None) -> drive.Run:
    """One run of a scoring cell; ``wrap_server`` (tests) wraps the
    program's serve function."""
    from ip_avsr_torch import serve

    if world > 1:
        raise ValueError(f"{cell.name}: the score driver runs on one card")
    config, traffic = cell.config, cell.traffic
    drive.set_precision(config)
    out = drive.Run("score", config, traffic, device, traced)
    B, P = int(traffic["batch"]), int(traffic["pool_batches"])
    out.lstm_shape = (B, int(config["input"]["frames"]))
    params = inputs.make_weights(config["model"], seed, device)
    pool, mask, lens = score_pool(config, traffic, seed, device)
    requests = [_request(config, pool, mask, slice(k * B, (k + 1) * B)) for k in range(P)]
    serve_fn = _server(config, params, device)
    if wrap_server is not None:
        serve_fn = wrap_server(serve_fn)
    server = serve.PipelinedServer(serve_fn=serve_fn, depth=int(traffic["depth"]),
                                   batch=int(traffic["stack"]), device=device)
    for _ in server.map(requests[k % P] for k in range(int(traffic["warmup_requests"]))):
        pass
    drive.sync(device)
    gc.collect()
    gc.freeze()  # set-up's objects are never scanned again by the collector
    order = inputs.order(seed)
    sent, results, spans = [], [], []

    def feed(more):
        while more():
            k = int(order.integers(P))
            sent.append(k)
            t = time.perf_counter()
            yield requests[k]
            spans.append(time.perf_counter() - t)

    def drain(more):
        for got in server.map(feed(more)):
            results.append((time.perf_counter(), np.array(got)))

    out.setup_s = time.perf_counter() - t0
    if traced:
        n = int(traffic["trace_requests"])

        def body():  # n more requests, sent and drained
            stop = len(sent) + n
            drain(lambda: len(sent) < stop)

        drive.trace_window(out, body, device)
        done = results[:n]  # the first window's
    else:
        start = time.perf_counter()
        end = start + seconds
        drain(lambda: time.perf_counter() < end)
        drive.sync(device)
        out.window_s = seconds
        done = [r for r in results if r[0] <= end]
    out.unexpected = guard.forbidden_modules()
    out.attempted, out.failed, out.completed = len(sent), len(sent) - len(results), len(done)
    out.utterances = len(done) * B
    out.valid_frames = int(sum(lens[k * B:(k + 1) * B].sum() for k in sent[:len(done)]))
    out.spans = spans[:len(done)]
    out.memory_peak_bytes = drive.memory_peak(device)
    got = [scores for _, scores in results]
    del server, serve_fn, params, requests
    gc.unfreeze()
    drive.free(device)
    rng = np.random.default_rng(inputs.sub_seed(seed, "check"))
    picks = sorted(rng.choice(len(done), size=min(int(traffic["check_requests"]), len(done)),
                              replace=False).tolist())
    want = reference_scores(config, seed, pool, mask, [sent[i] for i in picks], B, device,
                            tf32=False)
    out.checks = {"score_gap": max(check.score_gap(got[i], w) for i, w in zip(picks, want))}
    return out


def control(cell: spec.Cell, seed: int, device) -> dict:
    """The control's and the faults' readings of the check (see
    ``harness/control.py``): the reference in TF32, and half of each
    request's batch scored in place of the whole."""
    config, traffic = cell.config, cell.traffic
    B = int(traffic["batch"])
    pool, mask, _ = score_pool(config, traffic, seed, device)
    picks = list(range(int(traffic["check_requests"])))
    want = reference_scores(config, seed, pool, mask, picks, B, device, tf32=False)
    low = reference_scores(config, seed, pool, mask, picks, B, device, tf32=True)
    half = [torch.cat([w[: B // 2], w[: B - B // 2]]) for w in want]
    return {"control": {"score_gap": max(check.score_gap(a.cpu(), w) for a, w in zip(low, want))},
            "faults": {"half_batch": {"score_gap": max(
                check.score_gap(a.cpu(), w) for a, w in zip(half, want))}}}
