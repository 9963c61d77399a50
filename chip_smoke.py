#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ip_avsr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build every CUDA kernel of the serving and training paths from
   ``ip_avsr_torch/csrc`` (one nvcc per source, started together) and print
   the toolchain;
2. print the card's name and power limit (nvidia-smi);
3. with TF32 off, hold each kernel against its plain PyTorch version at the
   flagship's shapes and time kernel, plain version and library call: the
   delta FIR, the inference recurrence, the training recurrence (which also
   writes cells and gates) and the backward chain (with an upstream
   gradient that makes the +-5 clip bite);
4. build the full-width trimodal adenet_v3 (1144/90/1144, H = 500, W = 9)
   from a seeded generator, serve raw uint8 requests (B = 1 and 8, T = 29,
   ragged masks) through ``serve.make_trimodal_server``, check the scores
   (finite, rows sum to 1, equal to the port's CPU path on the same
   parameters) and that every kernel was launched by that run (5 LSTM and 2
   delta launches per forward);
5. time requests on the host clock, and trace five B = 8 requests with
   torch.profiler for the device time by kernel and the device's busy share;
6. train the same model at B = 10, T = 29 through
   ``train.trainer.make_train_step``: three steps with its own dropout rates
   (loss, gradients and parameters finite; 5 training-recurrence, 5
   backward-chain, 2 delta and no inference-recurrence launches per step),
   then at dropout 0 the card against the port's CPU path on the same
   parameters and batch (loss, every gradient, updated parameters), the step
   median on the host clock, and a torch.profiler trace of three steps;
7. print the kernels line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero without a CUDA device or without the package beside it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_FRAMES = 29
IMAGE_SHAPE = (26, 44)
DCT = 90
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# FLOP/s outside the tensor cores (TF32 is off, so f32 work runs there).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# kernel vs plain version on identical inputs, float32: the two differ only
# in summation order (delta: none beyond FMA contraction; LSTM: 500-term
# dot products over 29 dependent steps), as in the CPU tests
DELTA_TOL = 1e-5
LSTM_TOL = 1e-5
# card (cuBLAS, kernels) vs the port's CPU path on one request, on
# probabilities: the DCT features (~1e3) round differently, which reaches
# the dct stream's gates; the CPU tests hold the CPU path to JAX at 2e-5
SCORE_TOL = 2e-5
# gate math per (row, step, unit): 3 sigmoids, 2 tanh, cell/hidden update and
# the two mask blends, counted as 20 float32 operations
LSTM_GATE_FLOPS = 20
# gate backward per (row, step, unit): the same 5 activations, the four gate
# cotangents, the clip, and the dcell/dhid carries, counted as 40
LSTM_BWD_GATE_FLOPS = 40
# backward chain, kernel vs plain version: 29 dependent steps, each summing
# 2000 products per dh entry in another order, so the error grows with the
# magnitudes the chain carries; held relative to each output's max abs
LSTM_BWD_TOL = 1e-5
# train step, card vs the port's CPU path (cuBLAS vs CPU GEMMs, kernels vs
# plain loops, all float32): the loss relative, each gradient relative to
# its tensor's max abs (sums over 290 rows and 29-step chains), the updated
# parameters absolute (Adam's first step moves an entry by at most lr = 1e-4)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
TRAIN_PARAM_TOL = 1e-5
TRAIN_B = 10


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def delta_cost(B, T, D, W):
    # x read once, [x, d, a] written once; 3 ops per tap per output, 2 orders
    return 4 * (B * T * D + 3 * B * T * D), 2 * B * T * D * 3 * max(W, 0)


def lstm_cost(B, T, H):
    nbytes = 4 * (B * T * 4 * H + H * 4 * H + B * T + 2 * B * H + B * T * H)
    flops = 2 * B * T * H * 4 * H + LSTM_GATE_FLOPS * B * T * H
    return nbytes, flops


def lstm_train_cost(B, T, H):
    # the inference recurrence's traffic plus the residuals cells and gates
    nbytes, flops = lstm_cost(B, T, H)
    return nbytes + 4 * (B * T * H + B * T * 4 * H), flops


def lstm_bwd_cost(B, T, H):
    # reads g_out, gates, cells, cells_prev, mask, W_hid; writes dgates,
    # dcell0, dhid0; the dgates @ W_hid^T chain and the gate backward
    nbytes = 4 * (3 * B * T * H + B * T * 4 * H + B * T + H * 4 * H
                  + B * T * 4 * H + 2 * B * H)
    flops = 2 * B * T * 4 * H * H + LSTM_BWD_GATE_FLOPS * B * T * H
    return nbytes, flops


def max_err(got, ref):
    """(max abs difference, max abs difference over max(1, max |ref|))."""
    e = (got - ref).abs().max().item()
    return e, e / max(1.0, ref.abs().max().item())


def ragged_mask(B, T, gen, device):
    import torch

    lens = torch.randint(1, T + 1, (B,), generator=gen)
    lens[0] = T
    return (torch.arange(T)[None, :] < lens[:, None]).float().to(device)


def phase_build():
    from ip_avsr_torch.ops.kernels import _build

    print("nvcc:", _build.nvcc_version().splitlines()[-1])
    print("ninja:", shutil.which("ninja") or "absent",
          "| triton:", "present" if importlib.util.find_spec("triton") else "absent")
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.build_logs):
        for line in _build.build_logs[name].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_card():
    print(smi("name,power.limit"))


def phase_delta(dev):
    import torch

    from ip_avsr_torch.ops.delta import append_delta_coeff
    from ip_avsr_torch.ops.kernels.delta import append_delta

    gen = torch.Generator().manual_seed(SEED)
    err = 0.0
    # the main path's shapes (B in {1, 8}, T = 29, D = 50, W = 9), then edges:
    # no window, T < W, a feature count that is not a multiple of 32
    for B, T, D, W in [(1, 29, 50, 9), (8, 29, 50, 9), (2, 29, 50, 0),
                       (2, 3, 70, 4), (3, 29, 33, 1)]:
        x = torch.randn(B, T, D, generator=gen).to(dev) * 3
        got = append_delta(x, W)
        ref = append_delta_coeff(x, W)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        print(f"delta B={B} T={T} D={D} W={W}: max_abs_err={e:.3e}")
        if not e <= DELTA_TOL:
            raise AssertionError(f"delta kernel disagrees with its plain version: {e}")
        err = max(err, e)
    rows = {}
    for B in (1, 8):
        x = torch.randn(B, T_FRAMES, 50, generator=gen).to(dev)
        ms = cuda_ms(lambda: append_delta(x, 9))
        plain_ms = cuda_ms(lambda: append_delta_coeff(x, 9))
        b_ms, by = bound(*delta_cost(B, T_FRAMES, 50, 9))
        rows[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        print(f"delta B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({by})")
    return err, rows


def phase_lstm(dev):
    import torch

    from ip_avsr_torch.ops.kernels.lstm import lstm_recurrence, lstm_recurrence_plain

    H = 500
    gen = torch.Generator().manual_seed(SEED + 1)
    err = 0.0
    for B in (1, 8):
        for D in (150, 90, 500):
            w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            b = (torch.randn(4 * H, generator=gen) * 0.1).to(dev)
            c0 = torch.randn(1, H, generator=gen).to(dev).expand(B, H).contiguous()
            h0 = (torch.randn(1, H, generator=gen) * 0.5).to(dev).expand(B, H).contiguous()
            x = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
            mask = ragged_mask(B, T_FRAMES, gen, dev)
            for backwards in (False, True):
                xs, ms_ = (x.flip(1), mask.flip(1)) if backwards else (x, mask)
                x_proj = (xs.reshape(-1, D) @ w_in).reshape(B, T_FRAMES, 4 * H) + b
                got = lstm_recurrence(x_proj, w_hid, ms_.contiguous(), c0, h0)
                ref = lstm_recurrence_plain(x_proj, w_hid, ms_, c0, h0)
                torch.cuda.synchronize()
                e = (got - ref).abs().max().item()
                print(f"lstm B={B} D_in={D} H={H} backwards={backwards}: "
                      f"max_abs_err={e:.3e}")
                if not e <= LSTM_TOL:
                    raise AssertionError(
                        f"LSTM kernel disagrees with its plain version: {e}")
                err = max(err, e)
    rows = {}
    for B in (1, 8):
        x_proj = torch.randn(B, T_FRAMES, 4 * H, generator=gen).to(dev)
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        mask = ragged_mask(B, T_FRAMES, gen, dev)
        c0 = torch.zeros(B, H, device=dev)
        h0 = torch.zeros(B, H, device=dev)
        ms = cuda_ms(lambda: lstm_recurrence(x_proj, w_hid, mask, c0, h0))
        plain_ms = cuda_ms(lambda: lstm_recurrence_plain(x_proj, w_hid, mask, c0, h0),
                           iters=5, warmup=1)
        # yardstick only (the port never calls it): cuDNN's LSTM on an
        # all-valid mask at the stream LSTM's shape; it also does the 150-wide
        # input projection that the kernel leaves to cuBLAS
        cudnn = torch.nn.LSTM(150, H, batch_first=True).to(dev)
        xin = torch.randn(B, T_FRAMES, 150, generator=gen).to(dev)
        with torch.inference_mode():
            lib_ms = cuda_ms(lambda: cudnn(xin))
        b_ms, by = bound(*lstm_cost(B, T_FRAMES, H))
        rows[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                       library_ms=lib_ms)
        print(f"lstm B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN nn.LSTM {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by})")
    return err, rows


def phase_lstm_train(dev):
    import torch

    from ip_avsr_torch.ops.kernels.lstm import (lstm_bwd_chain, lstm_bwd_chain_plain,
                                                lstm_recurrence_train,
                                                lstm_recurrence_train_plain)

    H = 500
    gen = torch.Generator().manual_seed(SEED + 3)
    fwd_err = bwd_err = 0.0
    for B in (1, TRAIN_B):
        for D in (150, 90, 500):
            w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            b = (torch.randn(4 * H, generator=gen) * 0.1).to(dev)
            c0 = torch.randn(1, H, generator=gen).to(dev).expand(B, H).contiguous()
            h0 = (torch.randn(1, H, generator=gen) * 0.5).to(dev).expand(B, H).contiguous()
            x = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
            mask = ragged_mask(B, T_FRAMES, gen, dev)
            if B > 1:
                mask[-1] = 0.0  # a fully padded row
            g = torch.randn(B, T_FRAMES, H, generator=gen).to(dev)
            for backwards in (False, True):
                xs, ms_ = (x.flip(1), mask.flip(1)) if backwards else (x, mask)
                ms_ = ms_.contiguous()
                x_proj = (xs.reshape(-1, D) @ w_in).reshape(B, T_FRAMES, 4 * H) + b
                got = lstm_recurrence_train(x_proj, w_hid, ms_, c0, h0)
                ref = lstm_recurrence_train_plain(x_proj, w_hid, ms_, c0, h0)
                e = max(max_err(a, r)[0] for a, r in zip(got, ref))
                print(f"lstm_fwd_train B={B} D_in={D} H={H} backwards={backwards}: "
                      f"max_abs_err={e:.3e} (hids, cells, gates)")
                if not e <= LSTM_TOL:
                    raise AssertionError(
                        f"training LSTM kernel disagrees with its plain version: {e}")
                fwd_err = max(fwd_err, e)
                _, cells, gates = ref
                cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
                # scale 100 makes the clip bite; clip 0 checks the unclipped chain
                for scale, clip in ((1.0, 5.0), (100.0, 5.0), (1.0, 0.0)):
                    args = ((g * scale).contiguous(), gates, cells, cells_prev, ms_, w_hid)
                    got = lstm_bwd_chain(*args, clip)
                    ref = lstm_bwd_chain_plain(*args, clip)
                    errs = [max_err(a, r) for a, r in zip(got, ref)]
                    rel = max(r for _, r in errs)
                    clipped = (ref[0].abs() == clip).float().mean().item() if clip else 0.0
                    print(f"lstm_bwd B={B} D_in={D} backwards={backwards} g x{scale:g} "
                          f"clip={clip:g}: max_abs_err={max(a for a, _ in errs):.3e}, "
                          f"relative {rel:.3e}, clipped share {clipped:.4f}")
                    if not rel <= LSTM_BWD_TOL:
                        raise AssertionError(
                            f"LSTM backward kernel disagrees with its plain version: {rel}")
                    if clip and scale > 1 and not clipped > 0.01:
                        raise AssertionError(f"the clip did not bite: share {clipped}")
                    if scale == 1.0 and clip:
                        bwd_err = max(bwd_err, max(a for a, _ in errs))
    rows = {}
    for B in (1, TRAIN_B):
        D = 150
        w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        x = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
        x_proj = (x.reshape(-1, D) @ w_in).reshape(B, T_FRAMES, 4 * H)
        mask = ragged_mask(B, T_FRAMES, gen, dev)
        c0 = torch.zeros(B, H, device=dev)
        h0 = torch.zeros(B, H, device=dev)
        _, cells, gates = lstm_recurrence_train(x_proj, w_hid, mask, c0, h0)
        cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
        g = torch.randn(B, T_FRAMES, H, generator=gen).to(dev)
        bargs = (g, gates, cells, cells_prev, mask, w_hid, 5.0)
        fwd_ms = cuda_ms(lambda: lstm_recurrence_train(x_proj, w_hid, mask, c0, h0))
        fwd_plain = cuda_ms(lambda: lstm_recurrence_train_plain(x_proj, w_hid, mask, c0, h0),
                            iters=5, warmup=1)
        bwd_ms = cuda_ms(lambda: lstm_bwd_chain(*bargs))
        bwd_plain = cuda_ms(lambda: lstm_bwd_chain_plain(*bargs), iters=5, warmup=1)
        # yardsticks only (the port never calls them): cuDNN's LSTM at the
        # stream LSTM's shape, all-valid mask, forward with grad enabled (it
        # also does the 150-wide input projection), and its backward, which
        # also computes dW and dx and clips nothing
        cudnn = torch.nn.LSTM(D, H, batch_first=True).to(dev)
        xin = torch.randn(B, T_FRAMES, D, generator=gen).to(dev).requires_grad_(True)
        lib_fwd = cuda_ms(lambda: cudnn(xin))
        out, _ = cudnn(xin)
        gy = torch.randn_like(out)
        wts = [xin, *cudnn.parameters()]
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(out, wts, gy, retain_graph=True))
        fb, fby = bound(*lstm_train_cost(B, T_FRAMES, H))
        bb, bby = bound(*lstm_bwd_cost(B, T_FRAMES, H))
        rows[B] = {
            "lstm_fwd_train": dict(ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
                                   library_ms=lib_fwd),
            "lstm_bwd": dict(ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                             library_ms=lib_bwd),
        }
        print(f"lstm_fwd_train B={B}: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"cuDNN nn.LSTM forward (grad on) {lib_fwd:.4f} ms, bound {fb:.5f} ms ({fby})")
        print(f"lstm_bwd B={B}: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
              f"cuDNN nn.LSTM backward (with dW, dx; no clip) {lib_bwd:.4f} ms, "
              f"bound {bb:.5f} ms ({bby})")
    return fwd_err, bwd_err, rows


def phase_serve(dev):
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.ops.kernels.delta import append_delta
    from ip_avsr_torch.ops.kernels.lstm import lstm_recurrence
    from ip_avsr_torch.serve import make_trimodal_server

    cfg = zoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    t0 = time.perf_counter()
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED), cfg,
                                       device=dev)
    print(f"adenet_v3 full width: init {time.perf_counter() - t0:.1f} s")
    server = make_trimodal_server(params, cfg, IMAGE_SHAPE, DCT, device=dev)
    rng = np.random.RandomState(SEED)
    requests = []
    for B in (1, 8, 8):
        raw = rng.randint(0, 256, (B, T_FRAMES, 1144)).astype(np.uint8)
        lens = rng.randint(1, T_FRAMES + 1, B)
        lens[0] = T_FRAMES
        mask = (np.arange(T_FRAMES)[None] < lens[:, None]).astype(np.float32)
        requests.append((raw, mask))
    for (raw, mask) in requests[:1]:
        server(raw, mask)  # warm-up: cuBLAS handles, kernel libraries
    torch.cuda.synchronize()

    append_delta.launches = 0
    lstm_recurrence.launches = 0
    scores = [server(raw, mask) for raw, mask in requests]
    torch.cuda.synchronize()
    launches = {"delta": append_delta.launches, "lstm_fwd": lstm_recurrence.launches}
    n = len(requests)
    print(f"served {n} requests: launches {launches}")
    expected = {"delta": 2 * n, "lstm_fwd": 5 * n}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")

    cpu_server = make_trimodal_server(tree_to(params, torch.device("cpu")), cfg,
                                      IMAGE_SHAPE, DCT, device="cpu")
    for (raw, mask), s in zip(requests, scores):
        s = s.cpu()
        if s.shape != (raw.shape[0], 10) or not torch.isfinite(s).all():
            raise AssertionError(f"bad scores: shape {tuple(s.shape)}")
        row_err = (s.sum(-1) - 1).abs().max().item()
        ref_err = (s - cpu_server(raw, mask)).abs().max().item()
        print(f"B={raw.shape[0]}: |row sum - 1| {row_err:.2e}, "
              f"|card - CPU path| {ref_err:.2e}")
        if not (row_err <= 1e-5 and ref_err <= SCORE_TOL):
            raise AssertionError("scores disagree with the CPU path")

    latency = {}
    for B, (raw, mask) in ((1, requests[0]), (8, requests[1])):
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server(raw, mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[B] = statistics.median(times[5:])
        print(f"serve B={B}: median request {latency[B]:.3f} ms "
              f"(host clock, 25 requests, uint8 upload included)")
    print("right after: clocks.sm, clocks.max.sm, power.draw, utilization.gpu =",
          smi("clocks.sm,clocks.max.sm,power.draw,utilization.gpu"))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    raw, mask = requests[1]
    n_traced = 5
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_traced):
            server(raw, mask)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=14))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3 / n_traced
    print(f"serve B=8: device busy {busy_ms:.3f} ms per request (profiler, "
          f"{n_traced} requests); busy share of the median request "
          f"{busy_ms / latency[8]:.3f}")
    return launches, latency


def phase_train(dev):
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.ops.kernels.delta import append_delta
    from ip_avsr_torch.ops.kernels.lstm import (lstm_bwd_chain, lstm_recurrence,
                                                lstm_recurrence_train)
    from ip_avsr_torch.train import trainer

    counters = {"lstm_fwd_train": lstm_recurrence_train, "lstm_bwd": lstm_bwd_chain,
                "delta": append_delta, "lstm_fwd": lstm_recurrence}
    cfg = zoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 4), cfg,
                                       device=dev)
    rng = np.random.RandomState(SEED + 4)
    B, T = TRAIN_B, T_FRAMES
    streams = [torch.from_numpy(rng.randn(B, T, s.input_dim).astype(np.float32)).to(dev)
               for s in cfg.streams]
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randint(0, 10, B)).long().to(dev)
    opt, step = trainer.make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = opt.init(params)
    step(params, state, streams, y, mask, gen)  # warm-up: cuBLAS handles, libraries
    torch.cuda.synchronize()

    for fn in counters.values():
        fn.launches = 0
    p, st = params, state
    losses = []
    n_steps = 3
    for _ in range(n_steps):
        p, st, loss = step(p, st, streams, y, mask, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"train {n_steps} steps, flagship dropout: losses "
          f"{[round(float(v), 6) for v in losses]}, launches {launches}")
    expected = {"lstm_fwd_train": 5 * n_steps, "lstm_bwd": 5 * n_steps,
                "delta": 2 * n_steps, "lstm_fwd": 0}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")
    # m is a positive mix of every step's gradients: finite m, finite grads
    finite = []
    tree_map(lambda t: finite.append(bool(torch.isfinite(t).all())), (p, st["m"], st["v"]))
    if not (all(finite) and all(torch.isfinite(v) for v in losses)):
        raise AssertionError("non-finite loss, gradient or parameter in training")

    # dropout 0: card against the port's CPU path, same parameters and batch
    cfg0 = dataclasses.replace(
        cfg, agg_dropout=0.0,
        streams=[dataclasses.replace(s, dropout=0.0) for s in cfg.streams])
    cpu = torch.device("cpu")
    loss_d, grads_d = trainer.loss_and_grads(params, cfg0, streams, y, mask)
    loss_c, grads_c = trainer.loss_and_grads(tree_to(params, cpu), cfg0,
                                             tree_to(streams, cpu), y.cpu(), mask.cpu())
    _, step0 = trainer.make_train_step(cfg0)
    p_d, _, _ = step0(params, opt.init(params), streams, y, mask)
    cparams = tree_to(params, cpu)
    p_c, _, _ = step0(cparams, opt.init(cparams), tree_to(streams, cpu), y.cpu(), mask.cpu())
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    grad_rel, param_abs = [], []
    tree_map(lambda a, b: grad_rel.append(max_err(a.cpu(), b)[0]
                                          / max(b.abs().max().item(), 1e-30)),
             grads_d, grads_c)
    tree_map(lambda a, b: param_abs.append(max_err(a.cpu(), b)[0]), p_d, p_c)
    print(f"train dropout 0, card vs CPU path: loss {float(loss_d):.7f} vs "
          f"{float(loss_c):.7f} (relative {loss_rel:.2e}); gradients, worst of "
          f"{len(grad_rel)} relative to max abs {max(grad_rel):.2e}; updated "
          f"parameters max abs {max(param_abs):.2e}")
    if not (loss_rel <= TRAIN_LOSS_TOL and max(grad_rel) <= TRAIN_GRAD_TOL
            and max(param_abs) <= TRAIN_PARAM_TOL):
        raise AssertionError("the training step on the card disagrees with the CPU path")

    times = []
    p, st = params, opt.init(params)
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st, loss = step(p, st, streams, y, mask, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times[5:])
    print(f"train B={B}: median step {median:.3f} ms (host clock, 20 steps after 5, "
          f"flagship dropout); peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print("right after: clocks.sm, clocks.max.sm, power.draw, utilization.gpu =",
          smi("clocks.sm,clocks.max.sm,power.draw,utilization.gpu"))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n_traced = 3
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_traced):
            p, st, loss = step(p, st, streams, y, mask, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    print(events.table(sort_by="self_cuda_time_total", row_limit=16))
    # where the host's time goes: the step is expected to be host-bound
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3 / n_traced
    print(f"train B={B}: device busy {busy_ms:.3f} ms per step (profiler, {n_traced} "
          f"steps); busy share of the median step {busy_ms / median:.3f}")
    return launches, median


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ip_avsr_torch  # noqa: F401  (fails outside a checkout of the repo)

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    phase_build()
    phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    delta_err, delta_rows = phase_delta(dev)
    lstm_err, lstm_rows = phase_lstm(dev)
    train_fwd_err, bwd_err, train_rows = phase_lstm_train(dev)
    launches, _ = phase_serve(dev)
    train_launches, _ = phase_train(dev)

    kernels = [
        {"name": "delta", "route": "cuda", "source": "ip_avsr_torch/csrc/delta.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/delta_kernel.py:56",
         "launches": launches["delta"], "max_abs_err": delta_err,
         "shape": "B=8 T=29 D=50 W=9", **delta_rows[8], "library_ms": None},
        {"name": "lstm_fwd", "route": "cuda", "source": "ip_avsr_torch/csrc/lstm_fwd.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/lstm_kernel.py:42",
         "launches": launches["lstm_fwd"], "max_abs_err": lstm_err,
         "shape": "B=8 T=29 H=500", **lstm_rows[8]},
        {"name": "lstm_fwd_train", "route": "cuda", "source": "ip_avsr_torch/csrc/lstm_fwd.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/lstm_kernel.py:131",
         "launches": train_launches["lstm_fwd_train"], "max_abs_err": train_fwd_err,
         "shape": f"B={TRAIN_B} T=29 H=500", **train_rows[TRAIN_B]["lstm_fwd_train"]},
        {"name": "lstm_bwd", "route": "cuda", "source": "ip_avsr_torch/csrc/lstm_bwd.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/lstm_kernel.py:240",
         "launches": train_launches["lstm_bwd"], "max_abs_err": bwd_err,
         "shape": f"B={TRAIN_B} T=29 H=500 clip=5", **train_rows[TRAIN_B]["lstm_bwd"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
