#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ip_avsr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build every CUDA kernel of the serving path from ``ip_avsr_torch/csrc``
   (one nvcc per source, started together) and print the toolchain;
2. print the card's name and power limit (nvidia-smi);
3. with TF32 off, hold each kernel against its plain PyTorch version at the
   flagship's shapes and time kernel, plain version and library call;
4. build the full-width trimodal adenet_v3 (1144/90/1144, H = 500, W = 9)
   from a seeded generator, serve raw uint8 requests (B = 1 and 8, T = 29,
   ragged masks) through ``serve.make_trimodal_server``, check the scores
   (finite, rows sum to 1, equal to the port's CPU path on the same
   parameters) and that every kernel was launched by that run (5 LSTM and 2
   delta launches per forward);
5. time requests on the host clock, and trace five B = 8 requests with
   torch.profiler for the device time by kernel and the device's busy share;
6. print the kernels line, then ``{"ok": true, "device": ...}`` last.

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
    launches, _ = phase_serve(dev)

    kernels = [
        {"name": "delta", "route": "cuda", "source": "ip_avsr_torch/csrc/delta.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/delta_kernel.py:56",
         "launches": launches["delta"], "max_abs_err": delta_err,
         "shape": "B=8 T=29 D=50 W=9", **delta_rows[8], "library_ms": None},
        {"name": "lstm_fwd", "route": "cuda", "source": "ip_avsr_torch/csrc/lstm_fwd.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/lstm_kernel.py:42",
         "launches": launches["lstm_fwd"], "max_abs_err": lstm_err,
         "shape": "B=8 T=29 H=500", **lstm_rows[8]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
