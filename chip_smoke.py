#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ip_avsr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build every CUDA kernel of the serving and training paths from
   ``ip_avsr_torch/csrc`` (one nvcc per source, started together) and the
   native ``.mat`` reader from ``ip_avsr_torch/native/matread.cc`` (g++),
   and print the toolchain;
2. print the card's name and power limit (nvidia-smi);
3. with TF32 off, hold each kernel against its plain PyTorch version at the
   shapes of the paths below and time kernel, plain version and library
   call: the grouped delta FIR (the flagship's two streams at B = 1 and 8,
   the 4-stream model's four at B = 1 and 10 and edge groups of one, into
   NaN-filled outputs; the grid of each model's group; one
   traced launch per call, its device time, the yardstick ``torch.matmul(S,
   x)`` and the DeltaLayer's backward), the inference recurrence and the
   training recurrence
   (which also writes cells and gates) at the flagship's H = 500, then the
   peephole recurrences at the 4-stream model's H = 250 (D_in 150, 270, 117,
   250), all six LSTM kernels one cooperative launch per call; the four
   recurrences again at B in {1, 8, 10, 64}, H in {500, 250, 130} and T in
   {1, 29}, both directions, ragged masks with a fully padded row and a
   length-1 row, nonzero peephole vectors, into NaN-filled outputs, with each
   shape's launch plan and its time per call and per step; the two backward
   chains at B in {1, 10, 64} and H in {500, 250, 130}, both directions,
   clip 5 with x1 and x100 upstream (the clip bites) and clip 0, the three
   peephole gradients compared too, with each shape's launch plan; the six
   persistent kernels traced with torch.profiler at the main path's shapes
   (exactly one launch per call and no other device work, its device time
   per call and per step), timed against cuDNN, and at two units-per-block
   settings in turns; batches above one launch's shared memory (rows 1 and
   3 at B = 6000, rows 3 and 4 at B = 2100, H = 500) and forced row chunks
   at B = 64 (all six), each chunked call against its plain version;
4. build the full-width trimodal adenet_v3 (1144/90/1144, H = 500, W = 9)
   from a seeded generator, serve raw uint8 requests (B = 1 and 8, T = 29,
   ragged masks) through ``serve.make_trimodal_server``, check the scores
   (finite, rows sum to 1, equal to the port's CPU path on the same
   parameters) and the launches of that run (5 LSTM launches and 1 delta
   launch per forward, no other kernel);
5. time requests on the host clock, and trace five B = 8 requests with
   torch.profiler for the device time by kernel, the device's busy share,
   and the device kernels and host launch calls per request (1 launch of the
   grouped delta kernel and 5 of the non-peephole recurrence, no other chain
   kernel and none of the per-step kernel per request);
6. train the same model at B = 10, T = 29 through
   ``train.trainer.make_train_step``: three steps with its own dropout rates
   (loss, gradients and parameters finite; 5 training-recurrence, 5
   backward-chain, 1 delta and no other launches per step), then at dropout
   0 the card against the port's CPU path on the same parameters and batch
   (loss, every gradient, updated parameters), the step median on the host
   clock, and a torch.profiler trace of three steps (device time by kernel,
   device kernels and host launch calls per step, 1 delta launch and 5 of
   each non-peephole persistent kernel, none of the peephole ones and none
   of the per-step kernel per step);
7. build the peephole 4-stream adasum AdeNet of ``configs/oulu_4stream.ini``
   through ``train.config`` at full width (features 150/150/270/117, H =
   250), serve seeded feature streams (B = 1 and 10, lengths 14-29) through
   ``serve.make_server`` (6 peephole recurrences and 1 delta launch over
   the four streams per forward, no other kernel; probabilities equal to the
   CPU path), time and trace it (1 delta launch and 6 launches of the
   peephole inference chain per request, no other chain
   kernel and none of the per-step kernel; device kernels and host launch
   calls per request);
8. train it three steps at the ini's batch size and learning rate (6
   peephole training recurrences, 6 peephole backward chains, 1 delta, no
   other launch per step), hold the card's step against the CPU path, time
   and trace it (1 delta launch and 6 of each peephole chain kernel per
   step, none of the others);
9. rows 1 and 5 with their final-cell output (``phase_lstm_state``, run
   after the chunk checks of 3.): H = 500 at B = 1 and 8, H = 250 at B = 1
   and 10, 3 forced row chunks at B = 64, T in {1, 2, 29, 32}, nonzero
   initial states, into NaN-filled outputs, a fully padded row handing its
   cell back bit for bit, the T = 32 call against chunks of 1 + 2 + 29
   frames resumed from the carried state, and at B = 1 the traced time for
   T = 1 and 32 beside the bound;
10. streaming (``phase_stream``): ``serve.StreamingSession`` at B = 1 on
   the full-width adenet_v4 (row 1, last-step head) and adenet_v2_4 (row 5,
   per-step head with the vote), seeded weights, 4 utterances of 14-29
   frames fed one frame per feed and one in chunks of 7: 3 launches of the
   model's row per advance and none of any other row (the delta FIR runs
   on the host), every frame against the CPU session and against the
   card's one-shot ``make_server(vote=False)`` (every frame, or the last
   for the last-step head) within 2e-5; the median host time of a one-frame
   feed that emits a score, of ``finalize``, and the busy share;
11. the bucketed and pipelined servers (``phase_serve_buckets``) on the
   4-stream model at full width: ``make_bucketed_server`` with buckets
   (1, 8, 32) x (32, 64) on B in {1, 3, 8, 40} x T in {14, 29} against the
   same server on the CPU, launches counted; ``PipelinedServer`` over 64
   requests of B = 1, T = 29 at depth 8, batch 1 and 4, in order and equal
   to the synchronous server, requests/s against a synchronous loop and
   against pageable uploads, in turns, and each loop's host time per
   request split into upload, forward, packing and waiting;
12. train through ``train.trainer.Trainer.fit`` (``phase_fit``): the
   flagship at full width with its dropout on configs/oulu_trimodal.ini's
   ``[training]`` schedule (adadelta, lr 1.0, decay 0.1, batch 10, W = 9,
   validation window 6) cut to 3 epochs of 4 steps with the decay from
   epoch 2, on a seeded split of 40 / 20 / 20 utterances (T 5-29), a
   checkpoint each epoch: every launch of the fit counted (5 training
   recurrences and 5 backward chains per step, 5 inference recurrences per
   evaluation forward, 1 delta per forward, no other), the host time per
   step split into batch assembly, its pinned copy, the copy to the card
   and the step, the epoch wall times, an epoch's device busy share, the
   validation split's evaluation time and peak memory; a split of 600
   evaluated in chunks of 512 (host and device-side) against one batch of
   600 (rates within one utterance); at dropout 0 the
   fit on the card against the CPU path, with device-resident data against
   the host path, and resumed from its epoch-2 checkpoint on the card
   against the CPU path's resume (costs within 1e-4 relative, class rates
   within one utterance, best parameters within 1e-4); then the 4-stream
   model of configs/oulu_4stream.ini through the same Trainer for 2 epochs
   of 3 steps (6 peephole training recurrences and backward chains per
   step, 6 peephole inference recurrences per evaluation forward);
13. the training CLIs (``phase_cli``) from ``.mat`` and INI files: a seeded
   corpus at OuluVS's widths written through the port's ``save_mat`` and
   ``save_dbn_mat`` (26 x 44 uint8 pixels, DCT 90, MFCC 39 with other
   lengths, 60 utterances over 10 subjects, subject files, two
   1144-2000-1000-500-50 autoencoders), configs/oulu_trimodal.ini and
   configs/oulu_4stream.ini pointed at it with ``[training]`` cut as in 12.;
   ``cli.trimodal`` (the flagship from the autoencoders, its dropout on: 5
   rows 3 and 4 per step, 5 row 1 per evaluation forward, 1 delta per
   forward) and ``cli.nstream`` (peephole, adasum, force-aligned: 6 rows 6
   and 7 per step, 6 row 5 per evaluation forward) in-process on the card,
   then bucketed (``bucket_boundaries = auto``) and with
   ``grad_accum_steps = 2`` (2 microbatches a step); each CLI again with
   ``--device cpu`` (trimodal at dropout 0 on both), what reached
   ``Trainer.fit`` equal bit for bit and the fits as in 12., the
   accumulated fit against the unaccumulated one; then ``cli.leave_one_out``
   (adenet_v5 from the autoencoders on the trimodal INI, subject 3 held out
   as validation and test, dropout 0: 5 rows 3 and 4 per step, 5 row 1 per
   evaluation forward) and ``cli.audio_visual`` (the pixels through one
   autoencoder and the MFCC stream, force-aligned, 2 epochs of 3 steps: 4
   rows 6 and 7 per step, 4 row 5 per evaluation forward), each on the
   card and with ``--device cpu``; the ``.mat`` load, preprocessing, model
   build, fit and wall seconds of every run and the card's host split per
   step;
14. export (``phase_export``): the full-width flagship raw-pixel server
   (symbolic B and T) exported on the card and again on the CPU, the
   full-width 4-stream server (symbolic; f32, and bf16 weights on per-step
   probabilities), a pinned B = 8, T = 29 flagship artifact and an
   adenet_v4 streaming artifact, each written to a temporary directory,
   loaded onto the card and held against its live server (2e-5; bf16 2e-3
   with the same argmax on frames whose top-2 gap exceeds 4e-3; the pinned
   one refusing B = 1), also on requests with swapped axes (numpy and on
   the card), with exactly 5 row-1 (flagship) or 6 row-5 (4-stream)
   launches and 1 delta launch per artifact forward and 3 row-1 launches
   per streaming advance; a traced artifact forward holds those kernels
   and no host-to-device copy beyond the inputs' upload; export seconds,
   artifact bytes, host medians of artifact and live server in turns, busy
   shares; the operators' host cost, per kernel call and per live request
   (through the operators against straight launches, in turns);
15. the rest of the model zoo (``phase_zoo``): deltanet, baseline_end2end,
   adenet_v1, v1_1, v2_2, v2_nodelta, v5 (sum and adasum), v6 and avnet at
   full width (1144 pixels, DCT 90, MFCC 39, the builders' own H, 10
   classes), seeded weights and running statistics, each served at B = 8,
   T = 29 with a ragged mask through ``serve.make_server``: its launches per
   forward against :data:`ZOO_LAUNCHES`, its probabilities against the CPU
   path within 2e-5, its device time per forward; adenet_v1 (batch norm)
   stepped at B = 10 against the CPU path, fitted on the flagship's cut
   schedule on the card and on the CPU (held to 4x the spread of two CPU
   fits that differ in summation order), its running statistics moved,
   and exported (an f32 artifact against its live server); the flagship
   with ``fuse_scans`` served and stepped equal to unfused bit for bit;
16. the residual levers (``phase_residuals``): the flagship and the 4-stream
   model each take a train step under none, remat, bf16 residuals and
   both, each against the CPU path for the same setting, remat against none
   within 1e-4; for one step at B = 10 and T = 29 and 512, the memory the
   forward holds for its backward and the step's peak beside the predicted
   residual bytes;
17. pretraining (``phase_pretrain``) at full width from a seeded corpus
   of OuluVS's size (16763 frames of 26 x 44 uint8 pixels, and the same
   utterances at 60 x 80): ``cli.pretrain_dbn`` on the reference's
   schedule (1144-2000-1000-500-50, sigm and a linear top, 10 epochs of
   168 CD-1 steps a layer, every epoch timed), ``cli.ae_finetuner`` on its
   ``.mat`` (2 epochs), ``cli.trimodal`` from the finetuned ``.mat`` (one
   autoencoder for the raw and the diff stream, cut as in 13.: rows 1-4
   counted), ``cli.convae`` for the four variants (1 epoch each) and
   ``pretrain.sde.train_sde`` (1 epoch a layer), every pretraining run
   launching no ported row; a traced CD epoch of layer 1 (device kernels
   and host launch calls per step, busy share, the step's bound), the AE
   and conv-AE step times; then layer 1 on the card against the CPU path
   with the same draws (one CD-1 step with its flipped states counted,
   one epoch by its error), an AE-finetune epoch, and the conv-AE's
   forward and training step (plain and batchnorm, rerouted pooling
   windows counted); the peak memory and the phase's seconds;
18. the last CLIs and the native ``.mat`` reader (``phase_tools``):
   ``cli.parity_check --rehearse`` at AVLetters' full shape (780 utterances
   of 30 x 40 pixels written as ``.mat`` files with a 1200-2000-1000-500-50
   autoencoder, a BLSTM of H = 250, 26 classes) on
   configs/avletters_1stream.ini's whole schedule (30 epochs of 20 steps at
   batch 26, Adam): 2 rows 3 and 4 and 1 row 2 per step, 2 row 1 and 1 row
   2 per evaluation forward, none of rows 5-7, its test rate above
   REHEARSAL_CR_FLOOR; the same corpus for 2 epochs through ``cli.nstream``
   on the card (best parameters saved), with the native reader off, and on
   the CPU (inputs of the fit equal bit for bit, the fits as in 12.); the
   native reader against ``scipy.io.loadmat`` bit for bit on that corpus
   and on 13.'s, the readers timed in interleaved turns; then
   ``cli.confusion_visualizer`` with the saved model on the card (one
   forward over the 780 utterances: 2 row 1, 1 row 2) against the CPU path
   (equal confusions and matrix);
19. print the fit's numbers, the kernels line (each row's launches in the
   fits and per fit epoch, beside its serve or train path's count; rows 1
   and 5 also their launches in the streaming sessions and the state
   output's error; rows 1, 2 and 5 their launches through the artifacts;
   every row its launches through the CLIs' card runs, through phase_zoo,
   through phase_residuals, through phase_pretrain and through phase_tools),
   then ``{"ok": true,
   "device": ...}`` last.

Exits non-zero without a CUDA device or without the package beside it.

    python3 chip_smoke.py --ab DIR

is a measurement only: it times and traces row 2 per forward of both models
(the model's delta stage, its yardstick and the DeltaLayer's backward), and
times on the host clock and traces the serve and train paths of both
models, with the package in DIR (another checkout, for example an earlier
commit unpacked by ``git archive``), and prints one JSON line.  Two trees
are compared in turns on one card, parent, change, change, parent, each
turn its own process:

    git archive PARENT | tar -x -C results/parent
    for d in results/parent . . results/parent; do
        python3 chip_smoke.py --ab $d
    done
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
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
# in rounding (delta: the kernel applies the composed (3T, T) matrix, one
# rounding per tap, where the plain version rounds d before its second FIR,
# a few float32 ulps of outputs below 32; LSTM: 500-term dot products over
# 29 dependent steps), as in the CPU tests
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
# peepholes per (row, step, unit): forward, three multiply-adds into the i, f
# and o pre-activations (6 operations); backward, the same three recomputed,
# the out-gate route into dc, the in and forget routes into dc_prev and the
# three gradient sums (18 operations)
PEEP_FLOPS = 6
PEEP_BWD_FLOPS = 18
# train step, card vs CPU path: a gradient's tolerance relative to its max
# abs has this absolute floor (the adasum coefficients' gradients are small
# sums of terms that cancel, so their relative error is float32 noise)
TRAIN_GRAD_FLOOR = 1e-8
OULU_INI = os.path.join("configs", "oulu_4stream.ini")
# the seven kernels' launch counters: name -> wrapper attribute
KERNEL_COUNTERS = {
    "delta": ("delta", "append_delta"),
    "lstm_fwd": ("lstm", "lstm_recurrence"),
    "lstm_fwd_train": ("lstm", "lstm_recurrence_train"),
    "lstm_bwd": ("lstm", "lstm_bwd_chain"),
    "lstm_peep_fwd": ("lstm", "lstm_peep_recurrence"),
    "lstm_peep_fwd_train": ("lstm", "lstm_peep_recurrence_train"),
    "lstm_peep_bwd": ("lstm", "lstm_peep_bwd_chain"),
}
# the persistent kernels' instantiations as a trace names them, by their
# template arguments before the units per block: lstm_fwd_chain_kernel
# <EmitResiduals, Peephole, U> and lstm_bwd_chain_kernel<Peephole, U>
CHAIN_TRACE = {
    "lstm_fwd": "lstm_fwd_chain_kernel<false, false,",
    "lstm_fwd_train": "lstm_fwd_chain_kernel<true, false,",
    "lstm_peep_fwd": "lstm_fwd_chain_kernel<false, true,",
    "lstm_peep_fwd_train": "lstm_fwd_chain_kernel<true, true,",
    "lstm_bwd": "lstm_bwd_chain_kernel<false,",
    "lstm_peep_bwd": "lstm_bwd_chain_kernel<true,",
}
# every kernel a path trace is checked for, as the trace names it
TRACE_NAMES = {"delta": "delta_group_kernel", **CHAIN_TRACE}
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
# the delta groups of the two models' forwards: stream widths and batches
DELTA_GROUPS = {"flagship": ((50, 50), (1, 8)), "4-stream": ((50, 50, 90, 39), (1, TRAIN_B))}


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


def lstm_cost(B, T, H, peep=False):
    # with peepholes, also the three (H,) vectors and their multiply-adds
    nbytes = 4 * (B * T * 4 * H + H * 4 * H + B * T + 2 * B * H + B * T * H
                  + (3 * H if peep else 0))
    flops = (2 * B * T * H * 4 * H + LSTM_GATE_FLOPS * B * T * H
             + (PEEP_FLOPS * B * T * H if peep else 0))
    return nbytes, flops


def lstm_train_cost(B, T, H, peep=False):
    # the inference recurrence's traffic plus the residuals cells and gates
    nbytes, flops = lstm_cost(B, T, H, peep)
    return nbytes + 4 * (B * T * H + B * T * 4 * H), flops


def lstm_state_cost(B, T, H, peep=False):
    # the inference recurrence's traffic plus the final cell written once
    nbytes, flops = lstm_cost(B, T, H, peep)
    return nbytes + 4 * B * H, flops


def lstm_bwd_cost(B, T, H, peep=False):
    # reads g_out, gates, cells, cells_prev, mask, W_hid; writes dgates,
    # dcell0, dhid0; the dgates @ W_hid^T chain and the gate backward; with
    # peepholes also reads the three vectors, writes their three gradients,
    # and sums B (H,) partials into each
    nbytes = 4 * (3 * B * T * H + B * T * 4 * H + B * T + H * 4 * H
                  + B * T * 4 * H + 2 * B * H + (6 * H if peep else 0))
    flops = (2 * B * T * 4 * H * H + LSTM_BWD_GATE_FLOPS * B * T * H
             + (PEEP_BWD_FLOPS * B * T * H + 3 * B * H if peep else 0))
    return nbytes, flops


def counters():
    """{name: wrapper} for the seven kernels' wrappers; each wrapper's
    ``launches`` counts the calls that launched its kernel."""
    import importlib

    return {name: getattr(importlib.import_module(f"ip_avsr_torch.ops.kernels.{mod}"), fn)
            for name, (mod, fn) in KERNEL_COUNTERS.items()}


def reset_launches():
    for fn in counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in counters().items()}


def expect_launches(got, **nonzero):
    """Raise unless ``got`` has the counts ``nonzero`` and 0 elsewhere."""
    expected = {name: nonzero.get(name, 0) for name in KERNEL_COUNTERS}
    if got != expected:
        raise AssertionError(f"kernel launches {got}, expected {expected}")


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
    from ip_avsr_torch import native

    t0 = time.perf_counter()
    lib = native.build()
    print(f"native .mat reader: {shutil.which(native.CXX) or native.CXX} "
          f"{' '.join(native.CXX_FLAGS + native.LIBS)} -> {os.path.basename(lib)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in sorted(_build.build_logs):
        for line in _build.build_logs[name].splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                print(f"  {name}: {line.strip()}")


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()


def phase_card():
    print(smi("name,power.limit"))


def delta_group_cost(widths, B, T, W):
    """(bytes, operations) of one grouped call: the sum over its streams."""
    costs = [delta_cost(B, T, D, W) for D in widths]
    return sum(c[0] for c in costs), sum(c[1] for c in costs)


def phase_delta(dev):
    """Row 2, the grouped delta kernel: against its plain version per stream
    into NaN-filled outputs (the models' groups, then groups of one at the
    edges, every block of the grid written); at the models' groups,
    one traced launch per call and its device time, the event and host
    times, the plain version, the bound, the yardstick ``torch.matmul(S,
    x)``, and the DeltaLayer's backward (one product per stream)."""
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.ops.delta import append_delta_coeff, delta_group
    from ip_avsr_torch.ops.kernels.delta import append_delta, append_delta_group

    gen = torch.Generator().manual_seed(SEED)

    def group(widths, B, T=T_FRAMES):
        return [(torch.randn(B, T, D, generator=gen) * 3).to(dev) for D in widths]

    err = 0.0
    # the models' groups at their batches; groups of one with no window, T < W,
    # T = 1 and D not a multiple of 32
    cases = [(widths, B, T_FRAMES, 9) for widths, batches in DELTA_GROUPS.values()
             for B in batches]
    cases += [((50,), 2, 29, 0), ((70,), 2, 3, 4), ((33,), 3, 29, 1), ((20,), 2, 1, 9)]
    for widths, B, T, W in cases:
        xs = group(widths, B, T)
        outs = [torch.full((B, T, 3 * D), float("nan"), device=dev) for D in widths]
        append_delta_group(xs, W, outs=outs)
        torch.cuda.synchronize()
        e = max((o - append_delta_coeff(x, W)).abs().max().item() for x, o in zip(xs, outs))
        print(f"delta group D={list(widths)} B={B} T={T} W={W}: {append_delta.blocks} "
              f"blocks, max_abs_err={e:.3e}")
        if not e <= DELTA_TOL:
            raise AssertionError(f"delta kernel disagrees with its plain version: {e}")
        err = max(err, e)

    rows = {}
    W = 9
    S = yardstick_matrix(T_FRAMES, W, dev)
    for model, (widths, batches) in DELTA_GROUPS.items():
        for B in batches:
            xs = group(widths, B)
            fn = lambda: append_delta_group(xs, W)  # noqa: E731
            events = traced(fn, 5)
            device = [e for e in events if e.device_type == DeviceType.CUDA]
            ours = sum(e.count for e in device if "delta_group_kernel" in e.key)
            traced_ms = sum(e.self_device_time_total for e in device) / 1e3 / 5
            if ours != 5 or sum(e.count for e in device) != ours:
                raise AssertionError(f"delta {model} B={B}: expected 5 launches of "
                                     f"delta_group_kernel and nothing else, got "
                                     f"{[(e.key, e.count) for e in device]}")
            ms, host = cuda_ms(fn), host_us(fn)
            plain_ms = cuda_ms(lambda: [append_delta_coeff(x, W) for x in xs])
            # the yardstick: one matmul over the streams stacked where they
            # share D (the flagship's), else one per stream
            if len(set(widths)) == 1:
                stacked = torch.cat(xs)
                lib, lib_calls = (lambda: torch.matmul(S, stacked)), 1
            else:
                lib, lib_calls = (lambda: [torch.matmul(S, x) for x in xs]), len(xs)
            lib_ms = cuda_ms(lib)
            lib_traced, lib_ops = trace_device(lib, 5)
            b_ms, by = bound(*delta_group_cost(widths, B, T_FRAMES, W))
            xg = [x.clone().requires_grad_(True) for x in xs]
            outs = delta_group(xg, W)
            gs = [torch.randn_like(o) for o in outs]
            bwd = traced(lambda: torch.autograd.grad(outs, xg, gs, retain_graph=True), 5)
            bwd_dev = [e for e in bwd if e.device_type == DeviceType.CUDA]
            bwd_ms = sum(e.self_device_time_total for e in bwd_dev) / 1e3 / 5
            bwd_ops = sum(e.count for e in bwd_dev) / 5
            label = f"delta {model} B={B} D={list(widths)}"
            if bwd_ops != len(xs):
                raise AssertionError(f"{label}: the DeltaLayer backward took {bwd_ops:g} "
                                     f"device ops, not one product per stream")
            print(f"{label}: one launch per call, traced {traced_ms:.4f} ms per call, "
                  f"events {ms:.4f} ms, host {host:.1f} us per call; plain {plain_ms:.4f} ms; "
                  f"bound {b_ms:.7f} ms ({by}); yardstick matmul(S, x) ({lib_calls} call(s)) "
                  f"{lib_ms:.4f} ms events, traced {lib_traced:.4f} ms, {lib_ops:g} ops; "
                  f"DeltaLayer backward traced {bwd_ms:.4f} ms, {bwd_ops:g} device ops "
                  f"for {len(xs)} streams: " + "; ".join(
                      f"{e.key[:50]} x{e.count / 5:g}" for e in bwd_dev))
            rows[(model, B)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                    library_ms=lib_ms, traced_ms=traced_ms,
                                    library_traced_ms=lib_traced, host_us=host,
                                    bwd_traced_ms=bwd_ms, bwd_device_ops=bwd_ops)
    return err, rows


def phase_lstm(dev):
    import torch

    from ip_avsr_torch.ops.kernels.lstm import (_run_fwd, lstm_recurrence,
                                                lstm_recurrence_plain)

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
        print(f"lstm B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuDNN nn.LSTM {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({by})")
        args = (x_proj, w_hid, mask, c0, h0)
        traced = trace_chain(lambda: lstm_recurrence(*args), f"lstm_fwd B={B} H={H}",
                             "lstm_fwd", T_FRAMES)
        rows[B] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                       library_ms=lib_ms, traced_ms=traced)
        compare_units(lambda u: (lambda: _run_fwd("lstm_recurrence", args, False, units=u)),
                      (4, 8), f"lstm_fwd B={B} H={H}")
    return err, rows


def fwd_sweep(dev):
    """Rows 1, 3, 5 and 6 against their plain versions at B in {1, 8, 10,
    64}, H in {500, 250, 130} (130 leaves the last block ragged whatever the
    units per block) and T in {1, 29}, both directions, ragged masks with a
    fully padded row and a length-1 row, nonzero peephole vectors, each
    output held relative to its max abs.  Each kernel runs twice: through
    its wrapper, and into NaN-filled outputs (which must come out finite and
    bit-equal to the first), so a value the kernel did not write, or read
    stale, shows.  Prints each shape's launch plan and, at T = 29, each
    kernel's time per call and per step.  Returns the largest absolute error
    of each row at its main path's H (500, or 250 with peepholes)."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 10)
    # name -> (wrapper, plain version, training, peepholes)
    rows = {"lstm_fwd": (kl.lstm_recurrence, kl.lstm_recurrence_plain, False, False),
            "lstm_fwd_train": (kl.lstm_recurrence_train, kl.lstm_recurrence_train_plain, True,
                               False),
            "lstm_peep_fwd": (kl.lstm_peep_recurrence, kl.lstm_peep_recurrence_plain, False,
                              True),
            "lstm_peep_fwd_train": (kl.lstm_peep_recurrence_train,
                                    kl.lstm_peep_recurrence_train_plain, True, True)}
    err = {name: 0.0 for name in rows}
    for H in (500, 250, 130):
        for B in (1, 8, TRAIN_B, 64):
            plan = kl.fwd_launch_plan(B, H, sm_count)
            print(f"lstm_fwd plan B={B} H={H} on {sm_count} SMs: U={plan.units} hidden units per "
                  f"block, grid {plan.grid}, {plan.smem_bytes} B of shared memory, last block "
                  f"U={plan.last_units} live, {plan.chunks} chunk(s) of <= {plan.rows} rows")
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            c0 = torch.randn(B, H, generator=gen).to(dev)
            h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
            vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3))
            for T in (1, T_FRAMES):
                x_proj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
                mask = ragged_mask(B, T, gen, "cpu")
                if B > 2:
                    mask[-1] = 0.0  # a fully padded row
                    mask[1] = 0.0   # a length-1 row
                    mask[1, 0] = 1.0
                for backwards in (False, True):
                    ms_ = (mask.flip(1) if backwards else mask).contiguous().to(dev)
                    args = (x_proj, w_hid, ms_, c0, h0)
                    for name, (kernel, plain, train, peep) in rows.items():
                        pargs = (*args, *vecs) if peep else args
                        got = kernel(*pargs)
                        got = got if train else (got,)
                        ref = plain(*pargs)
                        ref = ref if train else (ref,)
                        nan = [torch.full_like(g, float("nan")) for g in got]
                        kl._run_fwd(name, args, train, peep=vecs if peep else (), outs=nan)
                        same = all(torch.equal(a, b) for a, b in zip(nan, got))
                        errs = [max_err(a, r)[0] for a, r in zip(got, ref)]
                        rel = max(a / max(r.abs().max().item(), 1e-30)
                                  for a, r in zip(errs, ref))
                        print(f"{name} B={B} H={H} T={T} backwards={backwards}: max_abs_err="
                              f"{max(errs):.3e}, relative {rel:.3e}; into NaN-filled "
                              f"outputs: bit-equal {same}")
                        if not (same and rel <= LSTM_TOL):
                            raise AssertionError(
                                f"{name} kernel disagrees with its plain version: {rel}")
                        if H == (250 if peep else 500):
                            err[name] = max(err[name], max(errs))
                if T == T_FRAMES:
                    for name, (kernel, _, _, peep) in rows.items():
                        pargs = (*args, *vecs) if peep else args
                        ms = cuda_ms(lambda: kernel(*pargs))
                        print(f"{name} B={B} H={H}: kernel {ms:.4f} ms per call, "
                              f"{ms * 1e3 / T_FRAMES:.3f} us per step (event clock)")
    return err


def phase_lstm_train(dev):
    import torch

    from ip_avsr_torch.ops.kernels.lstm import (_run_bwd, _run_fwd, lstm_bwd_chain,
                                                lstm_bwd_chain_plain, lstm_recurrence_train,
                                                lstm_recurrence_train_plain)

    H = 500
    gen = torch.Generator().manual_seed(SEED + 3)
    fwd_err = 0.0
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
    bwd_err = bwd_sweep(dev, peep=False)
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
        print(f"lstm_fwd_train B={B}: kernel {fwd_ms:.4f} ms, plain {fwd_plain:.4f} ms, "
              f"cuDNN nn.LSTM forward (grad on) {lib_fwd:.4f} ms, bound {fb:.5f} ms ({fby})")
        print(f"lstm_bwd B={B}: kernel {bwd_ms:.4f} ms, plain {bwd_plain:.4f} ms, "
              f"cuDNN nn.LSTM backward (with dW, dx; no clip) {lib_bwd:.4f} ms, "
              f"bound {bb:.5f} ms ({bby}); kernel / cuDNN {bwd_ms / lib_bwd:.4f}")
        fargs = (x_proj, w_hid, mask, c0, h0)
        fwd_traced = trace_chain(lambda: lstm_recurrence_train(*fargs),
                                 f"lstm_fwd_train B={B} H={H}", "lstm_fwd_train", T_FRAMES)
        compare_units(lambda u: (lambda: _run_fwd("lstm_recurrence_train", fargs, True,
                                                  units=u)), (4, 8), f"lstm_fwd_train B={B} H={H}")
        bwd_traced = trace_chain(lambda: lstm_bwd_chain(*bargs), f"lstm_bwd B={B} H={H}",
                                 "lstm_bwd", T_FRAMES + 1)
        compare_units(lambda u: (lambda: _run_bwd("lstm_bwd_chain", bargs[:-1], 5.0,
                                                  units=u)), (4, 8), f"lstm_bwd B={B} H={H}")
        rows[B] = {
            "lstm_fwd_train": dict(ms=fwd_ms, plain_ms=fwd_plain, bound_ms=fb, bound_by=fby,
                                   library_ms=lib_fwd, traced_ms=fwd_traced),
            "lstm_bwd": dict(ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bb, bound_by=bby,
                             library_ms=lib_bwd, traced_ms=bwd_traced),
        }
    return fwd_err, bwd_err, rows


def bwd_sweep(dev, peep):
    """Row 4 (``peep`` False) or row 7 against its plain version at B in {1,
    10, 64} and H in {500, 250, 130} (130 leaves the last block ragged
    whatever the units per block), both directions, ragged masks with a
    fully padded row, clip 5 with x1 and x100 upstream and clip 0, each
    output held relative to its max abs; prints each shape's launch plan and
    the kernel's time there.
    Returns the largest absolute error at the main path's H (500, or 250
    with peepholes) at clip 5 and x1."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    name = "lstm_peep_bwd" if peep else "lstm_bwd"
    chain = kl.lstm_peep_bwd_chain if peep else kl.lstm_bwd_chain
    plain = kl.lstm_peep_bwd_chain_plain if peep else kl.lstm_bwd_chain_plain
    fwd = kl.lstm_peep_recurrence_train_plain if peep else kl.lstm_recurrence_train_plain
    main_h = 250 if peep else 500
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 8 + peep)
    D = 150
    err = 0.0
    for H in (500, 250, 130):
        for B in (1, TRAIN_B, 64):
            plan = kl.bwd_launch_plan(B, H, sm_count)
            print(f"{name} plan B={B} H={H} on {sm_count} SMs: U={plan.units} hidden units per "
                  f"block, grid {plan.grid}, {plan.smem_bytes} B of shared memory, last block "
                  f"U={plan.last_units} live")
            w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            b = (torch.randn(4 * H, generator=gen) * 0.1).to(dev)
            vecs = [(torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3 * peep)]
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
                _, cells, gates = fwd(x_proj, w_hid, ms_, c0, h0, *vecs)
                cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
                # scale 100 makes the clip bite; clip 0 checks the unclipped chain
                for scale, clip in ((1.0, 5.0), (100.0, 5.0), (1.0, 0.0)):
                    args = ((g * scale).contiguous(), gates, cells, cells_prev, ms_, w_hid,
                            *vecs, clip)
                    got = chain(*args)
                    ref = plain(*args)
                    errs = [max_err(a, r) for a, r in zip(got, ref)]
                    rel = max(r for _, r in errs)
                    clipped = (ref[0].abs() == clip).float().mean().item() if clip else 0.0
                    peep_note = (f" (peephole grads {max(a for a, _ in errs[3:]):.3e})"
                                 if peep else "")
                    print(f"{name} B={B} H={H} backwards={backwards} g x{scale:g} "
                          f"clip={clip:g}: max_abs_err={max(a for a, _ in errs):.3e}"
                          f"{peep_note}, relative {rel:.3e}, clipped share {clipped:.4f}")
                    if not (len(got) == len(ref) == 3 + 3 * peep and rel <= LSTM_BWD_TOL):
                        raise AssertionError(
                            f"{name} kernel disagrees with its plain version: {rel}")
                    if clip and scale > 1 and not clipped > 0.01:
                        raise AssertionError(f"the clip did not bite: share {clipped}")
                    if scale == 1.0 and clip and H == main_h:
                        err = max(err, max(a for a, _ in errs))
            args = (g, gates, cells, cells_prev, ms_, w_hid, *vecs, 5.0)
            ms = cuda_ms(lambda: chain(*args))
            print(f"{name} B={B} H={H}: kernel {ms:.4f} ms per call (clip 5), "
                  f"{ms * 1e3 / (T_FRAMES + 1):.3f} us per step")
    return err


def traced(fn, n):
    """``key_averages()`` of a torch.profiler trace (host and card) of ``n``
    calls of ``fn``.  The profile's first step calls ``fn`` once and is
    thrown away (the profiler's warm-up): on the H100 the first kernel after
    tracing starts can be lost, late in a run every time (4 of 5 traced
    chain launches, with 5 launch calls on the host).  The traced calls
    start and end 10 ms inside the trace: the trace's device clock can stand
    milliseconds off the host's, and a record that falls outside the trace
    is lost.  The schedule's own ``ProfilerStep*`` records (one on the host,
    one on the card) are left out."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    warm_up = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=warm_up) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(0.01)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.01)
        prof.step()
    events = prof.key_averages()
    events[:] = [e for e in events if not e.key.startswith("ProfilerStep")]
    return events


def trace_chain(fn, label, row, steps, n=5):
    """Trace ``n`` calls of a persistent kernel's wrapper with torch.profiler:
    each call must be exactly one launch of the instantiation of ``row``
    (:data:`CHAIN_TRACE`) and no other device work.  Prints and returns its
    device time per call, and prints it per step over ``steps``."""
    from torch.autograd import DeviceType

    events = traced(fn, n)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    ours = [e for e in device if CHAIN_TRACE[row] in e.key]
    launches = sum(e.count for e in ours)
    others = sum(e.count for e in device) - launches
    host = sum(e.count for e in events if e.key == "cudaLaunchCooperativeKernel")
    ms = sum(e.self_device_time_total for e in ours) / 1e3 / n
    names = sorted({re.search(r"lstm_\w+_chain_kernel<[^>]*>", e.key).group(0) for e in ours})
    print(f"{label}: traced {n} calls, {launches} launches of {names} ({host} cooperative "
          f"launch calls on the host) and {others} other device ops; device time {ms:.4f} ms "
          f"per call, {ms * 1e3 / steps:.3f} us per step (/ {steps}; the earlier "
          f"one-launch-per-step kernels took 5.2-8.0 us per step launch)")
    if launches != n or others:
        raise AssertionError(f"{label}: expected {n} kernel launches and nothing else, traced "
                             f"{launches} launches, {others} other device ops and {host} "
                             f"cooperative launch calls on the host")
    return ms


def compare_units(make, units, label):
    """Time the chain at each units-per-block in ``units``, in turns (a, b,
    b, a), on the card's clock; ``make(u)`` gives the call, which bypasses
    the wrapper's launch counter."""
    order = list(units) + list(units)[::-1]
    times = {u: [] for u in units}
    for u in order:
        times[u].append(cuda_ms(make(u)))
    print(f"{label}: units per block vs kernel ms (two runs each, in turns): "
          + ", ".join(f"U={u}: {' / '.join(f'{t:.4f}' for t in times[u])}" for u in units))
    return times


def phase_serve(dev):
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet, zoo
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

    reset_launches()
    scores = [server(raw, mask) for raw, mask in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(requests)
    print(f"served {n} requests: launches {launches}")
    expect_launches(launches, delta=n, lstm_fwd=5 * n)

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

    raw, mask = requests[1]
    n_traced = 5
    events = traced(lambda: server(raw, mask), n_traced)
    print(events.table(sort_by="self_cuda_time_total", row_limit=14))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3 / n_traced
    print(f"serve B=8: device busy {busy_ms:.3f} ms per request (profiler, "
          f"{n_traced} requests); busy share of the median request "
          f"{busy_ms / latency[8]:.3f}")
    expect_traced(events, n_traced, "serve B=8", delta=1, lstm_fwd=5)
    launch_counts(events, n_traced, "serve B=8", "95 with one delta launch per stream")
    return launches, latency


def expect_traced(events, n, label, **per_call):
    """Raise unless a trace's ``key_averages()`` over ``n`` requests or steps
    holds, per request or step, the launches ``per_call`` (row name -> count)
    of the grouped delta kernel and of the persistent kernels' instantiations
    (:data:`TRACE_NAMES`), none of the other instantiations and no launch of
    the per-step recurrence kernel."""
    from torch.autograd import DeviceType

    forbidden = "lstm_step_kernel"
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    got = {row: sum(e.count for e in device if name in e.key) / n
           for row, name in TRACE_NAMES.items()}
    want = {row: float(per_call.get(row, 0)) for row in TRACE_NAMES}
    bad = {e.key: e.count for e in device if forbidden in e.key}
    print(f"{label}: traced kernel launches per request or step {got}; {forbidden}: "
          f"{bad or 'none'}")
    if got != want or bad:
        raise AssertionError(f"{label}: expected {want} per call and no {forbidden}")


def phase_train(dev):
    import dataclasses

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.train import trainer

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

    reset_launches()
    p, st = params, state
    losses = []
    n_steps = 3
    for _ in range(n_steps):
        p, st, loss = step(p, st, streams, y, mask, gen)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"train {n_steps} steps, flagship dropout: losses "
          f"{[round(float(v), 6) for v in losses]}, launches {launches}")
    expect_launches(launches, lstm_fwd_train=5 * n_steps, lstm_bwd=5 * n_steps,
                    delta=n_steps)
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

    n_traced = 3
    carry = [p, st]

    def train_step():
        carry[:] = step(*carry, streams, y, mask, gen)[:2]

    events = traced(train_step, n_traced)
    print(events.table(sort_by="self_cuda_time_total", row_limit=16))
    # where the host's time goes: the step is expected to be host-bound
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3 / n_traced
    print(f"train B={B}: device busy {busy_ms:.3f} ms per step (profiler, {n_traced} "
          f"steps); busy share of the median step {busy_ms / median:.3f}")
    expect_traced(events, n_traced, f"train B={B}", delta=1, lstm_fwd_train=5,
                  lstm_bwd=5)
    launch_counts(events, n_traced, f"train B={B}",
                  "772 with one delta launch per stream and a 17-op FIR backward per stream")
    return launches, median


def phase_lstm_peep(dev):
    """Rows 5-7: the peephole kernels against their plain versions at the
    4-stream model's shapes (H = 250, D_in of its four stream LSTMs and its
    aggregator), then their times."""
    import torch

    from ip_avsr_torch.ops.kernels.lstm import (
        _run_bwd, _run_fwd, lstm_peep_bwd_chain, lstm_peep_bwd_chain_plain, lstm_peep_recurrence,
        lstm_peep_recurrence_plain, lstm_peep_recurrence_train,
        lstm_peep_recurrence_train_plain)

    H = 250
    gen = torch.Generator().manual_seed(SEED + 5)
    fwd_err = train_err = 0.0
    for B in (1, TRAIN_B):
        for D in (150, 270, 117, 250):
            w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            b = (torch.randn(4 * H, generator=gen) * 0.1).to(dev)
            peep = [(torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3)]
            c0 = torch.randn(1, H, generator=gen).to(dev).expand(B, H).contiguous()
            h0 = (torch.randn(1, H, generator=gen) * 0.5).to(dev).expand(B, H).contiguous()
            x = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
            mask = ragged_mask(B, T_FRAMES, gen, dev)
            if B > 1:
                mask[-1] = 0.0  # a fully padded row
            for backwards in (False, True):
                xs, ms_ = (x.flip(1), mask.flip(1)) if backwards else (x, mask)
                ms_ = ms_.contiguous()
                x_proj = (xs.reshape(-1, D) @ w_in).reshape(B, T_FRAMES, 4 * H) + b
                fargs = (x_proj, w_hid, ms_, c0, h0, *peep)
                e_inf = max_err(lstm_peep_recurrence(*fargs),
                                lstm_peep_recurrence_plain(*fargs))[0]
                got = lstm_peep_recurrence_train(*fargs)
                ref = lstm_peep_recurrence_train_plain(*fargs)
                e_train = max(max_err(a, r)[0] for a, r in zip(got, ref))
                print(f"lstm_peep_fwd B={B} D_in={D} H={H} backwards={backwards}: "
                      f"max_abs_err={e_inf:.3e}; training (hids, cells, gates) {e_train:.3e}")
                if not (e_inf <= LSTM_TOL and e_train <= LSTM_TOL):
                    raise AssertionError("peephole LSTM kernel disagrees with its plain "
                                         f"version: {e_inf}, {e_train}")
                fwd_err, train_err = max(fwd_err, e_inf), max(train_err, e_train)
    bwd_err = bwd_sweep(dev, peep=True)
    rows = {}
    for B in (1, TRAIN_B):
        D = 150
        w_in = (torch.randn(D, 4 * H, generator=gen) / D ** 0.5).to(dev)
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        peep = [(torch.randn(H, generator=gen) * 0.1).to(dev) for _ in range(3)]
        x = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
        x_proj = (x.reshape(-1, D) @ w_in).reshape(B, T_FRAMES, 4 * H)
        mask = ragged_mask(B, T_FRAMES, gen, dev)
        c0 = torch.zeros(B, H, device=dev)
        h0 = torch.zeros(B, H, device=dev)
        fargs = (x_proj, w_hid, mask, c0, h0, *peep)
        _, cells, gates = lstm_peep_recurrence_train(*fargs)
        cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
        g = torch.randn(B, T_FRAMES, H, generator=gen).to(dev)
        bargs = (g, gates, cells, cells_prev, mask, w_hid, *peep, 5.0)
        timed = {
            "lstm_peep_fwd": (lambda: lstm_peep_recurrence(*fargs),
                              lambda: lstm_peep_recurrence_plain(*fargs),
                              lstm_cost(B, T_FRAMES, H, peep=True)),
            "lstm_peep_fwd_train": (lambda: lstm_peep_recurrence_train(*fargs),
                                    lambda: lstm_peep_recurrence_train_plain(*fargs),
                                    lstm_train_cost(B, T_FRAMES, H, peep=True)),
            "lstm_peep_bwd": (lambda: lstm_peep_bwd_chain(*bargs),
                              lambda: lstm_peep_bwd_chain_plain(*bargs),
                              lstm_bwd_cost(B, T_FRAMES, H, peep=True)),
        }
        rows[B] = {}
        for name, (kernel, plain, cost) in timed.items():
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            b_ms, by = bound(*cost)
            # no PyTorch call computes a peephole LSTM (cuDNN's has none)
            rows[B][name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                                 library_ms=None)
            print(f"{name} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({by})")
        # context only, not a yardstick of the same function: cuDNN's
        # non-peephole LSTM at the same shapes (all-valid mask, it also does
        # the input projection), inference, forward with grad, and backward
        cudnn = torch.nn.LSTM(D, H, batch_first=True).to(dev)
        xin = torch.randn(B, T_FRAMES, D, generator=gen).to(dev)
        with torch.inference_mode():
            inf_ms = cuda_ms(lambda: cudnn(xin))
        xin.requires_grad_(True)
        fwd_ms = cuda_ms(lambda: cudnn(xin))
        out, _ = cudnn(xin)
        gy = torch.randn_like(out)
        wts = [xin, *cudnn.parameters()]
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, wts, gy, retain_graph=True))
        print(f"context B={B}: cuDNN nn.LSTM without peepholes, D_in={D} H={H}: inference "
              f"{inf_ms:.4f} ms, forward with grad {fwd_ms:.4f} ms, backward "
              f"{bwd_ms:.4f} ms; lstm_peep_bwd kernel / cuDNN backward "
              f"{rows[B]['lstm_peep_bwd']['ms'] / bwd_ms:.4f}")
        for name, fn, train in (("lstm_peep_fwd", lstm_peep_recurrence, False),
                                ("lstm_peep_fwd_train", lstm_peep_recurrence_train, True)):
            rows[B][name]["traced_ms"] = trace_chain(lambda: fn(*fargs), f"{name} B={B} H={H}",
                                                     name, T_FRAMES)
            compare_units(lambda u: (lambda: _run_fwd(name.replace("fwd", "recurrence"),
                                                      fargs[:5], train, tuple(peep), units=u)),
                          (2, 4), f"{name} B={B} H={H}")
        rows[B]["lstm_peep_bwd"]["traced_ms"] = trace_chain(
            lambda: lstm_peep_bwd_chain(*bargs), f"lstm_peep_bwd B={B} H={H}",
            "lstm_peep_bwd", T_FRAMES + 1)
        compare_units(lambda u: (lambda: _run_bwd("lstm_peep_bwd_chain", bargs[:6], 5.0,
                                                  tuple(peep), units=u)), (2, 4),
                      f"lstm_peep_bwd B={B} H={H}")
    return fwd_err, train_err, bwd_err, rows


def phase_chunks(dev):
    """Batches whose carries do not fit one launch's shared memory beside
    W_hid, and forced row chunks at a small batch, each chunked call held
    against its plain version (relative to each output's max abs) and timed
    on the event clock: rows 1 and 3 at B = 6000 and rows 3 and 4 at
    B = 2100 (H = 500, T = 29) through their wrappers, then all six
    persistent rows at B = 64 in 3 chunks of 21, 21 and 22 rows (H = 500, or
    250 with peepholes), the recurrences also into NaN-filled outputs."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 12)
    fwd_rows = {  # name -> (wrapper, plain version, training, peepholes)
        "lstm_fwd": (kl.lstm_recurrence, kl.lstm_recurrence_plain, False, False),
        "lstm_fwd_train": (kl.lstm_recurrence_train, kl.lstm_recurrence_train_plain, True,
                           False),
        "lstm_peep_fwd": (kl.lstm_peep_recurrence, kl.lstm_peep_recurrence_plain, False, True),
        "lstm_peep_fwd_train": (kl.lstm_peep_recurrence_train,
                                kl.lstm_peep_recurrence_train_plain, True, True)}
    bwd_rows = {"lstm_bwd": (kl.lstm_bwd_chain, kl.lstm_bwd_chain_plain, False),
                "lstm_peep_bwd": (kl.lstm_peep_bwd_chain, kl.lstm_peep_bwd_chain_plain, True)}

    def inputs(B, H, peep):
        x_proj = torch.randn(B, T_FRAMES, 4 * H, generator=gen).to(dev)
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        mask = ragged_mask(B, T_FRAMES, gen, "cpu")
        mask[-1] = 0.0  # a fully padded row
        c0 = torch.randn(B, H, generator=gen).to(dev)
        h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
        vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3 * peep))
        return (x_proj, w_hid, mask.to(dev), c0, h0), vecs

    def hold(label, got, ref, tol, ms, plan):
        errs = [max_err(a, r)[0] for a, r in zip(got, ref)]
        rel = max(e / max(r.abs().max().item(), 1e-30) for e, r in zip(errs, ref))
        print(f"{label}: {plan.chunks} chunk(s) of <= {plan.rows} rows, {plan.smem_bytes} B of "
              f"shared memory per block, U={plan.units}; max_abs_err {max(errs):.3e}, relative "
              f"{rel:.3e}; kernel {ms:.4f} ms per call (event clock)")
        if not (len(got) == len(ref) and rel <= tol):
            raise AssertionError(f"{label}: chunked kernel disagrees with its plain version")

    for name, B, H, chunks in (("lstm_fwd", 6000, 500, None), ("lstm_fwd_train", 6000, 500, None),
                               ("lstm_fwd_train", 2100, 500, None), ("lstm_bwd", 2100, 500, None),
                               *((n, 64, 250 if "peep" in n else 500, 3)
                                 for n in (*fwd_rows, *bwd_rows))):
        label = f"{name} B={B} H={H}" + (f" forced into {chunks} chunks" if chunks else "")
        if name in fwd_rows:
            wrapper, plain, train, peep = fwd_rows[name]
            args, vecs = inputs(B, H, peep)

            def call():
                if chunks is None:
                    return wrapper(*args, *vecs)
                return kl._run_fwd(name, args, train, peep=vecs, chunks=chunks)

            got = call()
            got = got if train else (got,)
            ref = plain(*args, *vecs)
            ref = ref if train else (ref,)
            nan = [torch.full_like(g, float("nan")) for g in got]
            kl._run_fwd(name, args, train, peep=vecs, chunks=chunks, outs=nan)
            if not all(torch.equal(a, b) for a, b in zip(nan, got)):
                raise AssertionError(f"{label}: NaN-filled outputs not bit-equal")
            ms = cuda_ms(call, iters=3, warmup=1)
            plan = kl.fwd_launch_plan(B, H, sm_count, chunks=chunks)
            hold(label, got, ref, LSTM_TOL, ms, plan)
        else:
            chain, plain, peep = bwd_rows[name]
            fwd = kl.lstm_peep_recurrence_train_plain if peep else kl.lstm_recurrence_train_plain
            (x_proj, w_hid, mask, c0, h0), vecs = inputs(B, H, peep)
            _, cells, gates = fwd(x_proj, w_hid, mask, c0, h0, *vecs)
            cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
            g = torch.randn(B, T_FRAMES, H, generator=gen).to(dev)
            bargs = (g, gates, cells, cells_prev, mask, w_hid)

            def call():
                if chunks is None:
                    return chain(*bargs, *vecs, 5.0)
                return kl._run_bwd(name.replace("bwd", "bwd_chain"), bargs, 5.0, vecs,
                                   chunks=chunks)

            got = call()
            ms = cuda_ms(call, iters=3, warmup=1)
            plan = kl.bwd_launch_plan(B, H, sm_count, chunks=chunks)
            hold(label, got, plain(*bargs, *vecs, 5.0), LSTM_BWD_TOL, ms, plan)


# rows 1 and 5 with their final-cell output: row name -> (state wrapper,
# plain version, peepholes, H of the streaming model, its batches)
STATE_ROWS = {"lstm_fwd": ("lstm_recurrence_state", "lstm_recurrence_state_plain", False, 500,
                           (1, 8)),
              "lstm_peep_fwd": ("lstm_peep_recurrence_state", "lstm_peep_recurrence_state_plain",
                                True, 250, (1, TRAIN_B))}
STATE_T = (1, 2, T_FRAMES, 32)
STATE_SPLIT = (1, 2, 29)  # time chunks of the T = 32 call


def phase_lstm_state(dev):
    """Rows 1 and 5 with their final-cell output (``lstm_recurrence_state``,
    ``lstm_peep_recurrence_state``) against their plain versions: H = 500
    at B = 1 and 8 (row 1), H = 250 at B = 1 and 10 (row 5), and 3 forced
    row chunks at B = 64, each at T in {1, 2, 29, 32}, with nonzero
    per-row initial states, ragged masks with a fully padded row, nonzero
    peephole vectors; each call also into NaN-filled outputs (which must
    come out bit-equal).  The T = 32 call against the same call cut into
    chunks of 1 + 2 + 29 frames, each resumed from the last one's (cell_T,
    hids[:, -1]).  At B = 1, T = 1 and 32: one traced launch per call, its
    device time, the event time and the bound.  Returns {row: {"err": the
    largest absolute error, "B1": {T: times}}}."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 20)
    out = {}
    for name, (wrapper, plain, peep, H, batches) in STATE_ROWS.items():
        wrapper, plain = getattr(kl, wrapper), getattr(kl, plain)
        err, times = 0.0, {}
        for B in (*batches, 64):
            chunks = 3 if B == 64 else None
            w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
            c0 = torch.randn(B, H, generator=gen).to(dev)
            h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
            vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev)
                         for _ in range(3 * peep))
            whole = {}
            for T in STATE_T:
                x_proj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
                mask = ragged_mask(B, T, gen, "cpu")
                if B > 2:
                    mask[-1] = 0.0  # a fully padded row
                args = (x_proj, w_hid, mask.to(dev), c0, h0)

                def call(args=args):
                    if chunks is None:
                        return wrapper(*args, *vecs)
                    return kl._run_fwd(name, args, False, peep=vecs, chunks=chunks, state=True)

                got = call()
                ref = plain(*args, *vecs)
                nan = [torch.full_like(g, float("nan")) for g in got]
                kl._run_fwd(name, args, False, peep=vecs, chunks=chunks, outs=nan, state=True)
                same = all(torch.equal(a, b) for a, b in zip(nan, got))
                errs = [max_err(a, r)[0] for a, r in zip(got, ref)]
                rel = max(e / max(r.abs().max().item(), 1e-30) for e, r in zip(errs, ref))
                kept = torch.equal(got[1][-1], c0[-1]) if B > 2 else True
                print(f"{name} state B={B} H={H} T={T}"
                      + (f" in {chunks} forced chunks" if chunks else "")
                      + f": max_abs_err hids {errs[0]:.3e}, cell_T {errs[1]:.3e}, relative "
                      f"{rel:.3e}; into NaN-filled outputs bit-equal {same}; fully padded "
                      f"row keeps its cell bit for bit {kept}")
                if not (same and kept and rel <= LSTM_TOL):
                    raise AssertionError(f"{name} state kernel disagrees with its plain version")
                err = max(err, *errs)
                whole[T] = (args, got)
            # one-shot against time chunks resumed from the carried state
            (x_proj, w_hid, mask, _, _), (hids, cell_T) = whole[32]
            state, pieces, s = (c0, h0), [], 0
            for n in STATE_SPLIT:
                part = (x_proj[:, s: s + n].contiguous(), w_hid,
                        mask[:, s: s + n].contiguous(), *state)
                if chunks is None:
                    h_part, c_part = wrapper(*part, *vecs)
                else:
                    h_part, c_part = kl._run_fwd(name, part, False, peep=vecs, chunks=chunks,
                                                 state=True)
                pieces.append(h_part)
                state = (c_part, h_part[:, -1].contiguous())
                s += n
            chunked = torch.cat(pieces, dim=1)
            e_h, e_c = max_err(chunked, hids)[0], max_err(state[0], cell_T)[0]
            bit = torch.equal(chunked, hids) and torch.equal(state[0], cell_T)
            print(f"{name} state B={B} H={H}: T=32 one-shot vs chunks {STATE_SPLIT}: "
                  f"|hids| {e_h:.3e}, |cell_T| {e_c:.3e}, bit-equal {bit}")
            if not max(e_h, e_c) <= LSTM_TOL:
                raise AssertionError(f"{name}: chunked state calls disagree with one-shot")
            if B == 1:
                for T in (1, 32):
                    args = whole[T][0]
                    traced_ms = trace_chain(lambda: wrapper(*args, *vecs),
                                            f"{name} state B=1 H={H} T={T}", name, T)
                    ms = cuda_ms(lambda: wrapper(*args, *vecs))
                    plain_ms = cuda_ms(lambda: plain(*args, *vecs), iters=3, warmup=1)
                    b_ms, by = bound(*lstm_state_cost(1, T, H, peep))
                    print(f"{name} state B=1 H={H} T={T}: traced {traced_ms:.4f} ms, kernel "
                          f"{ms:.4f} ms (event clock), plain {plain_ms:.4f} ms, bound "
                          f"{b_ms:.6f} ms ({by})")
                    times[T] = dict(traced_ms=traced_ms, ms=ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=by)
        out[name] = {"err": err, "B1": times}
    return out


STREAM_UTTERANCES = 4
STREAM_CHUNK = 7


def stream_models():
    """The two streaming models at full width: adenet_v4 (raw 1144 through
    the sigmoid encoder with deltas, DCT 90 without; two non-peephole stream
    LSTMs and a forward aggregator at H = 500, last-step head) and
    adenet_v2_4 (raw and diff 1144 through ReLU encoders with deltas; two
    peephole stream LSTMs and a forward aggregator at H = 250, per-step
    head with the vote): name -> (config, row of its recurrences)."""
    from ip_avsr_torch.models import zoo

    return {"adenet_v4": (zoo.adenet_v4(1144, 90, output_classes=10), "lstm_fwd"),
            "adenet_v2_4": (zoo.adenet_v2_4(1144, 1144, output_classes=10), "lstm_peep_fwd")}


def phase_stream(dev):
    """Streaming sessions (``serve.StreamingSession``, B = 1) of the two
    streaming models at full width with seeded weights: 4 utterances of
    14-29 frames fed one frame per ``feed``, then one fed in chunks of 7.
    Every launch of those sessions is counted: 3 of the model's row per
    advance (two stream LSTMs and the aggregator, each through the state
    wrapper), none of any other row (the delta FIR runs on the host).  Every
    emitted frame held against the CPU session on the same parameters, and
    against the card's one-shot ``make_server(vote=False)``: every frame's
    probabilities for adenet_v2_4 (whose vote must also match where no frame
    is near a tie), the last frame's for adenet_v4, whose one-shot head is
    last-step.  Prints the median host time of a one-frame feed that emits
    a score (time to score) and of one that does not (the lookahead), the
    time of ``finalize``, and the card's busy share over one utterance.
    Returns {model: numbers}."""
    import numpy as np
    import torch

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.ops.voting import masked_majority_vote
    from ip_avsr_torch.serve import StreamingSession, make_server

    result = {}
    for idx, (name, (cfg, row)) in enumerate(stream_models().items()):
        params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 30 + idx), cfg,
                                           device=dev)
        rng = np.random.RandomState(SEED + 30 + idx)
        utts = [[rng.randn(1, T, s.input_dim).astype(np.float32) for s in cfg.streams]
                for T in rng.randint(14, T_FRAMES + 1, STREAM_UTTERANCES)]
        template = StreamingSession(params, cfg, device=dev)
        cpu_template = StreamingSession(tree_to(params, torch.device("cpu")), cfg,
                                        device="cpu")
        advances = [0]
        advance = template._advance

        def counted(*a, advance=advance):
            advances[0] += 1
            return advance(*a)

        template._advance = counted

        def run(sess, xs, step, clock=None):
            """Feed ``xs`` in chunks of ``step`` frames; returns (every
            emitted frame (1, T, C), finalize's result)."""
            got = []
            for s in range(0, xs[0].shape[1], step):
                t0 = time.perf_counter()
                out = sess.feed([x[:, s: s + step] for x in xs])
                if clock is not None:
                    clock["score" if out else "lookahead"].append(time.perf_counter() - t0)
                got += out
            t0 = time.perf_counter()
            tail, res = sess.finalize()
            if clock is not None:
                clock["finalize"].append(time.perf_counter() - t0)
            return np.concatenate([np.stack(got, axis=1), tail], axis=1) if got else tail, res

        run(template.fresh(), utts[0], 1)  # warm-up: cuBLAS handles, first launches
        torch.cuda.synchronize()
        clock = {"score": [], "lookahead": [], "finalize": []}
        advances[0] = 0
        reset_launches()
        runs = [run(template.fresh(), xs, 1, clock) for xs in utts]
        runs.append(run(template.fresh(), utts[-1], STREAM_CHUNK))
        torch.cuda.synchronize()
        launches, n_adv = read_launches(), advances[0]
        print(f"{name} streaming: {STREAM_UTTERANCES} utterances frame by frame and one in "
              f"chunks of {STREAM_CHUNK}, {n_adv} advances; launches {launches}")
        expect_launches(launches, **{row: 3 * n_adv})

        one_shot = make_server(params, cfg, vote=False, device=dev)
        err_cpu = err_one = 0.0
        for i, ((emitted, res), xs) in enumerate(zip(runs, utts + utts[-1:])):
            T = xs[0].shape[1]
            ref_cpu, _ = run(cpu_template.fresh(), xs, 1 if i < STREAM_UTTERANCES
                             else STREAM_CHUNK)
            with torch.inference_mode():
                probs = one_shot([torch.from_numpy(x).to(dev) for x in xs],
                                 torch.ones(1, T, device=dev)).cpu().numpy()
            if emitted.shape != (1, T, cfg.output_classes) or not np.isfinite(emitted).all():
                raise AssertionError(f"{name}: bad streamed scores {emitted.shape}")
            e_cpu = float(np.abs(emitted - ref_cpu).max())
            if cfg.output_mode == "per_step":
                e_one = float(np.abs(emitted - probs).max())
                top2 = np.sort(probs, axis=-1)[..., -2:]
                gap = float((top2[..., 1] - top2[..., 0]).min())
                vote = masked_majority_vote(probs, np.ones((1, T)))
                if gap > 2 * SCORE_TOL and not np.array_equal(res, vote):
                    raise AssertionError(f"{name}: streamed vote {res} != one-shot {vote}")
                extra = f", vote {res} (one-shot {vote}, smallest top-2 gap {gap:.2e})"
            else:
                e_one = float(np.abs(res - probs).max())
                extra = ""
            print(f"{name} utterance {i} (T={T}): |card - CPU session| {e_cpu:.2e} over every "
                  f"frame; |session - one-shot on the card| {e_one:.2e} over "
                  f"{'every frame' if cfg.output_mode == 'per_step' else 'the last frame'}"
                  f"{extra}")
            if not max(e_cpu, e_one) <= SCORE_TOL:
                raise AssertionError(f"{name}: streamed probabilities disagree")
            err_cpu, err_one = max(err_cpu, e_cpu), max(err_one, e_one)

        ms = {k: statistics.median(v) * 1e3 for k, v in clock.items()}
        xs = utts[0]
        t0 = time.perf_counter()
        run(template.fresh(), xs, 1)
        torch.cuda.synchronize()
        utt_ms = (time.perf_counter() - t0) * 1e3
        events, busy_ms = busy_share(traced(lambda: run(template.fresh(), xs, 1), 1), 1, utt_ms,
                                     f"{name} streaming one utterance (T={xs[0].shape[1]}, "
                                     f"frame by frame)")
        print(f"{name} streaming (host clock): time to score, median one-frame feed that "
              f"emits {ms['score']:.3f} ms ({len(clock['score'])} feeds); lookahead feed "
              f"{ms['lookahead']:.3f} ms; finalize {ms['finalize']:.3f} ms; one utterance "
              f"{utt_ms:.3f} ms, device busy {busy_ms:.3f} ms, share {busy_ms / utt_ms:.3f}")
        result[name] = dict(row=row, launches=launches[row], advances=n_adv,
                            score_ms=ms["score"], lookahead_ms=ms["lookahead"],
                            finalize_ms=ms["finalize"], utterance_ms=utt_ms, busy_ms=busy_ms,
                            busy_share=busy_ms / utt_ms, err_cpu=err_cpu, err_one_shot=err_one)
    return result


BUCKETS = ((1, 8, 32), (32, 64))
BUCKET_REQUESTS = [(B, T) for B in (1, 3, 8, 40) for T in (14, T_FRAMES)]
PIPE_REQUESTS = 64
PIPE_DEPTH = 8


def phase_serve_buckets(dev):
    """``serve.make_bucketed_server`` on the 4-stream model of
    configs/oulu_4stream.ini at full width, buckets (1, 8, 32) x (32, 64):
    requests with B in {1, 3, 8, 40} and T in {14, 29} (lengths from T/2,
    the first full; B = 40 runs as 32 + 8), every launch counted (1 delta
    and 6 peephole recurrences per forward, nothing else), probabilities
    (``vote=False``) held to the same server on the CPU within 2e-5 and the
    voted scores where no frame is near a tie.  Then ``serve.
    PipelinedServer`` over 64 requests of B = 1, T = 29 at depth 8 with
    batch 1 and 4: results in submission order, equal to the synchronous
    server, launches counted, and requests/s on the host clock against a
    synchronous loop and against the pipelined loop with uploads from
    pageable memory, in turns; then each loop's host time per request,
    split (:func:`host_split`).  Returns the numbers."""
    import numpy as np
    import torch

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.serve import PipelinedServer, make_bucketed_server, make_server

    cfg, _ = oulu_4stream()
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 40), cfg,
                                       device=dev)
    cpu_params = tree_to(params, torch.device("cpu"))
    kw = dict(batch_buckets=BUCKETS[0], time_buckets=BUCKETS[1])
    servers = {v: make_bucketed_server(params, cfg, vote=v, device=dev, **kw)
               for v in (True, False)}
    cpu_servers = {v: make_bucketed_server(cpu_params, cfg, vote=v, device="cpu", **kw)
                   for v in (True, False)}
    rng = np.random.RandomState(SEED + 40)
    requests = []
    for B, T in BUCKET_REQUESTS:
        lens = rng.randint(T // 2, T + 1, B)
        lens[0] = T
        requests.append(([rng.randn(B, T, s.input_dim).astype(np.float32)
                          for s in cfg.streams], lens))
    servers[True](*requests[0])  # warm-up
    torch.cuda.synchronize()
    forwards = sum(-(-B // BUCKETS[0][-1]) for B, _ in BUCKET_REQUESTS)
    reset_launches()
    got = {v: [servers[v](*r) for r in requests] for v in (True, False)}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"bucketed 4-stream server, buckets {BUCKETS}: {len(requests)} requests x vote on "
          f"and off, {2 * forwards} forwards; launches {launches}")
    expect_launches(launches, delta=2 * forwards, lstm_peep_fwd=12 * forwards)
    err = 0.0
    for (B, T), r, probs, votes in zip(BUCKET_REQUESTS, requests, got[False], got[True]):
        ref = cpu_servers[False](*r)
        probs, votes = probs.cpu(), votes.cpu()
        if probs.shape != (B, T, cfg.output_classes) or votes.shape != (B, cfg.output_classes):
            raise AssertionError(f"bucketed B={B} T={T}: shapes {tuple(probs.shape)}, "
                                 f"{tuple(votes.shape)}")
        mask = torch.from_numpy(np.arange(T)[None] < r[1][:, None])
        e = (probs - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1])[mask].min().item()
        e_vote = (votes - cpu_servers[True](*r)).abs().max().item()
        print(f"bucketed B={B} T={T}: probabilities |card - CPU| {e:.2e}; voted |card - CPU| "
              f"{e_vote:.2e} (smallest top-2 gap {gap:.2e})")
        if not (e <= SCORE_TOL and (gap <= 2 * SCORE_TOL or e_vote <= SCORE_TOL)):
            raise AssertionError(f"bucketed B={B} T={T} disagrees with the CPU server")
        err = max(err, e)

    sync = make_server(params, cfg, device=dev)
    reqs = []
    for _ in range(PIPE_REQUESTS):
        lens = rng.randint(T_FRAMES // 2, T_FRAMES + 1)
        reqs.append(([rng.randn(1, T_FRAMES, s.input_dim).astype(np.float32)
                      for s in cfg.streams],
                     (np.arange(T_FRAMES)[None] < lens).astype(np.float32)))
    want = [sync(*r).cpu().numpy() for r in reqs]
    pipe = {b: PipelinedServer(params, cfg, depth=PIPE_DEPTH, batch=b, device=dev)
            for b in (1, 4)}
    pipe_err = 0.0
    for b, srv in pipe.items():
        reset_launches()
        out = list(srv.map(iter(reqs)))
        torch.cuda.synchronize()
        n_fwd = PIPE_REQUESTS // b
        expect_launches(read_launches(), delta=n_fwd, lstm_peep_fwd=6 * n_fwd)
        if [o.shape for o in out] != [w.shape for w in want]:
            raise AssertionError(f"pipelined batch={b}: shapes or order differ")
        e = max(float(np.abs(o - w).max()) for o, w in zip(out, want))
        print(f"pipelined batch={b} depth={PIPE_DEPTH}: {PIPE_REQUESTS} results in order, "
              f"|pipelined - synchronous| {e:.2e} ({n_fwd} forwards counted)")
        if not e <= SCORE_TOL:
            raise AssertionError(f"pipelined batch={b} disagrees with the synchronous server")
        pipe_err = max(pipe_err, e)

    # the pipelined loop with uploads from pageable memory, for comparison
    pageable = PipelinedServer(params, cfg, depth=PIPE_DEPTH, device=dev)
    pageable._upload = lambda args: (tree_map(lambda a: torch.as_tensor(a, device=dev), args),
                                     [])
    runs = {"sync": lambda: [sync(*r).cpu().numpy() for r in reqs],
            1: lambda: list(pipe[1].map(iter(reqs))),
            4: lambda: list(pipe[4].map(iter(reqs))),
            "pageable": lambda: list(pageable.map(iter(reqs)))}
    runs["pageable"]()
    rates = {k: [] for k in runs}
    for turn in (*runs, *reversed(runs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[turn]()
        torch.cuda.synchronize()
        rates[turn].append(PIPE_REQUESTS / (time.perf_counter() - t0))
    names = {"sync": "synchronous loop", 1: "pipelined batch=1", 4: "pipelined batch=4",
             "pageable": "pipelined batch=1 with pageable uploads"}
    print(f"requests/s over 64 requests of B=1 T=29 (host clock, two turns each, in turns "
          f"{list(runs)} then back): " + "; ".join(
              f"{names[k]} " + " / ".join(f"{r:.1f}" for r in v) for k, v in rates.items()))
    split = host_split(pipe[1], sync, reqs)
    print(f"host ms per request: {split}")
    n_traced = 1
    events, busy_ms = busy_share(traced(lambda: list(pipe[1].map(iter(reqs))), n_traced),
                                 n_traced, PIPE_REQUESTS / max(rates[1]) * 1e3,
                                 f"pipelined batch=1 over {PIPE_REQUESTS} requests")
    return dict(err=err, pipe_err=pipe_err, rates={str(k): v for k, v in rates.items()},
                pipe_busy_ms=busy_ms, host_split=split)


def host_split(pipe, sync, reqs):
    """Host time per request, on the host clock: the pipelined loop split
    into staging the upload, issuing the forward, packing a block and
    waiting for its copy home; the synchronous loop into issuing the
    forward and copying its result home (which waits for the card)."""
    import torch

    acc = {"pipelined": dict(upload=0.0, forward=0.0, pack=0.0, wait=0.0),
           "sync": dict(forward=0.0, copy_home=0.0)}

    def timed(key, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            acc["pipelined"][key] += time.perf_counter() - t0
            return out
        return call

    saved = {k: getattr(pipe, k) for k in ("_upload", "_serve", "_pack", "_unpack")}
    pipe._upload, pipe._serve, pipe._pack = (timed("upload", saved["_upload"]),
                                             timed("forward", saved["_serve"]),
                                             timed("pack", saved["_pack"]))

    def unpack(packed):
        t0 = time.perf_counter()
        if packed[1] is not None:  # the block's event (none off the card)
            packed[1].synchronize()
        acc["pipelined"]["wait"] += time.perf_counter() - t0
        return saved["_unpack"](packed)

    pipe._unpack = unpack
    t0 = time.perf_counter()
    list(pipe.map(iter(reqs)))
    acc["pipelined"]["wall"] = time.perf_counter() - t0
    for k, v in saved.items():
        setattr(pipe, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        t1 = time.perf_counter()
        out = sync(*r)
        acc["sync"]["forward"] += time.perf_counter() - t1
        t1 = time.perf_counter()
        out.cpu()
        acc["sync"]["copy_home"] += time.perf_counter() - t1
    acc["sync"]["wall"] = time.perf_counter() - t0
    return {loop: {k: round(v * 1e3 / len(reqs), 4) for k, v in parts.items()}
            for loop, parts in acc.items()}


def oulu_4stream():
    """(model config, training config) of configs/oulu_4stream.ini through
    the port's train.config, at the file's full widths."""
    from ip_avsr_torch.train import config as config_lib

    cp = config_lib.load_config(os.path.join(ROOT, OULU_INI))
    cfg = config_lib.build_model_config(config_lib.parse_streams(cp),
                                        config_lib.parse_classifier(cp))
    return cfg, config_lib.parse_training(cp)


def stream_batch(cfg, B, seed, device, T=T_FRAMES):
    """Seeded normal features (B, T, D_i) per stream, lengths T/2-T (the
    first full), and labels."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    streams = [torch.from_numpy(rng.randn(B, T, s.input_dim).astype(np.float32)).to(device)
               for s in cfg.streams]
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    mask = torch.from_numpy((np.arange(T)[None] < lens[:, None]).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.randint(0, cfg.output_classes, B)).long().to(device)
    return streams, mask, y


def launch_counts(events, n, label, before):
    """Print the device kernels and the host's kernel-launch calls per
    request or step of a trace's ``key_averages()`` over ``n`` of them, with
    ``before``, the earlier count, beside them.  Returns (device kernels,
    host launch calls) per request or step."""
    from torch.autograd import DeviceType

    kernels = sum(e.count for e in events if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(("Memcpy", "Memset")))
    copies = sum(e.count for e in events if e.device_type == DeviceType.CUDA) - kernels
    calls = {e.key: e.count for e in events
             if e.device_type == DeviceType.CPU and e.key.startswith("cu") and "Launch" in e.key}
    print(f"{label}: {kernels / n:.1f} device kernels and {copies / n:.1f} copies or fills "
          f"each (trace); host launch calls each {sum(calls.values()) / n:.1f} "
          f"{ {k: v / n for k, v in calls.items()} } (device kernels, {before})")
    return kernels / n, sum(calls.values()) / n


def busy_share(events, n, median_ms, label, rows=14):
    """Print a trace's table (its ``key_averages()``) and its device time per
    request or step over ``n`` of them, and its share of ``median_ms`` (none
    without one).  Returns ``events`` and that device time."""
    from torch.autograd import DeviceType

    print(events.table(sort_by="self_cuda_time_total", row_limit=rows))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3 / n
    share = f"; busy share of the median {busy_ms / median_ms:.3f}" if median_ms else ""
    print(f"{label}: device busy {busy_ms:.3f} ms each (profiler, {n} traced){share}")
    return events, busy_ms


def phase_serve_4stream(dev):
    """The peephole 4-stream adasum AdeNet of configs/oulu_4stream.ini at full
    width, served on preprocessed streams through serve.make_server."""
    import torch

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.serve import make_server

    cfg, _ = oulu_4stream()
    print(f"oulu_4stream full width: features {[s.feature_dim() for s in cfg.streams]}, "
          f"H={cfg.lstm_size}, fusion {cfg.fusiontype}, peepholes {cfg.use_peepholes}")
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 6), cfg, device=dev)
    server = make_server(params, cfg, device=dev)
    probs_server = make_server(params, cfg, vote=False, device=dev)
    requests = [stream_batch(cfg, B, SEED + 6 + i, dev)[:2]
                for i, B in enumerate((1, TRAIN_B, TRAIN_B))]
    server(*requests[0])  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    scores = [server(streams, mask) for streams, mask in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(requests)
    print(f"4-stream served {n} requests: launches {launches}")
    expect_launches(launches, delta=n, lstm_peep_fwd=6 * n)

    cpu = torch.device("cpu")
    cpu_params = tree_to(params, cpu)
    cpu_server = make_server(cpu_params, cfg, device="cpu")
    cpu_probs_server = make_server(cpu_params, cfg, vote=False, device="cpu")
    for (streams, mask), s in zip(requests, scores):
        B = mask.shape[0]
        s = s.cpu()
        probs = probs_server(streams, mask).cpu()
        c_streams, c_mask = tree_to(streams, cpu), mask.cpu()
        ref = cpu_probs_server(c_streams, c_mask)
        if (s.shape != (B, cfg.output_classes) or probs.shape != (B, T_FRAMES, cfg.output_classes)
                or not (torch.isfinite(s).all() and torch.isfinite(probs).all())):
            raise AssertionError(f"bad scores: {tuple(s.shape)}, {tuple(probs.shape)}")
        row_err = max((s.sum(-1) - 1).abs().max().item(), (probs.sum(-1) - 1).abs().max().item())
        ref_err = (probs - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1])[c_mask > 0].min().item()
        vote_err = (s - cpu_server(c_streams, c_mask)).abs().max().item()
        print(f"4-stream B={B}: |row sum - 1| {row_err:.2e}, probabilities |card - CPU path| "
              f"{ref_err:.2e}; voted scores |card - CPU path| {vote_err:.2e} (smallest "
              f"top-2 gap of a frame {gap:.2e})")
        if not (row_err <= 1e-5 and ref_err <= SCORE_TOL):
            raise AssertionError("4-stream probabilities disagree with the CPU path")
        # the vote compares argmaxes: held to the CPU path where no frame is
        # within the probability tolerance of a tie
        if gap > 2 * SCORE_TOL and not vote_err <= SCORE_TOL:
            raise AssertionError("4-stream voted scores disagree with the CPU path")

    latency = {}
    for B, (streams, mask) in ((1, requests[0]), (TRAIN_B, requests[1])):
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server(streams, mask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        latency[B] = statistics.median(times[5:])
        print(f"4-stream serve B={B}: median request {latency[B]:.3f} ms "
              f"(host clock, 25 requests, feature upload included)")
    print("right after: clocks.sm, clocks.max.sm, power.draw, utilization.gpu =",
          smi("clocks.sm,clocks.max.sm,power.draw,utilization.gpu"))
    n_traced = 5
    events, _ = busy_share(traced(lambda: server(*requests[1]), n_traced), n_traced,
                           latency[TRAIN_B], f"4-stream serve B={TRAIN_B}")
    expect_traced(events, n_traced, f"4-stream serve B={TRAIN_B}", delta=1,
                  lstm_peep_fwd=6)
    launch_counts(events, n_traced, f"4-stream serve B={TRAIN_B}",
                  "84 with one delta launch per stream")
    return launches, latency


def phase_train_4stream(dev):
    """Three train steps of the same model at the ini's batch size and
    learning rate through train.trainer.make_train_step, then the card
    against the CPU path (the ini has no dropout, so this is the real
    step)."""
    import torch

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.train import trainer

    cfg, training = oulu_4stream()
    B = training.batchsize
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 7), cfg, device=dev)
    streams, mask, y = stream_batch(cfg, B, SEED + 7, dev)
    opt, step = trainer.make_train_step(cfg, lr=training.learning_rate)
    state = opt.init(params)
    step(params, state, streams, y, mask)  # warm-up
    torch.cuda.synchronize()

    reset_launches()
    p, st = params, state
    losses = []
    n_steps = 3
    for _ in range(n_steps):
        p, st, loss = step(p, st, streams, y, mask)
        losses.append(loss)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"4-stream train {n_steps} steps at B={B}, lr={training.learning_rate}: losses "
          f"{[round(float(v), 6) for v in losses]}, launches {launches}")
    expect_launches(launches, lstm_peep_fwd_train=6 * n_steps, lstm_peep_bwd=6 * n_steps,
                    delta=n_steps)
    finite = []
    tree_map(lambda t: finite.append(bool(torch.isfinite(t).all())), (p, st["m"], st["v"]))
    if not (all(finite) and all(torch.isfinite(v) for v in losses)):
        raise AssertionError("non-finite loss, gradient or parameter in 4-stream training")

    cpu = torch.device("cpu")
    loss_d, grads_d = trainer.loss_and_grads(params, cfg, streams, y, mask)
    c_params, c_streams, c_y, c_mask = (tree_to(params, cpu), tree_to(streams, cpu), y.cpu(),
                                        mask.cpu())
    loss_c, grads_c = trainer.loss_and_grads(c_params, cfg, c_streams, c_y, c_mask)
    p_d, _, _ = step(params, opt.init(params), streams, y, mask)
    p_c, _, _ = step(c_params, opt.init(c_params), c_streams, c_y, c_mask)
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    grad_ok, grad_rel, param_abs = [], [], []

    def grad_check(a, b):
        e = max_err(a.cpu(), b)[0]
        top = b.abs().max().item()
        grad_ok.append(e <= max(TRAIN_GRAD_TOL * top, TRAIN_GRAD_FLOOR))
        grad_rel.append(e / max(top, 1e-30))

    tree_map(grad_check, grads_d, grads_c)
    tree_map(lambda a, b: param_abs.append(max_err(a.cpu(), b)[0]), p_d, p_c)
    peep_grads = [grads_d["streams"]["s1"]["lstm"][k].abs().max().item()
                  for k in ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")]
    print(f"4-stream train, card vs CPU path: loss {float(loss_d):.7f} vs {float(loss_c):.7f} "
          f"(relative {loss_rel:.2e}); gradients ({len(grad_rel)} tensors) relative to max abs "
          f"worst {max(grad_rel):.2e}, within tolerance or the {TRAIN_GRAD_FLOOR:g} floor: "
          f"{sum(grad_ok)}/{len(grad_ok)}; updated parameters max abs {max(param_abs):.2e}; "
          f"stream 1 peephole gradients max abs {peep_grads}")
    if not (loss_rel <= TRAIN_LOSS_TOL and all(grad_ok) and max(param_abs) <= TRAIN_PARAM_TOL
            and min(peep_grads) > 0):
        raise AssertionError("the 4-stream train step on the card disagrees with the CPU path")

    times = []
    p, st = params, opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, st, loss = step(p, st, streams, y, mask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    median = statistics.median(times[5:])
    print(f"4-stream train B={B}: median step {median:.3f} ms (host clock, 20 steps after 5); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print("right after: clocks.sm, clocks.max.sm, power.draw, utilization.gpu =",
          smi("clocks.sm,clocks.max.sm,power.draw,utilization.gpu"))
    n_traced = 3
    carry = [p, st]

    def train_step():
        carry[:] = step(*carry, streams, y, mask)[:2]

    events, _ = busy_share(traced(train_step, n_traced), n_traced, median,
                           f"4-stream train B={B}", rows=16)
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    expect_traced(events, n_traced, f"4-stream train B={B}", delta=1,
                  lstm_peep_fwd_train=6, lstm_peep_bwd=6)
    launch_counts(events, n_traced, f"4-stream train B={B}",
                  "1088 with one delta launch per stream and a 17-op FIR backward per "
                  "stream")
    return launches, median


def trace_device(fn, n):
    """Device time and device operations (kernels, copies and fills) per
    call of ``fn`` over ``n`` traced calls, whatever they are."""
    from torch.autograd import DeviceType

    device = [e for e in traced(fn, n) if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in device) / 1e3 / n,
            sum(e.count for e in device) / n)


def yardstick_matrix(T, W, dev):
    """The (3T, T) matrix S whose row 3t + k is row t of I, F and F F (F the
    edge-clamped FIR matrix, F F in float64): viewed as (B, 3T, D), one
    ``torch.matmul(S, x)`` is the (B, T, 3D) output [x, d, a].  Built here
    from ``ops/delta.fir_matrix``, which every version of the port has."""
    import torch

    from ip_avsr_torch.ops.delta import fir_matrix

    F = fir_matrix(T, W, dtype=torch.float64)
    S = torch.stack([torch.eye(T, dtype=torch.float64), F, F @ F], dim=1)
    return S.reshape(3 * T, T).float().to(dev)


def host_us(fn, n=200):
    """Host time of one call of ``fn``, the enqueue, with no synchronize
    inside the timed loop: the median of ``n`` calls on the host's clock, in
    microseconds."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(walls) * 1e6


def host_median_ms(fn, calls=25, warmup=5):
    """Median host-clock time of one call of ``fn``, synchronized before and
    after each, over ``calls`` calls after ``warmup``."""
    import torch

    times = []
    for _ in range(warmup + calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[warmup:])


def delta_ab(dev):
    """Row 2 per forward of both models at T = 29, W = 9, through the model's
    own delta stage (``adenet.stream_prefix`` over streams with no encoder,
    so every version of the port runs its DeltaLayer as its models do): the
    event time, traced device time, device operations and host time of one
    forward's delta; the yardstick ``torch.matmul(S, x)`` (one call per
    stream, S built once outside the timed region) on events and traced; and
    the traced device time and operations of the DeltaLayer's backward over
    the same streams.  Returns the numbers."""
    import torch
    from torch.autograd import DeviceType

    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.ops.delta import append_delta_coeff

    gen = torch.Generator().manual_seed(SEED + 17)
    W = 9
    S = yardstick_matrix(T_FRAMES, W, dev)
    out = {}
    for model, (widths, batches) in DELTA_GROUPS.items():
        cfg = adenet.AdeNetConfig(
            streams=[adenet.StreamSpec(D, name=f"s{i}") for i, D in enumerate(widths)],
            output_classes=2, window=W)
        params = {"streams": {s.name: {} for s in cfg.streams}}
        for B in batches:
            xs = [(torch.randn(B, T_FRAMES, D, generator=gen) * 3).to(dev) for D in widths]
            fwd = lambda: adenet.stream_prefix(params, cfg, xs)  # noqa: E731
            lib = lambda: [torch.matmul(S, x) for x in xs]  # noqa: E731
            err = max((o - append_delta_coeff(x, W)).abs().max().item()
                      for x, o in zip(xs, fwd()))
            lib_err = max((torch.matmul(S, x).view(B, T_FRAMES, -1)
                           - append_delta_coeff(x, W)).abs().max().item() for x in xs)
            if not (err <= DELTA_TOL and lib_err <= DELTA_TOL):
                raise AssertionError(f"delta {model} B={B}: |kernel - plain| {err:.2e}, "
                                     f"|S x - plain| {lib_err:.2e}")
            ms, lib_ms = cuda_ms(fwd), cuda_ms(lib)
            traced_ms, ops = trace_device(fwd, 5)
            lib_traced, lib_ops = trace_device(lib, 5)
            host = host_us(fwd)
            xg = [x.clone().requires_grad_(True) for x in xs]
            outs = adenet.stream_prefix(params, cfg, xg)
            gs = [torch.randn_like(o) for o in outs]
            events = traced(lambda: torch.autograd.grad(outs, xg, gs, retain_graph=True), 5)
            device = [e for e in events if e.device_type == DeviceType.CUDA]
            bwd_ms = sum(e.self_device_time_total for e in device) / 1e3 / 5
            bwd_ops = sum(e.count for e in device) / 5
            label = f"delta {model} B={B} D={list(widths)}"
            print(f"{label}: per forward {ms:.4f} ms (events), traced {traced_ms:.4f} ms, "
                  f"{ops:.1f} device ops, host {host:.1f} us, |kernel - plain| {err:.2e}; "
                  f"yardstick matmul(S, x) per stream {lib_ms:.4f} ms (events), traced "
                  f"{lib_traced:.4f} ms, {lib_ops:.1f} ops, |S x - plain| {lib_err:.2e}; "
                  f"DeltaLayer backward traced {bwd_ms:.4f} ms, {bwd_ops:.1f} device ops")
            print("  backward kernels: " + "; ".join(
                f"{e.key[:60]} x{e.count / 5:g}" for e in device))
            out[label] = dict(ms=ms, traced_ms=traced_ms, device_ops=ops, host_us=host,
                              library_ms=lib_ms, library_traced_ms=lib_traced,
                              bwd_traced_ms=bwd_ms, bwd_device_ops=bwd_ops)
    return out


def ab_run(dev):
    """``--ab``: row 2 per forward of both models (:func:`delta_ab`), then
    the 4-stream serve (B = 10) and train (B = 10) paths and the flagship's
    (serve B = 1 and 8, train B = 10) of whichever package is first on the
    path, through the entry points every version of the port has: each
    path's median on the host clock, then its trace (device time, kernels,
    host launch calls, row 2's launches and device time).  Returns the
    numbers."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import ip_avsr_torch
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.serve import make_server, make_trimodal_server
    from ip_avsr_torch.train import trainer

    out = {"package": os.path.dirname(os.path.abspath(ip_avsr_torch.__file__))}
    out.update(delta_ab(dev))
    cfg, training = oulu_4stream()
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 6), cfg, device=dev)
    server = make_server(params, cfg, device=dev)
    streams, mask, y = stream_batch(cfg, TRAIN_B, SEED + 7, dev)
    opt, step = trainer.make_train_step(cfg, lr=training.learning_rate)
    state = [params, opt.init(params)]
    # the flagship at full width: served from raw uint8 (B = 8), trained
    # with its dropout (B = 10)
    cfg3 = zoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    params3 = adenet.init_adenet_params(torch.Generator().manual_seed(SEED), cfg3, device=dev)
    server3 = make_trimodal_server(params3, cfg3, IMAGE_SHAPE, DCT, device=dev)
    rng = np.random.RandomState(SEED)
    raw = rng.randint(0, 256, (8, T_FRAMES, 1144)).astype(np.uint8)
    raw_mask = (np.arange(T_FRAMES)[None] < rng.randint(1, T_FRAMES + 1, 8)[:, None]).astype(
        np.float32)
    streams3 = [torch.from_numpy(rng.randn(TRAIN_B, T_FRAMES, s.input_dim).astype(np.float32))
                .to(dev) for s in cfg3.streams]
    y3 = torch.from_numpy(rng.randint(0, 10, TRAIN_B)).long().to(dev)
    opt3, step3 = trainer.make_train_step(cfg3)
    gen3 = torch.Generator(device=dev).manual_seed(SEED)
    state3 = [params3, opt3.init(params3)]

    def train_step():
        state[:2] = step(*state, streams, y, mask)[:2]

    def train_step3():
        state3[:2] = step3(*state3, streams3, y3, mask, gen3)[:2]

    raw1, raw_mask1 = raw[:1], raw_mask[:1]
    for label, fn, n in ((f"4-stream serve B={TRAIN_B}", lambda: server(streams, mask), 5),
                         (f"4-stream train B={TRAIN_B}", train_step, 3),
                         ("flagship serve B=1", lambda: server3(raw1, raw_mask1), 5),
                         ("flagship serve B=8", lambda: server3(raw, raw_mask), 5),
                         (f"flagship train B={TRAIN_B}", train_step3, 3)):
        median = host_median_ms(fn)
        events, busy = busy_share(traced(fn, n), n, median, label, rows=8)
        kernels, calls = launch_counts(events, n, label, "this tree")
        row2 = [e for e in events if e.device_type == DeviceType.CUDA and "delta" in e.key]
        deltas = sum(e.count for e in row2) / n
        delta_ms = sum(e.self_device_time_total for e in row2) / 1e3 / n
        print(f"{label}: median {median:.3f} ms (host clock, 25 after 5); {deltas:g} row-2 "
              f"launches each, {delta_ms:.4f} ms of row-2 device time each")
        out[label] = dict(host_median_ms=median, device_ms=busy, device_kernels=kernels,
                          host_launch_calls=calls, delta_launches=deltas, delta_ms=delta_ms)
    return out


EXPORT_SIZES = [(B, T) for B in (1, 8) for T in (T_FRAMES, 14)]
# bf16-stored weights against the f32 live server (each weight rounded to
# bf16 once) on per-step probabilities of about 0.1: 4.3x the largest
# difference read at full width (4.64e-4, NVIDIA H100 80GB HBM3, 700 W); and
# the top-2 gap of a frame on which the argmax must agree, fixed at twice
# the limit (a frame within it may flip without any probability being off
# by more than the limit)
EXPORT_BF16_TOL = 2e-3
EXPORT_CLEAR_GAP = 2 * EXPORT_BF16_TOL


def export_requests(kind, cfg, sizes, seed):
    """Seeded requests as a user hands them to a server: uint8 pixels
    (``kind`` "raw") or float32 features per stream (numpy), ragged float32
    masks (lengths 1..T, the first full) at each (B, T) of ``sizes``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    out = []
    for B, T in sizes:
        lens = rng.randint(1, T + 1, B)
        lens[0] = T
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        if kind == "raw":
            x = rng.randint(0, 256, (B, T, IMAGE_SHAPE[0] * IMAGE_SHAPE[1])).astype(np.uint8)
        else:
            x = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
        out.append((x, mask))
    return out


def check_artifact(label, art, live, requests, row, per_forward, totals, tol=SCORE_TOL):
    """Hold ``art`` (a loaded ``ExportedServer``) against ``live`` on each
    request (within ``tol``; with ``tol`` above SCORE_TOL, the bf16 case on
    per-step probabilities, also the same argmax on every valid frame whose
    top-2 gap exceeds :data:`EXPORT_CLEAR_GAP`), counting the artifact's
    launches: each forward must
    add exactly ``per_forward`` of ``row`` and one grouped delta launch, and
    nothing else; they are added to ``totals``.  Returns the largest
    difference."""
    import torch

    live(*requests[0])  # warm-up
    torch.cuda.synchronize()
    err = 0.0
    for req in requests:
        want = live(*req)
        reset_launches()
        got = art(*req)
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, delta=1, **{row: per_forward})
        for k, v in launches.items():
            totals[k] += v
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: bad scores {tuple(got.shape)}")
        e = (got - want).abs().max().item()
        B, T = req[1].shape
        flips = ""
        if tol > SCORE_TOL:
            top2 = want.topk(2, dim=-1).values
            clear = ((top2[..., 0] - top2[..., 1]) > EXPORT_CLEAR_GAP) & (
                torch.as_tensor(req[1]) > 0).to(want.device)
            flipped = int((got.argmax(-1) != want.argmax(-1))[clear].sum())
            flips = f"; argmax differs on {flipped} of {int(clear.sum())} clear frames"
        else:
            flipped = 0
        print(f"{label} B={B} T={T}: |artifact - live server| {e:.2e}{flips}; launches "
              f"{launches}")
        if not e <= tol or flipped:
            raise AssertionError(f"{label}: the artifact disagrees with the live server")
        err = max(err, e)
    return err


def host_turns(label, fns, req):
    """Host medians (``host_median_ms``: 25 calls after 5) of each of
    ``fns`` (name -> server) on ``req``, in turns a, b, b, a."""
    names = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    for k in names:
        times[k].append(host_median_ms(lambda: fns[k](*req)))
    B, T = req[1].shape
    print(f"{label} B={B} T={T}: host median per request (ms, in turns) "
          + ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}" for k, v in times.items()))
    return times


def trace_artifact(label, art, req, row, per_forward, median_ms):
    """Trace five forwards of ``art``: ``per_forward`` launches of ``row``'s
    instantiation and one of ``delta_group_kernel`` each, nothing of the
    other rows, and no host-to-device copy beyond the request's own upload
    (one per input array): a tensor the program left on the CPU would be
    copied in each call.  Returns (busy ms, busy share of ``median_ms``, or
    None without one)."""
    from torch.autograd import DeviceType

    n = 5
    events, busy_ms = busy_share(traced(lambda: art(*req), n), n, median_ms, label, rows=10)
    expect_traced(events, n, label, delta=1, **{row: per_forward})
    htod = sum(e.count for e in events if e.device_type == DeviceType.CUDA
               and e.key.startswith("Memcpy HtoD")) / n
    inputs = 1 + (1 if art.input_kind == "raw" else len(art.stream_dims))
    print(f"{label}: {htod:.1f} host-to-device copies per request ({inputs} input arrays)")
    if htod != inputs:
        raise AssertionError(f"{label}: {htod} host-to-device copies per request, expected "
                             f"{inputs} (the inputs' upload)")
    return busy_ms, busy_ms / median_ms if median_ms else None


def op_host_us(dev):
    """Host time of one row-1 call (B = 1, T = 29, H = 500) through its
    operator ``ip_avsr::lstm_recurrence`` against the same launch made
    straight through ``_run_fwd``, in turns (a, b, b, a), under
    ``torch.inference_mode()`` as both served paths run: the dispatcher's
    cost per kernel call, which the live and exported paths both pay."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 43)
    H = 500
    args = [t.to(dev) for t in (torch.randn(1, T_FRAMES, 4 * H, generator=gen),
                                torch.randn(H, 4 * H, generator=gen) * 0.05,
                                torch.ones(1, T_FRAMES), torch.zeros(1, H),
                                torch.zeros(1, H))]
    fns = {"operator": lambda: kl.lstm_recurrence(*args),
           "direct": lambda: kl._run_fwd("lstm_recurrence", args, train=False)}
    times = {k: [] for k in fns}
    with torch.inference_mode():
        for k in ("operator", "direct", "direct", "operator"):
            times[k].append(host_us(fns[k]))
    print("row 1 host time per call under inference_mode (us, median of 200 enqueues, in "
          "turns): "
          + ", ".join(f"{k} {' / '.join(f'{t:.1f}' for t in v)}" for k, v in times.items()))
    return times


@contextlib.contextmanager
def direct_launches():
    """Within it the live serve path makes its kernel calls straight through
    the launches (``_run_fwd``, the delta's ``_check`` and ``_launch``),
    counted as the operators count them, not through the ``ip_avsr::``
    operators: a request as it would cost without the dispatcher."""
    from ip_avsr_torch.ops import lstm as ops_lstm
    from ip_avsr_torch.ops.kernels import delta as kd
    from ip_avsr_torch.ops.kernels import lstm as kl

    def recurrence(name, counter):
        def call(x_proj, w_hid, mask, cell0, hid0, *peep):
            out = kl._run_fwd(name, (x_proj, w_hid, mask, cell0, hid0), train=False, peep=peep)
            counter.launches += 1
            return out
        return call

    def delta_group(xs, window, outs=None):
        xs = list(xs)
        kd._check(xs, window)
        return kd._launch(xs, window, outs)

    saved = ops_lstm.lstm_recurrence, ops_lstm.lstm_peep_recurrence, kd.append_delta_group
    ops_lstm.lstm_recurrence = recurrence("lstm_recurrence", kl.lstm_recurrence)
    ops_lstm.lstm_peep_recurrence = recurrence("lstm_peep_recurrence", kl.lstm_peep_recurrence)
    kd.append_delta_group = delta_group
    try:
        yield
    finally:
        ops_lstm.lstm_recurrence, ops_lstm.lstm_peep_recurrence, kd.append_delta_group = saved


def ops_turns(label, live, req, row, per_forward, turns=8, calls=50):
    """The live server's host median per request (``host_median_ms``,
    ``calls`` after 5) with its kernel calls through the operators against
    the same calls made straight (:func:`direct_launches`), in ``turns``
    alternating turns (a, b, b, a, ...) in this process; both must give the
    same scores and the same launches.  Returns {"operators": [ms],
    "direct": [ms]}."""
    import torch

    outs, times = {}, {"operators": [], "direct": []}
    order = [("operators", "direct", "direct", "operators")[i % 4] for i in range(turns)]
    for k in ("operators", "direct") + tuple(order):
        with direct_launches() if k == "direct" else contextlib.nullcontext():
            if k not in outs:  # the first of each: its scores and launches
                reset_launches()
                outs[k] = live(*req)
                torch.cuda.synchronize()
                expect_launches(read_launches(), delta=1, **{row: per_forward})
                continue
            times[k].append(host_median_ms(lambda: live(*req), calls=calls))
    if not torch.equal(outs["operators"], outs["direct"]):
        raise AssertionError(f"{label}: the direct launches changed the scores")
    B, T = req[1].shape
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"{label} B={B} T={T}: live server host median per request (ms, {turns} turns of "
          f"{calls} calls): " + ", ".join(f"{k} {' / '.join(f'{t:.3f}' for t in v)}"
                                          for k, v in times.items())
          + f"; medians {med['operators']:.4f} / {med['direct']:.4f}, the operators' cost "
          f"{(med['operators'] - med['direct']) * 1e3:.1f} us per request")
    return times


def check_strided(label, art, live, req, row, per_forward):
    """Feed ``art`` the request as dense arrays with swapped axes (a
    time-major array viewed as (B, T, .)), numpy and on the card, and hold
    its scores against ``live``'s on the contiguous request: the artifact
    must upload contiguous rows for the operators.  Returns the largest
    difference."""
    import numpy as np
    import torch

    def swapped(a):
        return np.ascontiguousarray(np.swapaxes(a, 0, 1)).swapaxes(0, 1)

    x, mask = req
    want = live(x, mask)
    err = 0.0
    for kind, conv in (("numpy", swapped),
                       ("cuda", lambda a: torch.from_numpy(np.ascontiguousarray(
                           np.swapaxes(a, 0, 1))).to(want.device).transpose(0, 1))):
        xs = conv(x) if isinstance(x, np.ndarray) else [conv(a) for a in x]
        m = conv(mask)
        leaves = [xs, m] if isinstance(x, np.ndarray) else [*xs, m]
        if any((v.flags.c_contiguous if isinstance(v, np.ndarray) else v.is_contiguous())
               for v in leaves if v.shape[0] > 1):
            raise AssertionError(f"{label}: the strided request is contiguous")
        reset_launches()
        got = art(xs, m)
        torch.cuda.synchronize()
        expect_launches(read_launches(), delta=1, **{row: per_forward})
        e = (got - want).abs().max().item()
        print(f"{label} strided {kind} request B={mask.shape[0]} T={mask.shape[1]}: "
              f"|artifact - live server on the contiguous request| {e:.2e}")
        if not e <= SCORE_TOL:
            raise AssertionError(f"{label}: a strided request changed the artifact's scores")
        err = max(err, e)
    return err


def phase_export(dev):
    """Export (``ip_avsr_torch.export``): five artifacts written to a
    temporary directory and loaded onto the card, each held against the
    live server it was traced from, with every launch counted.  The
    full-width flagship raw-pixel server (symbolic B and T) traced on the
    card and again on the CPU (then moved to the card by the loader); the
    full-width 4-stream peephole server of configs/oulu_4stream.ini
    (symbolic), with f32 and bf16 weights; a pinned B = 8, T = 29 flagship
    artifact (which must refuse another shape); an adenet_v4 streaming
    artifact against the live ``StreamingSession`` and the one-shot server.
    The symbolic f32 artifacts also take requests with swapped axes
    (:func:`check_strided`).  Prints each export's seconds and bytes, the
    host medians of artifact and live server in turns, each traced
    artifact's busy share, and the host cost of the operators per kernel
    call (:func:`op_host_us`) and per live request (:func:`ops_turns`).
    Returns
    {numbers}, with the launches of each row through the artifacts."""
    import tempfile

    import numpy as np
    import torch

    from ip_avsr_torch import export as export_lib
    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.serve import StreamingSession, make_server, make_trimodal_server

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    result = {"exports": {}, "err": {}, "host_ms": {}, "busy": {}, "op_host_us": op_host_us(dev),
              "strided_err": {}, "ops_ms": {}}
    totals = {row: 0 for row in KERNEL_COUNTERS}

    def export(name, save, *args, **kw):
        path = os.path.join(tmp, f"{name}.ipax")
        t0 = time.perf_counter()
        save(path, *args, **kw)
        secs = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"export {name}: {secs:.2f} s, {size} bytes")
        result["exports"][name] = {"s": secs, "bytes": size}
        return path

    try:
        tri = dict(image_shape=IMAGE_SHAPE, dct_coeffs=DCT)
        cfg = flagship()
        params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 40), cfg,
                                           device=dev)
        live = make_trimodal_server(params, cfg, device=dev, **tri)
        requests = export_requests("raw", cfg, EXPORT_SIZES, SEED + 40)
        cpu = torch.device("cpu")
        req8 = next(r for r in requests if r[1].shape == (8, T_FRAMES))
        for name, trace_dev in (("flagship", dev), ("flagship_cpu_traced", cpu)):
            # traced on the CPU from parameters there, moved by the loader
            path = export(name, export_lib.save_artifact, tree_to(params, trace_dev), cfg,
                          trimodal=tri, device=trace_dev)
            art = export_lib.load_server(path, device=dev)
            result["err"][name] = check_artifact(name, art, live, requests, "lstm_fwd", 5,
                                                 totals)
            median = None
            if name == "flagship":
                result["strided_err"][name] = check_strided(name, art, live, req8, "lstm_fwd",
                                                            5)
                for B in (1, 8):
                    req = next(r for r in requests if r[1].shape == (B, T_FRAMES))
                    result["host_ms"][f"{name} B={B}"] = host_turns(
                        name, {"artifact": art, "live": live}, req)
                    result["ops_ms"][f"{name} B={B}"] = ops_turns(name, live, req, "lstm_fwd",
                                                                  5)
                median = statistics.median(result["host_ms"][f"{name} B=8"]["artifact"])
            result["busy"][name] = trace_artifact(f"{name} artifact B=8", art, req8,
                                                  "lstm_fwd", 5, median)

        path = export("flagship_pinned", export_lib.save_artifact, params, cfg, trimodal=tri,
                      batch=8, time=T_FRAMES, device=dev)
        art = export_lib.load_server(path, device=dev)
        pinned = [r for r in requests if r[1].shape == (8, T_FRAMES)]
        result["err"]["flagship_pinned"] = check_artifact("flagship_pinned", art, live, pinned,
                                                          "lstm_fwd", 5, totals)
        try:
            art(*requests[1])
        except Exception as e:  # the exported program's shape check
            print(f"flagship_pinned refuses B=1 T={T_FRAMES}: {type(e).__name__}")
        else:
            raise AssertionError("the pinned artifact served another shape")

        cfg4, _ = oulu_4stream()
        params4 = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 41), cfg4,
                                            device=dev)
        live4 = make_server(params4, cfg4, device=dev)
        live4_probs = make_server(params4, cfg4, vote=False, device=dev)
        requests4 = export_requests("streams", cfg4, [(1, T_FRAMES), (1, 14),
                                                      (TRAIN_B, T_FRAMES), (TRAIN_B, 14)],
                                    SEED + 41)
        # the bf16 artifact's per-step probabilities: a vote over near-uniform
        # random-weight frames flips with any perturbation
        for name, wd, tol, vote_live in (("4stream", None, SCORE_TOL, live4),
                                         ("4stream_bf16", "bfloat16", EXPORT_BF16_TOL,
                                          live4_probs)):
            path = export(name, export_lib.save_artifact, params4, cfg4, weights_dtype=wd,
                          vote=wd is None, device=dev)
            art = export_lib.load_server(path, device=dev)
            result["err"][name] = check_artifact(name, art, vote_live, requests4,
                                                 "lstm_peep_fwd", 6, totals, tol)
            if wd is None:
                req = next(r for r in requests4 if r[1].shape == (TRAIN_B, T_FRAMES))
                result["strided_err"][name] = check_strided(name, art, live4, req,
                                                            "lstm_peep_fwd", 6)
                for B in (1, TRAIN_B):
                    req = next(r for r in requests4 if r[1].shape == (B, T_FRAMES))
                    result["host_ms"][f"{name} B={B}"] = host_turns(
                        name, {"artifact": art, "live": live4}, req)
                    result["ops_ms"][f"{name} B={B}"] = ops_turns(name, live4, req,
                                                                  "lstm_peep_fwd", 6)
                median = statistics.median(result["host_ms"][f"{name} B={TRAIN_B}"]["artifact"])
                req = next(r for r in requests4 if r[1].shape == (TRAIN_B, T_FRAMES))
                result["busy"][name] = trace_artifact(f"{name} artifact B={TRAIN_B}", art, req,
                                                      "lstm_peep_fwd", 6, median)

        cfg_s = zoo.adenet_v4(1144, 90, output_classes=10)
        params_s = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 42), cfg_s,
                                             device=dev)
        path = export("adenet_v4_streaming", export_lib.save_streaming_artifact, params_s,
                      cfg_s, device=dev)
        loaded = export_lib.load_streaming_artifact(path, device=dev)
        advances = [0]
        advance = loaded._advance

        def counted(*a):
            advances[0] += 1
            return advance(*a)

        loaded._advance = counted
        template = StreamingSession(params_s, cfg_s, device=dev)
        one_shot = make_server(params_s, cfg_s, vote=False, device=dev)
        rng = np.random.RandomState(SEED + 42)
        err = 0.0
        for T in (T_FRAMES, 14):
            xs = [rng.randn(1, T, s.input_dim).astype(np.float32) for s in cfg_s.streams]
            frames = {}
            for kind, sess in (("live", template.fresh()), ("artifact", loaded.new_session())):
                advances[0] = 0
                reset_launches()
                got = [f for t in range(T) for f in sess.feed([x[:, t: t + 1] for x in xs])]
                tail, last = sess.finalize()
                torch.cuda.synchronize()
                launches = read_launches()
                if kind == "artifact":
                    for row, n in launches.items():
                        totals[row] += n
                    expect_launches(launches, lstm_fwd=3 * advances[0])
                frames[kind] = (np.concatenate([np.stack(got, axis=1), tail], axis=1)
                                if got else tail, last)
            (a, a_last), (b, _) = frames["artifact"], frames["live"]
            ref = one_shot(xs, np.ones((1, T), np.float32)).cpu().numpy()
            e_live = float(np.abs(a - b).max())
            e_one = float(np.abs(a_last - ref).max())
            print(f"adenet_v4 streaming artifact T={T}: {advances[0]} advances, launches "
                  f"{launches}; |artifact - live session| {e_live:.2e} over every frame, "
                  f"|last frame - one-shot server| {e_one:.2e}")
            if a.shape != (1, T, 10) or not max(e_live, e_one) <= SCORE_TOL:
                raise AssertionError("the streaming artifact disagrees")
            err = max(err, e_live, e_one)
        result["err"]["adenet_v4_streaming"] = err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["launches"] = totals
    return result


# configs/oulu_trimodal.ini's [training] schedule as phase_fit cuts it, and
# the split it trains on: seeded features, lengths 5-29 (the first 29)
TRIMODAL_INI = os.path.join("configs", "oulu_trimodal.ini")
FIT_CUTS = {"num_epoch": 3, "epochsize": 4, "decay_start": 2}
FIT_SPLIT = (40, 20, 20)
# the 4-stream fit: configs/oulu_4stream.ini's [training] cut to 2 epochs of 3
# steps, on 30 / 10 / 10 utterances
FIT4_CUTS = {"num_epoch": 2, "epochsize": 3}
FIT4_SPLIT = (30, 10, 10)
# a split evaluated in chunks of eval_batchsize = 512
FIT_BIG_SPLIT = 600
# card vs the port's CPU path over a whole fit at dropout 0: each epoch's
# costs relative, the best parameters relative to each leaf's max abs (twelve
# adadelta steps carry the steps' float32 differences forward)
FIT_COST_TOL = 1e-4
FIT_PARAM_TOL = 1e-4
# an Adam fit, card against CPU: the share of a leaf's entries that may
# stand beyond FIT_PARAM_TOL, each within 2 lr per step (Adam's step is
# about +-lr for any gradient above its epsilon, so an entry whose gradient
# is float32 noise around zero moves lr either way on either side).  The
# audio_visual fit's 6 steps left 0.006% to 0.06% of its encoder weights'
# entries there and 2% of its visual LSTM bias (1000 entries), NVIDIA H100
# 80GB HBM3, 700 W
ADAM_NOISE_SHARE = 0.05


def flagship(dropout=True):
    """The flagship adenet_v3 at full width as phase_train builds it; without
    ``dropout`` every rate is 0."""
    from ip_avsr_torch.models import zoo

    cfg = zoo.adenet_v3(1144, 90, 1144, lstm_size=250, window=9, output_classes=10)
    return cfg if dropout else no_dropout(cfg)


def no_dropout(cfg):
    """``cfg`` with every dropout rate 0."""
    import dataclasses

    return dataclasses.replace(cfg, agg_dropout=0.0, streams=[
        dataclasses.replace(s, dropout=0.0) for s in cfg.streams])


def trimodal_schedule():
    """``[training]`` of configs/oulu_trimodal.ini as TrainOptions fields
    (the CLI's adadelta), and the same with :data:`FIT_CUTS` applied."""
    import configparser

    cp = configparser.ConfigParser()
    if not cp.read(os.path.join(ROOT, TRIMODAL_INI)):
        raise FileNotFoundError(TRIMODAL_INI)
    t = cp["training"]
    full = dict(optimizer="adadelta", learning_rate=t.getfloat("learning_rate"),
                decay_rate=t.getfloat("decay_rate"), decay_start=t.getint("decay_start"),
                num_epoch=t.getint("num_epoch"), epochsize=t.getint("epochsize"),
                batchsize=t.getint("batchsize"), window=t.getint("windowsize"),
                validation_window=t.getint("validation_window"))
    return full, {**full, **FIT_CUTS}


def fit_split(dims, n, seed, classes):
    """(frame-major streams, per-frame targets, lengths) of ``n`` seeded
    utterances: normal features whose first ``classes`` columns carry a
    class-dependent shift, lengths 5-29 with the first 29."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lens = rng.randint(5, T_FRAMES + 1, n)
    lens[0] = T_FRAMES
    y = rng.randint(0, classes, n)
    frames = np.repeat(y, lens)
    streams = []
    for D in dims:
        x = rng.randn(int(lens.sum()), D).astype(np.float32)
        x[np.arange(len(frames)), frames % D] += 1.0
        streams.append(x)
    return streams, frames, lens


def fit_splits(cfg, sizes, seed):
    dims = [s.input_dim for s in cfg.streams]
    return [fit_split(dims, n, seed + i, cfg.output_classes) for i, n in enumerate(sizes)]


def fit_forwards(result, epochsize):
    """(train steps, evaluation forwards) of a fit from its result: per epoch
    the last batch's cost, the validation cost and the validation rate, plus
    the test rate at every new best validation cost (or once at the end if
    there was none)."""
    best, improved = float("inf"), 0
    for v in result.cost_val:
        if v < best:
            best, improved = v, improved + 1
    return (result.epochs_run * epochsize,
            3 * result.epochs_run + improved + (0 if improved else 1))


class FitClock:
    """Host times of a fit's parts on the card: batch assembly and its copy
    into pinned host memory (both on the prefetch thread), the copy of a
    training batch to the card (``_device_batch``), the step's host time
    (``train_step``, which returns before the card finishes) and the start
    of each copy, and the time of each log line (one per epoch)."""

    def __init__(self, trainer, batchsize):
        import numpy as np

        self.assembly, self.pin, self.copy, self.step, self.starts, self.logs = (
            [], [], [], [], [], [])
        batches, host_batch, device_batch, train_step = (
            trainer._infinite_batches, trainer._host_batch, trainer._device_batch,
            trainer.train_step)

        def timed_batches(*args):
            it = batches(*args)
            while True:
                t0 = time.perf_counter()
                item = next(it)
                self.assembly.append(time.perf_counter() - t0)
                yield item

        def timed_pin(streams, y, mask):
            t0 = time.perf_counter()
            out = host_batch(streams, y, mask)
            if isinstance(mask, np.ndarray) and len(mask) == batchsize:
                self.pin.append(time.perf_counter() - t0)
            return out

        def timed_copy(streams, y, mask):
            t0 = time.perf_counter()
            out = device_batch(streams, y, mask)
            if len(mask) == batchsize:
                self.copy.append(time.perf_counter() - t0)
                self.starts.append(t0)
            return out

        def timed_step(*args):
            t0 = time.perf_counter()
            out = train_step(*args)
            self.step.append(time.perf_counter() - t0)
            return out

        trainer._infinite_batches = timed_batches
        trainer._host_batch = timed_pin
        trainer._device_batch = timed_copy
        trainer.train_step = timed_step
        trainer.options.log_fn = self.log

    def log(self, line):
        if line.startswith("Epoch"):
            self.logs.append(time.perf_counter())
        print(f"  fit: {line}")

    def report(self, label, t_start, epochsize):
        """Print and return per-epoch wall times, steps/s and the medians of
        the host split per step (epochs after the first)."""
        ms = lambda xs: statistics.median(xs[epochsize:] or xs) * 1e3  # noqa: E731
        walls = [b - a for a, b in zip([t_start] + self.logs, self.logs)]
        # gaps between consecutive batch copies inside an epoch: one step each
        gaps = [b - a for e in range(len(self.starts) // epochsize)
                for a, b in zip(self.starts[e * epochsize:(e + 1) * epochsize],
                                self.starts[e * epochsize + 1:(e + 1) * epochsize])]
        gaps = gaps[epochsize - 1:] or gaps
        ms_gap = statistics.median(gaps) * 1e3
        out = dict(epoch_s=walls, step_gap_ms=ms_gap, assembly_ms=ms(self.assembly),
                   pin_ms=ms(self.pin), copy_ms=ms(self.copy), step_host_ms=ms(self.step),
                   steps_per_s=1e3 / ms_gap)
        print(f"{label}: epoch wall times {[round(w, 4) for w in walls]} s (the first with "
              f"set-up and first calls; with checkpoints, each later one with the previous "
              f"epoch's); "
              f"per step, median after the first epoch: {ms_gap:.3f} ms between steps "
              f"({out['steps_per_s']:.1f} steps/s); on the prefetch thread, batch assembly "
              f"{out['assembly_ms']:.3f} ms and its pinned copy {out['pin_ms']:.3f} ms; on the "
              f"main thread, copy to the card {out['copy_ms']:.3f} ms and step "
              f"{out['step_host_ms']:.3f} ms (host time, the card runs on); "
              f"{smi('name,power.limit')}")
        return out


def named_leaves(tree, path=""):
    """[(path, leaf)] of a nested dict/list/tuple tree, in ``tree_map``
    order; paths as "/streams/raw/encoder/bottleneck/b"."""
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    return [(path, tree)] if items is None else [
        n for k, v in items for n in named_leaves(v, f"{path}/{k}")]


def zero_grad_biases(cfg):
    """The biases whose exact gradient is zero: each batch-norm stream's last
    encoder layer's (batch norm removes any shift of its input).  Float32
    gives them noise, which Adam turns into steps of about lr and adadelta
    into steps of about lr times the noise."""
    return [f"/streams/{s.name}/encoder/bottleneck/b" for s in cfg.streams
            if s.use_batchnorm and s.encoder_shapes]


def fit_gaps(got, ref, zero_grad=()):
    """(worst per-epoch cost difference relative, class-rate difference,
    [(path, best-parameter difference, leaf max abs)]) of two fits; the
    difference is relative to the leaf's max abs, absolute for a leaf of
    ``zero_grad`` (paths of :func:`named_leaves` whose exact gradient is
    zero)."""
    import numpy as np

    rel = lambda a, b: float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))  # noqa: E731
    cost = max(rel(got.cost_train, ref.cost_train), rel(got.cost_val, ref.cost_val))
    rates = max(abs(a - b) for a, b in zip(got.class_rate, ref.class_rate))
    params = []
    for (path, a), (_, b) in zip(named_leaves(got.best_params), named_leaves(ref.best_params)):
        top = b.abs().max().item()
        params.append((path, max_err(a, b)[0] / (1.0 if path in zero_grad else max(top, 1e-30)),
                       top))
    return cost, rates, params


def adam_noise_entries(got, ref, path, param_tol, lr, steps):
    """(entries of leaf ``path`` beyond ``param_tol`` of its max abs, all its
    entries, whether each of those is within 2 lr steps): an Adam fit's
    entries whose gradients sit within float32 noise of zero, which Adam
    steps by about +-lr each way whatever the gradient's size."""
    a = dict(named_leaves(got.best_params))[path]
    b = dict(named_leaves(ref.best_params))[path]
    diff = (a - b).abs()
    beyond = diff > param_tol * b.abs().max()
    return (int(beyond.sum()), diff.numel(),
            bool((diff[beyond] <= 2 * lr * steps * (1 + 1e-3)).all()))


def compare_fits(label, got, ref, n_val, cost_tol=FIT_COST_TOL, param_tol=FIT_PARAM_TOL,
                 margins=None, zero_grad=(), adam=None):
    """Raise unless two fits agree: per-epoch costs within ``cost_tol``
    relative, class rates within one utterance, the same epochs and rate,
    best parameters within ``param_tol`` of each leaf's max abs (absolute
    for a leaf of ``zero_grad``, see :func:`fit_gaps`).  With ``adam`` =
    (lr, steps), a leaf beyond that passes when at most ADAM_NOISE_SHARE of
    its entries are (:func:`adam_noise_entries`), each within 2 lr steps.
    Prints the worst differences, and ``margins()`` where a rate differs."""
    cost, rates, params = fit_gaps(got, ref, zero_grad)
    flips = rates * n_val
    over = [path for path, e, _ in params if e > param_tol]
    if adam is not None and over:
        noise = {path: adam_noise_entries(got, ref, path, param_tol, *adam) for path in over}
        print(f"{label}: Adam's steps on gradients within noise of zero (lr {adam[0]:g}, "
              f"{adam[1]} steps): entries beyond {param_tol:g} of max abs "
              f"{ {p: f'{n} of {m}' for p, (n, m, _) in noise.items()} }")
        params = [(path, 0.0 if path in noise and noise[path][0] <= ADAM_NOISE_SHARE
                   * noise[path][1] and noise[path][2] else e, top)
                  for path, e, top in params]
    worst_path, worst, top = max(params, key=lambda t: t[1])
    print(f"{label}: costs {[round(float(c), 6) for c in got.cost_val]} (val) against "
          f"{[round(float(c), 6) for c in ref.cost_val]}, worst relative difference "
          f"{cost:.2e}; "
          f"class rates {got.class_rate} against {ref.class_rate} ({flips:.0f} utterances "
          f"apart at most); best parameters, worst of {len(params)} relative to max abs "
          f"{worst:.2e} (at {worst_path}, max abs {top:.3e}"
          f"{'; absolute: its exact gradient is 0' if worst_path in zero_grad else ''})")
    if flips and margins is not None:
        margins()
    if not (len(got.cost_val) == len(ref.cost_val) and cost <= cost_tol and flips <= 1
            and got.epochs_run == ref.epochs_run and got.final_lr == ref.final_lr
            and worst <= param_tol):
        raise AssertionError(f"{label}: the fits disagree")


def phase_fit(dev):
    """The single-device Trainer on the card: the flagship through
    ``Trainer.fit`` on configs/oulu_trimodal.ini's schedule (cut) with every
    launch counted, its host split per step, an epoch's device busy share,
    the evaluation time and peak memory; the same fit at dropout 0 on the
    card against the CPU path, with device-resident data, and resumed from
    its epoch-2 checkpoint; then the 4-stream model of configs/
    oulu_4stream.ini through the same Trainer, its launches counted.
    Returns ({row: launches}, epochs) of the flagship fit and of the
    4-stream fit, and the fit's numbers."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ip_avsr_torch.data.datagen import PaddedDataset
    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.train import trainer as trainer_lib

    full, sched = trimodal_schedule()
    cuts = {k: f"{full[k]} -> {v}" for k, v in FIT_CUTS.items()}
    print(f"fit: flagship adenet_v3 full width, configs/oulu_trimodal.ini [training] "
          f"{full}; cut: {cuts}; split {FIT_SPLIT} (train, val, test), T <= {T_FRAMES}")
    cfg, cfg0 = flagship(), flagship(dropout=False)
    data = fit_splits(cfg, FIT_SPLIT, SEED + 20)
    n_val = FIT_SPLIT[1]
    cpu = torch.device("cpu")
    params0 = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 8), cfg,
                                        device="cpu")
    start = {"cpu": params0, dev.type: tree_to(params0, dev)}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")

    def make(config, device, **kw):
        o = trainer_lib.TrainOptions(**{**sched, "seed": SEED, "log_fn": lambda s: None,
                                        **kw})
        t = trainer_lib.Trainer(config, o, device=device)
        t.init_params = lambda generator, **_: start[t.device.type]
        return t

    try:
        # warm-up: cuBLAS handles and the kernels' first calls, one step
        make(cfg, dev, num_epoch=1, epochsize=1).fit(*data)
        torch.cuda.synchronize()

        main = make(cfg, dev, checkpoint_dir=os.path.join(tmp, "main"))
        clock = FitClock(main, sched["batchsize"])
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        result = main.fit(*data)
        torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2**20
        steps, evals = fit_forwards(result, sched["epochsize"])
        print(f"fit, flagship with its dropout: {result.epochs_run} epochs, {steps} steps, "
              f"{evals} evaluation forwards; final lr {result.final_lr}; launches {launches}; "
              f"peak memory {peak:.0f} MiB; {smi('name,power.limit')}")
        expect_launches(launches, lstm_fwd_train=5 * steps, lstm_bwd=5 * steps,
                        lstm_fwd=5 * evals, delta=steps + evals)
        finite = np.isfinite(result.cost_train + result.cost_val).all()
        if not (finite and result.test_conf.sum() == FIT_SPLIT[2]):
            raise AssertionError("fit: non-finite costs or a wrong confusion matrix")
        timing = clock.report("fit, flagship", t0, sched["epochsize"])

        # the evaluation of the validation split, as fit runs it each epoch
        ev = make(cfg, dev)
        best = tree_to(result.best_params, dev)
        val_host = PaddedDataset(*data[1]).gather(np.arange(n_val))
        val = ev._device_batch(*val_host)
        for name, fn in (("evaluate", lambda: ev.evaluate(best, *val_host, dev=val)),
                         ("eval_cost", lambda: float(ev.eval_cost(best, *val)))):
            times = []
            for _ in range(12):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t1) * 1e3)
            timing[f"val_{name}_ms"] = statistics.median(times[2:])
            print(f"fit: {name} of the validation split (B={n_val}) "
                  f"{timing[f'val_{name}_ms']:.3f} ms (host clock, median of 10); "
                  f"{smi('name,power.limit')}")

        # a split larger than eval_batchsize = 512: a chunk of 512 and one of 88
        # padded to 512 with all-pad rows, against the whole split as one batch
        # of 600, host and device-side evaluation
        big = PaddedDataset(*fit_split([s.input_dim for s in cfg.streams], FIT_BIG_SPLIT,
                                       SEED + 40, cfg.output_classes))
        big_host = big.gather(np.arange(big.n))
        reset_launches()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        chunked = ev.evaluate(best, *big_host)
        torch.cuda.synchronize()
        timing["big_evaluate_ms"] = (time.perf_counter() - t1) * 1e3
        chunk_launches = read_launches()
        n_chunks = -(-big.n // 512)
        expect_launches(chunk_launches, lstm_fwd=5 * n_chunks, delta=n_chunks)
        whole = ev.evaluate(best, *big_host, eval_batchsize=2 * big.n)
        on_card = make(cfg, dev, device_eval=True).evaluate(best, *big_host)
        apart = max(abs(chunked[0] - whole[0]), abs(on_card[0] - whole[0])) * big.n
        print(f"fit: evaluate {big.n} utterances in {n_chunks} chunks of 512 "
              f"({timing['big_evaluate_ms']:.1f} ms, launches {chunk_launches}): rate "
              f"{chunked[0]:.4f}, device-side {on_card[0]:.4f}, as one batch of {big.n} "
              f"{whole[0]:.4f} ({apart:.0f} utterances apart at most)")
        if not (apart <= 1 and chunked[1].sum() == on_card[1].sum() == big.n):
            raise AssertionError("fit: chunked evaluation disagrees with one batch")

        # one epoch's device busy share: a one-epoch fit timed, then traced
        epoch = make(cfg, dev, num_epoch=1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        epoch.fit(*data)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t1) * 1e3
        events, busy = busy_share(traced(lambda: make(cfg, dev, num_epoch=1).fit(*data), 1), 1,
                                  wall, "fit, one flagship epoch", rows=16)
        print(events.table(sort_by="self_cpu_time_total", row_limit=12))
        timing.update(epoch_ms=wall, epoch_busy_ms=busy, epoch_busy_share=busy / wall,
                      peak_mib=peak)
        print(f"fit, one flagship epoch ({sched['epochsize']} steps and its evaluations): "
              f"{wall:.1f} ms, device busy {busy:.1f} ms, share {busy / wall:.3f}; "
              f"{smi('name,power.limit')}")

        # dropout 0: the card against the CPU path, device-resident data, resume
        host_dir = os.path.join(tmp, "host")
        card = make(cfg0, dev, checkpoint_dir=host_dir).fit(*data)
        cpu_fit = make(cfg0, cpu).fit(*data)

        def margins():
            probs = ev.predict(tree_to(cpu_fit.best_params, dev), val[0], val[2]).cpu()
            ref = ev.predict(cpu_fit.best_params, tree_to(val[0], cpu), val[2].cpu())
            top = ref.topk(2, dim=-1).values
            flipped = (probs.argmax(-1) != ref.argmax(-1)).nonzero().flatten().tolist()
            print(f"  flipped predictions at the CPU fit's best parameters: {flipped}, "
                  f"top-two margins {[(top[i, 0] - top[i, 1]).item() for i in flipped]}")

        compare_fits("fit dropout 0, card vs CPU path", card, cpu_fit, n_val, margins=margins)
        reset_launches()
        dd = make(cfg0, dev, device_data=True).fit(*data)
        dd_launches = read_launches()
        steps0, evals0 = fit_forwards(dd, sched["epochsize"])
        expect_launches(dd_launches, lstm_fwd_train=5 * steps0, lstm_bwd=5 * steps0,
                        lstm_fwd=5 * evals0, delta=steps0 + evals0)
        compare_fits("fit dropout 0, device_data vs host path (card)", dd, card, n_val)
        # the resumed epoch draws its batches from RandomState(seed + 2), as
        # the JAX package's resume does: the card's resume is held against
        # the CPU path's from the same checkpoint, its restored history and
        # rate against the uninterrupted fit
        resumed = {}
        for name, device in (("card", dev), ("cpu", cpu)):
            ck = os.path.join(tmp, f"resume_{name}")
            shutil.copytree(os.path.join(host_dir, "step_2"), os.path.join(ck, "step_2"))
            resumed[name] = make(cfg0, device, checkpoint_dir=ck, resume=True).fit(*data)
        r = resumed["card"]
        if not (r.cost_val[:2] == card.cost_val[:2] and r.cost_train[:2] == card.cost_train[:2]
                and r.final_lr == card.final_lr and len(r.cost_val) == 3):
            raise AssertionError("fit resume: the restored history or rate differs")
        print(f"fit resume from epoch 2 (card): restored costs equal, final lr {r.final_lr} "
              f"equal to the uninterrupted fit's")
        compare_fits("fit resume, card vs CPU path", resumed["card"], resumed["cpu"], n_val)

        # the 4-stream model through the same Trainer
        cfg4, training = oulu_4stream()
        o4 = dict(num_epoch=training.num_epoch, epochsize=training.epochsize,
                  batchsize=training.batchsize, learning_rate=training.learning_rate,
                  optimizer=training.optimizer, validation_window=training.validation_window,
                  window=cfg4.window, decay_rate=training.decay_rate,
                  decay_start=training.decay_start,
                  bucket_boundaries=training.bucket_boundaries,
                  grad_accum_steps=training.grad_accum_steps)
        print(f"fit, 4-stream: configs/oulu_4stream.ini [training] {o4}; cut: "
              f"{ {k: f'{o4[k]} -> {v}' for k, v in FIT4_CUTS.items()} }; split {FIT4_SPLIT}")
        o4.update(FIT4_CUTS)
        data4 = fit_splits(cfg4, FIT4_SPLIT, SEED + 30)
        t4 = trainer_lib.Trainer(cfg4, trainer_lib.TrainOptions(
            **o4, seed=SEED, log_fn=lambda s: print(f"  fit: {s}")), device=dev)
        reset_launches()
        r4 = t4.fit(*data4)
        torch.cuda.synchronize()
        launches4 = read_launches()
        steps4, evals4 = fit_forwards(r4, o4["epochsize"])
        print(f"fit, 4-stream: {r4.epochs_run} epochs, {steps4} steps, {evals4} evaluation "
              f"forwards; launches {launches4}")
        expect_launches(launches4, lstm_peep_fwd_train=6 * steps4, lstm_peep_bwd=6 * steps4,
                        lstm_peep_fwd=6 * evals4, delta=steps4 + evals4)
        if not np.isfinite(r4.cost_train + r4.cost_val).all():
            raise AssertionError("fit, 4-stream: non-finite costs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, result.epochs_run, launches4, r4.epochs_run, timing


# phase_cli: the training CLIs run from .mat and INI files.  The corpus has
# OuluVS's widths: 26 x 44 uint8 pixels, DCT 90, MFCC 39 whose lengths differ
# from the video's by up to 2 frames (so force-align pads), 10 classes,
# 1-based targets; 60 utterances of 5-29 frames over 10 subjects, split 6 / 2
# / 2 by subject files; two 1144-2000-1000-500-50 autoencoders.
CLI_CORPUS = dict(n=60, subjects=10, imagesize=IMAGE_SHAPE, dct=DCT, mfcc=39,
                  ae=(2000, 1000, 500, 50), classes=10)
CLI_SUBJECTS = {"train": "1,2,3,4,5,6", "val": "7,8", "test": "9,10"}
# cli.audio_visual's schedule (its own flags: Adam at lr 1e-4, batch 10,
# W = 9, H = 250) cut to 2 epochs of 3 steps
AV_CUTS = {"num_epoch": 2, "epochsize": 3}


def write_cli_corpus(root, corpus=None, seed=SEED):
    """Write a seeded corpus through the port's ``save_mat`` and
    ``save_dbn_mat`` into ``root``: ``images.mat`` (uint8 pixels, per-frame
    targets, per-video subjects and lengths), ``dct.mat`` and ``mfcc.mat``
    (float64 features in the same schema; the MFCC lengths differ), the
    autoencoders ``ae.mat`` and ``ae_diff.mat`` (w1..w4, b1..b4) and the
    subject files.  ``corpus`` overrides entries of :data:`CLI_CORPUS`.
    Returns {name: path}."""
    import numpy as np

    from ip_avsr_torch.io import matio

    c = {**CLI_CORPUS, **(corpus or {})}
    rng = np.random.RandomState(seed)
    n, classes = c["n"], c["classes"]
    lens = rng.randint(5, T_FRAMES + 1, n)
    lens[0] = T_FRAMES
    y = rng.randint(1, classes + 1, n)
    subjects = np.arange(n) % c["subjects"] + 1
    mfcc_lens = np.clip(lens + rng.randint(-2, 3, n), 1, T_FRAMES)
    pixels = c["imagesize"][0] * c["imagesize"][1]

    def vectors(lengths):
        return {"targetsVec": np.repeat(y, lengths).reshape(-1, 1),
                "subjectsVec": subjects.reshape(-1, 1),
                "videoLengthVec": lengths.reshape(-1, 1)}

    def features(lengths, d, scale):
        # normal features, the class's column shifted
        cls = np.repeat(y - 1, lengths)
        x = scale * rng.randn(len(cls), d)
        x[np.arange(len(cls)), cls % d] += 2.0 * scale
        return x

    # uint8 pixels, a band of columns per class brighter
    cls = np.repeat(y - 1, lens)
    band = (np.arange(pixels)[None, :] * classes // pixels) == cls[:, None]
    images = (rng.randint(0, 192, (len(cls), pixels)) + 63 * band).astype(np.uint8)
    paths = {k: os.path.join(root, f"{k}.mat") for k in ("images", "dct", "mfcc", "ae",
                                                         "ae_diff")}
    matio.save_mat({"dataMatrix": images, **vectors(lens)}, paths["images"])
    matio.save_mat({"dataMatrix": features(lens, c["dct"], 10.0), **vectors(lens)},
                   paths["dct"])
    matio.save_mat({"dataMatrix": features(mfcc_lens, c["mfcc"], 1.0),
                    **vectors(mfcc_lens)}, paths["mfcc"])
    for name in ("ae", "ae_diff"):
        fan, weights, biases = pixels, [], []
        for units in c["ae"]:
            weights.append(rng.randn(fan, units) / np.sqrt(fan))
            biases.append(0.1 * rng.randn(units))
            fan = units
        matio.save_dbn_mat(weights, biases, paths[name])
    for part, ids in CLI_SUBJECTS.items():
        paths[part] = os.path.join(root, f"{part}.txt")
        with open(paths[part], "w") as f:
            f.write(ids + "\n")
    return paths


def cli_sets(kind, paths, corpus=None):
    """(section, key, value) settings that point a copy of
    configs/oulu_trimodal.ini ("trimodal") or configs/oulu_4stream.ini
    ("nstream") at a corpus of :func:`write_cli_corpus` (at OuluVS's widths
    the widths are the files' own)."""
    c = {**CLI_CORPUS, **(corpus or {})}
    size = ",".join(str(v) for v in c["imagesize"])
    split = [("training", f"{part}_subjects_file", paths[part]) for part in CLI_SUBJECTS]
    if kind == "trimodal":
        return [("data", "images", paths["images"]), ("data", "dct", paths["dct"]),
                ("data", "imagesize", size), ("models", "ae_pretrained", paths["ae"]),
                ("models", "ae_diff_pretrained", paths["ae_diff"])] + split
    pixels = c["imagesize"][0] * c["imagesize"][1]
    sets = []
    for sec, ae in (("stream1", "ae"), ("stream2", "ae_diff")):
        sets += [(sec, "data", paths["images"]), (sec, "model", paths[ae]),
                 (sec, "imagesize", size), (sec, "input_dimensions", pixels),
                 (sec, "shape", ",".join(str(u) for u in c["ae"])),
                 (sec, "nonlinearities", ",".join(["sigmoid"] * (len(c["ae"]) - 1)
                                                  + ["linear"]))]
    return sets + [("stream3", "data", paths["dct"]), ("stream3", "input_dimensions", c["dct"]),
                   ("stream4", "data", paths["mfcc"]),
                   ("stream4", "input_dimensions", c["mfcc"])] + split


def write_cli_ini(path, kind, sets):
    """Copy configs/oulu_trimodal.ini ("trimodal") or configs/oulu_4stream.ini
    ("nstream") to ``path`` with each (section, key, value) of ``sets``
    set; returns the (section, key, old, new) of every value changed."""
    import configparser

    cp = configparser.ConfigParser()
    src = TRIMODAL_INI if kind == "trimodal" else OULU_INI
    if not cp.read(os.path.join(ROOT, src)):
        raise FileNotFoundError(src)
    changed = []
    for sec, key, value in sets:
        old = cp.get(sec, key, fallback=None)
        if old != str(value):
            changed.append((sec, key, old, str(value)))
        cp.set(sec, key, str(value))
    with open(path, "w") as f:
        cp.write(f)
    return changed


def run_cli(main, argv):
    """Run a CLI's ``main(argv)`` in-process and return (its result, a
    record): the seconds in ``.mat`` loads (``matio.load_mat_file`` and
    ``load_mat_files``), in
    ``Trainer.init_params`` (building the model on its device), on the host
    before ``Trainer.fit`` otherwise (preprocessing, split, normalisation:
    ``prep_s``), in the fit and in the whole call; what reached the fit (the
    data as numpy, the initial parameters as CPU tensors); and on the card
    the fit's launches, counted from 0 at its start, and its ``FitClock``;
    the fit's result (``result``)."""
    import torch

    from ip_avsr_torch.device import tree_map
    from ip_avsr_torch.io import matio
    from ip_avsr_torch.train.trainer import Trainer

    rec = {"load_s": 0.0, "init_s": 0.0}
    card = argv[argv.index("--device") + 1] == "cuda"
    load, load_many = matio.load_mat_file, matio.load_mat_files
    init, fit = Trainer.init_params, Trainer.fit

    def sync(device):
        if device.type == "cuda":
            torch.cuda.synchronize()

    def timed_load(path):
        t = time.perf_counter()
        out = load(path)
        rec["load_s"] += time.perf_counter() - t
        return out

    def timed_load_many(paths, workers=None):
        t = time.perf_counter()
        out = load_many(paths, workers)
        rec["load_s"] += time.perf_counter() - t
        return out

    def timed_init(self, *args, **kw):
        t = time.perf_counter()
        out = init(self, *args, **kw)
        sync(self.device)
        rec["init_s"] += time.perf_counter() - t
        rec["params0"] = tree_map(lambda v: v.detach().cpu().clone(), out)
        return out

    def probed_fit(self, *data):
        rec["fit_entry"] = time.perf_counter()
        rec["data"] = data
        if card:
            rec["clock"] = FitClock(self, self.options.batchsize)
            reset_launches()
        result = fit(self, *data)
        sync(self.device)
        rec["fit_s"] = time.perf_counter() - rec["fit_entry"]
        rec["result"] = result
        if card:
            rec["launches"] = read_launches()
        return result

    matio.load_mat_file, matio.load_mat_files = timed_load, timed_load_many
    Trainer.init_params, Trainer.fit = timed_init, probed_fit
    try:
        t0 = time.perf_counter()
        result = main(argv)
        rec["wall_s"] = time.perf_counter() - t0
    finally:
        matio.load_mat_file, matio.load_mat_files = load, load_many
        Trainer.init_params, Trainer.fit = init, fit
    rec["prep_s"] = rec["fit_entry"] - t0 - rec["load_s"] - rec["init_s"]
    return result, rec


def same_fit_inputs(label, got, ref):
    """Raise unless two :func:`run_cli` records handed ``Trainer.fit`` the
    same data (arrays equal in dtype and value) and the same initial
    parameters, bit for bit."""
    import numpy as np
    import torch

    from ip_avsr_torch.device import tree_map

    def same(a, b):
        if isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, z) for x, z in zip(a, b))
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)

    leaves = []
    tree_map(lambda a, b: leaves.append(torch.equal(a, b)), got["params0"], ref["params0"])
    if not (same(got["data"], ref["data"]) and all(leaves)):
        raise AssertionError(f"{label}: the inputs of Trainer.fit differ")
    n = sum(int(np.asarray(split[2]).size) for split in ref["data"])
    print(f"{label}: what reached Trainer.fit is equal bit for bit ({n} utterances in "
          f"3 splits, {len(leaves)} initial parameter leaves)")


def phase_cli(dev):
    """The training CLIs on the card from .mat and INI files: a seeded corpus
    at OuluVS's widths (:func:`write_cli_corpus`), configs/oulu_trimodal.ini
    and configs/oulu_4stream.ini pointed at it with ``[training]`` cut as
    phase_fit cuts it; ``cli.trimodal`` (the flagship from the two
    autoencoders, its dropout on) and ``cli.nstream`` (the peephole 4-stream
    model, force-aligned) with every launch counted; a bucketed and a
    ``grad_accum_steps = 2`` nstream fit; ``cli.leave_one_out`` (adenet_v5
    from the autoencoders on the trimodal INI, ``--test_subj 3``) and
    ``cli.audio_visual`` (the pixels through one autoencoder and the MFCC
    stream, force-aligned, 2 epochs of 3 steps); each CLI again with
    ``--device cpu`` (trimodal and leave_one_out at dropout 0, on the card
    and on the CPU), what reached ``Trainer.fit`` equal bit for bit and the
    fits within FIT_COST_TOL and FIT_PARAM_TOL.  Returns ({row: launches}
    summed over the phase's card runs, the phase's numbers)."""
    import tempfile

    import numpy as np

    from ip_avsr_torch.cli import audio_visual, leave_one_out, nstream, trimodal
    from ip_avsr_torch.models import zoo

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    numbers, totals = {}, {name: 0 for name in KERNEL_COUNTERS}
    try:
        t0 = time.perf_counter()
        paths = write_cli_corpus(tmp)
        numbers["write_s"] = time.perf_counter() - t0
        mb = sum(os.path.getsize(p) for p in paths.values()) / 1e6
        print(f"cli: corpus {CLI_CORPUS}, subjects {CLI_SUBJECTS}, written in "
              f"{numbers['write_s']:.2f} s ({mb:.1f} MB)")
        inis = {}
        for name, kind, cuts in (
                ("trimodal", "trimodal", FIT_CUTS), ("nstream", "nstream", FIT4_CUTS),
                ("buckets", "nstream", {**FIT4_CUTS, "bucket_boundaries": "auto"}),
                ("accum", "nstream", {**FIT4_CUTS, "grad_accum_steps": 2})):
            inis[name] = os.path.join(tmp, f"{name}.ini")
            changed = write_cli_ini(inis[name], kind, cli_sets(kind, paths) + [
                ("training", k, v) for k, v in cuts.items()])
            print(f"cli: {name}.ini from {TRIMODAL_INI if kind == 'trimodal' else OULU_INI}, "
                  f"[training] cut: {[c[1:] for c in changed if c[1] in cuts]}")

        def run(label, main, ini, device, epochsize, per_step, per_eval):
            """One CLI run (``ini`` a name of ``inis`` or the CLI's argument
            list); on the card its launches held to ``per_step`` per train
            step and ``per_eval`` per evaluation forward."""
            args = ["--config", inis[ini]] if isinstance(ini, str) else list(ini)
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    result, rec = run_cli(main, args + ["--device", device])
            finally:  # the CLI's report: the epoch lines and the final rates
                for line in out.getvalue().splitlines():
                    if any(k in line for k in ("Epoch", "CR:", "bucketed", "WARNING",
                                               "Error", "Traceback")):
                        print(f"  {label}, {device}: {line.strip()}")
            timing = {k: rec[k] for k in ("load_s", "init_s", "prep_s", "fit_s", "wall_s")}
            if device == "cuda":
                steps, evals = fit_forwards(result, epochsize)
                launches = rec["launches"]
                print(f"cli, {label}: {result.epochs_run} epochs, {steps} steps, {evals} "
                      f"evaluation forwards; launches {launches}")
                expect_launches(launches, **{
                    row: per_step.get(row, 0) * steps + per_eval.get(row, 0) * evals
                    for row in {**per_step, **per_eval}})
                for row, k in launches.items():
                    totals[row] += k
                timing.update(rec["clock"].report(f"cli, {label}", rec["fit_entry"],
                                                  epochsize))
            print(f"cli, {label} on {device}: .mat loads {timing['load_s']:.3f} s, "
                  f"preprocessing and split {timing['prep_s']:.3f} s, model build "
                  f"{timing['init_s']:.3f} s, fit {timing['fit_s']:.3f} s, CLI wall "
                  f"{timing['wall_s']:.3f} s; {smi('name,power.limit')}")
            if not np.isfinite(result.cost_train + result.cost_val).all():
                raise AssertionError(f"cli, {label}: non-finite costs")
            numbers[f"{label}, {device}"] = timing
            return result, rec

        ep3, ep4 = FIT_CUTS["epochsize"], FIT4_CUTS["epochsize"]
        flagship_rows = (dict(lstm_fwd_train=5, lstm_bwd=5, delta=1),
                         dict(lstm_fwd=5, delta=1))
        peep_rows = (dict(lstm_peep_fwd_train=6, lstm_peep_bwd=6, delta=1),
                     dict(lstm_peep_fwd=6, delta=1))
        run("trimodal", trimodal.main, "trimodal", "cuda", ep3, *flagship_rows)
        adenet_v3 = zoo.adenet_v3
        zoo.adenet_v3 = lambda *a, **kw: no_dropout(adenet_v3(*a, **kw))
        try:
            card, card_rec = run("trimodal dropout 0", trimodal.main, "trimodal", "cuda",
                                 ep3, *flagship_rows)
            cpu, cpu_rec = run("trimodal dropout 0", trimodal.main, "trimodal", "cpu", ep3,
                               {}, {})
        finally:
            zoo.adenet_v3 = adenet_v3
        same_fit_inputs("cli, trimodal dropout 0, card vs CPU", card_rec, cpu_rec)
        compare_fits("cli, trimodal dropout 0, card vs CPU", card, cpu,
                     len(cpu_rec["data"][1][2]))

        card, card_rec = run("4-stream", nstream.main, "nstream", "cuda", ep4, *peep_rows)
        cpu, cpu_rec = run("4-stream", nstream.main, "nstream", "cpu", ep4, {}, {})
        same_fit_inputs("cli, 4-stream, card vs CPU", card_rec, cpu_rec)
        compare_fits("cli, 4-stream, card vs CPU", card, cpu, len(cpu_rec["data"][1][2]))
        lens = np.asarray(card_rec["data"][0][2])
        print(f"cli, 4-stream: force-aligned lengths {int(lens.min())}-{int(lens.max())}, "
              f"{int(lens.sum())} training frames")

        bucketed, b_rec = run("4-stream bucketed", nstream.main, "buckets", "cuda", ep4,
                              *peep_rows)
        bucketed_cpu, _ = run("4-stream bucketed", nstream.main, "buckets", "cpu", ep4, {}, {})
        compare_fits("cli, 4-stream bucketed, card vs CPU", bucketed, bucketed_cpu,
                     len(b_rec["data"][1][2]))
        # two microbatches a step: two forwards and backwards each
        accum, a_rec = run("4-stream grad_accum_steps=2", nstream.main, "accum", "cuda", ep4,
                           {row: 2 * k for row, k in peep_rows[0].items()}, peep_rows[1])
        # the accumulated gradient is the full batch's: the unaccumulated fit
        compare_fits("cli, 4-stream grad_accum_steps=2 vs 1 (card)", accum, card,
                     len(a_rec["data"][1][2]))

        # leave-one-out: adenet_v5 from the autoencoders on the trimodal INI,
        # subject 3 held out as validation and test, at dropout 0 (card, CPU)
        loo_args = ["--config", inis["trimodal"], "--test_subj", "3"]
        adenet_v5 = zoo.adenet_v5
        zoo.adenet_v5 = lambda *a, **kw: no_dropout(adenet_v5(*a, **kw))
        try:
            card, card_rec = run("leave_one_out dropout 0", leave_one_out.main, loo_args,
                                 "cuda", ep3, *flagship_rows)
            cpu, cpu_rec = run("leave_one_out dropout 0", leave_one_out.main, loo_args, "cpu",
                               ep3, {}, {})
        finally:
            zoo.adenet_v5 = adenet_v5
        same_fit_inputs("cli, leave_one_out dropout 0, card vs CPU", card_rec, cpu_rec)
        compare_fits("cli, leave_one_out dropout 0, card vs CPU", card, cpu,
                     len(cpu_rec["data"][1][2]))
        print(f"cli, leave_one_out: {len(cpu_rec['data'][0][2])} training utterances, "
              f"{len(cpu_rec['data'][2][2])} of subject 3 as validation and test")

        # audio_visual: the pixels through one autoencoder, the MFCC stream
        # force-aligned to them, the corpus's subject files, 2 epochs of 3 steps
        av_args = ["--visual", paths["images"], "--audio", paths["mfcc"], "--encoder",
                   paths["ae"], "--train_subjects_file", paths["train"],
                   "--val_subjects_file", paths["val"], "--test_subjects_file", paths["test"],
                   "--num_epoch", str(AV_CUTS["num_epoch"]),
                   "--epochsize", str(AV_CUTS["epochsize"])]
        avnet_rows = (dict(lstm_peep_fwd_train=4, lstm_peep_bwd=4, delta=1),
                      dict(lstm_peep_fwd=4, delta=1))
        card, card_rec = run("audio_visual", audio_visual.main, av_args, "cuda",
                             AV_CUTS["epochsize"], *avnet_rows)
        cpu, cpu_rec = run("audio_visual", audio_visual.main, av_args, "cpu",
                           AV_CUTS["epochsize"], {}, {})
        same_fit_inputs("cli, audio_visual, card vs CPU", card_rec, cpu_rec)
        compare_fits("cli, audio_visual, card vs CPU", card, cpu, len(cpu_rec["data"][1][2]),
                     adam=(1e-4, fit_forwards(card, AV_CUTS["epochsize"])[0]))
        lens = np.asarray(card_rec["data"][0][2])
        print(f"cli, audio_visual: force-aligned lengths {int(lens.min())}-{int(lens.max())}, "
              f"{int(lens.sum())} training frames")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli: launches over the phase's card runs {totals}")
    return totals, numbers


# phase_zoo: the rest of the model zoo at full width (OuluVS's 1144 pixels,
# DCT 90, MFCC 39, the builders' own H, 10 classes), each forward's
# launches as predicted from its recurrences: row 1 or row 5 once per
# LSTM (a BLSTM layer is two), row 2 once over every delta stream
ZOO_B = 8
ZOO_MFCC = 39
# adenet_v1's fit, card against CPU: this many times the spread between two
# CPU fits that differ only in float32 summation order (1 thread and all)
BN_FIT_SPREAD = 4
ZOO_LAUNCHES = {
    "deltanet": dict(lstm_fwd=2, delta=1),
    "baseline_end2end": dict(lstm_fwd=2),
    "adenet_v1": dict(lstm_fwd=4, delta=1),
    "adenet_v1_1": dict(lstm_fwd=4, delta=1),
    "adenet_v2_2": dict(lstm_peep_fwd=4, delta=1),
    "adenet_v2_nodelta": dict(lstm_peep_fwd=4),
    "adenet_v5": dict(lstm_fwd=5, delta=1),
    "adenet_v5 adasum": dict(lstm_fwd=5, delta=1),
    "adenet_v6": dict(lstm_fwd=4, delta=1),
    "avnet": dict(lstm_peep_fwd=4, delta=1),
}


def zoo_models():
    """{label: full-width config} of the builders phase_zoo serves."""
    from ip_avsr_torch.models import avnet, zoo

    nl, sh = zoo.SIGMOID_ENCODER
    px, C = IMAGE_SHAPE[0] * IMAGE_SHAPE[1], 10
    return {
        "deltanet": zoo.deltanet(px, sh, nl, output_classes=C),
        "baseline_end2end": zoo.baseline_end2end(px, sh, nl, output_classes=C),
        "adenet_v1": zoo.adenet_v1(px, DCT, output_classes=C),
        "adenet_v1_1": zoo.adenet_v1_1(px, DCT, output_classes=C),
        "adenet_v2_2": zoo.adenet_v2_2(px, px, output_classes=C),
        "adenet_v2_nodelta": zoo.adenet_v2_nodelta(px, px, output_classes=C),
        "adenet_v5": zoo.adenet_v5(px, DCT, px, output_classes=C),
        "adenet_v5 adasum": zoo.adenet_v5(px, DCT, px, output_classes=C, use_adascale=True),
        "adenet_v6": zoo.adenet_v6(px, px, output_classes=C),
        "avnet": avnet.avnet_config([px, ZOO_MFCC], ["visual", "audio"], output_classes=C,
                                    no_encoder_for=["audio"]),
    }


def move_bn_state(params, cfg, seed):
    """Set each batch-norm stream's running statistics away from their init
    (seeded: mean N(0, 0.3^2), var U(0.5, 1.5)), so that evaluation
    normalizes; in place, returns ``params``."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    for spec in cfg.streams:
        if spec.use_batchnorm:
            sp = params["streams"][spec.name]
            d, device = spec.encoded_dim(), sp["bn"]["gamma"].device
            sp["bn_state"] = {"mean": (0.3 * torch.randn(d, generator=gen)).to(device),
                              "var": (0.5 + torch.rand(d, generator=gen)).to(device)}
    return params


def step_against_cpu(label, cfg, params, streams, y, mask, grad_tol=TRAIN_GRAD_TOL):
    """The loss, gradients and one update of a dropout-free config on the
    card against the port's CPU path from the same parameters and batch:
    the loss within TRAIN_LOSS_TOL relative, each gradient within
    ``grad_tol`` of its max abs (or TRAIN_GRAD_FLOOR), and the parameters
    after one adadelta update at lr 1.0 (configs/oulu_trimodal.ini's
    optimizer) with the running statistics merged, within TRAIN_PARAM_TOL.
    Adadelta's first step is at most the gradient itself, so it carries the
    gradients' float32 differences over unamplified (Adam's first step is
    about +-lr whatever a gradient's size, so it turns the noise of an
    entry whose gradient is near zero into a step of lr either way).  A
    bias of :func:`zero_grad_biases` is held instead to a gradient under
    1e-4 of its layer's weight gradient on both.  Returns (card gradients,
    numbers)."""
    import torch

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.train import optimizers, trainer

    cpu = torch.device("cpu")
    c_params, c_streams, c_y, c_mask = (tree_to(params, cpu), tree_to(streams, cpu), y.cpu(),
                                        mask.cpu())
    opt = optimizers.adadelta(1.0)
    updated = []
    for p, batch in ((params, (streams, y, mask)), (c_params, (c_streams, c_y, c_mask))):
        loss, grads, aux = trainer.loss_and_grads(p, cfg, *batch, return_aux=True)
        new = trainer.merge_bn_state(opt.apply(p, grads, opt.init(p))[0], aux)
        updated.append((loss, grads, new))
    (loss_d, grads_d, p_d), (loss_c, grads_c, p_c) = updated
    zero = zero_grad_biases(cfg)
    g_d, g_c = dict(named_leaves(grads_d)), dict(named_leaves(grads_c))
    pd, pc = dict(named_leaves(p_d)), dict(named_leaves(p_c))
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    grad_rel, bad = {}, []
    for path, b in g_c.items():
        e = max_err(g_d[path].cpu(), b)[0]
        top = b.abs().max().item()
        grad_rel[path] = e / max(top, 1e-30)
        if path in zero:
            weight = g_c[path[:-1] + "w"].abs().max().item()
            noise = max(g_d[path].abs().max().item(), top)
            if not noise <= 1e-4 * weight:
                bad.append(f"{path} gradient {noise:.2e} against its weight's {weight:.2e}")
        elif not e <= max(grad_tol * top, TRAIN_GRAD_FLOOR):
            bad.append(f"{path} gradient {e:.2e} of max abs {top:.2e}")
    param_abs = {path: max_err(pd[path].cpu(), b)[0] for path, b in pc.items()
                 if path not in zero}
    bad += [f"{path} parameter {e:.2e}" for path, e in param_abs.items()
            if not e <= TRAIN_PARAM_TOL]
    worst = max((e, path) for path, e in grad_rel.items() if path not in zero)
    print(f"{label}, card vs CPU path: loss {float(loss_d):.7f} vs {float(loss_c):.7f} "
          f"(relative {loss_rel:.2e}); gradients ({len(grad_rel)} tensors) relative to max abs "
          f"worst {worst[0]:.2e} ({worst[1]}; held to {grad_tol:g}); parameters after one "
          f"adadelta update max abs {max(param_abs.values()):.2e}"
          + (f"; zero-gradient biases {zero} held to noise" if zero else ""))
    if not loss_rel <= TRAIN_LOSS_TOL or bad:
        raise AssertionError(f"{label}: the train step on the card disagrees with the CPU "
                             f"path: {bad or f'loss {loss_rel:.2e}'}")
    return grads_d, dict(loss_rel=loss_rel, grad_rel=worst[0],
                         param_abs=max(param_abs.values()))


def count_into(totals, launches):
    for k, v in launches.items():
        totals[k] += v


def phase_zoo(dev):
    """The rest of the model zoo on the card at full width: every builder
    of :func:`zoo_models` from seeded weights (running statistics moved off
    their init), served at B = 8, T = 29 with a ragged mask through
    ``serve.make_server`` (launches per forward against
    :data:`ZOO_LAUNCHES`, probabilities against the CPU path within
    SCORE_TOL, device time per forward); adenet_v1 also trained (one step
    at B = 10 against the CPU path; ``Trainer.fit`` on the flagship's
    schedule cut as phase_fit cuts it, card against CPU, its running
    statistics moved) and exported (an f32 artifact against its live
    server); the flagship with ``fuse_scans`` served and stepped bit for bit
    as unfused.  Returns ({row: launches} over the phase, its numbers)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from ip_avsr_torch import export
    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.ops import fusion as fusion_ops
    from ip_avsr_torch.serve import make_server
    from ip_avsr_torch.train import trainer as trainer_lib

    totals, numbers = {name: 0 for name in KERNEL_COUNTERS}, {}
    cpu = torch.device("cpu")
    models = zoo_models()
    # adenet_v5 with sum fusion is the flagship's config: its parameters serve
    # the adasum variant too (with the adasum coefficients) and the
    # fuse_scans check below, which saves two orthogonal inits on the host
    if models["adenet_v5"] != flagship():
        raise AssertionError("zoo: adenet_v5 (sum) is no longer the flagship's config")
    v5 = None
    for i, (label, cfg) in enumerate(models.items()):
        seed = SEED + 50 + i
        if label == "adenet_v5 adasum":
            params = {**v5, "adasum": {k: v.to(dev) for k, v in
                                       fusion_ops.init_adasum_params(len(cfg.streams)).items()}}
        else:
            params = move_bn_state(adenet.init_adenet_params(
                torch.Generator().manual_seed(seed), cfg, device=dev), cfg, seed)
        if label == "adenet_v5":
            v5 = params
        streams, mask, _ = stream_batch(cfg, ZOO_B, seed, dev)
        server = make_server(params, cfg, vote=False, device=dev)
        server(streams, mask)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        probs = server(streams, mask)
        torch.cuda.synchronize()
        launches = read_launches()
        count_into(totals, launches)
        got = {k: v for k, v in launches.items() if v}
        expect_launches(launches, **ZOO_LAUNCHES[label])
        ref = make_server(tree_to(params, cpu), cfg, vote=False, device="cpu")(
            tree_to(streams, cpu), mask.cpu())
        want_shape = ((ZOO_B, T_FRAMES, cfg.output_classes) if cfg.output_mode == "per_step"
                      else (ZOO_B, cfg.output_classes))
        probs = probs.cpu()
        err = (probs - ref).abs().max().item()
        row_err = (probs.sum(-1) - 1).abs().max().item()
        ms = cuda_ms(lambda: server(streams, mask), iters=10)
        H = sorted({cfg.stream_lstm_size(s) for s in cfg.streams if s.use_lstm}
                   | set(cfg.aggregator_sizes()))
        print(f"zoo, {label}: H {H}, {cfg.output_mode}, fusion {cfg.fusiontype}, peepholes "
              f"{cfg.use_peepholes}; launches per forward {got} (predicted "
              f"{ZOO_LAUNCHES[label]}); |card - CPU path| {err:.2e}, |row sum - 1| "
              f"{row_err:.2e}; {ms:.3f} ms per forward (CUDA events, B={ZOO_B})")
        if not (tuple(probs.shape) == want_shape and torch.isfinite(probs).all()
                and err <= SCORE_TOL and row_err <= 1e-5):
            raise AssertionError(f"zoo, {label}: bad probabilities {tuple(probs.shape)}, "
                                 f"error {err:.2e}")
        numbers[label] = dict(launches=got, err=err, ms=ms)
        del params, server
    print(f"zoo: launches per forward, measured against predicted: all "
          f"{len(models)} equal; {smi('name,power.limit')}")

    # adenet_v1: a train step, a fit, an artifact
    cfg = models["adenet_v1"]
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 60), cfg,
                                       device=dev)
    streams, mask, y = stream_batch(cfg, TRAIN_B, SEED + 60, dev)
    opt, step = trainer_lib.make_train_step(cfg)
    step(params, opt.init(params), streams, y, mask)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    p1 = step(params, opt.init(params), streams, y, mask)[0]
    torch.cuda.synchronize()
    launches = read_launches()
    count_into(totals, launches)
    expect_launches(launches, lstm_fwd_train=4, lstm_bwd=4, delta=1)
    moved = (p1["streams"]["raw"]["bn_state"]["var"] - 1).abs().max().item()
    print(f"zoo, adenet_v1 train step B={TRAIN_B}: launches {launches}; running var moved "
          f"{moved:.3e} from 1")
    if not moved > 0:
        raise AssertionError("zoo, adenet_v1: the train step left bn_state at its init")
    _, numbers["adenet_v1 step"] = step_against_cpu("zoo, adenet_v1 train step", cfg, params,
                                                    streams, y, mask)

    full, sched = trimodal_schedule()
    data = fit_splits(cfg, FIT_SPLIT, SEED + 61)
    params0 = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 61), cfg,
                                        device="cpu")
    start = {"cpu": params0, dev.type: tree_to(params0, dev)}

    def make(device):
        t = trainer_lib.Trainer(cfg, trainer_lib.TrainOptions(
            **{**sched, "seed": SEED, "log_fn": lambda s: None}), device=device)
        t.init_params = lambda generator, **_: start[t.device.type]
        return t

    reset_launches()
    t0 = time.perf_counter()
    card = make(dev).fit(*data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    count_into(totals, launches)
    steps, evals = fit_forwards(card, sched["epochsize"])
    print(f"zoo, adenet_v1 fit (configs/oulu_trimodal.ini's schedule cut to {FIT_CUTS}): "
          f"{card.epochs_run} epochs, {steps} steps, {evals} evaluation forwards in "
          f"{fit_s:.2f} s; launches {launches}")
    expect_launches(launches, lstm_fwd_train=4 * steps, lstm_bwd=4 * steps,
                    lstm_fwd=4 * evals, delta=steps + evals)
    cpu_fit = make(cpu).fit(*data)
    # batch norm divides its input's gradient by the encoder output's std
    # (about 1e-2 at this init), so float32 summation order alone moves the
    # fit: the same CPU fit on one thread gives the spread, and the card is
    # held to BN_FIT_SPREAD times it where that exceeds the fit tolerances
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_thread = make(cpu).fit(*data)
    finally:
        torch.set_num_threads(threads)
    zero = zero_grad_biases(cfg)
    cost_spread, _, spread = fit_gaps(one_thread, cpu_fit, zero)
    param_spread = max(e for path, e, _ in spread if path not in zero)
    cost_tol = max(FIT_COST_TOL, BN_FIT_SPREAD * cost_spread)
    param_tol = max(FIT_PARAM_TOL, BN_FIT_SPREAD * param_spread)
    print(f"zoo, adenet_v1 fit on the CPU, 1 against {threads} threads: costs "
          f"{cost_spread:.2e}, best parameters {param_spread:.2e} (worst, relative); the card "
          f"held to costs {cost_tol:.2e}, parameters {param_tol:.2e}")
    compare_fits("zoo, adenet_v1 fit, card vs CPU path", card, cpu_fit, FIT_SPLIT[1],
                 cost_tol=cost_tol, param_tol=param_tol, zero_grad=zero)
    numbers["adenet_v1 fit"] = dict(cost_spread=cost_spread, param_spread=param_spread,
                                    cost_tol=cost_tol, param_tol=param_tol)
    bn = card.best_params["streams"]["raw"]["bn_state"]
    moved = max(bn["mean"].abs().max().item(), (bn["var"] - 1).abs().max().item())
    print(f"zoo, adenet_v1 fit: best parameters' running statistics {moved:.3e} from their "
          f"init at most")
    if not moved > 0:
        raise AssertionError("zoo, adenet_v1 fit: bn_state did not move")
    numbers["adenet_v1 fit_s"] = fit_s

    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        moved_params = move_bn_state(tree_map(lambda t: t.clone(), params), cfg, SEED + 62)
        path = os.path.join(tmp, "adenet_v1.ipax")
        export.save_artifact(path, moved_params, cfg, device=dev)
        art = export.load_server(path, device=dev)
        live = make_server(moved_params, cfg, device=dev)
        reqs = export_requests("features", cfg, [(ZOO_B, T_FRAMES), (1, 14)], SEED + 62)
        numbers["adenet_v1 artifact err"] = check_artifact(
            "zoo, adenet_v1 f32 artifact", art, live, reqs, "lstm_fwd", 4, totals)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the flagship with fuse_scans: the grouped calls run their members in the
    # unfused order, so the forward and the step are the unfused ones bit for bit
    cfg = flagship()
    fused = dataclasses.replace(cfg, fuse_scans=True)
    params = v5
    streams, mask, y = stream_batch(cfg, ZOO_B, SEED + 63, dev)
    want = make_server(params, cfg, vote=False, device=dev)(streams, mask)
    reset_launches()
    got = make_server(params, fused, vote=False, device=dev)(streams, mask)
    torch.cuda.synchronize()
    launches = read_launches()
    count_into(totals, launches)
    expect_launches(launches, lstm_fwd=5, delta=1)
    streams, mask, y = stream_batch(cfg, TRAIN_B, SEED + 64, dev)
    outs = []
    for c in (cfg, fused):
        opt, step = trainer_lib.make_train_step(c)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_launches()
        outs.append(step(params, opt.init(params), streams, y, mask, gen))
        torch.cuda.synchronize()
        step_launches = read_launches()
        count_into(totals, step_launches)
        expect_launches(step_launches, lstm_fwd_train=5, lstm_bwd=5, delta=1)
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), outs[0][:2], outs[1][:2])
    print(f"zoo, flagship fuse_scans=True: forward launches {launches}, probabilities equal "
          f"to unfused: {torch.equal(got, want)}; train step (its dropout, the same draws) "
          f"loss {float(outs[1][2]):.7f}, equal: {torch.equal(outs[0][2], outs[1][2])}, "
          f"parameters and Adam state equal: {sum(same)}/{len(same)} leaves")
    if not (torch.equal(got, want) and torch.equal(outs[0][2], outs[1][2]) and all(same)):
        raise AssertionError("zoo: fuse_scans is not the unfused forward and step bit for bit")
    print(f"zoo: launches over the phase {totals}")
    return totals, numbers


# phase_residuals: the LSTM residual levers on a train step.  Per LSTM layer
# the training residuals held from forward to backward are the gates
# (T B 4H) and the hids and cells (2 T B H), 4 bytes each, 2 in bf16;
# remat keeps no gates (one layer's are rebuilt at a time in the backward)
RESIDUAL_SETTINGS = {"none": {}, "remat": dict(lstm_remat=True),
                     "bf16": dict(lstm_residual_dtype="bfloat16"),
                     "remat+bf16": dict(lstm_remat=True, lstm_residual_dtype="bfloat16")}
RESIDUAL_T = (T_FRAMES, 512)
# remat against none on the card: the rebuilt gates are the same products in
# another order, held as the train step's gradients are
REMAT_TOL = 1e-4
# bf16 residuals, card against CPU: each side rounds its own float32 stacks,
# and an entry whose two float32 values straddle a bf16 rounding boundary
# is stored one bf16 ulp (2^-8 relative) apart (about one entry in 4e4 of
# a gate stack, some 15 a flagship step); 4.8x under the 2.42e-3 gap
# between float32 and bf16-residual gradients (ROADMAP Queue 3)
BF16_STEP_TOL = 5e-4


def lstm_layer_sizes(cfg):
    """H of every recurrence of a config (a BLSTM layer counts twice)."""
    sizes = [cfg.stream_lstm_size(s) for s in cfg.streams if s.use_lstm]
    for H in cfg.aggregator_sizes():
        sizes += [H] * (2 if cfg.agg_bidirectional else 1)
    return sizes


def residual_bytes(cfg, B, T, setting):
    """Predicted bytes of the LSTM residual stacks a train step holds between
    its forward and its backward under ``setting``."""
    item = 2 if "bf16" in setting else 4
    return sum((0 if "remat" in setting else T * B * 4 * H * item) + 2 * T * B * H * item
               for H in lstm_layer_sizes(cfg))


def phase_residuals(dev):
    """The flagship (dropout 0) and the peephole 4-stream model of
    configs/oulu_4stream.ini each take a train step under the four residual
    settings: each setting on the card against the CPU path for the same
    setting (:func:`step_against_cpu`), remat against none on the card
    within REMAT_TOL, bf16 against none printed; and for one step at B = 10
    and T in RESIDUAL_T, the memory the forward holds for its backward and
    the step's peak (``torch.cuda.max_memory_allocated``) beside the
    predicted residual bytes.  Returns ({row: launches}, numbers)."""
    import dataclasses

    import torch

    from ip_avsr_torch.device import tree_map
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.train import trainer

    totals, numbers = {name: 0 for name in KERNEL_COUNTERS}, {}
    cfg4, training4 = oulu_4stream()
    models = (("flagship", flagship(dropout=False), 1e-4,
               dict(lstm_fwd_train=5, lstm_bwd=5, delta=1)),
              ("4-stream", cfg4, training4.learning_rate,
               dict(lstm_peep_fwd_train=6, lstm_peep_bwd=6, delta=1)))
    MiB = 2 ** 20
    for k, (label, cfg, lr, per_step) in enumerate(models):
        params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 70 + k), cfg,
                                           device=dev)
        streams, mask, y = stream_batch(cfg, TRAIN_B, SEED + 70 + k, dev)
        grads = {}
        for setting, fields in RESIDUAL_SETTINGS.items():
            c = dataclasses.replace(cfg, **fields)
            reset_launches()
            grads[setting], numbers[f"{label} {setting}"] = step_against_cpu(
                f"residuals, {label} {setting}", c, params, streams, y, mask,
                grad_tol=BF16_STEP_TOL if "bf16" in setting else TRAIN_GRAD_TOL)
            runs = 1  # the gradients of the comparison
            opt, step = trainer.make_train_step(c, lr=lr)
            mem = {}
            for T in RESIDUAL_T:
                batch = stream_batch(c, TRAIN_B, SEED + 72, dev, T=T)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                tracked = tree_map(lambda t: t.detach().requires_grad_(True), params)
                loss = trainer.loss_fn(tracked, c, batch[0], batch[2], batch[1])
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated() - base
                loss.backward()
                del loss, tracked
                torch.cuda.synchronize()
                state = opt.init(params)
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                step(params, state, batch[0], batch[2], batch[1])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                del state, batch
                runs += 2
                mem[T] = dict(predicted_mib=residual_bytes(c, TRAIN_B, T, setting) / MiB,
                              held_mib=held / MiB, step_peak_mib=peak / MiB)
            launches = read_launches()
            count_into(totals, launches)
            expect_launches(launches, **{r: n * runs for r, n in per_step.items()})
            numbers[f"{label} {setting}"]["memory"] = mem
            print(f"residuals, {label} {setting}: " + "; ".join(
                f"T={T}: predicted residual stacks {m['predicted_mib']:.1f} MiB, held by the "
                f"forward {m['held_mib']:.1f} MiB, step peak above the parameters "
                f"{m['step_peak_mib']:.1f} MiB" for T, m in mem.items())
                + f" (B={TRAIN_B}; {smi('name,power.limit')})")
        for setting in ("remat", "bf16", "remat+bf16"):
            rel = max(max_err(a, b)[0] / max(b.abs().max().item(), 1e-30)
                      for (path, a), (_, b) in zip(named_leaves(grads[setting]),
                                                   named_leaves(grads["none"]))
                      if path not in zero_grad_biases(cfg))
            numbers[f"{label} {setting}"]["vs_none"] = rel
            print(f"residuals, {label}: {setting} against none on the card, gradients worst "
                  f"{rel:.2e} of max abs")
            if setting == "remat" and not rel <= REMAT_TOL:
                raise AssertionError(f"residuals, {label}: remat moved the gradients {rel:.2e}")
        del params, grads
    print(f"residuals: launches over the phase {totals}")
    return totals, numbers


# phase_pretrain: pretraining on the card at full width.  The corpus has
# OuluVS's size at its pixel width: 26 x 44 = 1144 uint8 pixels, 20 subjects
# x 10 phrases x 5 repetitions of 5-29 frames (about 17k frames, 78 MB as
# float32), a band of columns per phrase brighter, iterVec the repetition
# (1 and 2 train, as the reference's split); the conv-AE's corpus is the
# same utterances at 60 x 80, so that cli.convae resizes them to 30 x 40.
PRETRAIN_CORPUS = dict(subjects=20, phrases=10, repetitions=5)
CONVAE_IMAGESIZE = (60, 80)
# cli.pretrain_dbn on the reference's dbnParamsInit schedule, uncut
DBN_HIDDEN = (2000, 1000, 500, 50)
DBN_ARGS = ["--hidden", ",".join(str(h) for h in DBN_HIDDEN),
            "--activations", "sigm,sigm,sigm,linear", "--epochs", "10", "--batchsize", "100"]
# cli.ae_finetuner (8 layers, adadelta, batch 128) cut to 2 of its 30
# epochs; cli.convae (batch 128) to 1 of its 25 per variant; train_sde to 1
# of its 20 per layer
AE_FT_EPOCHS = 2
CONVAE_EPOCHS = 1
SDE_EPOCHS = 1
PRETRAIN_B = 128
# card against the port's CPU path: one CD-1 step's state and velocity
# (absolute; the step moves entries by about 1e-3) when no Bernoulli state
# flipped; a CD epoch's mean error per sample, relative, after the states
# that flipped let the runs diverge legitimately (a band: the reference
# draws differ anyway); the conv-AE forward relative to max(1, max |ref|)
CD_STEP_TOL = 1e-5
CD_EPOCH_BAND = 1e-4
CONVAE_FWD_TOL = 1e-4
# a conv-AE step, card vs CPU, relative to each gradient's max abs: in
# float64, the semantics (free of rounding); in float32, cuDNN's precision:
# the algorithm it picks for conv3's weight gradient (5 x 5, 100 -> 150
# channels) lay 3.4e-3 from its own float64 step, where PyTorch's CUDA
# convolution without cuDNN lay 1.1e-6 and the CPU 2.1e-6 (B = 32, NVIDIA
# H100 80GB HBM3, 700 W; convae_check prints these); a pooling window
# rerouted by rounding moved a gradient 1.3e-3
CONVAE_F64_TOL = 1e-10
CUDNN_GRAD_TOL = 1e-2
CONVAE_CHECK_B = 32


def pretrain_utterances(seed=SEED):
    """(lengths, subjects, phrases, repetitions) of the utterances of
    :data:`PRETRAIN_CORPUS`, one per (subject, phrase, repetition)."""
    import numpy as np

    c = PRETRAIN_CORPUS
    S, P, R = c["subjects"], c["phrases"], c["repetitions"]
    lens = np.random.RandomState(seed).randint(5, T_FRAMES + 1, S * P * R)
    subjects = np.repeat(np.arange(1, S + 1), P * R)
    phrases = np.tile(np.repeat(np.arange(1, P + 1), R), S)
    reps = np.tile(np.arange(1, R + 1), S * P)
    return lens, subjects, phrases, reps


def write_pretrain_corpus(path, imagesize, seed=SEED):
    """Write the utterances of :func:`pretrain_utterances` as uint8 frames of
    ``imagesize`` (a band of columns per phrase brighter) in the ``.mat``
    schema with ``iterVec``; returns the frame count."""
    import numpy as np

    from ip_avsr_torch.io import matio

    lens, subjects, phrases, reps = pretrain_utterances(seed)
    pixels = imagesize[0] * imagesize[1]
    cls = np.repeat(phrases - 1, lens)
    rng = np.random.RandomState(seed + 1)
    images = rng.randint(0, 192, (len(cls), pixels), dtype=np.uint8)
    band = (np.arange(pixels)[None, :] * PRETRAIN_CORPUS["phrases"] // pixels) == cls[:, None]
    np.add(images, 63, out=images, where=band)
    matio.save_mat({"dataMatrix": images, "targetsVec": np.repeat(phrases, lens)[:, None],
                    "subjectsVec": subjects[:, None], "videoLengthVec": lens[:, None],
                    "iterVec": reps[:, None]}, path)
    return len(cls)


def run_main(label, main, argv, keep=("epoch", "saved", "Pretraining", "Error", "Traceback")):
    """Run a CLI's ``main(argv)`` in-process with its launches counted from
    0; print the report lines that hold a word of ``keep``; return (its
    wall seconds, its launches)."""
    import torch

    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            main(argv)
        torch.cuda.synchronize()
    finally:
        lines = out.getvalue().splitlines()
        for line in lines:
            if any(k in line for k in keep):
                print(f"  {label}: {line.strip()}")
    return time.perf_counter() - t0, read_launches()


def cd_step_cost(B, d, h):
    """(bytes, operations) of one CD-1 step: reads the batch, the draw, W,
    its velocity and the biases and theirs once, writes W, the velocity,
    the biases and theirs once; five (B, d, h) products (up, down, up
    again, the two outer products) and the updates' elementwise work."""
    nbytes = 4 * (B * d + B * h + 2 * d * h + 2 * (d + h)) + 4 * (2 * d * h + 2 * (d + h) + 1)
    flops = 5 * 2 * B * d * h + 10 * B * (d + h) + 6 * d * h
    return nbytes, flops


def cd_check(dev, x, numbers):
    """Layer 1 on the card against the CPU path with the same draws, drawn
    once on the CPU: one CD-1 step (B = 100, the flips counted, the update
    held to CD_STEP_TOL with none), then one epoch in the same order (its
    mean error held to CD_EPOCH_BAND)."""
    import torch

    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.pretrain import rbm

    hyper, h = rbm.RBMHyperParams(), DBN_HIDDEN[0]
    lrs = hyper.rates_for("sigm", "sigm")
    B, (n, d) = hyper.batchsize, x.shape
    gen = torch.Generator().manual_seed(SEED + 90)
    state = rbm.init_rbm(gen, d, h, "sigm", "sigm")
    batch = x[:B]
    u = torch.rand((B, h), generator=gen)
    runs = {}
    for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
        s = tree_to({k: v.clone() for k, v in state.items()}, device)
        vel = {k: torch.zeros_like(v) for k, v in s.items()}
        probs = rbm.rbm_up(batch.to(device), s["weights"], s["hidbiases"], "sigm")[0].cpu()
        err = rbm.cd1_step(s, vel, batch.to(device), hyper.init_momentum, lrs, vl_type="sigm",
                           hl_type="sigm", cd_type=1, batchsize=B, noise=(u.to(device), None))
        runs[where] = (probs, tree_to(s, "cpu"), tree_to(vel, "cpu"), err.item())
    flips = int(((runs["card"][0] > u) != (runs["cpu"][0] > u)).sum())
    gap = (runs["card"][0] - u).abs().min().item()
    step_err = max(max_err(runs["card"][i][k], runs["cpu"][i][k])[0]
                   for i in (1, 2) for k in state)
    rel = abs(runs["card"][3] - runs["cpu"][3]) / runs["cpu"][3]
    print(f"pretrain, CD-1 step card vs CPU (layer 1, B = {B}, {d} -> {h}, the same draws): "
          f"{flips} of {B * h} hidden states flipped (smallest |probs - u| {gap:.3g}); state "
          f"and velocity {step_err:.3g} apart (tolerance {CD_STEP_TOL:g} with no flip), error "
          f"{rel:.3g} relative")
    if flips == 0 and step_err > CD_STEP_TOL:
        raise AssertionError(f"pretrain: the CD-1 step on the card is {step_err:.3g} from the "
                             f"CPU path with no state flipped")
    numbers["cd_step"] = dict(flips=flips, smallest_gap=gap, max_abs_err=step_err,
                              err_rel=rel)

    # one epoch in one order with one set of draws, each uploaded per step
    order = torch.randperm(n, generator=gen)
    draws = [torch.rand((min(B, n - s), h), generator=gen) for s in range(0, n, B)]
    draw = rbm.draw_cd1_noise
    epoch = {}
    try:
        for where, device in (("cpu", torch.device("cpu")), ("card", dev)):
            feed = iter(draws)
            rbm.draw_cd1_noise = lambda *a, _d=device, **kw: (next(feed).to(_d), None)
            s = tree_to({k: v.clone() for k, v in state.items()}, device)
            vel = {k: torch.zeros_like(v) for k, v in s.items()}
            err = rbm.rbm_epoch(s, vel, x.to(device), order.to(device), hyper.init_momentum,
                                lrs, None, vl_type="sigm", hl_type="sigm", cd_type=1,
                                batchsize=B, weight_penalty_l2=hyper.weight_penalty_l2)
            epoch[where] = (err.item() / n, s["weights"].cpu())
    finally:
        rbm.draw_cd1_noise = draw
    rel = abs(epoch["card"][0] - epoch["cpu"][0]) / epoch["cpu"][0]
    w_err = max_err(epoch["card"][1], epoch["cpu"][1])[0]
    print(f"pretrain, a CD epoch card vs CPU (layer 1, {len(draws)} steps, the same order "
          f"and draws): mean error {epoch['card'][0]:.6f} against {epoch['cpu'][0]:.6f}, "
          f"{rel:.3g} relative (band {CD_EPOCH_BAND:g}); weights {w_err:.3g} apart at most")
    if rel > CD_EPOCH_BAND:
        raise AssertionError(f"pretrain: a CD epoch's error on the card is {rel:.3g} from the "
                             f"CPU path's")
    numbers["cd_epoch"] = dict(err_rel=rel, weights_max_abs=w_err, steps=len(draws))


def ae_check(dev, weights, biases, x, numbers):
    """One AE-finetune epoch (deterministic) of the finetuned 8-layer AE on
    the card against the CPU path on the rows ``x`` (20 batches of 128, as
    cli.ae_finetuner preprocesses them): the epoch's loss within
    FIT_COST_TOL relative, every layer within FIT_PARAM_TOL of its max
    abs."""
    import torch

    from ip_avsr_torch.pretrain import finetune

    acts = ["sigmoid"] * 3 + ["linear"] + ["sigmoid"] * 3 + ["linear"]
    runs = {}
    for where, device in (("cpu", "cpu"), ("card", dev)):
        logs = []
        runs[where] = (finetune.finetune_autoencoder(weights, biases, acts, x, epochs=1,
                                                     batchsize=PRETRAIN_B, log_fn=logs.append,
                                                     device=device),
                       float(logs[-1].rsplit("= ", 1)[1]))
    loss_rel = abs(runs["card"][1] - runs["cpu"][1]) / runs["cpu"][1]
    worst = max(float(abs(a - b).max() / abs(b).max())
                for a, b in zip(runs["card"][0][0] + runs["card"][0][1],
                                runs["cpu"][0][0] + runs["cpu"][0][1]))
    print(f"pretrain, an AE-finetune epoch card vs CPU (8 layers, 20 steps of {PRETRAIN_B}): "
          f"loss {runs['card'][1]:.6f} against {runs['cpu'][1]:.6f} ({loss_rel:.3g} relative, "
          f"printed digits), worst layer {worst:.3g} of its max abs")
    if loss_rel > FIT_COST_TOL or worst > FIT_PARAM_TOL:
        raise AssertionError("pretrain: the AE-finetune epoch on the card disagrees with the "
                             "CPU path")
    numbers["ae_epoch"] = dict(loss_rel=loss_rel, worst_rel=worst)


def convae_check(dev, images, numbers):
    """The conv-AE, plain and batchnorm, on the card against the CPU path
    from the same parameters and batch of CONVAE_CHECK_B images.  In float64
    (the semantics, free of rounding): every gradient and adadelta update
    within CONVAE_F64_TOL of its max abs.  In float32: the forward within
    CONVAE_FWD_TOL, the loss within TRAIN_LOSS_TOL relative, every gradient
    within CUDNN_GRAD_TOL of its max abs and the update (lr 0.8, whose first
    step moves an entry by at most lr times its gradient's change) within
    lr CUDNN_GRAD_TOL; each device's own float32 error against its float64
    step is printed beside it, and so is the card's float32 error with
    cuDNN switched off (PyTorch's own CUDA convolutions), for reference.
    A bias that batch norm follows has an exact
    gradient of zero and is held absolute (TRAIN_GRAD_TOL in float32).
    Pooling windows that route a gradient to another input on the card than
    on the CPU (a window's top two values within rounding) are counted
    from the pooling indices."""
    import torch
    import torch.nn.functional as F

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import convae
    from ip_avsr_torch.pretrain import finetune
    from ip_avsr_torch.train import optimizers

    lr = 0.8
    x = torch.as_tensor(images[:CONVAE_CHECK_B])
    pool = convae._maxpool
    cpu, f32, f64 = torch.device("cpu"), torch.float32, torch.float64
    for variant in ("plain", "batchnorm"):
        cfg = convae.ConvAEConfig(use_batchnorm=variant == "batchnorm")
        zero_grad = ({f"/{name}/b" for name in ("conv1", "conv3", "conv5", "dense7")}
                     if cfg.use_batchnorm else set())
        params = convae.init_convae_params(torch.Generator().manual_seed(SEED + 91), cfg)
        runs = {}
        for key in ((cpu, f32), (dev, f32), (cpu, f64), (dev, f64), ("no cudnn", f32)):
            device, dtype = (dev, key[1]) if key[0] == "no cudnn" else key
            indices = []

            def recorded(h, pad_h=0, _indices=indices):
                y, i = F.max_pool2d(h, 2, 2, padding=(pad_h, 0), return_indices=True)
                _indices.append(i.cpu())
                return y

            p = tree_map(lambda v: v.to(device, dtype), params)
            xb = x.to(device, dtype)
            with torch.no_grad():
                fwd = convae.convae_forward(p, cfg, xb).cpu()
            convae._maxpool = recorded
            torch.backends.cudnn.enabled = key[0] != "no cudnn"
            try:
                loss, grads = finetune.value_and_grad(finetune._convae_loss, p, xb, cfg, None)
            finally:
                convae._maxpool = pool
                torch.backends.cudnn.enabled = True
            opt = optimizers.adadelta(lr)
            new, _ = opt.apply(p, grads, opt.init(p))
            runs[key] = dict(fwd=fwd, loss=loss.item(), indices=indices,
                             grads=dict(named_leaves(tree_to(grads, "cpu"))),
                             new=dict(named_leaves(tree_to(new, "cpu"))))

        def gaps(a, b, zero_tol):
            """{path: (gradient gap, update gap)} of runs ``a`` against ``b``,
            relative to the gradient's max abs in ``b`` (a zero-gradient
            bias: absolute, over ``zero_tol``)."""
            out = {}
            for path, ref in b["grads"].items():
                scale = zero_tol if path in zero_grad else max(ref.abs().max().item(), 1e-300)
                out[path] = (max_err(a["grads"][path].double(), ref.double())[0] / scale,
                             max_err(a["new"][path].double(), b["new"][path].double())[0]
                             / (lr * scale))
            return out

        card, host = runs[(dev, f32)], runs[(cpu, f32)]
        exact = gaps(runs[(dev, f64)], runs[(cpu, f64)], 1.0)
        single = gaps(card, host, 1.0)
        card_own = gaps(card, runs[(dev, f64)], 1.0)
        host_own = gaps(host, runs[(cpu, f64)], 1.0)
        native_own = gaps(runs[("no cudnn", f32)], runs[(dev, f64)], 1.0)
        fwd_err = max_err(card["fwd"], host["fwd"])[1]
        loss_rel = abs(card["loss"] - host["loss"]) / host["loss"]
        reroutes = sum(int((a != b).sum()) for a, b in zip(card["indices"], host["indices"]))
        worst = lambda d, i=0: max(d, key=lambda k: d[k][i])  # noqa: E731
        w64, w32 = worst(exact), worst({k: v for k, v in single.items() if k not in zero_grad})
        print(f"pretrain, conv-AE {variant} card vs CPU (B = {CONVAE_CHECK_B}): float64 "
              f"gradients {exact[w64][0]:.3g} of their max abs (at {w64}), updates "
              f"{max(v[1] for v in exact.values()):.3g}; float32 forward {fwd_err:.3g} "
              f"(relative to max(1, max |ref|)), loss {loss_rel:.3g} relative, gradients "
              f"{single[w32][0]:.3g} of their max abs at {w32} (the card's own float32 error "
              f"there {card_own[w32][0]:.3g}, without cuDNN {native_own[w32][0]:.3g}, the "
              f"CPU's {host_own[w32][0]:.3g}), updates "
              f"{max(v[1] for v in single.values()):.3g}; zero-gradient biases "
              f"{sorted(zero_grad)} at most {max([single[p][0] for p in zero_grad] or [0]):.3g} "
              f"absolute; pooling windows routed apart: {reroutes}")
        ok = (max(max(v) for v in exact.values()) <= CONVAE_F64_TOL
              and fwd_err <= CONVAE_FWD_TOL and loss_rel <= TRAIN_LOSS_TOL
              and all(max(v) <= (TRAIN_GRAD_TOL if k in zero_grad else CUDNN_GRAD_TOL)
                      for k, v in single.items()))
        if not ok:
            raise AssertionError(f"pretrain: the conv-AE {variant} on the card disagrees with "
                                 f"the CPU path")
        numbers[f"convae_{variant}_check"] = dict(
            f64_grad_rel=exact[w64][0], fwd_err=fwd_err, loss_rel=loss_rel,
            f32_grad_rel=single[w32][0], f32_grad_at=w32, card_own_f32=card_own[w32][0],
            no_cudnn_own_f32=native_own[w32][0], cpu_own_f32=host_own[w32][0],
            reroutes=reroutes)


def phase_pretrain(dev):
    """Pretraining at full width on the card, through the CLIs a user runs:
    ``cli.pretrain_dbn`` (RBM CD-1, greedy stacking, unfolding, the w1..w8
    ``.mat``) on the frames of a corpus of OuluVS's size, ``cli.ae_finetuner``
    on that ``.mat``, ``cli.trimodal`` trained from the finetuned ``.mat``
    (one autoencoder serves the raw and the diff stream; rows 1-4 counted as
    in phase_cli), ``cli.convae`` for the four variants on the same
    utterances at 60 x 80, and ``pretrain.sde.train_sde``; every
    pretraining run launches no ported row.  Then layer 1's CD-1 step and
    epoch, an AE-finetune epoch and the conv-AE's forward and step on the
    card against the CPU path; the times per CD epoch and layer, CD steps/s,
    a traced CD epoch's host launch calls per step and busy share, the CD
    step's bound, AE, conv-AE and SDE times and the peak memory.  Returns
    ({row: launches}, numbers)."""
    import tempfile

    import numpy as np
    import torch

    from ip_avsr_torch.cli import ae_finetuner, pretrain_dbn, trimodal
    from ip_avsr_torch.cli import convae as convae_cli
    from ip_avsr_torch.data import preprocessing as pp
    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.io import matio
    from ip_avsr_torch.models import convae
    from ip_avsr_torch.pretrain import finetune, rbm, sde

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pretrain_")
    numbers, totals = {}, {name: 0 for name in KERNEL_COUNTERS}
    device = dev.type

    def no_launches(label, launches):
        expect_launches(launches)
        print(f"pretrain, {label}: no ported row launched ({launches})")

    try:
        frames_mat, frames60_mat = (os.path.join(tmp, f"{k}.mat") for k in ("frames",
                                                                          "frames60"))
        t0 = time.perf_counter()
        n = write_pretrain_corpus(frames_mat, IMAGE_SHAPE)
        write_pretrain_corpus(frames60_mat, CONVAE_IMAGESIZE)
        numbers["write_s"] = time.perf_counter() - t0
        print(f"pretrain: corpus {PRETRAIN_CORPUS} ({n} frames of {IMAGE_SHAPE} and of "
              f"{CONVAE_IMAGESIZE}), written in {numbers['write_s']:.2f} s "
              f"({(os.path.getsize(frames_mat) + os.path.getsize(frames60_mat)) / 1e6:.1f} MB)")

        # cli.pretrain_dbn, every CD epoch timed on the card
        epochs, rbm_epoch = [], rbm.rbm_epoch

        def timed_epoch(state, velocity, data, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = rbm_epoch(state, velocity, data, *a, **kw)
            torch.cuda.synchronize()
            epochs.append((tuple(state["weights"].shape), time.perf_counter() - t,
                           -(-data.shape[0] // kw["batchsize"])))
            return out

        dbn_mat = os.path.join(tmp, "dbn.mat")
        rbm.rbm_epoch = timed_epoch
        try:
            wall, launches = run_main("pretrain_dbn", pretrain_dbn.main, [
                "--data", frames_mat, *DBN_ARGS, "--out", dbn_mat, "--device", device],
                keep=("Pretraining", "epoch 10", "saved"))
        finally:
            rbm.rbm_epoch = rbm_epoch
        no_launches("pretrain_dbn", launches)
        layers = {}
        for shape, seconds, steps in epochs:
            layers.setdefault(shape, []).append((seconds, steps))
        numbers["dbn"] = {"wall_s": wall, "layers": {}}
        for shape, runs in layers.items():
            secs = [s for s, _ in runs]
            steps = runs[0][1]
            numbers["dbn"]["layers"][f"{shape[0]}-{shape[1]}"] = dict(
                epochs=len(runs), steps_per_epoch=steps, epoch_s=statistics.median(secs),
                first_epoch_s=secs[0], steps_per_s=steps / statistics.median(secs))
            print(f"pretrain, pretrain_dbn layer {shape[0]}-{shape[1]}: {len(runs)} epochs of "
                  f"{steps} CD steps, median epoch {statistics.median(secs) * 1e3:.1f} ms "
                  f"(first {secs[0] * 1e3:.1f} ms), {steps / statistics.median(secs):.0f} CD "
                  f"steps/s")
        print(f"pretrain, pretrain_dbn: CLI wall {wall:.2f} s; {smi('name,power.limit')}")

        # a traced CD epoch of layer 1 (the first step's shapes: B = 100, 1144 -> 2000)
        x = torch.as_tensor(matio.load_mat_file(frames_mat)["dataMatrix"].astype(np.float32))
        x = torch.as_tensor(rbm.normalise_data("sigm", x.numpy())[0])
        hyper, h1 = rbm.RBMHyperParams(), DBN_HIDDEN[0]
        B, d = hyper.batchsize, x.shape[1]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state = tree_to(rbm.init_rbm(torch.Generator().manual_seed(SEED), d, h1, "sigm",
                                     "sigm"), dev)
        vel = {k: torch.zeros_like(v) for k, v in state.items()}
        xd, order = x.to(dev), torch.randperm(n, device=dev, generator=gen)
        lrs, steps = hyper.rates_for("sigm", "sigm"), -(-n // B)

        def cd_epoch():
            return rbm.rbm_epoch(state, vel, xd, order, hyper.init_momentum, lrs, gen,
                                 vl_type="sigm", hl_type="sigm", cd_type=1, batchsize=B,
                                 weight_penalty_l2=hyper.weight_penalty_l2)

        epoch_ms = host_median_ms(cd_epoch, calls=3, warmup=1)
        events = traced(cd_epoch, 1)
        kernels, calls = launch_counts(events, steps, "pretrain, a CD epoch of layer 1, per "
                                       "CD step", "no earlier count")
        _, busy_ms = busy_share(events, 1, epoch_ms, "pretrain, a CD epoch of layer 1", rows=10)
        nbytes, flops = cd_step_cost(B, d, h1)
        bound_ms, bound_by = bound(nbytes, flops)
        step_ms = epoch_ms / steps
        print(f"pretrain, CD step of layer 1 (B = {B}, {d} -> {h1}): {step_ms:.4f} ms on the "
              f"host clock ({epoch_ms:.1f} ms an epoch of {steps}), busy {busy_ms / steps:.4f} "
              f"ms on the card; bound {bound_ms:.5f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB)")
        numbers["cd_step_layer1"] = dict(
            epoch_ms=epoch_ms, step_ms=step_ms, busy_share=busy_ms / epoch_ms,
            device_ms_per_step=busy_ms / steps, kernels_per_step=kernels,
            launch_calls_per_step=calls, bound_ms=bound_ms, bound_by=bound_by)

        # cli.ae_finetuner on the unfolded DBN, then an AE step timed
        ft_mat = os.path.join(tmp, "ae_finetuned.mat")
        wall, launches = run_main("ae_finetuner", ae_finetuner.main, [
            "--ae", dbn_mat, "--data", frames_mat, "--epochs", str(AE_FT_EPOCHS),
            "--batchsize", str(PRETRAIN_B), "--out", ft_mat, "--device", device])
        no_launches("ae_finetuner", launches)
        weights, biases = matio.load_dbn_mat(ft_mat, n_layers=8)
        acts = ["sigmoid"] * 3 + ["linear"] + ["sigmoid"] * 3 + ["linear"]
        params = finetune.ae_params_from_lists(weights, biases, dev)
        opt = finetune.opt_lib.adadelta()
        opt_state = opt.init(params)
        batch = xd[:PRETRAIN_B]

        def ae_step():
            _, grads = finetune.value_and_grad(finetune._ae_loss, params, batch, acts, 0.005)
            opt.apply(params, grads, opt_state)

        numbers["ae"] = dict(wall_s=wall, step_ms=host_median_ms(ae_step))
        print(f"pretrain, ae_finetuner: {AE_FT_EPOCHS} epochs, CLI wall {wall:.2f} s; a step "
              f"at B = {PRETRAIN_B} {numbers['ae']['step_ms']:.3f} ms (host clock)")

        # cli.trimodal from the finetuned autoencoder, rows 1-4 counted
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        paths = write_cli_corpus(cli_dir)
        ini = os.path.join(tmp, "trimodal.ini")
        write_cli_ini(ini, "trimodal", cli_sets("trimodal", paths) + [
            ("models", "ae_pretrained", ft_mat), ("models", "ae_diff_pretrained", ft_mat)] + [
            ("training", k, v) for k, v in FIT_CUTS.items()])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result, rec = run_cli(trimodal.main, ["--config", ini, "--device", device])
        steps_fit, evals = fit_forwards(result, FIT_CUTS["epochsize"])
        expect_launches(rec["launches"], lstm_fwd_train=5 * steps_fit, lstm_bwd=5 * steps_fit,
                        lstm_fwd=5 * evals, delta=steps_fit + evals)
        for row, k in rec["launches"].items():
            totals[row] += k
        enc = rec["params0"]["streams"]
        for stream in ("raw", "diff"):
            for i, name in enumerate(("fc1", "fc2", "fc3", "bottleneck")):
                if not np.array_equal(enc[stream]["encoder"][name]["w"].numpy(), weights[i]):
                    raise AssertionError(f"pretrain: the {stream} encoder's {name} is not the "
                                         f"finetuned .mat's w{i + 1}")
        if not np.isfinite(result.cost_train + result.cost_val).all():
            raise AssertionError("pretrain: the trimodal fit's costs are not finite")
        numbers["trimodal"] = {k: rec[k] for k in ("load_s", "init_s", "prep_s", "fit_s",
                                                   "wall_s")}
        print(f"pretrain, trimodal from the finetuned AE (one AE for the raw and the diff "
              f"stream): {result.epochs_run} epochs, {steps_fit} steps, {evals} evaluation "
              f"forwards, costs {[round(float(c), 4) for c in result.cost_val]} (val); "
              f"launches {rec['launches']}; fit {rec['fit_s']:.2f} s, CLI wall "
              f"{rec['wall_s']:.2f} s")

        # cli.convae, the four variants from 60 x 80 frames, then their steps timed
        numbers["convae"] = {}
        train_X = None
        for variant in ("plain", "batchnorm", "dropout", "bndrop"):
            pkl = os.path.join(tmp, f"convae_{variant}.pkl")
            wall, launches = run_main(f"convae {variant}", convae_cli.main, [
                "--data", frames60_mat, "--model", variant, "--epochs", str(CONVAE_EPOCHS),
                "--batchsize", str(PRETRAIN_B), "--out", pkl, "--device", device])
            no_launches(f"convae {variant}", launches)
            saved = matio.load_model(pkl)
            if not np.isfinite(saved["history"]).all():
                raise AssertionError(f"pretrain: convae {variant}'s loss is not finite")
            cfg = convae.ConvAEConfig(**saved["config"])
            if train_X is None:
                data = matio.load_mat_file(frames60_mat)
                split = pp.create_split_index(len(data["dataMatrix"]),
                                              data["videoLengthVec"], data["iterVec"])
                train_X = pp.normalize_input(pp.resize_images(
                    data["dataMatrix"][split][:PRETRAIN_B]).astype(np.float32))
            p = tree_to(convae.init_convae_params(torch.Generator().manual_seed(SEED), cfg),
                        dev)
            opt = finetune.opt_lib.adadelta(0.8)
            opt_state, xb = opt.init(p), torch.as_tensor(train_X).to(dev)
            g = torch.Generator(device=dev).manual_seed(SEED)

            def convae_step():
                _, grads = finetune.value_and_grad(finetune._convae_loss, p, xb, cfg, g)
                opt.apply(p, grads, opt_state)

            numbers["convae"][variant] = dict(wall_s=wall, loss=saved["history"][0],
                                              step_ms=host_median_ms(convae_step, calls=10))
            print(f"pretrain, convae {variant}: CLI wall {wall:.2f} s, epoch loss "
                  f"{saved['history'][0]:.6f}; a step at B = {PRETRAIN_B} "
                  f"{numbers['convae'][variant]['step_ms']:.3f} ms (host clock)")

        # the stacked denoising AE, one epoch per layer timed
        sde_times, layer = [], sde.train_denoising_layer

        def timed_layer(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = layer(*a, **kw)
            torch.cuda.synchronize()
            sde_times.append(time.perf_counter() - t)
            return out

        sde.train_denoising_layer = timed_layer
        reset_launches()
        try:
            logs = []
            t0 = time.perf_counter()
            sde_w, _ = sde.train_sde(SEED, x, DBN_HIDDEN, epochs=SDE_EPOCHS,
                                     batchsize=PRETRAIN_B, log_fn=logs.append, device=dev)
            sde_wall = time.perf_counter() - t0
        finally:
            sde.train_denoising_layer = layer
        no_launches("train_sde", read_launches())
        if not all(np.isfinite(w).all() for w in sde_w):
            raise AssertionError("pretrain: the SDE weights are not finite")
        numbers["sde"] = dict(wall_s=sde_wall, layer_epoch_s=sde_times)
        print(f"pretrain, train_sde {x.shape[1]} -> {DBN_HIDDEN}: {SDE_EPOCHS} epoch per "
              f"layer, {[round(t, 3) for t in sde_times]} s; last {logs[-1]}")

        # the card against the CPU path
        t0 = time.perf_counter()
        cd_check(dev, x, numbers)
        data = matio.load_mat_file(frames_mat)
        split = pp.create_split_index(n, data["videoLengthVec"], data["iterVec"])
        ae_check(dev, weights, biases, pp.normalize_input(
            data["dataMatrix"][split][:20 * PRETRAIN_B].astype(np.float32)), numbers)
        convae_check(dev, train_X, numbers)
        numbers["checks_s"] = time.perf_counter() - t0
        print(f"pretrain: the card against the CPU path took {numbers['checks_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"pretrain: peak memory {numbers['peak_mib']:.0f} MiB; phase {numbers['phase_s']:.1f} "
          f"s; launches {totals}; {smi('name,power.limit')}")
    return totals, numbers


# phase_tools: cli.parity_check's rehearsal at AVLetters' full shape
# (configs/avletters_1stream.ini: 780 utterances of 30 x 40 pixels, the
# 1200-2000-1000-500-50 encoder, a BLSTM of H = 250, 26 classes) on the
# INI's whole schedule (30 epochs of 20 steps at batch 26, Adam at lr 1e-4,
# validation window 6); its fit launches per train step rows 3 and 4 once
# per recurrence and row 2 once, per evaluation forward row 1 once per
# recurrence and row 2 once
AVLETTERS_INI = os.path.join("configs", "avletters_1stream.ini")
# the card against the CPU path: 2 epochs of the same corpus and schedule
TOOLS_CHECK_EPOCHS = 2
# the full rehearsal's test rate must stand above this floor: chance is
# 1/26 = 0.038, and the JAX package's own rehearsal test holds 0.15 at
# scale 0.1 after 8 epochs (tests/test_cli_and_checkpoints.py)
REHEARSAL_CR_FLOOR = 0.15
# interleaved turns of the three readers over a corpus's files
READER_TURNS = 5


def same_as_scipy(path, got):
    """Raise unless ``got`` (a native reader's dict) holds the arrays of
    ``scipy.io.loadmat(path)`` bit for bit: names, dtypes, shapes, Fortran
    order, values.  Returns the number of arrays."""
    import numpy as np
    import scipy.io as sio

    ref = {k: v for k, v in sio.loadmat(path).items() if not k.startswith("__")}
    got = {k: v for k, v in got.items() if not k.startswith("__")}
    if sorted(got) != sorted(ref):
        raise AssertionError(f"{path}: native keys {sorted(got)}, scipy {sorted(ref)}")
    for k, r in ref.items():
        g = got[k]
        if not (g.dtype == r.dtype and g.shape == r.shape
                and g.flags["F_CONTIGUOUS"] == r.flags["F_CONTIGUOUS"]
                and np.array_equal(g, r)):
            raise AssertionError(f"{path}: {k} native {g.dtype}{g.shape} against scipy "
                                 f"{r.dtype}{r.shape}, or their values or order differ")
    return len(ref)


def reader_turns(label, paths):
    """Hold the native reader to scipy on every file of ``paths``, then time
    ``scipy.io.loadmat`` over the files one after another, the native
    reader likewise, and ``matio.load_mat_files`` (the native reader in its
    thread pool), in READER_TURNS interleaved turns in this process (the
    files sit in the page cache).  Prints and returns the medians."""
    import scipy.io as sio

    from ip_avsr_torch import native
    from ip_avsr_torch.io import matio

    arrays = sum(same_as_scipy(p, native.load_mat_native(p)) for p in paths)
    mb = sum(os.path.getsize(p) for p in paths) / 1e6
    readers = {"scipy": lambda: [sio.loadmat(p) for p in paths],
               "native": lambda: [native.load_mat_native(p) for p in paths],
               "load_mat_files": lambda: matio.load_mat_files(paths)}
    times = {k: [] for k in readers}
    for turn in range(READER_TURNS):
        for name in (list(readers) if turn % 2 == 0 else list(readers)[::-1]):
            t0 = time.perf_counter()
            readers[name]()
            times[name].append(time.perf_counter() - t0)
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"tools, .mat readers on {label} ({len(paths)} files, {arrays} arrays, {mb:.1f} MB; "
          f"every array equal to scipy's bit for bit, Fortran order included): median of "
          f"{READER_TURNS} interleaved turns, scipy {med['scipy']:.4f} s "
          f"({mb / med['scipy']:.0f} MB/s), native {med['native']:.4f} s "
          f"({mb / med['native']:.0f} MB/s), load_mat_files "
          f"{med['load_mat_files']:.4f} s ({mb / med['load_mat_files']:.0f} MB/s), "
          f"{os.cpu_count()} host cores; host clock, page cache warm; "
          f"{smi('name,power.limit')}")
    return dict(files=len(paths), arrays=arrays, mb=mb, seconds=med,
                mb_per_s={k: mb / v for k, v in med.items()})


def phase_tools(dev):
    """The last CLIs and the native ``.mat`` reader on the card's machine:
    ``cli.parity_check --rehearse`` at AVLetters' full shape on the INI's
    whole schedule (every launch counted: rows 1-4 and 2, none of rows 5-7;
    its test rate above REHEARSAL_CR_FLOOR); the same corpus for
    TOOLS_CHECK_EPOCHS epochs through ``cli.nstream`` on the card (its best
    parameters saved with ``--save_best``), again with the reader off
    (``IP_AVSR_NATIVE=0``) and with ``--device cpu`` (what reached
    ``Trainer.fit`` equal bit for bit, the fits within FIT_COST_TOL and
    FIT_PARAM_TOL); the native reader against scipy on the rehearsal's
    corpus, uncompressed and compressed, and on phase_cli's
    (:func:`reader_turns`); then
    ``cli.confusion_visualizer`` with the saved model and the resolved INI
    on the card (one forward over the 780 utterances, its launches counted;
    through ``main`` where the host has matplotlib, else through its device
    part ``evaluate``) against the same with ``--device cpu``.  Returns
    ({row: launches} summed over the phase's card runs, numbers)."""
    import tempfile

    import numpy as np
    import scipy.io as sio
    import torch

    from ip_avsr_torch.cli import confusion_visualizer, nstream, parity_check
    from ip_avsr_torch.train import config as config_lib

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    numbers, totals = {}, {name: 0 for name in KERNEL_COUNTERS}
    try:
        resolved = os.path.join(tmp, f"resolved_{os.path.basename(AVLETTERS_INI)}")
        cp = config_lib.load_config(os.path.join(ROOT, AVLETTERS_INI))
        recurrences = len(lstm_layer_sizes(config_lib.build_model_config(
            config_lib.parse_streams(cp), config_lib.parse_classifier(cp))))
        epochsize = config_lib.parse_training(cp).epochsize

        def counted(label, rec, result):
            """Hold a card fit's launches to the prediction; add them up."""
            steps, evals = fit_forwards(result, epochsize)
            expect_launches(rec["launches"], lstm_fwd_train=recurrences * steps,
                            lstm_bwd=recurrences * steps, lstm_fwd=recurrences * evals,
                            delta=steps + evals)
            for row, k in rec["launches"].items():
                totals[row] += k
            print(f"tools, {label}: {result.epochs_run} epochs, {steps} steps, {evals} "
                  f"evaluation forwards; launches {rec['launches']}: per step "
                  f"{recurrences} row 3, {recurrences} row 4, 1 row 2; per evaluation "
                  f"forward {recurrences} row 1, 1 row 2; rows 5-7 none")
            return steps, evals

        def quiet(fn, *args, keep=("Epoch", "CR:", "parity_check: writing", "WARNING",
                                   "misclassified", "Error", "Traceback")):
            out = io.StringIO()
            try:
                with contextlib.redirect_stdout(out):
                    return fn(*args)
            finally:
                for line in out.getvalue().splitlines():
                    if any(k in line for k in keep):
                        print(f"  {line.strip()}")

        # 1. the full-scale rehearsal on the card, the INI's whole schedule
        argv = ["--rehearse", "--rehearse-scale", "1.0", "--rehearse-dir", tmp,
                "--config", os.path.join(ROOT, AVLETTERS_INI), "--out",
                os.path.join(tmp, "parity_report.json"), "--device", "cuda"]
        report, rec = quiet(run_cli, parity_check.run, argv)
        result = rec["result"]
        steps, evals = counted("parity_check --rehearse (full scale)", rec, result)
        clock = rec["clock"].report("tools, parity_check --rehearse", rec["fit_entry"],
                                    epochsize)
        corpus = report["rehearsal_corpus"]
        data_mat = os.path.join(tmp, "allData_mouthROIs.mat")
        ae_mat = os.path.join(tmp, "avletters_ae_finetuned.mat")
        frames = int(sum(np.asarray(split[2]).sum() for split in rec["data"][::2]))
        numbers["rehearsal"] = dict(
            corpus=corpus, frames=frames, mb={os.path.basename(p): os.path.getsize(p) / 1e6
                                              for p in (data_mat, ae_mat)},
            epochs=result.epochs_run, steps=steps, evals=evals, test_cr=report["test_cr"],
            best_cr=report["best_cr"], best_val=report["best_val"],
            launches=rec["launches"], wall_s=rec["wall_s"], load_s=rec["load_s"],
            prep_s=rec["prep_s"], init_s=rec["init_s"], fit_s=rec["fit_s"], clock=clock)
        print(f"tools, parity_check --rehearse: {corpus['n_utterances']} utterances "
              f"({frames} frames of {corpus['dim']} pixels), encoder {corpus['encoder']}, "
              f"{numbers['rehearsal']['mb']} MB; test_cr {report['test_cr']:.4f} (floor "
              f"{REHEARSAL_CR_FLOOR}, chance {1 / 26:.4f}), best_cr {report['best_cr']:.4f}, "
              f"best val cost {report['best_val']:.5f}; .mat loads {rec['load_s']:.3f} s, "
              f"preprocessing and split {rec['prep_s']:.3f} s, model build "
              f"{rec['init_s']:.3f} s, fit {rec['fit_s']:.3f} s, CLI wall "
              f"{rec['wall_s']:.3f} s; {smi('name,power.limit')}")
        if not np.isfinite(result.cost_train + result.cost_val).all():
            raise AssertionError("tools: the rehearsal's costs are not finite")
        if not report["test_cr"] > REHEARSAL_CR_FLOOR:
            raise AssertionError(f"tools: the rehearsal's test_cr {report['test_cr']} is not "
                                 f"above {REHEARSAL_CR_FLOOR}")

        # 2. the same corpus, TOOLS_CHECK_EPOCHS epochs: the card (with the
        # native reader, then without it) against the CPU path
        best = os.path.join(tmp, "best.pkl")
        check = ["--config", resolved, "--split", "itervec", "--num_epoch",
                 str(TOOLS_CHECK_EPOCHS)]
        fits = {}
        for label, args, env in (("card", ["--save_best", best, "--device", "cuda"], "1"),
                                 ("card, IP_AVSR_NATIVE=0", ["--device", "cuda"], "0"),
                                 ("CPU", ["--device", "cpu"], "1")):
            held = os.environ.get("IP_AVSR_NATIVE")
            os.environ["IP_AVSR_NATIVE"] = env
            try:
                res, r = quiet(run_cli, nstream.main, check + args)
            finally:
                if held is None:
                    del os.environ["IP_AVSR_NATIVE"]
                else:
                    os.environ["IP_AVSR_NATIVE"] = held
            if label.startswith("card"):
                counted(f"nstream {TOOLS_CHECK_EPOCHS} epochs, {label}", r, res)
            fits[label] = (res, r)
            numbers[f"check, {label}"] = {k: r[k] for k in ("load_s", "prep_s", "init_s",
                                                            "fit_s", "wall_s")}
            print(f"tools, nstream {TOOLS_CHECK_EPOCHS} epochs on the rehearsal corpus, "
                  f"{label}: .mat loads {r['load_s']:.3f} s, preprocessing and split "
                  f"{r['prep_s']:.3f} s, model build {r['init_s']:.3f} s, fit {r['fit_s']:.3f} "
                  f"s, CLI wall {r['wall_s']:.3f} s; {smi('name,power.limit')}")
        (card, card_rec), (cpu, cpu_rec) = fits["card"], fits["CPU"]
        same_fit_inputs("tools, rehearsal corpus, card vs CPU", card_rec, cpu_rec)
        same_fit_inputs("tools, rehearsal corpus, native reader vs scipy (card)",
                        fits["card, IP_AVSR_NATIVE=0"][1], card_rec)
        compare_fits("tools, rehearsal corpus, card vs CPU", card, cpu,
                     len(cpu_rec["data"][1][2]),
                     adam=(1e-4, fit_forwards(card, epochsize)[0]))

        # 3. the native reader against scipy on the rehearsal's corpus and on
        # phase_cli's, timed
        cli_dir = os.path.join(tmp, "cli")
        os.makedirs(cli_dir)
        cli_paths = [p for p in write_cli_corpus(cli_dir).values() if p.endswith(".mat")]
        numbers["readers"] = {"rehearsal": reader_turns("the rehearsal corpus",
                                                        [data_mat, ae_mat]),
                              "phase_cli": reader_turns("phase_cli's corpus", cli_paths)}
        # savemat writes uncompressed; MATLAB's save (-v7) compresses with zlib
        zipped = []
        for path in (data_mat, ae_mat):
            zipped.append(path.replace(".mat", "_zlib.mat"))
            sio.savemat(zipped[-1], {k: v for k, v in sio.loadmat(path).items()
                                     if not k.startswith("__")}, do_compression=True)
        numbers["readers"]["rehearsal, compressed"] = reader_turns(
            "the rehearsal corpus compressed (as MATLAB's save -v7 writes it)", zipped)

        # 4. confusion_visualizer with the saved model on the card, then the CPU
        viz = ["--config", resolved, "--model", best, "--outdir", os.path.join(tmp, "viz"),
               "--max_renders", "2"]
        plots = importlib.util.find_spec("matplotlib") is not None
        print(f"tools, confusion_visualizer: matplotlib "
              f"{'present: main runs and renders' if plots else 'absent: its device part evaluate() runs, nothing is rendered'}")
        reset_launches()
        t0 = time.perf_counter()
        if plots:
            confusions, conf_mat = quiet(confusion_visualizer.main, viz + ["--device", "cuda"])
            pngs = sorted(os.listdir(os.path.join(tmp, "viz")))
        else:
            confusions, conf_mat, _ = quiet(confusion_visualizer.evaluate,
                                            confusion_visualizer.parse_args(
                                                viz + ["--device", "cuda"]))
            pngs = []
        torch.cuda.synchronize()
        viz_s = time.perf_counter() - t0
        launches = read_launches()
        expect_launches(launches, lstm_fwd=recurrences, delta=1)
        for row, k in launches.items():
            totals[row] += k
        cpu_conf, cpu_mat, _ = quiet(confusion_visualizer.evaluate,
                                     confusion_visualizer.parse_args(viz + ["--device", "cpu"]))
        if cpu_conf != confusions or not np.array_equal(cpu_mat, conf_mat):
            raise AssertionError("tools: confusion_visualizer's confusions on the card differ "
                                 "from the CPU path's")
        numbers["confusion_visualizer"] = dict(
            utterances=int(conf_mat.sum()), misclassified=len(confusions), wall_s=viz_s,
            launches=launches, rendered=pngs)
        print(f"tools, confusion_visualizer on the card: one forward over "
              f"{int(conf_mat.sum())} utterances, launches {launches} ({recurrences} row 1, "
              f"1 row 2); {len(confusions)} misclassified, the confusions and the 26 x 26 "
              f"matrix equal to the CPU path's; {viz_s:.3f} s with the model load"
              f"{' and ' + str(len(pngs)) + ' PNGs' if plots else ''}; "
              f"{smi('name,power.limit')}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"tools: phase {numbers['phase_s']:.1f} s; launches {totals}; "
          f"{smi('name,power.limit')}")
    return totals, numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    ab = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--ab" else None
    if len(sys.argv) > 1 and ab is None:
        print(f"usage: {sys.argv[0]} [--ab DIR]", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(ab) if ab else ROOT)
    import ip_avsr_torch  # noqa: F401  (fails outside a checkout of the repo)

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    phase_build()
    phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if ab:
        print(json.dumps({"ab": ab_run(dev)}))
        return 0
    delta_err, delta_rows = phase_delta(dev)
    lstm_err, lstm_rows = phase_lstm(dev)
    train_fwd_err, bwd_err, train_rows = phase_lstm_train(dev)
    sweep_err = fwd_sweep(dev)
    lstm_err = max(lstm_err, sweep_err["lstm_fwd"])
    train_fwd_err = max(train_fwd_err, sweep_err["lstm_fwd_train"])
    peep_err, peep_train_err, peep_bwd_err, peep_rows = phase_lstm_peep(dev)
    peep_err = max(peep_err, sweep_err["lstm_peep_fwd"])
    peep_train_err = max(peep_train_err, sweep_err["lstm_peep_fwd_train"])
    phase_chunks(dev)
    state = phase_lstm_state(dev)
    launches, _ = phase_serve(dev)
    train_launches, _ = phase_train(dev)
    launches4, _ = phase_serve_4stream(dev)
    train_launches4, _ = phase_train_4stream(dev)
    stream = phase_stream(dev)
    buckets = phase_serve_buckets(dev)
    print(json.dumps({"lstm_state": state, "stream": stream, "serve_buckets": buckets}))
    fit_launches, fit_epochs, fit4_launches, fit4_epochs, fit_timing = phase_fit(dev)
    print(json.dumps({"fit": fit_timing}))
    cli_launches, cli_numbers = phase_cli(dev)
    print(json.dumps({"cli": cli_numbers}))
    export = phase_export(dev)
    print(json.dumps({"export": export}))
    zoo_launches, zoo_numbers = phase_zoo(dev)
    print(json.dumps({"zoo": zoo_numbers}))
    residual_launches, residual_numbers = phase_residuals(dev)
    print(json.dumps({"residuals": residual_numbers}))
    pretrain_launches, pretrain_numbers = phase_pretrain(dev)
    print(json.dumps({"pretrain": pretrain_numbers}))
    tools_launches, tools_numbers = phase_tools(dev)
    print(json.dumps({"tools": tools_numbers}))

    pallas = "ip_avsr_tpu/ops/pallas/lstm_kernel.py"
    fwd_src, bwd_src = "ip_avsr_torch/csrc/lstm_fwd.cu", "ip_avsr_torch/csrc/lstm_bwd.cu"
    peep_shape = f"B={TRAIN_B} T=29 H=250"
    kernels = [
        {"name": "delta", "route": "cuda", "source": "ip_avsr_torch/csrc/delta.cu",
         "replaces": "ip_avsr_tpu/ops/pallas/delta_kernel.py:56",
         "launches": launches["delta"], "max_abs_err": delta_err,
         "shape": "flagship group: 2 streams of B=8 T=29 D=50, W=9",
         **{k: delta_rows[("flagship", 8)][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "traced_ms")}},
        {"name": "lstm_fwd", "route": "cuda", "source": fwd_src, "replaces": f"{pallas}:42",
         "launches": launches["lstm_fwd"], "max_abs_err": lstm_err,
         "shape": "B=8 T=29 H=500", **lstm_rows[8]},
        {"name": "lstm_fwd_train", "route": "cuda", "source": fwd_src,
         "replaces": f"{pallas}:131",
         "launches": train_launches["lstm_fwd_train"], "max_abs_err": train_fwd_err,
         "shape": f"B={TRAIN_B} T=29 H=500", **train_rows[TRAIN_B]["lstm_fwd_train"]},
        {"name": "lstm_bwd", "route": "cuda", "source": bwd_src, "replaces": f"{pallas}:240",
         "launches": train_launches["lstm_bwd"], "max_abs_err": bwd_err,
         "shape": f"B={TRAIN_B} T=29 H=500 clip=5", **train_rows[TRAIN_B]["lstm_bwd"]},
        {"name": "lstm_peep_fwd", "route": "cuda", "source": fwd_src,
         "replaces": f"{pallas}:343",
         "launches": launches4["lstm_peep_fwd"], "max_abs_err": peep_err,
         "shape": peep_shape, **peep_rows[TRAIN_B]["lstm_peep_fwd"]},
        {"name": "lstm_peep_fwd_train", "route": "cuda", "source": fwd_src,
         "replaces": f"{pallas}:388",
         "launches": train_launches4["lstm_peep_fwd_train"], "max_abs_err": peep_train_err,
         "shape": peep_shape, **peep_rows[TRAIN_B]["lstm_peep_fwd_train"]},
        {"name": "lstm_peep_bwd", "route": "cuda", "source": bwd_src,
         "replaces": f"{pallas}:515",
         "launches": train_launches4["lstm_peep_bwd"], "max_abs_err": peep_bwd_err,
         "shape": f"{peep_shape} clip=5", **peep_rows[TRAIN_B]["lstm_peep_bwd"]},
    ]
    # launches: each row's count in the fits (the flagship's for rows 1-4 and
    # the delta, the 4-stream model's for rows 5-7), and per fit epoch; the
    # serve or train path's count above stays beside them
    for row in kernels:
        counts, epochs = ((fit4_launches, fit4_epochs) if row["name"].startswith("lstm_peep")
                          else (fit_launches, fit_epochs))
        row.update(path_launches=row["launches"], launches=counts[row["name"]],
                   launches_per_fit_epoch=counts[row["name"]] / epochs)
        # rows 1 and 5 with their final-cell output: launches in the
        # streaming sessions of their model, error against the plain version
        if row["name"] in state:
            row.update(state_launches=next(m["launches"] for m in stream.values()
                                           if m["row"] == row["name"]),
                       state_max_abs_err=state[row["name"]]["err"])
        # rows 1, 2 and 5: their launches through the loaded artifacts
        if row["name"] in ("delta", "lstm_fwd", "lstm_peep_fwd"):
            row.update(export_launches=export["launches"][row["name"]])
        # every row: its launches through the training CLIs' card runs, the
        # rest of the zoo's serving, training and export, the residual
        # levers' train steps, the pretraining phase (its trimodal fit) and
        # the tools phase (the rehearsal's fits, the confusion forward)
        row.update(cli_launches=cli_launches[row["name"]],
                   zoo_launches=zoo_launches[row["name"]],
                   residual_launches=residual_launches[row["name"]],
                   pretrain_launches=pretrain_launches[row["name"]],
                   tools_launches=tools_launches[row["name"]])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
