#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ip_avsr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build every CUDA kernel of the serving and training paths from
   ``ip_avsr_torch/csrc`` (one nvcc per source, started together) and the
   native ``.mat`` reader from ``ip_avsr_torch/native/matread.cc`` (g++),
   and print the toolchain; then read every instantiation of the two chain
   kernels from the built libraries with cuobjdump (``phase_sass``): its
   registers per thread and its tensor-core instructions (HMMA), which
   every bf16 instantiation must have and no float32 one;
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
   settings in turns; the four recurrences' large-B body (``tiled_check``,
   rows 1 and 3 at H = 500, B in {64, 128, 600, 256}, rows 5 and 6 at H =
   250, B in {250, 512}, T in {1, 29}, both directions, nonzero states, into
   NaN-filled outputs, at H = 500 also from an unaligned hid0, traced at the
   cells' batch beside the small-B body)
   and the backward chains' (``bwd_tiled_check``, row 4 at H = 500, B in
   {64, 600, 256}, row 7 at H = 250, B in {250, 600, 512}, as the
   recurrences' plus clip 5 with x1 and x100 upstream and clip 0, the
   peephole gradients bit-equal call to call); batches above one launch
   (rows 1 and 3 at B = 6000, rows 3 and 4 at B = 2100, H = 500; rows 1 and
   3 at B = 6000 and row 4 at B = 2100 again in the small-B body, its carry
   split) and forced row chunks at B = 64 (all six), each chunked call
   against its plain version and into NaN-filled outputs;
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
   backward-chain, 1 delta and no other launches per step, and 1 launch of
   the Adam kernel), then at dropout
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
   other launch per step, and 1 launch of the Adam kernel), hold the card's step against the CPU path, time
   and trace it (1 delta launch and 6 of each peephole chain kernel per
   step, none of the others); then ``tiled_main_path``: both models' forward
   and ``Trainer.train_step`` at the cells' batch (256, 512 for the
   4-stream step) and at B = 8 or 10, each f32 LSTM row's ``.launches`` and
   ``.launches_tiled`` and ``adam_update.launches`` zeroed before each
   call: every launch of the forward's row, and of the step's two rows, in
   the large-B body at the cells' batch, none at the small one; one Adam
   launch a train step, none a forward;
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
   probabilities, whose bf16 w_hid runs row 5's bf16 instantiation), a pinned B = 8, T = 29 flagship artifact and an
   adenet_v4 streaming artifact, each written to a temporary directory,
   loaded onto the card and held against its live server (2e-5; bf16 2e-3
   with the same argmax on frames whose top-2 gap exceeds 4e-3; the pinned
   one refusing B = 1), also on requests with swapped axes (numpy and on
   the card), with exactly 5 row-1 (flagship) or 6 row-5 (4-stream; bf16
   for the bf16 weights) launches and 1 delta launch per artifact forward and 3 row-1 launches
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
19. ``matmul_dtype="bfloat16"`` (``phase_bf16``, run right after 8., while
   torch.profiler still records cooperative launches): the bf16-W_hid
   instantiations of rows 1 and 3-7 (their products on the tensor cores)
   against their plain versions (rows 1, 3, 4 at H = 500, B = 8 and 10;
   rows 5-7 at H = 250, B = 10; T = 1 within LSTM_TOL, T = 29 within
   BF16_CHAIN_TOL; the chains at clip 5 x1 and x100 and clip 0; the state
   variants of rows 1 and 5 at B = 1; every row at B in {1, 10, 17, 64} and
   H in {500, 250, 130}, clip 5 and 0, step by step against the plain
   version fed the kernel's own operands (LSTM_TOL) and, but for the
   backward chains at B = 1 (printed), free-running within the chain
   limits; U = 8 and 4 forced; rows 1 and 4 one batch above a bf16
   launch's row cap), each timed on events in turns with its f32 twin on
   the same inputs (``queued_ms``: device time, not the host's rate), the
   backward rows also at the f32 plan's units per block, traced (one
   launch per call) and bounded (W_hid at 2 bytes a value), rows 1, 3 and
   4 beside ``torch.nn.LSTM`` in bf16; the full-width flagship at bf16 served (B =
   1 and 8: 5 row-1 bf16 launches and 1 delta per forward) and trained
   three steps (5 rows 3 and 4 bf16 per step), the 4-stream model at bf16
   served and stepped (rows 5-7 bf16), each against the CPU path at bf16
   with the float32 model's gap printed; ``cli.trimodal`` with
   ``[training] matmul_dtype = bfloat16`` from ``.mat`` files, every launch
   counted; a bf16-model artifact and a bf16-weight artifact of the f32
   flagship against their live servers (5 row-1 bf16 launches per
   forward); no f32 LSTM launch on any of these paths;
20. scale-out (``phase_scale``) in ranks spawned by
   ``utils/cpu_mesh.RankPool`` (this process joins no group): one ``nccl``
   rank steps the full-width flagship at B = 10 through ``Trainer`` with
   use_mesh (gspmd, timed in interleaved turns against the plain step;
   shard_map), zero1 and multihost, serves it through
   ``make_server(mesh=)`` at B = 8 and steps the 4-stream model with
   use_mesh; two ``gloo`` ranks sharing the card step the flagship
   data-parallel at global B = 10 and adenet_v1 with batch-norm statistics
   synced over the ranks; each step against the one-process card step
   (the train tolerances; adenet_v1's gradients to BN_GRAD_TOL, which the
   same two-rank step with each rank's own batch-norm statistics must
   fail, beside its float64 step on the CPU that shows the float32 error
   behind that limit) with the same launches, its collectives and bytes
   printed;
20b. scale-out on four cards (``phase_scale4``), only on a host with four
   or more: one ``nccl`` rank per card; the flagship data-parallel (gspmd,
   shard_map, zero1, multihost at global B = 10; B = 40), tensor-parallel
   (data 2 x model 2, data 1 x model 4) and sequence-parallel (data 2 x
   seq 2 at T = 29 padded to 30, data 1 x seq 4 at T = 48), adenet_v1 with
   batch norm synced over data 4 and data 2 x seq 2 (and the controls),
   the 4-stream model data-parallel, ``make_server(mesh=)``, each against
   the one-process step or server on card 0 with every rank's launches
   counted, and ``cli.nstream`` under torchrun on the four cards with
   ``--mesh``, ``--model_parallel 2`` and ``--sequence_parallel 2``; step
   times, collectives and busy shares beside the cards and their link.
   On one card one line says that it did not run;
21. the numpy oracle (``phase_oracle``, run right after 17.): the
   full-width flagship, the 4-stream model (per-step probabilities), every
   model of 15. and the conv-AE plain and batchnorm, from the trees 4., 7.,
   15. and 17. built (biases, scales, coefficients and initial states
   moved off their init), through ``models/adenet.adenet_forward`` (or
   ``convae_forward``) on the card at B = 8, T = 29 with a ragged mask (a
   row of length 1), each against ``reference_impl.adenet_forward_np`` (or
   ``convae_forward_np``) on the host, the independent numpy forward that
   shares no code with the port: probabilities within 2e-5,
   reconstructions within 2e-4 relative plus 2e-5; the launches of each
   forward (rows 1, 2 and 5) against its predicted count, the CPU path's
   distance from the oracle, the card's forward time and the oracle's host
   time per forward (the "reference CPU" figure) beside the CPU model; then
   ``blstm_forward(grad_clipping=0)`` at the flagship aggregator's shape
   (rows 3 and 4 with clip 0) against the CPU path;
21b. the multi-tensor Adam kernel (``phase_adam``, run right after
   ``tiled_main_path``) at both training cells' parameter trees (43 and 70
   leaves, seeded as the benchmark's ``inputs.make_weights``): ``adam`` and
   ``adam_vlr`` over 5 steps of seeded gradients, p, m, v and t bit-equal
   to the plain version (the eager tree_maps) on the card, one launch an
   update a table; the kernel's time (20 launches, CUDA events) at the
   wrapper's block size (with ``--adam`` at several) beside its bound (7 x
   4 bytes a value), the whole
   update and the plain version (the card's clock and the host's), and
   ``torch.optim.Adam(fused=True)`` as a yardstick of time;
22. print the fit's numbers, the kernels line (each row's launches in the
   fits and per fit epoch, beside its serve or train path's count; rows 1
   and 5 also their launches in the streaming sessions and the state
   output's error; rows 1, 2 and 5 their launches through the artifacts;
   every row its launches through the CLIs' card runs, through phase_zoo,
   through phase_residuals, through phase_pretrain, through phase_tools,
   through phase_scale's mesh runs (``scale_launches``, every rank),
   through phase_scale4's (``scale4_launches``, every rank; null where it
   did not run) and through phase_oracle (``oracle_launches``);
   then the six bf16 rows, their launches on the bf16 serve and train
   paths, through the bf16 CLI run and the two artifacts; rows 1 and 3-7
   their large-B body at the cells' batch (``large_b``: traced time,
   bound, the small-B body's time, and ``main_path_launches``, the main
   path's [launches, launches_tiled] by batch from ``tiled_main_path``);
   every LSTM row with its instantiation's registers per thread and HMMA
   count; the Adam kernel's row, ``phase_adam``'s numbers with
   ``main_path_launches``, the Trainer step's Adam launches by model and
   batch from ``tiled_main_path``), then ``{"ok": true, "device": ...}`` last.

Exits non-zero without a CUDA device or without the package beside it.

    python3 chip_smoke.py --bf16

runs only phases 1, 2 and 19 (the build, the card, the registers and
tensor-core instructions of the chain kernels, and ``phase_bf16``) and
prints their numbers as JSON (about three minutes);

    python3 chip_smoke.py --tiled

runs only phases 1 and 2, ptxas's registers and spill bytes of the four
large-B recurrences (``tiled_ptxas``, which fails on a spill), the
large-B bodies of the four recurrences (also at other widths, both forms:
``TILED_WIDTHS``) and the two backward chains (``tiled_check``,
``bwd_tiled_check``, ``tiled_main_path``), then the crossover sweeps that
set ``ops/kernels/lstm.TILED_RESIDENT_MIN_ROWS``, ``TILED_MIN_ROWS`` and
``TILED_WIDE_H``, and
``BWD_TILED_MIN_ROWS``, ``BWD_TILED_MIN_H`` and ``BWD_TILED_MAX_H``
(``tiled_sweep``: the small-B body against the large-B one; rows 1 and 6
at the cells' widths and row 1 at H in {130, 64}, B in {64, 96, 128,
256}; rows 4 and 7 at the cells' widths at B = 16-256 (and
512 for row 7), row 4 at H in {130, 64} at B in {64, 128, 256, 512}), and
prints their numbers as JSON (about two minutes of command time);

    python3 chip_smoke.py --adam

runs only phases 1, 2 and ``phase_adam`` (the multi-tensor Adam kernel at
both training cells' trees, 21b. below, timed also at each of
``ADAM_CHUNKS`` values a block) and prints its numbers as JSON;

    python3 chip_smoke.py --mesh4

runs only phases 1 (the build), 2 and 20b (``phase_scale4``) on a host with
four cards, prints its numbers as JSON and the last line; with fewer cards
it exits non-zero and says why;

    python3 chip_smoke.py --sass DIR

builds the two chain kernels' sources of this checkout and of DIR (another
checkout) and fails unless every float32 instantiation compiles to the same
SASS in both, instruction for instruction;

    python3 chip_smoke.py --ab DIR

is a measurement only: it times and traces row 2 per forward of both models
(the model's delta stage, its yardstick and the DeltaLayer's backward) and
rows 4 and 7 at B = 8 and 10 (event clock and traced), and
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
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32
# FLOP/s outside the tensor cores (TF32 is off, so f32 work runs there) and
# the tensor cores' bf16 FLOP/s (bf16 operands, float32 sums: the products
# of the bf16 instantiations, whatever cores they run on today)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
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
# the six LSTM rows' wrappers, by the name of their float32 instantiation
LSTM_WRAPPERS = {
    "lstm_fwd": "lstm_recurrence",
    "lstm_fwd_train": "lstm_recurrence_train",
    "lstm_bwd": "lstm_bwd_chain",
    "lstm_peep_fwd": "lstm_peep_recurrence",
    "lstm_peep_fwd_train": "lstm_peep_recurrence_train",
    "lstm_peep_bwd": "lstm_peep_bwd_chain",
}
# the thirteen kernels' launch counters: name -> (module, wrapper, counter);
# each LSTM wrapper counts its float32 instantiation in ``launches`` and its
# bf16 one (a bf16 W_hid, matmul_dtype="bfloat16") in ``launches_bf16``
KERNEL_COUNTERS = {
    "delta": ("delta", "append_delta", "launches"),
    **{row: ("lstm", fn, "launches") for row, fn in LSTM_WRAPPERS.items()},
    **{f"{row}_bf16": ("lstm", fn, "launches_bf16") for row, fn in LSTM_WRAPPERS.items()},
}
# the persistent kernels' instantiations as a trace names them, by their
# template arguments: lstm_fwd_chain_kernel<EmitResiduals, Peephole, U, W>
# and lstm_bwd_chain_kernel<Peephole, U, W>, W float or __nv_bfloat16
# (regular expressions)
_CHAIN_ARGS = {
    "lstm_fwd": "lstm_fwd_chain_kernel<false, false, ",
    "lstm_fwd_train": "lstm_fwd_chain_kernel<true, false, ",
    "lstm_peep_fwd": "lstm_fwd_chain_kernel<false, true, ",
    "lstm_peep_fwd_train": "lstm_fwd_chain_kernel<true, true, ",
    "lstm_bwd": "lstm_bwd_chain_kernel<false, ",
    "lstm_peep_bwd": "lstm_bwd_chain_kernel<true, ",
}
CHAIN_TRACE = {
    **{row: rf"{args}\d+, float\s*>" for row, args in _CHAIN_ARGS.items()},
    **{f"{row}_bf16": rf"{args}\d+, \w*bfloat16\s*>" for row, args in _CHAIN_ARGS.items()},
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


_SLEEP_CYCLES_PER_MS = []


def queued_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls with the
    stream held busy while the host queues them: a sleep kernel sized to
    1.5 times the host time of the calls goes first, so the calls run back
    to back on the card even where the host takes longer to issue one than
    the card to run it (there :func:`cuda_ms` reads the host's rate)."""
    import torch

    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(end))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS[0] * (1.5 * host_ms * iters + 1)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, bf16_flops=0):
    # flops at the float32 rate, bf16_flops (products of bf16 operands) at
    # the bf16 rate
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + bf16_flops / BF16_FLOP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def delta_cost(B, T, D, W):
    # x read once, [x, d, a] written once; 3 ops per tap per output, 2 orders
    return 4 * (B * T * D + 3 * B * T * D), 2 * B * T * D * 3 * max(W, 0)


def product_flops(flops, w_bytes):
    # a recurrence's per-step product as (float32 operations, bf16
    # operations): a bf16 W_hid (w_bytes 2) makes it a bf16-operand product
    return (flops, 0) if w_bytes == 4 else (0, flops)


def lstm_cost(B, T, H, peep=False, w_bytes=4):
    # with peepholes, also the three (H,) vectors and their multiply-adds;
    # W_hid at w_bytes a value (2 for the bf16 instantiations), the rest f32;
    # returns (bytes, float32 operations, bf16 operations)
    nbytes = (4 * (B * T * 4 * H + B * T + 2 * B * H + B * T * H + (3 * H if peep else 0))
              + w_bytes * H * 4 * H)
    mm, mm_bf16 = product_flops(2 * B * T * H * 4 * H, w_bytes)
    flops = mm + LSTM_GATE_FLOPS * B * T * H + (PEEP_FLOPS * B * T * H if peep else 0)
    return nbytes, flops, mm_bf16


def lstm_train_cost(B, T, H, peep=False, w_bytes=4):
    # the inference recurrence's traffic plus the residuals cells and gates
    nbytes, flops, bf16_flops = lstm_cost(B, T, H, peep, w_bytes)
    return nbytes + 4 * (B * T * H + B * T * 4 * H), flops, bf16_flops


def lstm_state_cost(B, T, H, peep=False, w_bytes=4):
    # the inference recurrence's traffic plus the final cell written once
    nbytes, flops, bf16_flops = lstm_cost(B, T, H, peep, w_bytes)
    return nbytes + 4 * B * H, flops, bf16_flops


def lstm_bwd_cost(B, T, H, peep=False, w_bytes=4):
    # reads g_out, gates, cells, cells_prev, mask, W_hid; writes dgates,
    # dcell0, dhid0; the dgates @ W_hid^T chain and the gate backward; with
    # peepholes also reads the three vectors, writes their three gradients,
    # and sums B (H,) partials into each; W_hid at w_bytes a value
    nbytes = (4 * (3 * B * T * H + B * T * 4 * H + B * T + B * T * 4 * H + 2 * B * H
                   + (6 * H if peep else 0)) + w_bytes * H * 4 * H)
    mm, mm_bf16 = product_flops(2 * B * T * 4 * H * H, w_bytes)
    flops = (mm + LSTM_BWD_GATE_FLOPS * B * T * H
             + (PEEP_BWD_FLOPS * B * T * H + 3 * B * H if peep else 0))
    return nbytes, flops, mm_bf16


def counters():
    """{name: (wrapper, counter attribute)} for the thirteen kernels; each
    counter counts the calls that launched that kernel."""
    import importlib

    return {name: (getattr(importlib.import_module(f"ip_avsr_torch.ops.kernels.{mod}"), fn),
                   attr)
            for name, (mod, fn, attr) in KERNEL_COUNTERS.items()}


def reset_launches():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def expect_launches(got, **nonzero):
    """Raise unless ``got`` has the counts ``nonzero`` and 0 elsewhere."""
    expected = {name: nonzero.get(name, 0) for name in KERNEL_COUNTERS}
    if got != expected:
        raise AssertionError(f"kernel launches {got}, expected {expected}")


def reset_adam_launches():
    from ip_avsr_torch.ops.kernels import adam as kadam

    kadam.adam_update.launches = 0


def expect_adam_launches(params, steps, label):
    """Raise unless the Adam kernel's ``adam_update.launches`` reads one
    launch a table of ``params``'s tree for each of ``steps`` optimizer
    steps since :func:`reset_adam_launches`."""
    from ip_avsr_torch.ops.kernels import adam as kadam

    got = kadam.adam_update.launches
    want = steps * -(-len(kadam._leaves(params)) // kadam.CAPACITY)
    print(f"{label}: adam_update.launches = {got} over {steps} steps")
    if got != want:
        raise AssertionError(f"{label}: adam_update.launches = {got}, expected {want}")


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


# the rows' instantiations at their main path's units per block (the
# flagship's H = 500 at 4, the 4-stream model's H = 250 at 2; the bf16
# backward chains at 8, ops/kernels/lstm.MMA_UNITS)
ROW_INSTANCES = {
    "lstm_fwd": "lstm_fwd_chain_kernel<false, false, {u}, {w}>",
    "lstm_fwd_train": "lstm_fwd_chain_kernel<true, false, {u}, {w}>",
    "lstm_bwd": "lstm_bwd_chain_kernel<false, {u}, {w}>",
    "lstm_peep_fwd": "lstm_fwd_chain_kernel<false, true, {u}, {w}>",
    "lstm_peep_fwd_train": "lstm_fwd_chain_kernel<true, true, {u}, {w}>",
    "lstm_peep_bwd": "lstm_bwd_chain_kernel<true, {u}, {w}>",
}


def row_instance(name):
    """The demangled instantiation of a kernels-line LSTM row ("lstm_fwd",
    "lstm_fwd_bf16", ...) at its main path's units per block."""
    bf16 = name.endswith("_bf16")
    row = name[:-5] if bf16 else name
    units = 8 if bf16 and row.endswith("bwd") else 2 if "peep" in row else 4
    return ROW_INSTANCES[row].format(u=units, w="__nv_bfloat16" if bf16 else "float")


def chain_name(mangled):
    """The chain kernel instantiation a mangled name holds, as a demangler
    writes it ("lstm_fwd_chain_kernel<false, false, 4, float>"), or None:
    its template arguments are bools (Lb0E, Lb1E), ints (Li4E) and the
    type (f, 13__nv_bfloat16)."""
    m = re.search(r"(lstm_(?:fwd|bwd)_chain_kernel)I(\w+?)EEv", mangled)
    if not m:
        return None
    args = [("true" if b == "1" else "false") if b else i if i else
            "float" if t == "f" else "__nv_bfloat16"
            for b, i, t in re.findall(r"Lb([01])E|Li(\d+)E|(13__nv_bfloat16|f)", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def chain_kernels(lib_path):
    """{instantiation: (SASS instructions, registers per thread)} of the
    chain kernels in a built library, read with cuobjdump (SASS and
    resource usage)."""
    from ip_avsr_torch.ops.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")

    def dump(flag):
        return subprocess.run([cuobjdump, flag, lib_path], capture_output=True, text=True,
                              check=True, timeout=300).stdout

    code, name = {}, None
    for line in dump("--dump-sass").splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = chain_name(m.group(1))
            if name:
                code[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?)\s*;", line)
            if m:
                code[name].append(m.group(1))
    regs = {chain_name(m.group(1)): int(m.group(2)) for m in
            re.finditer(r"Function (\S+):\s*REG:(\d+)", dump("--dump-resource-usage"))}
    return {name: (ins, regs.get(name)) for name, ins in code.items()}


def ptxas_report(log):
    """{instantiation: (registers, spill store bytes, spill load bytes)} of
    the chain kernels in the messages of ``nvcc -Xptxas -v``."""
    regs, spills, name = {}, {}, None
    for line in log.splitlines():
        m = (re.search(r"Compiling entry function '(\S+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            name = chain_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills[name] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return {n: (r, *spills.get(n, (None, None))) for n, r in regs.items()}


def tiled_ptxas():
    """ptxas's registers and spill bytes of the recurrence's large-B body,
    its four instantiations lstm_fwd_chain_kernel<E, P, 16, float>, from a
    fresh build of csrc/lstm_fwd.cu with the package's flags.  Raises unless
    all four are there and none spills (W_hid's share lives in registers).
    Returns {instantiation: [registers, spill stores, spill loads]}."""
    import tempfile

    from ip_avsr_torch.ops.kernels import _build

    out = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    try:
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                               os.path.join(out, "lstm_fwd.so"),
                               os.path.join(ROOT, "ip_avsr_torch", "csrc", "lstm_fwd.cu")],
                              capture_output=True, text=True, timeout=600)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if proc.returncode != 0:
        raise RuntimeError(f"lstm_fwd.cu did not build:\n{proc.stdout}{proc.stderr}")
    report = ptxas_report(proc.stdout + proc.stderr)
    tiled = {n: list(v) for n, v in report.items() if re.search(r"<\w+, \w+, 16, float>$", n)}
    for n, (regs, stores, loads) in sorted(tiled.items()):
        print(f"ptxas, {n}: {regs} registers, {stores} bytes spill stores, {loads} bytes "
              f"spill loads")
    if len(tiled) != 4 or any(v[1] != 0 or v[2] != 0 for v in tiled.values()):
        raise AssertionError(f"the large-B recurrence's four instantiations must build "
                             f"without spills: {tiled}")
    return tiled


def phase_sass():
    """Registers per thread and tensor-core instructions (HMMA) of every
    instantiation of the two chain kernels in the built libraries.  Raises
    unless every bf16 instantiation's product runs on the tensor cores and
    no float32 one does.  Returns {instantiation: {"registers", "hmma"}}."""
    from ip_avsr_torch.ops.kernels import _build

    report = {}
    for path in _build.build(("lstm_fwd", "lstm_bwd")).values():
        for name, (ins, regs) in chain_kernels(path).items():
            report[name] = {"registers": regs, "hmma": sum("HMMA" in i for i in ins)}
    print(json.dumps({"sass": report}))
    bf16 = {k: v for k, v in report.items() if "bfloat16" in k}
    f32 = {k: v for k, v in report.items() if k.endswith("float>")}
    # float32: 24 small-B instantiations and the large-B bodies' six
    if len(bf16) != 24 or len(f32) != 30:
        raise AssertionError(f"expected 24 bf16 and 30 float32 chain instantiations in the "
                             f"SASS, found {sorted(report)}")
    if not all(v["hmma"] > 0 for v in bf16.values()) or any(v["hmma"] for v in f32.values()):
        raise AssertionError(f"the bf16 instantiations must run their product on the tensor "
                             f"cores (HMMA) and the float32 ones must not: {report}")
    for row in ROW_INSTANCES:
        print(f"registers per thread, {row}: float32 {report[row_instance(row)]['registers']}, "
              f"bf16 {report[row_instance(row + '_bf16')]['registers']} "
              f"(HMMA {report[row_instance(row + '_bf16')]['hmma']})")
    return report


def sass_against(other):
    """Build csrc/lstm_fwd.cu and csrc/lstm_bwd.cu of this checkout and of
    the checkout ``other`` with the same flags and hold every chain kernel
    instantiation that ``other`` has, float32 and bf16, to the same SASS,
    instruction for instruction (``--sass DIR``; a kernel is named by its
    template arguments alone, so one whose parameter list grew keeps its
    name).  Returns {instantiation: identical}."""
    import tempfile

    from ip_avsr_torch.ops.kernels import _build

    out = tempfile.mkdtemp(prefix="chip_smoke_sass_")
    try:
        procs = {}
        for tree, label in ((ROOT, "this"), (os.path.abspath(other), "other")):
            for name in ("lstm_fwd", "lstm_bwd"):
                lib = os.path.join(out, f"{label}_{name}.so")
                procs[(label, name)] = (lib, subprocess.Popen(
                    [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib,
                     os.path.join(tree, "ip_avsr_torch", "csrc", f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for (label, name), (lib, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"{label} {name}.cu did not build:\n{log}")
        same = {}
        for name in ("lstm_fwd", "lstm_bwd"):
            this = chain_kernels(procs[("this", name)][0])
            them = chain_kernels(procs[("other", name)][0])
            for fn, (code, _) in them.items():
                same[fn] = this.get(fn, (None,))[0] == code
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(f"chain kernels with SASS identical to {other}'s: {sum(same.values())} of "
          f"{len(same)}; differing: {sorted(fn for fn, ok in same.items() if not ok)}")
    return same


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
    tiled_err, rows["large_b"] = tiled_check(dev, "lstm_fwd")
    return max(err, tiled_err), rows


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
            plan = kl.fwd_plan(B, H, sm_count)
            print(f"lstm_fwd plan B={B} H={H} on {sm_count} SMs: U={plan.units} hidden units per "
                  f"block, grid {plan.grid}"
                  + (f" x {plan.row_groups} row groups (large-B body)" if plan.tiled else "")
                  + f", {plan.smem_bytes} B of shared memory, last block "
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


# the large-B body of rows 1, 3, 5 and 6 (ops/kernels/lstm.fwd_plan):
# row -> (H, batches) of its checks, the cells' batch last; B = 600 runs in
# row chunks (3 of 200 rows at H = 500)
TILED_CASES = {"lstm_fwd": (500, (64, 128, 600, 256)),
               "lstm_fwd_train": (500, (64, 128, 600, 256)),
               "lstm_peep_fwd": (250, (250, 512)), "lstm_peep_fwd_train": (250, (250, 512))}
# the same body at other widths, each of the four instantiations in each
# form (ops/kernels/lstm.tiled_resident): staged at H = 130, 64 and 498, W_hid
# in registers at 388 and 512 (short and full k slices): (row, H, batches)
TILED_WIDTHS = (("lstm_fwd", 130, (256,)), ("lstm_peep_fwd_train", 130, (256,)),
                ("lstm_fwd_train", 64, (256,)), ("lstm_peep_fwd", 64, (256,)),
                ("lstm_fwd", 498, (256,)), ("lstm_peep_fwd_train", 388, (256,)),
                ("lstm_peep_fwd", 512, (130,)), ("lstm_fwd_train", 388, (130,)))
# the large-B body of rows 4 and 7 (ops/kernels/lstm.bwd_plan): row ->
# (H, batches) of its checks, the cells' batch last; B = 600 runs in row
# chunks (3 of 200 rows at H = 500, 2 of 300 at H = 250)
BWD_TILED_CASES = {"lstm_bwd": (500, (64, 600, 256)), "lstm_peep_bwd": (250, (250, 600, 512))}
# the crossover sweeps, small-B body against large-B body: (row, H, batches);
# rows 1 and 6 at the cells' widths, row 1 at the small widths of the
# synthetic configurations and the tests (ops/kernels/lstm.
# TILED_RESIDENT_MIN_ROWS, TILED_MIN_ROWS, TILED_WIDE_H); rows 4 and 7 at the cells' widths and row 4 at two small
# ones (BWD_TILED_MIN_ROWS, BWD_TILED_MIN_H)
TILED_SWEEP = (("lstm_fwd", 500, (64, 96, 128, 256)),
               ("lstm_peep_fwd_train", 250, (64, 96, 128, 256)),
               *(("lstm_fwd", H, (64, 96, 128, 256)) for H in (130, 64)))
BWD_TILED_SWEEP = (("lstm_bwd", 500, (16, 32, 64, 96, 128, 192, 256)),
                   ("lstm_peep_bwd", 250, (16, 32, 64, 96, 128, 192, 256, 512)),
                   *(("lstm_bwd", H, (64, 128, 256, 512)) for H in (130, 64)))


def bwd_chain_inputs(B, T, H, peep, gen, dev, mask=None):
    """Inputs of a backward chain at (B, T, H) from the plain training
    recurrence on the card: ``(g_out, gates_pre, cells, cells_prev, mask,
    w_hid)`` and the peephole vectors (empty without ``peep``), nonzero
    initial states, a ragged ``mask`` unless one is given."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    fwd = kl.lstm_peep_recurrence_train_plain if peep else kl.lstm_recurrence_train_plain
    w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
    vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3 * peep))
    c0 = torch.randn(B, H, generator=gen).to(dev)
    h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
    x_proj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
    mask = ragged_mask(B, T, gen, dev) if mask is None else mask
    _, cells, gates = fwd(x_proj, w_hid, mask, c0, h0, *vecs)
    cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
    g = torch.randn(B, T, H, generator=gen).to(dev)
    return (g, gates, cells, cells_prev, mask, w_hid), vecs


def bwd_tiled_check(dev, name):
    """Row ``name`` (a key of :data:`BWD_TILED_CASES`) in the large-B body
    against its plain version at its shapes: nonzero initial states, ragged
    masks with a fully padded row and a length-1 row, T in {1, 29}, both
    directions, clip 5 with x1 and x100 upstream and clip 0, nonzero
    peephole vectors.  Each call runs through the wrapper where the
    dispatch takes the large-B body (which must count it in
    ``.launches_tiled``), forced through ``_run_bwd`` below the threshold,
    and again into NaN-filled outputs, which must come out bit-equal, the
    peephole gradients included (a value the kernel did not write, or read
    stale, shows; two calls, the same bits).  At the cells' batch, the
    traced time a call and per step beside the small-B body's on the event
    clock.  Returns the largest absolute error and {"traced_ms",
    "us_per_step", "ms", "small_ms", "bound_ms", "B", "H"}."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    H, batches = BWD_TILED_CASES[name]
    peep = "peep" in name
    label = LSTM_WRAPPERS[name]
    wrapper = getattr(kl, label)
    plain = getattr(kl, label + "_plain")
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 17 + len(name))
    err = 0.0
    for B in batches:
        auto = kl.bwd_plan(B, H, sm_count).tiled
        print(f"{name} B={B} H={H}: large-B plan {kl.bwd_plan(B, H, sm_count, tiled=True)}; the "
              f"dispatch takes it: {auto}")
        for T in (1, T_FRAMES):
            mask = ragged_mask(B, T, gen, "cpu")
            mask[-1] = 0.0  # a fully padded row
            mask[1] = 0.0   # a length-1 row
            mask[1, 0] = 1.0
            for backwards in (False, True):
                ms_ = (mask.flip(1) if backwards else mask).contiguous().to(dev)
                bargs, vecs = bwd_chain_inputs(B, T, H, peep, gen, dev, ms_)
                for scale, clip in ((1.0, 5.0), (100.0, 5.0), (1.0, 0.0)):
                    args = ((bargs[0] * scale).contiguous(), *bargs[1:])
                    before = (wrapper.launches, wrapper.launches_tiled)
                    if auto:
                        got = wrapper(*args, *vecs, clip)
                        if (wrapper.launches - before[0],
                                wrapper.launches_tiled - before[1]) != (1, 1):
                            raise AssertionError(f"{name} B={B}: the call was not counted once "
                                                 f"in .launches and .launches_tiled")
                    else:
                        got = kl._run_bwd(label, args, clip, vecs, tiled=True)
                    ref = plain(*args, *vecs, clip)
                    nan = [torch.full_like(g, float("nan")) for g in got[:3]]
                    again = kl._run_bwd(label, args, clip, vecs, outs=nan, tiled=True)
                    same = all(torch.equal(a, b) for a, b in zip(again, got))
                    errs = [max_err(a, r) for a, r in zip(got, ref)]
                    rel = max(r for _, r in errs)
                    clipped = (ref[0].abs() == clip).float().mean().item() if clip else 0.0
                    print(f"{name} large-B B={B} H={H} T={T} backwards={backwards} "
                          f"g x{scale:g} clip={clip:g}: max_abs_err="
                          f"{max(a for a, _ in errs):.3e}, relative {rel:.3e}, clipped share "
                          f"{clipped:.4f}; again into NaN-filled outputs: bit-equal {same}")
                    if not (same and len(got) == len(ref) == 3 + 3 * peep
                            and rel <= LSTM_BWD_TOL):
                        raise AssertionError(
                            f"{name} large-B body disagrees with its plain version: {rel}")
                    if clip and scale > 1 and T > 1 and not clipped > 0.01:
                        raise AssertionError(f"the clip did not bite: share {clipped}")
                    if scale == 1.0 and clip:
                        err = max(err, max(a for a, _ in errs))
    # the cells' batch: traced, and against the small-B body in turns
    B = batches[-1]
    bargs, vecs = bwd_chain_inputs(B, T_FRAMES, H, peep, gen, dev)
    traced_ms = trace_chain(lambda: wrapper(*bargs, *vecs, 5.0), f"{name} large-B B={B} H={H}",
                            name, T_FRAMES + 1)
    times = compare_units(lambda tiled: (lambda: kl._run_bwd(label, bargs, 5.0, vecs,
                                                             tiled=tiled)),
                          (False, True), f"{name} B={B} H={H} (units: large-B body True/False)")
    b_ms, _ = bound(*lstm_bwd_cost(B, T_FRAMES, H, peep=peep)[:2])
    numbers = dict(B=B, H=H, traced_ms=traced_ms, us_per_step=traced_ms * 1e3 / T_FRAMES,
                   ms=statistics.mean(times[True]), small_ms=statistics.mean(times[False]),
                   bound_ms=b_ms)
    print(f"{name} large-B B={B} H={H}: traced {traced_ms:.4f} ms a call, "
          f"{numbers['us_per_step']:.3f} us a step; bound {b_ms:.5f} ms "
          f"({b_ms / traced_ms:.1%} of it); small-B body {numbers['small_ms']:.4f} ms")
    return err, numbers


def tiled_check(dev, name, H=None, batches=None):
    """Row ``name`` in the large-B body against its plain version at width
    ``H`` and ``batches`` (by default its entry in :data:`TILED_CASES`):
    nonzero initial states, ragged masks with a fully padded row and a
    length-1 row, T in {1, 29}, both directions, nonzero peephole vectors;
    rows 1 and 5 also with their final cell (``state``), rows 3 and 6 with
    their residuals.  Each call runs through the wrapper where the dispatch
    takes the large-B body (which must count it in ``.launches_tiled``),
    forced through ``_run_fwd`` below the threshold, and again into
    NaN-filled outputs, which must come out bit-equal (a value the kernel
    did not write, or read stale, shows; two calls, the same bits); where
    W_hid is resident (``tiled_resident``), once more from a hid0 4 bytes
    off a float4 boundary, the same bits.  At the cells' batch, the traced time a call and per step beside the
    small-B body's on the event clock.  Returns the largest absolute error
    and {"traced_ms", "us_per_step", "ms", "small_ms", "bound_ms", "B", "H"}."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    if H is None:
        H, batches = TILED_CASES[name]
    train, peep = name.endswith("train"), "peep" in name
    wrapper = getattr(kl, name.replace("fwd", "recurrence"))
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(SEED + 13 + len(name))
    err = 0.0
    for B in batches:
        # below the dispatch's threshold the body is forced, past the wrapper
        auto = kl.fwd_plan(B, H, sm_count).tiled
        print(f"{name} B={B} H={H}: large-B plan {kl.fwd_plan(B, H, sm_count, tiled=True)}; the "
              f"dispatch takes it: {auto}")
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        c0 = torch.randn(B, H, generator=gen).to(dev)
        h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
        vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3 * peep))
        for T in (1, T_FRAMES):
            x_proj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
            mask = ragged_mask(B, T, gen, "cpu")
            mask[-1] = 0.0  # a fully padded row
            mask[1] = 0.0   # a length-1 row
            mask[1, 0] = 1.0
            for backwards in (False, True):
                ms_ = (mask.flip(1) if backwards else mask).contiguous().to(dev)
                args = (x_proj, w_hid, ms_, c0, h0)
                states = (False, True) if not train else (False,)
                for state in states:
                    before = (wrapper.launches, wrapper.launches_tiled)
                    stem = name.replace("fwd", "recurrence") + ("_state" if state else "")
                    if auto:
                        got = getattr(kl, stem)(*args, *vecs)
                        if (wrapper.launches - before[0],
                                wrapper.launches_tiled - before[1]) != (1, 1):
                            raise AssertionError(f"{name} B={B}: the call was not counted once "
                                                 f"in .launches and .launches_tiled")
                    else:
                        got = kl._run_fwd(name, args, train, peep=vecs, state=state, tiled=True)
                    ref = getattr(kl, stem + "_plain")(*args, *vecs)
                    got = got if train or state else (got,)
                    ref = ref if train or state else (ref,)
                    nan = [torch.full_like(g, float("nan")) for g in got]
                    kl._run_fwd(name, args, train, peep=vecs, outs=nan, state=state, tiled=True)
                    same = all(torch.equal(a, b) for a, b in zip(nan, got))
                    errs = [max_err(a, r)[0] for a, r in zip(got, ref)]
                    rel = max(a / max(r.abs().max().item(), 1e-30) for a, r in zip(errs, ref))
                    print(f"{name} large-B B={B} H={H} T={T} backwards={backwards} "
                          f"state={state}: max_abs_err={max(errs):.3e}, relative {rel:.3e}; "
                          f"into NaN-filled outputs: bit-equal {same}")
                    if not (same and rel <= LSTM_TOL):
                        raise AssertionError(
                            f"{name} large-B body disagrees with its plain version: {rel}")
                    err = max(err, max(errs))
                    if kl.tiled_resident(H) and T > 1 and not backwards and not state:
                        # hid0 4 bytes off a float4 boundary: the wrapper hands
                        # the resident body an aligned copy, the same bits
                        off = torch.empty(B * H + 1, device=dev)[1:].view(B, H).copy_(h0)
                        moved = kl._run_fwd(name, (x_proj, w_hid, ms_, c0, off), train,
                                            peep=vecs, state=state, tiled=True)
                        moved = moved if train or state else (moved,)
                        if not all(torch.equal(a, b) for a, b in zip(moved, got)):
                            raise AssertionError(f"{name} B={B}: an unaligned hid0 changed "
                                                 f"the resident body's outputs")
                        print(f"{name} large-B B={B} H={H}: unaligned hid0, the same bits")
    # the cells' batch: traced, and against the small-B body in turns
    B = batches[-1]
    x_proj = torch.randn(B, T_FRAMES, 4 * H, generator=gen).to(dev)
    mask = ragged_mask(B, T_FRAMES, gen, dev)
    args = (x_proj, w_hid, mask, c0, h0)
    traced_ms = trace_chain(lambda: wrapper(*args, *vecs), f"{name} large-B B={B} H={H}", name,
                            T_FRAMES)
    times = compare_units(lambda tiled: (lambda: kl._run_fwd(name, args, train, peep=vecs,
                                                             tiled=tiled)),
                          (False, True), f"{name} B={B} H={H} (units: large-B body True/False)")
    cost = (lstm_train_cost if train else lstm_cost)(B, T_FRAMES, H, peep=peep)
    b_ms, _ = bound(*cost[:2])
    numbers = dict(B=B, H=H, traced_ms=traced_ms, us_per_step=traced_ms * 1e3 / T_FRAMES,
                   ms=statistics.mean(times[True]), small_ms=statistics.mean(times[False]),
                   bound_ms=b_ms)
    print(f"{name} large-B B={B} H={H}: traced {traced_ms:.4f} ms a call, "
          f"{numbers['us_per_step']:.3f} us a step; bound {b_ms:.5f} ms "
          f"({b_ms / traced_ms:.1%} of it); small-B body {numbers['small_ms']:.4f} ms")
    return err, numbers


def tiled_sweep(dev, cases):
    """The crossovers that set ``ops/kernels/lstm.TILED_MIN_ROWS`` and
    ``TILED_WIDE_H`` (:data:`TILED_SWEEP`), and ``BWD_TILED_MIN_ROWS`` and
    ``BWD_TILED_MIN_H`` (:data:`BWD_TILED_SWEEP`): each (row, H, batches) of
    ``cases``, the small-B body against the large-B one in turns (a, b, b,
    a) on the event clock.  Returns {"<row> H=<H>": {B: (small ms, large
    ms)}}."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 14)
    out = {}
    for name, H, batches in cases:
        train, peep = name.endswith("train"), "peep" in name
        w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev)
        vecs = tuple((torch.randn(H, generator=gen) * 0.5).to(dev) for _ in range(3 * peep))
        key = f"{name} H={H}"
        out[key] = {}
        for B in batches:
            if name.endswith("bwd"):
                bargs, bvecs = bwd_chain_inputs(B, T_FRAMES, H, peep, gen, dev)

                def make(tiled):
                    return lambda: kl._run_bwd(name, bargs, 5.0, bvecs, tiled=tiled)
            else:
                x_proj = torch.randn(B, T_FRAMES, 4 * H, generator=gen).to(dev)
                mask = ragged_mask(B, T_FRAMES, gen, dev)
                c0 = torch.zeros(B, H, device=dev)
                args = (x_proj, w_hid, mask, c0, c0)

                def make(tiled):
                    return lambda: kl._run_fwd(name, args, train, peep=vecs, tiled=tiled)
            times = compare_units(make, (False, True),
                                  f"sweep {name} B={B} H={H} (units: large-B body True/False)")
            out[key][B] = (statistics.mean(times[False]), statistics.mean(times[True]))
    print(json.dumps({"tiled_sweep": out}))
    return out


def tiled_main_path(dev):
    """``.launches_tiled`` on the main path: the flagship's scoring forward
    (``make_trimodal_server``, row 1) and a ``Trainer.train_step`` (rows 3
    and 4), the 4-stream model's forward (``make_server``, row 5) and train
    step (rows 6 and 7), each at the cells' batch (256, and 512 for the
    4-stream step) and at the reference batch (8 scoring, 10 training),
    with every f32 LSTM row's ``.launches`` and ``.launches_tiled`` and the
    Adam kernel's ``adam_update.launches`` set to 0 before each call.  At
    the cells' batch every launch of the path's rows must take the large-B
    body (the two counts equal and nonzero), at the reference batch none,
    and no other LSTM row may launch; each train step must launch the Adam
    kernel once a table of its tree (one table at both trees), a scoring
    call never.  Returns {row: {B: [launches, launches_tiled]}}, and under
    ``"adam"`` {model: {B: Adam launches of the train step}}."""
    import numpy as np
    import torch

    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.ops.kernels import adam as kadam
    from ip_avsr_torch.ops.kernels import lstm as kl
    from ip_avsr_torch.serve import make_server, make_trimodal_server
    from ip_avsr_torch.train.trainer import Trainer, TrainOptions

    wrappers = {row: getattr(kl, fn) for row, fn in LSTM_WRAPPERS.items()}
    cfg4, training4 = oulu_4stream()
    out = {row: {} for row in LSTM_WRAPPERS}
    out["adam"] = {}
    for cfg, lr, peep, train_b in ((flagship(), 1e-4, False, 256),
                                   (cfg4, training4.learning_rate, True, 512)):
        params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 15), cfg,
                                           device=dev)
        model = "4-stream" if peep else "flagship"
        tables = -(-len(kadam._leaves(params)) // kadam.CAPACITY)
        trainer = Trainer(cfg, TrainOptions(learning_rate=lr, optimizer="adam",
                                            log_fn=lambda _: None), device=dev)
        opt_state = trainer.optimizer.init(params)
        gen = torch.Generator(device=dev).manual_seed(SEED + 15)
        if peep:
            server = make_server(params, cfg, device=dev)
        else:
            server = make_trimodal_server(params, cfg, IMAGE_SHAPE, DCT, device=dev)
        rng = np.random.RandomState(SEED + 15)

        def score(B):
            streams, mask, _ = stream_batch(cfg, B, SEED + 15, dev)
            if peep:
                return server(streams, mask)
            raw = rng.randint(0, 256, (B, T_FRAMES, 1144)).astype(np.uint8)
            return server(raw, mask.cpu().numpy())

        def step(B):
            streams, mask, y = stream_batch(cfg, B, SEED + 16, dev)
            return trainer.train_step(params, opt_state, streams, y, mask, gen, lr)

        p = "peep_" if peep else ""
        for rows, call, batches in (((f"lstm_{p}fwd",), score, (256, 8)),
                                    ((f"lstm_{p}fwd_train", f"lstm_{p}bwd"), step,
                                     (train_b, TRAIN_B))):
            for B in batches:
                for fn in wrappers.values():
                    fn.launches = fn.launches_tiled = 0
                kadam.adam_update.launches = 0
                call(B)
                torch.cuda.synchronize()
                counts = {r: [fn.launches, fn.launches_tiled] for r, fn in wrappers.items()}
                adam = kadam.adam_update.launches
                want = tables if call is step else 0
                print(f"main path {model} {call.__name__} B={B}: adam_update.launches = {adam}")
                if adam != want:
                    raise AssertionError(f"main path {model} {call.__name__} B={B}: "
                                         f"adam_update.launches = {adam}, expected {want}")
                if call is step:
                    out["adam"].setdefault(model, {})[B] = adam
                for row in rows:
                    out[row][B] = counts[row]
                    n, tiled = counts[row]
                    print(f"main path {row} B={B}: {LSTM_WRAPPERS[row]}.launches = {n}, "
                          f".launches_tiled = {tiled}")
                    if not (n and tiled == (n if B > TRAIN_B else 0)):
                        raise AssertionError(f"main path {row} B={B}: launches {counts}, "
                                             f"expected every launch of {row} in the large-B "
                                             f"body at B = {B} > {TRAIN_B} and none at "
                                             f"B <= {TRAIN_B}")
                others = {r: c for r, c in counts.items() if r not in rows and c != [0, 0]}
                if others:
                    raise AssertionError(f"main path {rows} B={B}: other rows launched: "
                                         f"{others}")
    return out


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
    tiled_err, numbers = tiled_check(dev, "lstm_fwd_train")
    tiled_bwd_err, bwd_numbers = bwd_tiled_check(dev, "lstm_bwd")
    rows["large_b"] = {"lstm_fwd_train": numbers, "lstm_bwd": bwd_numbers}
    return max(fwd_err, tiled_err), max(bwd_err, tiled_bwd_err), rows


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
    one on the card) are left out.  A trace whose host side made
    cooperative launches of which the card's side recorded none (the H100's
    profiler has dropped all of them, in phase_lstm_state and phase_bf16)
    is taken again, once; the callers' checks hold the trace that is
    returned."""
    import torch
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(2):
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
        host = sum(e.count for e in events if e.key == "cudaLaunchCooperativeKernel")
        chains = sum(e.count for e in events
                     if e.device_type == DeviceType.CUDA and "_chain_kernel" in e.key)
        if not (host and not chains) or attempt:
            return events
        print(f"traced: the card's side recorded none of the host's {host} cooperative "
              f"launches; tracing again")


def trace_chain(fn, label, row, steps, n=5, lost_ok=False):
    """Trace ``n`` calls of a persistent kernel's wrapper with torch.profiler:
    each call must be exactly one launch of the instantiation of ``row``
    (:data:`CHAIN_TRACE`) and no other device work.  Prints and returns its
    device time per call, and prints it per step over ``steps``.  With
    ``lost_ok``, a trace that recorded fewer launches (at least one) passes
    where the host made exactly ``n`` cooperative launch calls and no other
    device op appears: late in a run the H100's profiler has dropped such
    records even after :func:`traced`'s warm-up step (4 of 5; all of them
    after phase_tools); the time is then per recorded launch."""
    from torch.autograd import DeviceType

    events = traced(fn, n)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    ours = [e for e in device if re.search(CHAIN_TRACE[row], e.key)]
    launches = sum(e.count for e in ours)
    others = sum(e.count for e in device) - launches
    host = sum(e.count for e in events if e.key == "cudaLaunchCooperativeKernel")
    ms = sum(e.self_device_time_total for e in ours) / 1e3 / max(launches if lost_ok else n, 1)
    names = sorted({re.search(r"lstm_\w+_chain_kernel<[^>]*>", e.key).group(0) for e in ours})
    print(f"{label}: traced {n} calls, {launches} launches of {names} ({host} cooperative "
          f"launch calls on the host) and {others} other device ops; device time {ms:.4f} ms "
          f"per call, {ms * 1e3 / steps:.3f} us per step (/ {steps}; the earlier "
          f"one-launch-per-step kernels took 5.2-8.0 us per step launch)")
    lost = lost_ok and host == n and 1 <= launches < n
    if (launches != n and not lost) or others:
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


def phase_serve(dev, trees):
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
    trees["flagship"] = (cfg, tree_to(params, torch.device("cpu")))
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
    got = {row: sum(e.count for e in device if re.search(name, e.key)) / n
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
    reset_adam_launches()
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
    expect_adam_launches(params, n_steps, "train")
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
    rows["large_b"] = {}
    tiled_err, rows["large_b"]["lstm_peep_fwd"] = tiled_check(dev, "lstm_peep_fwd")
    tiled_train_err, rows["large_b"]["lstm_peep_fwd_train"] = tiled_check(
        dev, "lstm_peep_fwd_train")
    tiled_bwd_err, rows["large_b"]["lstm_peep_bwd"] = bwd_tiled_check(dev, "lstm_peep_bwd")
    return (max(fwd_err, tiled_err), max(train_err, tiled_train_err),
            max(bwd_err, tiled_bwd_err), rows)


def phase_chunks(dev):
    """Batches that do not fit one launch, and forced row chunks at a small
    batch, each chunked call held against its plain version (relative to
    each output's max abs) and timed on the event clock: rows 1 and 3 at
    B = 6000 and rows 3 and 4 at B = 2100 (H = 500, T = 29) through their
    wrappers (all four take the large-B body there, whose row groups fit 256
    rows a launch beside H = 500's unit groups: 24 and 9 chunks); rows 1 and
    3 again at B = 6000 and row 4 at B = 2100 in the small-B body, forced,
    whose carries overflow one block's shared memory beside W_hid there (the
    cap of 5982 rows gives 2 chunks; row 4's cap of 2077 gives B = 2100 its
    2), as they do wherever the large-B plan does not fit (H above 512, or
    too few SMs) and B is large enough; then all six persistent rows at
    B = 64 in 3 chunks of 21, 21 and 22 rows (H = 500, or 250 with
    peepholes); every call also into NaN-filled outputs."""
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

    # (row, B, H, chunks, tiled): tiled False forces the small-B body
    for name, B, H, chunks, tiled in (
            ("lstm_fwd", 6000, 500, None, None), ("lstm_fwd_train", 6000, 500, None, None),
            ("lstm_fwd_train", 2100, 500, None, None), ("lstm_bwd", 2100, 500, None, None),
            ("lstm_fwd", 6000, 500, None, False), ("lstm_fwd_train", 6000, 500, None, False),
            ("lstm_bwd", 2100, 500, None, False),
            *((n, 64, 250 if "peep" in n else 500, 3, None) for n in (*fwd_rows, *bwd_rows))):
        label = (f"{name} B={B} H={H}" + (f" forced into {chunks} chunks" if chunks else "")
                 + (" in the small-B body" if tiled is False else ""))
        if name in fwd_rows:
            wrapper, plain, train, peep = fwd_rows[name]
            args, vecs = inputs(B, H, peep)

            def call():
                if chunks is None and tiled is None:
                    return wrapper(*args, *vecs)
                return kl._run_fwd(name, args, train, peep=vecs, chunks=chunks, tiled=tiled)

            got = call()
            got = got if train else (got,)
            ref = plain(*args, *vecs)
            ref = ref if train else (ref,)
            nan = [torch.full_like(g, float("nan")) for g in got]
            kl._run_fwd(name, args, train, peep=vecs, chunks=chunks, outs=nan, tiled=tiled)
            if not all(torch.equal(a, b) for a, b in zip(nan, got)):
                raise AssertionError(f"{label}: NaN-filled outputs not bit-equal")
            ms = cuda_ms(call, iters=3, warmup=1)
            plan = kl.fwd_plan(B, H, sm_count, chunks=chunks, tiled=tiled)
            if tiled is False and plan.chunks < 2:
                raise AssertionError(f"{label}: expected the small-B body's row chunks, got "
                                     f"{plan}")
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
                if chunks is None and tiled is None:
                    return chain(*bargs, *vecs, 5.0)
                return kl._run_bwd(name.replace("bwd", "bwd_chain"), bargs, 5.0, vecs,
                                   chunks=chunks, tiled=tiled)

            got = call()
            nan = [torch.full_like(g, float("nan")) for g in got[:3]]
            again = kl._run_bwd(name.replace("bwd", "bwd_chain"), bargs, 5.0, vecs,
                                chunks=chunks, outs=nan, tiled=tiled)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"{label}: NaN-filled outputs not bit-equal")
            ms = cuda_ms(call, iters=3, warmup=1)
            plan = kl.bwd_plan(B, H, sm_count, chunks=chunks, tiled=tiled)
            if tiled is False and plan.chunks < 2:
                raise AssertionError(f"{label}: expected the small-B body's row chunks, got "
                                     f"{plan}")
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


def phase_serve_4stream(dev, trees):
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
    trees["4-stream"] = (cfg, tree_to(params, torch.device("cpu")))
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
    reset_adam_launches()
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
    expect_adam_launches(params, n_steps, "4-stream train")
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
    """``--ab``: row 2 per forward of both models (:func:`delta_ab`), rows 4
    and 7 at B = 8 and 10 (H = 500 and 250) through their wrappers (back to
    back on the event clock, traced, and a call on the host clock), then the 4-stream serve (B = 10) and train (B =
    10) paths and the flagship's (serve B = 1 and 8, train B = 10) of
    whichever package is first on the path, through the entry points every
    version of the port has: each path's median on the host clock, then its
    trace (device time, kernels, host launch calls, row 2's launches and
    device time).  Returns the numbers."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import ip_avsr_torch
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.serve import make_server, make_trimodal_server
    from ip_avsr_torch.train import trainer

    out = {"package": os.path.dirname(os.path.abspath(ip_avsr_torch.__file__))}
    out.update(delta_ab(dev))
    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 18)
    for name, H in (("lstm_bwd", 500), ("lstm_peep_bwd", 250)):
        chain = getattr(kl, LSTM_WRAPPERS[name])
        for B in (8, TRAIN_B):
            bargs, vecs = bwd_chain_inputs(B, T_FRAMES, H, "peep" in name, gen, dev)

            def call():
                return chain(*bargs, *vecs, 5.0)

            ms = queued_ms(call)
            traced_ms = trace_chain(call, f"{name} B={B} H={H}", name, T_FRAMES + 1)
            host_ms = host_median_ms(call)
            print(f"{name} B={B} H={H}: {ms:.4f} ms a call back to back (event clock), "
                  f"traced {traced_ms:.4f}, host clock {host_ms:.4f}")
            out[f"{name} B={B}"] = dict(ms=ms, traced_ms=traced_ms, host_ms=host_ms)
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
            kl._count(counter, w_hid)
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
        # (the bf16-stored w_hid runs row 5's bf16 instantiation, which
        # rounds h_{t-1} to bf16 as the JAX package's recurrence does)
        for name, wd, tol, vote_live in (("4stream", None, SCORE_TOL, live4),
                                         ("4stream_bf16", "bfloat16", EXPORT_BF16_TOL,
                                          live4_probs)):
            path = export(name, export_lib.save_artifact, params4, cfg4, weights_dtype=wd,
                          vote=wd is None, device=dev)
            art = export_lib.load_server(path, device=dev)
            row = "lstm_peep_fwd" if wd is None else "lstm_peep_fwd_bf16"
            result["err"][name] = check_artifact(name, art, vote_live, requests4, row, 6,
                                                 totals, tol)
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
    training batch to the card (``_to_device``), the step's host time
    (``train_step``, which returns before the card finishes) and the start
    of each copy, and the time of each log line (one per epoch)."""

    def __init__(self, trainer, batchsize):
        import numpy as np

        self.assembly, self.pin, self.copy, self.step, self.starts, self.logs = (
            [], [], [], [], [], [])
        batches, host_batch, to_device, train_step = (
            trainer._infinite_batches, trainer._host_batch, trainer._to_device,
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

        def timed_copy(batch):
            t0 = time.perf_counter()
            out = to_device(batch)
            if len(batch[2]) == batchsize:
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
        trainer._to_device = timed_copy
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


def phase_zoo(dev, trees):
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
        trees[f"zoo {label}"] = (cfg, tree_to(params, cpu))
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
        del server
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


# phase_oracle: the card's full-width forwards against the port's numpy
# oracle (ip_avsr_torch/reference_impl.py, which shares no code with the
# port), from the trees earlier phases built (``trees``), at B = 8, T = 29 with
# a ragged mask (a full row and a row of length 1)
ORACLE_B = 8
ORACLE_CONVAE_B = 8
# the conv-AE's reconstructions (up to 2.4 in magnitude, scaled tanh) pass
# through convolutions of 2500 products each (conv3, 100 -> 150 channels at
# 5 x 5), summed in another order by cuDNN than by the oracle's einsum, and
# through batch statistics: held as tests/test_reference_parity.py holds the
# JAX forward to the oracle, |card - oracle| <= ORACLE_ATOL + ORACLE_RTOL |oracle|
ORACLE_RTOL = 2e-4
ORACLE_ATOL = 2e-5
def cpu_model():
    """The host CPU's model name (``lscpu``'s, else /proc/cpuinfo's) and
    architecture."""
    import platform

    name = None
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=10).stdout
        name = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                     if line.startswith("Model name")), None)
    except (OSError, subprocess.SubprocessError):
        pass
    if name is None and os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            name = next((line.split(":", 1)[1].strip() for line in f
                         if line.startswith("model name")), None)
    return f"{name or 'unknown'} ({platform.machine()})"


def perturbed(params, seed):
    """A copy of ``params`` whose biases, scales, coefficients and initial
    states (the leaves with at most one dimension above 1, which init fills
    with 0 or 1) carry seeded N(0, 0.1^2) noise, so that their wiring shows;
    weight matrices and kernels are the same tensors."""
    import torch

    from ip_avsr_torch.device import tree_map

    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + (0.1 * torch.randn(t.shape, generator=gen)).to(t.device)
                    if t.dim() < 2 or t.shape[0] == 1 else t, params)


def oracle_batch(cfg, seed):
    """Seeded normal (B, T, D_i) features per stream and a ragged mask
    (row 0 full, row 1 one frame long), as numpy."""
    import numpy as np

    rng = np.random.RandomState(seed)
    inputs = [rng.randn(ORACLE_B, T_FRAMES, s.input_dim).astype(np.float32)
              for s in cfg.streams]
    lens = rng.randint(1, T_FRAMES + 1, ORACLE_B)
    lens[0], lens[1] = T_FRAMES, 1
    return inputs, (np.arange(T_FRAMES)[None] < lens[:, None]).astype(np.float32)


def clip0_check(dev, params, totals):
    """``blstm_forward(grad_clipping=0)`` at the flagship aggregator's shape
    (its own BLSTM, H = 250 over the 250-wide fused streams, B = TRAIN_B,
    T = 29, ragged): rows 3 and 4 with clip 0 on the card, every gradient
    against the CPU path within TRAIN_GRAD_TOL of its max abs, under an
    upstream x100 that makes clip 5 differ.  Returns the numbers."""
    import numpy as np
    import torch

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.ops import lstm as lstm_ops

    layer = params["aggregator"][0]
    H, D = layer["fwd"]["w_hid"].shape[0], layer["fwd"]["w_in"].shape[0]
    rng = np.random.RandomState(SEED + 70)
    x = rng.randn(TRAIN_B, T_FRAMES, D).astype(np.float32)
    lens = rng.randint(1, T_FRAMES + 1, TRAIN_B)
    lens[0] = T_FRAMES
    mask = (np.arange(T_FRAMES)[None] < lens[:, None]).astype(np.float32)
    g = 100.0 * rng.randn(TRAIN_B, T_FRAMES, H).astype(np.float32)
    cpu = torch.device("cpu")

    def grads(device, clip):
        fwd, bwd = (tree_map(lambda t: t.detach().to(device).clone().requires_grad_(True),
                             layer[k]) for k in ("fwd", "bwd"))
        xt = torch.from_numpy(x).to(device).requires_grad_(True)
        out = lstm_ops.blstm_forward(fwd, bwd, xt, torch.from_numpy(mask).to(device),
                                     "sum", clip)
        (out * torch.from_numpy(g).to(device)).sum().backward()
        leaves = {f"{k}/{n}": t.grad for k, tree in (("fwd", fwd), ("bwd", bwd))
                  for n, t in tree.items()}
        return tree_to({**leaves, "x": xt.grad}, cpu)

    reset_launches()
    card = grads(dev, 0.0)
    torch.cuda.synchronize()
    launches = read_launches()
    count_into(totals, launches)
    expect_launches(launches, lstm_fwd_train=2, lstm_bwd=2)
    host, clipped = grads(cpu, 0.0), grads(dev, 5.0)
    rel = {k: max_err(card[k], v)[0] / max(v.abs().max().item(), 1e-30)
           for k, v in host.items()}
    bite = max_err(clipped["x"], card["x"])[0] / card["x"].abs().max().item()
    worst = max(rel, key=rel.get)
    print(f"oracle, blstm_forward(grad_clipping=0) at the flagship aggregator's shape (B="
          f"{TRAIN_B}, T={T_FRAMES}, D={D}, H={H}, upstream x100): launches "
          f"{ {k: v for k, v in launches.items() if v} }; card "
          f"vs CPU path, gradients relative to max abs worst {rel[worst]:.2e} ({worst}; held "
          f"to {TRAIN_GRAD_TOL:g}); clip 5 moves dx by {bite:.2e} of its max abs")
    if not (all(e <= TRAIN_GRAD_TOL for e in rel.values()) and bite > 1e-2):
        raise AssertionError("oracle: blstm_forward(grad_clipping=0) on the card disagrees "
                             "with the CPU path, or clip 5 does not bite")
    return dict(grad_rel=rel[worst], clip5_moves_dx=bite)


def phase_oracle(dev, trees):
    """The card's full-width forwards against the port's numpy oracle
    (``reference_impl.adenet_forward_np`` / ``convae_forward_np``, run on
    the host from the same parameters through ``torch_tree_to_np``): the
    flagship (phase_serve's tree), the 4-stream model (phase_serve_4stream's,
    per-step probabilities before the vote), every model of
    :func:`zoo_models` (phase_zoo's, running statistics moved) and the
    conv-AE plain and batchnorm (convae_check's, its images), each with its
    biases, scales, coefficients and initial states moved off their init
    (:func:`perturbed`), through ``models/adenet.adenet_forward`` (or
    ``models/convae.convae_forward``) in evaluation mode.  Probabilities
    held within SCORE_TOL of the oracle, reconstructions within
    ORACLE_RTOL / ORACLE_ATOL; the port's CPU path's distance from the
    oracle printed beside the card's, the card's forward time (CUDA
    events) beside the oracle's host time.  Then :func:`clip0_check`.
    ``trees`` maps each label to (config, parameter tree on the host[,
    input]), as those phases fill it.  Returns ({row: launches} over the phase, its
    numbers)."""
    import numpy as np
    import torch

    from ip_avsr_torch import reference_impl
    from ip_avsr_torch.device import tree_to
    from ip_avsr_torch.models import adenet, convae

    totals, numbers = {name: 0 for name in KERNEL_COUNTERS}, {}
    cpu = torch.device("cpu")
    card = smi("name,power.limit")
    threads = torch.get_num_threads()
    print(f"oracle: host {cpu_model()}, {os.cpu_count()} cores, torch threads {threads}; "
          f"card {card}")
    expected = {"flagship": dict(lstm_fwd=5, delta=1),
                "4-stream": dict(lstm_peep_fwd=6, delta=1),
                **{f"zoo {k}": v for k, v in ZOO_LAUNCHES.items()},
                "convae plain": {}, "convae batchnorm": {}}
    for i, (label, want_launches) in enumerate(expected.items()):
        cfg, params, *rest = trees[label]
        params = perturbed(tree_to(params, dev), SEED + 80 + i)
        host_params = reference_impl.torch_tree_to_np(params)
        if label.startswith("convae"):
            x = rest[0][:ORACLE_CONVAE_B].numpy()
            inputs = [torch.from_numpy(x).to(dev)]

            def forward(p, xs, _cfg=cfg):
                return convae.convae_forward(p, _cfg, xs[0])

            def oracle(_p=host_params, _cfg=cfg, _x=x):
                return reference_impl.convae_forward_np(_p, _cfg, _x)
        else:
            xs, mask = oracle_batch(cfg, SEED + 80 + i)
            inputs = [torch.from_numpy(a).to(dev) for a in xs] + [torch.from_numpy(mask).to(dev)]

            def forward(p, xs, _cfg=cfg):
                return adenet.adenet_forward(p, _cfg, xs[:-1], xs[-1])

            def oracle(_p=host_params, _cfg=cfg, _xs=xs, _mask=mask):
                return reference_impl.adenet_forward_np(_p, _cfg, _xs, _mask)
        with torch.no_grad():
            forward(params, inputs)  # warm-up
            torch.cuda.synchronize()
            reset_launches()
            got = forward(params, inputs)
            torch.cuda.synchronize()
            launches = read_launches()
            count_into(totals, launches)
            expect_launches(launches, **want_launches)
            host = forward(tree_to(params, cpu), tree_to(inputs, cpu))
            ms = cuda_ms(lambda: forward(params, inputs), iters=10)
        want = oracle()
        got, ref = got.cpu().numpy(), want
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"oracle, {label}: shape {got.shape} against {ref.shape}, "
                                 f"or not finite")
        err, cpu_err = np.abs(got - ref).max(), np.abs(host.numpy() - ref).max()
        if label.startswith("convae"):
            over = (np.abs(got - ref) - ORACLE_ATOL - ORACLE_RTOL * np.abs(ref)).max()
            limit = f"|d| <= {ORACLE_ATOL:g} + {ORACLE_RTOL:g} |oracle|, worst margin {-over:.2e}"
            ok = over <= 0
        else:
            limit = f"held to {SCORE_TOL:g}"
            ok = err <= SCORE_TOL
        host_ms = host_median_ms(oracle, calls=3, warmup=0)
        print(f"oracle, {label}: |card - oracle| {err:.2e} ({limit}), |CPU path - oracle| "
              f"{cpu_err:.2e}; launches {({k: v for k, v in launches.items() if v})}; card "
              f"forward {ms:.3f} ms (CUDA events, B={len(ref)}; {card}); oracle "
              f"{host_ms:.1f} ms per forward (host clock, median of 3)")
        if not ok:
            raise AssertionError(f"oracle, {label}: the card disagrees with the numpy oracle")
        numbers[label] = dict(err=float(err), cpu_err=float(cpu_err), ms=ms, oracle_ms=host_ms)
        del params, inputs
    numbers["clip0"] = clip0_check(dev, trees["flagship"][1], totals)
    numbers["host"] = dict(cpu=cpu_model(), cores=os.cpu_count(), card=card)
    print(f"oracle: launches over the phase {totals}")
    return totals, numbers


# phase_adam: the multi-tensor Adam kernel (csrc/adam.cu) at the benchmark
# cells' parameter trees, seeded as the benchmark seeds them
ADAM_CONFIGS = ("adenet_v3-oulu-trimodal", "adenet-oulu-4stream")
ADAM_STEPS = 5
# adam_vlr's rates by path prefix over a base rate, for both trees
ADAM_LR_MAP = ({"aggregator": 3e-4, "output": 1e-3}, 1e-4)
# block sizes (values a block) timed beside the wrapper's CHUNK with --adam
ADAM_CHUNKS = (512, 1024, 2048, 4096, 16384)


def adam_tree(name, dev):
    """``(model config, parameter tree)`` of the benchmark configuration
    ``name``, seeded as ``avsr_bench/harness/inputs.make_weights``."""
    from avsr_bench.harness import inputs

    with open(os.path.join(ROOT, "avsr_bench", "configs", f"{name}.json")) as f:
        model = json.load(f)["model"]
    return model, inputs.make_weights(model, SEED, dev)


def adam_grads(params, step, dev):
    """A seeded gradient tree: standard normal leaves scaled by 1e-k, k
    cycling over 0-3 leaf by leaf (the trees' gradients span such ranges)."""
    import torch
    from ip_avsr_torch.ops.kernels.adam import _leaves, _rebuild

    gen = torch.Generator(device=dev).manual_seed(SEED + 100 + step)
    return _rebuild(params, [torch.randn(p.shape, generator=gen, device=dev) * 10.0 ** -(i % 4)
                             for i, p in enumerate(_leaves(params))])


def adam_differs(got, want):
    """(leaves that differ, values that differ, max abs difference) of two
    trees."""
    import torch
    from ip_avsr_torch.ops.kernels.adam import _leaves

    bad = [(a, b) for a, b in zip(_leaves(got), _leaves(want)) if not torch.equal(a, b)]
    return (len(bad), sum(int((a != b).sum()) for a, b in bad),
            max([(a - b).abs().max().item() for a, b in bad], default=0.0))


def phase_adam(dev, chunks=None):
    """The multi-tensor Adam kernel at both benchmark cells' trees: p, m, v
    and t bit-equal to the plain version (``ops/kernels/adam.plain``, the
    eager tree_maps) over 5 steps for ``adam`` and ``adam_vlr``, one launch
    an update a table; the kernel's time (20 launches, the card's clock
    with the stream held busy) beside its bound, at the wrapper's
    ``CHUNK`` values a block and at each of ``chunks`` besides; the whole
    update
    (``apply``: the step scalar's chain, the outputs, the table, the
    launch) and the plain version on the card's clock with the stream held
    busy (``queued_ms``) and on the host's; ``torch.optim.Adam(fused=True)``
    on the same tree as a yardstick of time only (its eps is added
    elsewhere than Lasagne's: the port never calls it)."""
    import torch
    from ip_avsr_torch.ops.kernels import adam as kadam
    from ip_avsr_torch.train import optimizers as opt_lib

    out = {"capacity": kadam.CAPACITY, "chunk": kadam.CHUNK}
    for name in ADAM_CONFIGS:
        _, params = adam_tree(name, dev)
        leaves = kadam._leaves(params)
        n = sum(t.numel() for t in leaves)
        rates, base = ADAM_LR_MAP
        lr_map = opt_lib.generate_lr_map(params, rates, base)
        tables = -(-len(leaves) // kadam.CAPACITY)
        row = {"leaves": len(leaves), "values": n}
        for kind in ("adam", "adam_vlr"):
            opt = opt_lib.adam(1e-4) if kind == "adam" else opt_lib.adam_vlr(lr_map, base_lr=base)
            state = opt.init(params)
            p, ref_p, ref_m, ref_v, ref_t = params, params, state["m"], state["v"], state["t"]
            for step in range(ADAM_STEPS):
                g = adam_grads(params, step, dev)
                lr = 1e-4 * 0.9 ** step
                kadam.adam_update.launches = 0
                p, state = opt.apply(p, g, state, learning_rate=lr)
                if kadam.adam_update.launches != tables:
                    raise AssertionError(f"adam {name} {kind}: {kadam.adam_update.launches} "
                                         f"launches an update, expected {tables}")
                ref_t = ref_t + 1.0
                scale = lr if kind == "adam" else lr / base
                s = scale * torch.sqrt(1.0 - 0.999 ** ref_t) / (1.0 - 0.9 ** ref_t)
                ref_p, ref_m, ref_v = kadam.plain(ref_p, g, ref_m, ref_v, s, 0.9, 0.999, 1e-8,
                                                  None if kind == "adam" else lr_map)
                for label, got, want in (("p", p, ref_p), ("m", state["m"], ref_m),
                                         ("v", state["v"], ref_v), ("t", state["t"], ref_t)):
                    leaves_off, values_off, worst = adam_differs(got, want)
                    if leaves_off:
                        raise AssertionError(
                            f"adam {name} {kind} step {step}: {label} differs from the plain "
                            f"version in {leaves_off} leaves, {values_off} values, max abs "
                            f"{worst:.3e}")
            row[f"{kind}_bit_equal_steps"] = ADAM_STEPS
        # the kernel alone: the wrapper's launches (outputs, table, launch)
        # with the stream held busy, so the card's clock reads the kernel
        opt = opt_lib.adam(1e-4)
        state = opt.init(params)
        g = adam_grads(params, 0, dev)
        a_t = torch.full((), 1e-4, dtype=torch.float32, device=dev)
        groups = [leaves] + [kadam._leaves(t) for t in (g, state["m"], state["v"])]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def kernel(chunk):
            return lambda: kadam._launch(groups, a_t, [1.0] * len(leaves), 0.9, 0.999, 1e-8,
                                         stream, chunk=chunk)

        by_chunk = {chunk: queued_ms(kernel(chunk))
                    for chunk in sorted({kadam.CHUNK, *(chunks or ())})}
        bound_ms, bound_by = bound(28 * n, 9 * n)
        row.update(kernel_ms_by_chunk=by_chunk, kernel_ms=by_chunk[kadam.CHUNK])
        row.update(bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / row["kernel_ms"])
        # the whole update, and the plain version, on the card's clock and
        # the host's
        apply = lambda: opt.apply(params, g, state, learning_rate=1e-4)  # noqa: E731

        def plain():
            t = state["t"] + 1.0
            s = 1e-4 * torch.sqrt(1.0 - 0.999 ** t) / (1.0 - 0.9 ** t)
            kadam.plain(params, g, state["m"], state["v"], s, 0.9, 0.999, 1e-8)

        row.update(apply_ms=queued_ms(apply), apply_host_ms=host_median_ms(apply),
                   plain_ms=queued_ms(plain), plain_host_ms=host_median_ms(plain))
        # the library's fused Adam, in place on its own copies
        ps = [t.clone().requires_grad_(True) for t in leaves]
        for t, grad in zip(ps, kadam._leaves(g)):
            t.grad = grad.clone()
        library = torch.optim.Adam(ps, lr=1e-4, eps=1e-8, fused=True)
        row["library_ms"] = queued_ms(library.step)
        row["library_host_ms"] = host_median_ms(library.step)
        del ps, library
        out[name] = row
        print(f"adam {name}: {len(leaves)} leaves, {n} values, {tables} launch(es) an update, "
              f"bit-equal over {ADAM_STEPS} steps (adam, adam_vlr); kernel "
              f"{row['kernel_ms']:.4f} ms against a bound of {bound_ms:.4f} ({bound_by}, "
              f"{100 * row['bound_share']:.1f}%); by chunk {row['kernel_ms_by_chunk']}; "
              f"apply {row['apply_ms']:.4f} ms card, {row['apply_host_ms']:.4f} host; plain "
              f"{row['plain_ms']:.4f} card, {row['plain_host_ms']:.4f} host; "
              f"torch.optim.Adam(fused=True) {row['library_ms']:.4f} card, "
              f"{row['library_host_ms']:.4f} host")
    torch.cuda.synchronize()
    return out


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


def convae_check(dev, images, numbers, trees):
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
        trees[f"convae {variant}"] = (cfg, params, x)
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


def phase_pretrain(dev, trees):
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
        convae_check(dev, train_X, numbers, trees)
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


# ---------------------------------------------------------------------------
# phase_bf16: matmul_dtype="bfloat16", the six LSTM rows' bf16 instantiations
# ---------------------------------------------------------------------------

# the bf16 instantiations: kernels-line name -> (float32 row, TPU kernel line,
# the row's shape on the main path as B, H)
BF16_ROWS = {
    "lstm_fwd_bf16": ("lstm_fwd", 42, 8, 500),
    "lstm_fwd_train_bf16": ("lstm_fwd_train", 131, TRAIN_B, 500),
    "lstm_bwd_bf16": ("lstm_bwd", 240, TRAIN_B, 500),
    "lstm_peep_fwd_bf16": ("lstm_peep_fwd", 343, TRAIN_B, 250),
    "lstm_peep_fwd_train_bf16": ("lstm_peep_fwd_train", 388, TRAIN_B, 250),
    "lstm_peep_bwd_bf16": ("lstm_peep_bwd", 515, TRAIN_B, 250),
}
# bf16 kernels against their plain versions (the same bf16 W_hid on both
# sides, TF32 off), relative to max(1, max |ref|).  At T = 1 both round the
# same operands (the given hid0; dgates of elementwise math), so only the
# float32 summation order differs: LSTM_TOL.  Over T = 29 steps an operand
# within that order's difference of a bf16 rounding boundary rounds to the
# neighbouring bf16 value on one side, and the one-ulp difference carries
# through the rest of its row: a few entries differ by up to
# BF16_CHAIN_TOL, of the size of the whole float32-vs-bf16 gap (1e-3 to
# 3e-3), so the max cannot tell the two apart.  The mean can: the float32
# instantiation on the same inputs (W_hid's bf16 values widened, nothing
# else rounded) moves every entry, so the kernel's mean error must be within
# BF16_CHAIN_MEAN_TOL and at most 1 / BF16_SEPARATION of that
# instantiation's mean distance from the same reference.  Read on an NVIDIA
# H100 80GB HBM3, 700 W, at the main path's shapes: max 9.9e-5 to 1.3e-3
# (2.3e-3 at B = 1-64, H = 130-500); mean 7e-9 to 5.3e-5 against gaps of
# 6.3e-5 to 3.5e-4, each at least 6.6 times its error.
BF16_CHAIN_TOL = 3e-3
# rounds of turns (f32, bf16, bf16, f32) behind each bf16 row's times
BF16_TIMING_ROUNDS = 3
# bf16_kernel_checks' sweep: batches of one, one ragged, two and four
# 16-row tensor-core tiles, and widths of 4, 2 and 1 units per block
BF16_SWEEP_B = (1, 10, 17, 64)
BF16_SWEEP_H = (500, 250, 130)
BF16_CHAIN_MEAN_TOL = 1e-4
BF16_SEPARATION = 3.0
# the bf16 models on the card against the port's CPU path at bf16, each side
# rounding its own operands (flips as above), beside the card's float32
# model against the same CPU path, read on the same card: probabilities
# absolute, max (read 2.3e-5 flagship, 1.06e-4 4-stream; float32 2.9e-4 to
# 5.1e-4 away) and mean (read 5.2e-6 and 1.3e-5; float32 26 and 6.2 times
# that); a train step's loss relative (read 2.4e-5 and 6.2e-7; float32 5.0e-5
# and 3.0e-5 away: one scalar, which cannot tell them apart), its gradients
# as one vector in relative norm (read 1.0e-3 and 1.1e-3; float32 3.4 and
# 3.8 times that), and Adam's first moment after one step (the gradients
# through the step function) in the same norm
BF16_SCORE_TOL = 1.5e-4
BF16_SCORE_MEAN_TOL = 2.5e-5
BF16_LOSS_TOL = 4e-5
BF16_GRAD_NORM_TOL = 1.5e-3


def mean_err(got, ref):
    """Mean abs difference over max(1, max |ref|)."""
    return (got - ref).abs().mean().item() / max(1.0, ref.abs().max().item())


def separated(label, err, gap, tol):
    """Print ``err`` (bf16 against the bf16 reference) beside ``gap`` (the
    float32 computation against the same reference) and raise unless err
    is within ``tol`` and at most 1 / BF16_SEPARATION of the gap: the check
    then fails a computation that stopped rounding."""
    print(f"{label}: {err:.2e} (tol {tol:g}); float32 {gap:.2e} away, "
          f"{gap / max(err, 1e-30):.1f} times the error (at least {BF16_SEPARATION:g})")
    if not err <= tol:
        raise AssertionError(f"{label}: bf16 disagrees with its reference ({err:.3e})")
    if not err * BF16_SEPARATION <= gap:
        raise AssertionError(f"{label}: the float32 computation lies {gap:.3e} from the bf16 "
                             f"reference, too close to this error ({err:.3e}) to tell them "
                             f"apart")


def bf16_inputs(B, T, H, gen, dev, peep):
    """Recurrence inputs at (B, T, H): x_proj, a bf16 W_hid (scaled
    1/sqrt(H)), a ragged mask with a full first row, nonzero initial states,
    and with ``peep`` the three (H,) vectors."""
    import torch

    x_proj = torch.randn(B, T, 4 * H, generator=gen).to(dev)
    w_hid = (torch.randn(H, 4 * H, generator=gen) / H ** 0.5).to(dev).to(torch.bfloat16)
    mask = ragged_mask(B, T, gen, dev)
    c0 = torch.randn(B, H, generator=gen).to(dev)
    h0 = (torch.randn(B, H, generator=gen) * 0.5).to(dev)
    pv = tuple((torch.randn(H, generator=gen) * 0.3).to(dev) for _ in range(3)) if peep else ()
    return (x_proj, w_hid, mask, c0, h0), pv


def bf16_kernel_checks(dev):
    """The six bf16 instantiations against their plain versions in bf16
    (``launch`` straight, not counted): rows 1 and 3 at B = 8 and TRAIN_B, H
    = 500, rows 5 and 6 at TRAIN_B, H = 250, into NaN-filled outputs; rows 4
    and 7 on the chains of those recurrences, clip 5 at x1 and x100 and clip
    0; T = 1 (LSTM_TOL) and T = 29 (BF16_CHAIN_TOL; the mean error against
    BF16_CHAIN_MEAN_TOL beside the float32 instantiation's); the state variants of
    rows 1 and 5 at B = 1; every row at B in BF16_SWEEP_B and H in
    BF16_SWEEP_H (T = 29, the chains at clip 5 and 0) and at U = 8 forced
    (B = 17, H = 500); row 1 and row 4 one batch above a bf16 launch's row
    cap (two chunks).  Returns {kernels-line name: worst error}."""
    import torch

    from ip_avsr_torch.ops.kernels import _build
    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 60)
    errs = {name: 0.0 for name in BF16_ROWS}

    def hold(name, label, got, ref, tol, f32=None):
        """``f32``: the float32 instantiation's outputs on the same inputs;
        the mean error is then held by :func:`separated` against their mean
        distance from ``ref``."""
        torch.cuda.synchronize()
        e = max(max_err(a, r)[1] for a, r in zip(got, ref))
        nan = any(torch.isnan(a).any().item() for a in got)
        print(f"bf16 {name} {label}: max error relative to max(1, |ref|) {e:.2e} (tol {tol:g})"
              + ("" if f32 is None else
                 f"; float32 instantiation {max(max_err(a, r)[1] for a, r in zip(f32, ref)):.2e}"
                 f" away"))
        if nan or not e <= tol:
            raise AssertionError(f"bf16 {name} {label}: the kernel disagrees with its plain "
                                 f"version ({e:.3e}, NaN {nan})")
        if f32 is not None:
            separated(f"bf16 {name} {label}: mean error",
                      max(mean_err(a, r) for a, r in zip(got, ref)),
                      max(mean_err(a, r) for a, r in zip(f32, ref)), BF16_CHAIN_MEAN_TOL)
        errs[name] = max(errs[name], e)

    def fwd(name, B, T, H, peep, train, state=False, units=None, free=True):
        """``free``: also against the free-running plain version (T = 1:
        LSTM_TOL; T = 29: the chain limits, the mean beside the float32
        instantiation's); at T > 1 always against the plain version fed the
        kernel's own operands, step by step (LSTM_TOL)."""
        args, pv = bf16_inputs(B, T, H, gen, dev, peep)
        shapes = ([(B, T, H), (B, T, H), (B, T, 4 * H)] if train
                  else [(B, T, H), (B, H)] if state else [(B, T, H)])
        outs = [torch.full(s, float("nan"), device=dev) for s in shapes]
        got = kl._run_fwd(name, args, train, pv, units=units, outs=outs, state=state)
        got = got if isinstance(got, tuple) else (got,)
        row = ("lstm_peep_fwd" if peep else "lstm_fwd") + ("_train" if train else "") + "_bf16"
        label = (f"B={B} T={T} H={H}{' state' if state else ''}"
                 f"{'' if units is None else f' U={units}'}")
        if T > 1:
            hids, cells, gates = kl._recurrence_plain(*args, pv or None, operands=got[0])
            forced = (hids, cells, gates) if train else (hids, cells[:, -1]) if state else (hids,)
            hold(row, f"{label} (each step from the kernel's operand)", got, forced, LSTM_TOL)
        if free:
            ref = getattr(kl, f"{name}_plain")(*args, *pv)
            ref = ref if isinstance(ref, tuple) else (ref,)
            tol = LSTM_TOL if T == 1 else BF16_CHAIN_TOL
            f32 = None
            if T == T_FRAMES:
                f32 = kl._run_fwd(name, (args[0], args[1].float(), *args[2:]), train, pv,
                                  units=units, state=state)
                f32 = f32 if isinstance(f32, tuple) else (f32,)
            hold(row, label, got, ref, tol, f32)
        return args, pv, got

    def bwd(B, T, H, peep, clip, scale, fwd_out, units=None, free=True):
        """As :func:`fwd`: at T > 1 against the plain chain fed the
        kernel's own dgates as each product's operand (LSTM_BWD_TOL), and
        with ``free`` against the free-running plain chain."""
        args, pv, (hids, cells, gates) = fwd_out
        g = torch.randn(B, T, H, generator=gen).to(dev) * scale
        c0 = args[3]
        cells_prev = torch.cat([c0[:, None], cells[:, :-1]], dim=1)
        chain = (g, gates, cells, cells_prev, args[2], args[1])
        got = kl._run_bwd("bf16 check", chain, clip, pv, units=units)
        name = "lstm_peep_bwd_bf16" if peep else "lstm_bwd_bf16"
        label = (f"B={B} T={T} H={H} clip={clip} x{scale:g}"
                 f"{'' if units is None else f' U={units}'}")
        if T > 1:
            dg, dc, dh, dw = kl._bwd_chain_plain(*chain, clip, pv or None, operands=got[0])
            forced = (dg, dc, dh, *(d.sum(dim=0) for d in dw)) if peep else (dg, dc, dh)
            hold(name, f"{label} (each step from the kernel's operand)", got, forced,
                 LSTM_BWD_TOL)
            if free:
                ref = (kl.lstm_peep_bwd_chain_plain(*chain, *pv, clip) if peep
                       else kl.lstm_bwd_chain_plain(*chain, clip))
                f32 = (kl._run_bwd("bf16 check", (*chain[:-1], chain[-1].float()), clip, pv,
                                   units=units)
                       if T == T_FRAMES else None)
                hold(name, label, got, ref, BF16_CHAIN_TOL, f32)
            return
        ref = (kl.lstm_peep_bwd_chain_plain(*chain, *pv, clip) if peep
               else kl.lstm_bwd_chain_plain(*chain, clip))
        # one step: the gate backward is elementwise, held tight; its dgates
        # may straddle a bf16 rounding boundary between the card's and the
        # plain version's sigmoids, so dhid0 is held to the product of the
        # kernel's own dgates, rounded to bf16, with W_hid^T
        hold(name, f"{label} (dgates, dcell0, peephole sums)", [got[0], got[1], *got[3:]],
             [ref[0], ref[1], *ref[3:]], LSTM_TOL)
        m = args[2][:, :1]
        dh = (kl.round_operand(got[0][:, 0], torch.bfloat16) @ args[1].float().T
              + (1.0 - m) * g[:, 0])
        hold(name, f"{label} (dhid0 from the kernel's dgates)", [got[2]], [dh], LSTM_TOL)

    def free_running_b1(H, peep, clip, fwd_out):
        """The B = 1 backward chain against the free-running plain version,
        beside the float32 instantiation's distance, printed and not held
        (see the sweep below)."""
        args, pv, (_, cells, gates) = fwd_out
        g = torch.randn(1, T_FRAMES, H, generator=gen).to(dev)
        cells_prev = torch.cat([args[3][:, None], cells[:, :-1]], dim=1)
        chain = (g, gates, cells, cells_prev, args[2], args[1])
        got = kl._run_bwd("bf16 check", chain, clip, pv)
        ref = (kl.lstm_peep_bwd_chain_plain(*chain, *pv, clip) if peep
               else kl.lstm_bwd_chain_plain(*chain, clip))
        f32 = kl._run_bwd("bf16 check", (*chain[:-1], chain[-1].float()), clip, pv)
        err = max(mean_err(a, r) for a, r in zip(got, ref))
        gap = max(mean_err(a, r) for a, r in zip(f32, ref))
        print(f"bf16 {'lstm_peep_bwd' if peep else 'lstm_bwd'}_bf16 B=1 T={T_FRAMES} H={H} "
              f"clip={clip} free-running (not held): max "
              f"{max(max_err(a, r)[1] for a, r in zip(got, ref)):.2e}, mean {err:.2e}; "
              f"float32 instantiation mean {gap:.2e} ({gap / max(err, 1e-30):.1f} times)")

    for T in (1, T_FRAMES):
        fwd("lstm_recurrence", 8, T, 500, False, False)
        out = fwd("lstm_recurrence_train", TRAIN_B, T, 500, False, True)
        for clip, scale in ((5.0, 1.0), (5.0, 100.0), (0.0, 1.0)):
            bwd(TRAIN_B, T, 500, False, clip, scale, out)
        fwd("lstm_peep_recurrence", TRAIN_B, T, 250, True, False)
        out = fwd("lstm_peep_recurrence_train", TRAIN_B, T, 250, True, True)
        for clip, scale in ((5.0, 1.0), (5.0, 100.0), (0.0, 1.0)):
            bwd(TRAIN_B, T, 250, True, clip, scale, out)
    fwd("lstm_recurrence_state", 1, T_FRAMES, 500, False, False, state=True)
    fwd("lstm_peep_recurrence_state", 1, T_FRAMES, 250, True, False, state=True)
    # the shapes that break fragment code (the tensor-core products): one,
    # one ragged, two and four tiles of 16 rows (B = 1, 10, 17, 64), H = 500,
    # 250 and 130 (the recurrences at U = 4, 2, 1; 250 and 130 pad their
    # last k step, 130 its 520-deep backward one too; the backward chains at
    # U = 8, their last block ragged at all three), every row with and
    # without peepholes, the chains at clip 5 and clip 0, each against the
    # plain version fed the kernel's own operands, and against the
    # free-running plain version within the chain limits, but for the
    # backward chains at B = 1: there the free-running comparison is printed
    # and not held, since a rounding flip in a 2000-deep dh sum moves every
    # later entry of the only row, and the mean rule's premise (a flip moves
    # a few entries) does not hold; then U = 8 (four n8 tiles forward) and
    # U = 4 (the backward chain) forced at H = 500
    for H in BF16_SWEEP_H:
        for B in BF16_SWEEP_B:
            for peep in (False, True):
                fwd("lstm_peep_recurrence" if peep else "lstm_recurrence", B, T_FRAMES, H,
                    peep, False)
                out = fwd("lstm_peep_recurrence_train" if peep else "lstm_recurrence_train",
                          B, T_FRAMES, H, peep, True)
                for clip in (5.0, 0.0):
                    bwd(B, T_FRAMES, H, peep, clip, 1.0, out, free=B > 1)
                    if B == 1:
                        free_running_b1(H, peep, clip, out)
    for peep in (False, True):
        fwd("lstm_peep_recurrence" if peep else "lstm_recurrence", 17, T_FRAMES, 500, peep,
            False, units=8)
        out = fwd("lstm_peep_recurrence_train" if peep else "lstm_recurrence_train", 17,
                  T_FRAMES, 500, peep, True, units=8)
        bwd(17, T_FRAMES, 500, peep, 5.0, 1.0, out, units=4)
    sms = kl._sm_count(dev.index or 0)

    def cap(plan, w_dtype):
        """The most rows one launch of ``plan`` holds at H = 500."""
        one = plan(1, 500, sms, w_dtype=w_dtype).smem_bytes
        return 1 + (_build.SMEM_LIMIT - one) // (plan(2, 500, sms, w_dtype=w_dtype).smem_bytes
                                                 - one)

    for label, plan in (("fwd", kl.fwd_launch_plan), ("bwd", kl.bwd_launch_plan)):
        B = cap(plan, torch.bfloat16) + 1
        print(f"bf16 {label} launch plan at H=500: one launch holds {B - 1} rows (float32: "
              f"{cap(plan, torch.float32)}); B={B} runs as "
              f"{plan(B, 500, sms, w_dtype=torch.bfloat16).chunks} launches")
        if label == "fwd":
            fwd("lstm_recurrence", B, 3, 500, False, False)
        else:
            bwd(B, 3, 500, False, 5.0, 1.0, fwd("lstm_recurrence_train", B, 3, 500, False, True))
    return errs


def bf16_timings(dev):
    """Each bf16 row at its main-path shape: its time on the card (events
    around back-to-back calls queued behind a sleep kernel, queued_ms, the
    mean of BF16_TIMING_ROUNDS rounds of turns f32, bf16, bf16, f32) and
    per step beside the float32 instantiation's on the same inputs, the
    backward rows also at the float32 plan's units per block (in the same
    turns), the plain version's time, its traced device time per call and
    per step (one launch per call; the times above do not rest on it:
    traces of cooperative launches can lose records), its bound (W_hid at
    2 bytes a value, the per-step product's operations at the bf16 rate,
    the gate math's at the float32 rate), and for rows 1, 3 and 4
    ``torch.nn.LSTM`` in bf16
    (cuDNN, which rounds every operand and state to bf16: not the same
    function).
    Returns {kernels-line name: numbers}."""
    import torch

    from ip_avsr_torch.ops.kernels import lstm as kl

    gen = torch.Generator().manual_seed(SEED + 61)
    rows = {}
    for name, (row, _, B, H) in BF16_ROWS.items():
        peep = "peep" in row
        args, pv = bf16_inputs(B, T_FRAMES, H, gen, dev, peep)
        args32 = (args[0], args[1].float(), *args[2:])
        if row.endswith("bwd"):
            train = kl.lstm_peep_recurrence_train if peep else kl.lstm_recurrence_train
            _, cells, gates = train(*args, *pv)
            cells_prev = torch.cat([args[3][:, None], cells[:, :-1]], dim=1)
            g = torch.randn(B, T_FRAMES, H, generator=gen).to(dev)
            chain = (g, gates, cells, cells_prev, args[2])
            fn = kl.lstm_peep_bwd_chain if peep else kl.lstm_bwd_chain
            plain = kl.lstm_peep_bwd_chain_plain if peep else kl.lstm_bwd_chain_plain

            def call(w, fn=fn, chain=chain):
                return fn(*chain, w, *pv, 5.0)

            f32_units = kl.bwd_launch_plan(B, H, kl._sm_count(dev.index or 0)).units

            def call_units(w, chain=chain, units=f32_units):
                return kl._run_bwd("bf16 timing", (*chain, w), 5.0, pv, units=units)

            def plain_call(plain=plain, chain=chain):
                return plain(*chain, args[1], *pv, 5.0)
            steps = T_FRAMES + 1
            cost = lstm_bwd_cost
        else:
            fn = getattr(kl, LSTM_WRAPPERS[row])
            plain = getattr(kl, f"{LSTM_WRAPPERS[row]}_plain")

            def call(w, fn=fn):
                return fn(args[0], w, *args[2:], *pv)

            def plain_call(plain=plain):
                return plain(*args, *pv)
            call_units = None
            steps = T_FRAMES
            cost = lstm_train_cost if row.endswith("train") else lstm_cost
        turns = {"f32": [], "bf16": []}
        kinds = ("f32", "bf16", "bf16", "f32")
        if call_units is not None:
            turns["bf16_f32_units"] = []
            kinds = ("f32", "bf16", "bf16_f32_units", "bf16_f32_units", "bf16", "f32")
        for kind in kinds * BF16_TIMING_ROUNDS:
            w = args32[1] if kind == "f32" else args[1]
            fn_k = call_units if kind == "bf16_f32_units" else call
            turns[kind].append(queued_ms(lambda w=w, fn_k=fn_k: fn_k(w)))
        ms = statistics.mean(turns["bf16"])
        f32_ms = statistics.mean(turns["f32"])
        units_ms = (statistics.mean(turns["bf16_f32_units"]) if call_units is not None
                    else None)
        plain_ms = cuda_ms(plain_call, iters=3, warmup=1)
        traced_ms = trace_chain(lambda: call(args[1]), f"{name} B={B} H={H}", name, steps,
                                lost_ok=True)
        b_ms, by = bound(*cost(B, T_FRAMES, H, peep, w_bytes=2))
        lib_ms = None
        if not peep:
            # yardstick only (the port never calls it): cuDNN's LSTM in bf16
            # at the stream LSTM's shape, all-valid mask, with its 150-wide
            # input projection
            cudnn = torch.nn.LSTM(150, H, batch_first=True).to(dev).to(torch.bfloat16)
            xin = torch.randn(B, T_FRAMES, 150, generator=gen).to(dev).to(torch.bfloat16)
            if row == "lstm_fwd":
                with torch.inference_mode():
                    lib_ms = cuda_ms(lambda: cudnn(xin))
            else:
                xin.requires_grad_(True)
                if row == "lstm_fwd_train":
                    lib_ms = cuda_ms(lambda: cudnn(xin))
                else:
                    out, _ = cudnn(xin)
                    gy = torch.randn_like(out)
                    wts = [xin, *cudnn.parameters()]
                    lib_ms = cuda_ms(lambda: torch.autograd.grad(out, wts, gy,
                                                                 retain_graph=True))
        print(f"{name} B={B} T={T_FRAMES} H={H}: kernel {ms:.4f} ms, "
              f"{ms * 1e3 / steps:.3f} us per step (float32 instantiation {f32_ms:.4f} ms, "
              f"{f32_ms * 1e3 / steps:.3f} us per step; in turns {turns}; bf16 / f32 "
              f"{ms / f32_ms:.3f}"
              + ("" if units_ms is None else
                 f"; bf16 at the float32 plan's units per block {units_ms:.4f} ms")
              + f"), plain {plain_ms:.4f} ms, traced {traced_ms:.4f} ms "
              f"({traced_ms * 1e3 / steps:.3f} us per step), bound {b_ms:.5f} ms ({by}), cuDNN "
              f"nn.LSTM bf16 {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; "
              f"{smi('name,power.limit')}")
        rows[name] = dict(ms=ms, f32_ms=f32_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                          library_ms=lib_ms, traced_ms=traced_ms,
                          us_per_step=ms * 1e3 / steps, f32_us_per_step=f32_ms * 1e3 / steps,
                          traced_us_per_step=traced_ms * 1e3 / steps, turns=turns,
                          f32_units_ms=units_ms,
                          shape=f"B={B} T=29 H={H}")
    return rows


def bf16_step_against_cpu(label, cfg, params, streams, y, mask, lr=1e-4):
    """One train step of ``cfg`` (bf16) on the card against the port's CPU
    path on the same parameters and batch, each beside the card's float32
    model; raises past the BF16_* tolerances.  Returns the numbers."""
    import dataclasses

    import torch

    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.train import trainer

    cpu = torch.device("cpu")
    f32_cfg = dataclasses.replace(cfg, matmul_dtype=None)
    c_params, c_streams = tree_to(params, cpu), tree_to(streams, cpu)
    loss_d, grads_d = trainer.loss_and_grads(params, cfg, streams, y, mask)
    loss_c, grads_c = trainer.loss_and_grads(c_params, cfg, c_streams, y.cpu(), mask.cpu())
    loss_f, grads_f = trainer.loss_and_grads(params, f32_cfg, streams, y, mask)
    moments = []
    for c, p, s, yy, mm in ((cfg, params, streams, y, mask),
                            (cfg, c_params, c_streams, y.cpu(), mask.cpu()),
                            (f32_cfg, params, streams, y, mask)):
        opt, step = trainer.make_train_step(c, lr=lr)
        moments.append(step(p, opt.init(p), s, yy, mm)[1]["m"])

    def flat(tree):
        leaves = []
        tree_map(lambda t: leaves.append(t.detach().double().cpu().reshape(-1)), tree)
        return torch.cat(leaves)

    def rel_norms(trees):
        d, c, f = (flat(t) for t in trees)
        return (d - c).norm().item() / c.norm().item(), (f - c).norm().item() / c.norm().item()

    grad_err, grad_gap = rel_norms((grads_d, grads_c, grads_f))
    m_err, m_gap = rel_norms(moments)
    loss_rel = abs(float(loss_d) - float(loss_c)) / abs(float(loss_c))
    loss_gap = abs(float(loss_f) - float(loss_c)) / abs(float(loss_c))
    print(f"{label}, card vs CPU path at bf16: loss relative {loss_rel:.2e} (tol "
          f"{BF16_LOSS_TOL:g}; the card's float32 model {loss_gap:.2e} away)")
    if not loss_rel <= BF16_LOSS_TOL:
        raise AssertionError(f"{label}: the bf16 loss on the card disagrees with the CPU path")
    separated(f"{label}: gradients, relative norm", grad_err, grad_gap, BF16_GRAD_NORM_TOL)
    separated(f"{label}: Adam's first moment after one step, relative norm", m_err, m_gap,
              BF16_GRAD_NORM_TOL)
    return dict(loss_rel=loss_rel, loss_f32_gap=loss_gap, grad_norm_err=grad_err,
                grad_f32_gap=grad_gap, moment_err=m_err, moment_f32_gap=m_gap)


def bf16_serve_check(label, server, cpu_server, f32_server, requests, n_rows):
    """Serve ``requests`` on the card with every launch counted (0 before,
    read after), hold the scores against the CPU path at bf16 and print the
    card's float32 model beside them.  Returns (launches, worst error,
    worst float32 gap)."""
    import torch

    reset_launches()
    scores = [server(*req) for req in requests]
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(requests)
    print(f"{label}: served {n} requests at bf16, launches {launches}")
    expect_launches(launches, delta=n, **{row: k * n for row, k in n_rows.items()})
    err = gap = 0.0
    for req, s in zip(requests, scores):
        s = s.cpu()
        ref = cpu_server(*req).cpu()
        f32 = f32_server(*req).cpu()
        if not torch.isfinite(s).all() or s.shape != ref.shape:
            raise AssertionError(f"{label}: bad scores {tuple(s.shape)}")
        e = (s - ref).abs().max().item()
        g = (f32 - ref).abs().max().item()
        print(f"{label} B={s.shape[0]}: |card - CPU path| at bf16 {e:.2e} (tol "
              f"{BF16_SCORE_TOL:g}); the card's float32 model {g:.2e} from it")
        if not e <= BF16_SCORE_TOL:
            raise AssertionError(f"{label}: bf16 scores disagree with the CPU path")
        separated(f"{label} B={s.shape[0]}: mean |card - CPU path| at bf16",
                  (s - ref).abs().mean().item(), (f32 - ref).abs().mean().item(),
                  BF16_SCORE_MEAN_TOL)
        err, gap = max(err, e), max(gap, g)
    return launches, err, gap


def phase_bf16(dev):
    """``matmul_dtype="bfloat16"`` on the card, TF32 off: the six bf16
    instantiations against their plain versions (:func:`bf16_kernel_checks`)
    and timed (:func:`bf16_timings`); the full-width flagship at bf16
    served (B = 1 and 8, raw uint8: 5 row-1 bf16 launches and 1 delta
    launch per forward) and trained three steps at TRAIN_B (5 rows 3 and 4
    bf16 and 1 delta per step), the oulu_4stream.ini model at bf16 served at
    TRAIN_B (6 row-5 bf16 per forward) and stepped twice at the ini's batch
    and lr (6 rows 6 and 7 bf16 per step), each against the port's CPU path
    at bf16 with the card's float32 gap printed; ``cli.trimodal`` from
    ``.mat`` files with ``[training] matmul_dtype = bfloat16`` (every launch
    of its fit counted); a bf16-model artifact and a bf16-weight artifact of
    the float32 flagship, each against its live server (5 row-1 bf16
    launches per forward).  No float32 LSTM row may launch on these paths.
    Returns ({kernels-line name: numbers}, {path: launches})."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from ip_avsr_torch import export as export_lib
    from ip_avsr_torch.cli import trimodal
    from ip_avsr_torch.device import tree_map, tree_to
    from ip_avsr_torch.models import adenet
    from ip_avsr_torch.serve import make_server, make_trimodal_server
    from ip_avsr_torch.train import trainer

    t_phase = time.perf_counter()
    errs = bf16_kernel_checks(dev)
    rows = bf16_timings(dev)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    paths, numbers = {}, {}
    cpu = torch.device("cpu")
    bf16 = {"matmul_dtype": "bfloat16"}

    # the flagship at full width, served
    cfg = dataclasses.replace(flagship(), **bf16)
    params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 62), cfg,
                                       device=dev)
    tri = dict(image_shape=IMAGE_SHAPE, dct_coeffs=DCT)
    server = make_trimodal_server(params, cfg, device=dev, **tri)
    cpu_server = make_trimodal_server(tree_to(params, cpu), cfg, device="cpu", **tri)
    f32_server = make_trimodal_server(params, flagship(), device=dev, **tri)
    requests = export_requests("raw", cfg, [(1, T_FRAMES), (8, T_FRAMES)], SEED + 62)
    server(*requests[0])  # warm-up
    torch.cuda.synchronize()
    paths["serve"], numbers["serve_err"], numbers["serve_f32_gap"] = bf16_serve_check(
        "bf16 flagship", server, cpu_server, f32_server, requests, {"lstm_fwd_bf16": 5})
    for B, req in ((1, requests[0]), (8, requests[1])):
        numbers[f"serve_ms B={B}"] = host_median_ms(lambda req=req: server(*req), calls=10)
        numbers[f"serve_f32_ms B={B}"] = host_median_ms(lambda req=req: f32_server(*req),
                                                        calls=10)
        print(f"bf16 flagship serve B={B}: median request {numbers[f'serve_ms B={B}']:.3f} ms, "
              f"float32 {numbers[f'serve_f32_ms B={B}']:.3f} ms (host clock)")

    # the flagship trained
    streams, mask, y = stream_batch(cfg, TRAIN_B, SEED + 63, dev)
    opt, step = trainer.make_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = opt.init(params)
    step(params, state, streams, y, mask, gen)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    p, st, losses = params, state, []
    for _ in range(3):
        p, st, loss = step(p, st, streams, y, mask, gen)
        losses.append(float(loss))
    torch.cuda.synchronize()
    paths["train"] = read_launches()
    print(f"bf16 flagship train 3 steps at B={TRAIN_B}: losses {losses}, launches "
          f"{paths['train']}")
    expect_launches(paths["train"], lstm_fwd_train_bf16=15, lstm_bwd_bf16=15, delta=3)
    finite = []
    tree_map(lambda t: finite.append(bool(torch.isfinite(t).all())), (p, st["m"], st["v"]))
    if not (all(finite) and np.isfinite(losses).all()):
        raise AssertionError("bf16 flagship training: non-finite loss or parameters")
    numbers["train"] = bf16_step_against_cpu("bf16 flagship dropout 0", no_dropout(cfg),
                                             params, streams, y, mask)
    numbers["train_ms"] = host_median_ms(lambda: step(params, state, streams, y, mask, gen),
                                         calls=10)
    print(f"bf16 flagship train B={TRAIN_B}: median step {numbers['train_ms']:.3f} ms "
          f"(host clock)")

    # the 4-stream model of configs/oulu_4stream.ini, served and stepped
    cfg4, training = oulu_4stream()
    cfg4 = dataclasses.replace(cfg4, **bf16)
    params4 = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 64), cfg4,
                                        device=dev)
    server4 = make_server(params4, cfg4, vote=False, device=dev)
    cpu4 = make_server(tree_to(params4, cpu), cfg4, vote=False, device="cpu")
    f32_4 = make_server(params4, dataclasses.replace(cfg4, matmul_dtype=None), vote=False,
                        device=dev)
    requests4 = [stream_batch(cfg4, TRAIN_B, SEED + 65 + i, dev)[:2] for i in range(2)]
    server4(*requests4[0])
    torch.cuda.synchronize()
    paths["serve_4stream"], numbers["serve4_err"], numbers["serve4_f32_gap"] = bf16_serve_check(
        "bf16 4-stream", server4, cpu4, f32_4, requests4, {"lstm_peep_fwd_bf16": 6})
    streams4, mask4, y4 = stream_batch(cfg4, training.batchsize, SEED + 67, dev)
    opt4, step4 = trainer.make_train_step(cfg4, lr=training.learning_rate)
    step4(params4, opt4.init(params4), streams4, y4, mask4)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    p4, st4 = params4, opt4.init(params4)
    for _ in range(2):
        p4, st4, _ = step4(p4, st4, streams4, y4, mask4)
    torch.cuda.synchronize()
    paths["train_4stream"] = read_launches()
    print(f"bf16 4-stream train 2 steps: launches {paths['train_4stream']}")
    expect_launches(paths["train_4stream"], lstm_peep_fwd_train_bf16=12, lstm_peep_bwd_bf16=12,
                    delta=2)
    numbers["train4"] = bf16_step_against_cpu("bf16 4-stream", cfg4, params4, streams4, y4,
                                              mask4, lr=training.learning_rate)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        # cli.trimodal from .mat files, [training] matmul_dtype = bfloat16
        files = write_cli_corpus(tmp)
        ini = os.path.join(tmp, "trimodal_bf16.ini")
        write_cli_ini(ini, "trimodal", cli_sets("trimodal", files) + [
            ("training", k, v) for k, v in {**FIT_CUTS, "matmul_dtype": "bfloat16"}.items()])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result, rec = run_cli(trimodal.main, ["--config", ini, "--device", "cuda"])
        steps, evals = fit_forwards(result, FIT_CUTS["epochsize"])
        paths["cli"] = rec["launches"]
        print(f"bf16 cli.trimodal: {result.epochs_run} epochs, {steps} steps, {evals} "
              f"evaluation forwards, costs {list(np.round(result.cost_train, 5))}; launches "
              f"{paths['cli']}; fit {rec['fit_s']:.2f} s, CLI wall {rec['wall_s']:.2f} s")
        expect_launches(paths["cli"], lstm_fwd_train_bf16=5 * steps, lstm_bwd_bf16=5 * steps,
                        lstm_fwd_bf16=5 * evals, delta=steps + evals)
        if not np.isfinite(result.cost_train + result.cost_val).all():
            raise AssertionError("bf16 cli.trimodal: non-finite costs")
        numbers["cli_fit_s"] = rec["fit_s"]

        # artifacts: the bf16 flagship, and the float32 flagship stored with
        # bf16 weights (its bf16 w_hid runs row 1's bf16 instantiation)
        totals = {row: 0 for row in KERNEL_COUNTERS}
        f32_params = adenet.init_adenet_params(torch.Generator().manual_seed(SEED + 68),
                                               flagship(), device=dev)
        for name, a_params, a_cfg, wd in (
                ("flagship_bf16_model", params, cfg, None),
                ("flagship_bf16_weights", f32_params, flagship(), "bfloat16")):
            path = os.path.join(tmp, f"{name}.ipax")
            export_lib.save_artifact(path, a_params, a_cfg, trimodal=tri, weights_dtype=wd,
                                     device=dev)
            art = export_lib.load_server(path, device=dev)
            live = make_trimodal_server(export_lib._cast_weights(a_params, wd), a_cfg,
                                        device=dev, **tri)
            numbers[f"{name}_err"] = check_artifact(name, art, live, requests, "lstm_fwd_bf16",
                                                    5, totals)
        paths["export"] = totals
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"bf16: phase {numbers['phase_s']:.1f} s")
    return rows, paths, numbers


SCALE_TURNS = 10
# the mesh options phase_scale steps the flagship with on one rank
SCALE_OPTIONS = {"gspmd": dict(use_mesh=True),
                 "shard_map": dict(use_mesh=True, mesh_mode="shard_map"),
                 "zero1": dict(zero1=True), "multihost": dict(use_mesh=True, multihost=True)}
SCALE_SERVE_B = 8
# adenet_v1's two-rank gradients against the one-process card step, of max
# abs.  Above TRAIN_GRAD_TOL because each float32 step of this model lies
# 1.2e-4 to 4.1e-4 from its float64 step (bn_conditioning prints it and its
# cause), so two correct ones may lie twice that apart; far below the
# control that normalises each rank's rows alone (about 0.1), which must
# exceed it
BN_GRAD_TOL = 1e-3


def scale_batch(cfg, B, seed, T=T_FRAMES):
    """A seeded numpy batch (streams, int32 labels, ragged mask: a full row,
    the rest T/2-T) of ``cfg``'s streams at ``T`` frames (default 29)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    streams = [rng.randn(B, T, s.input_dim).astype(np.float32) for s in cfg.streams]
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return streams, rng.randint(0, cfg.output_classes, B).astype(np.int32), mask


def check_scale_step(label, got, ref_launches, zero=(), grad_tol=TRAIN_GRAD_TOL):
    """A mesh step's gaps from the one-process card step within the train
    tolerances (gradients within ``grad_tol`` of max abs; zero-gradient
    biases to noise under ``grad_tol`` of their weight's gradient, at least
    1e-4) and its launches equal to the one-process step's."""
    g = got["gaps"]
    print(f"{label}: loss {got['loss']:.7f}, gaps to one process: loss {g['loss_rel']:.2e}, "
          f"gradients {g['grad_rel']:.2e} of max abs, parameters {g['param_abs']:.2e}"
          + (f", zero-gradient biases {g['zero_noise']:.2e} of their weight's" if zero else "")
          + f" (worst {g['grad_worst']}, held to {grad_tol:.2e})"
          + f"; launches {dict((k, v) for k, v in got['launches'].items() if v)}; "
          f"collectives {got['collectives']} ({got['collective_bytes']} B); "
          f"step {got['step_ms']:.3f} ms")
    if not (g["loss_rel"] <= TRAIN_LOSS_TOL and g["grad_rel"] <= grad_tol
            and g["param_abs"] <= TRAIN_PARAM_TOL and g["zero_noise"] <= max(grad_tol, 1e-4)):
        raise AssertionError(f"{label}: the mesh step disagrees with one process: {g}")
    if got["launches"] != ref_launches:
        raise AssertionError(f"{label}: launches {got['launches']}, one process "
                             f"{ref_launches}")


@contextlib.contextmanager
def plain_float64():
    """While active, the kernels' plain versions take float64 CPU tensors,
    for an exact reference: the wrappers refuse a dtype their kernels lack,
    so the delta wrapper's dtype check and the LSTM plain versions'
    widening of W_hid to float32 let float64 through (nothing launches on
    the CPU)."""
    import torch

    from ip_avsr_torch.ops.kernels import delta as delta_kernel
    from ip_avsr_torch.ops.kernels import lstm as lstm_kernel

    check, widen = delta_kernel._check, lstm_kernel._w_operand
    delta_kernel._check = lambda xs, window: check(
        [x.float() if x.dtype == torch.float64 else x for x in xs], window)
    lstm_kernel._w_operand = lambda w: w if w.dtype == torch.float64 else widen(w)
    try:
        yield
    finally:
        delta_kernel._check, lstm_kernel._w_operand = check, widen


def grad_gap(grads, exact, zero=()) -> float:
    """The worst gradient's max abs gap from ``exact`` ({path: array}) over
    that array's max abs, the leaves ``zero`` left out."""
    import numpy as np

    from ip_avsr_torch.parallel import _multiprocess_worker as worker

    return max(float(np.abs(np.asarray(a, np.float64) - exact[path]).max()
                     / max(np.abs(exact[path]).max(), 1e-30))
               for path, a in worker._named(grads) if path not in zero)


def bn_conditioning(cfg, params, batch, dev):
    """Why adenet_v1's two-rank step is held to BN_GRAD_TOL: the
    one-process step on the card against the same step in float64 on the
    CPU (:func:`plain_float64`), with the factors X and dZ of the
    bottleneck weight's gradient X^T dZ taken from both
    (``_multiprocess_worker.bottleneck_terms``).  Batch norm makes dZ's
    column sums zero, so X^T dZ equals (X - mean X)^T dZ, while X, sigmoids
    near 0.5, varies far less than its mean: float32's error in dZ, which
    does not sum to zero, comes out multiplied.  Prints X's mean and
    spread, the size of X^T dZ's terms over the result, and for the card
    step :func:`dz_share`.  Returns {"exact": the float64 gradients by
    path, "path", "shape", "X", "dZ": float64's factors}."""
    import numpy as np
    import torch

    from ip_avsr_torch.device import tree_map
    from ip_avsr_torch.parallel import _multiprocess_worker as worker
    from ip_avsr_torch.train.trainer import TrainOptions, loss_and_grads

    stream = next(s.name for s in cfg.streams if s.use_batchnorm)
    path = f"/streams/{stream}/encoder/bottleneck/w"
    shape = tuple(params["streams"][stream]["encoder"]["bottleneck"]["w"].shape)

    def step(dtype, device):
        p = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                     worker.tensors(params, device))
        streams, y, mask = batch
        gen = torch.Generator(device=device).manual_seed(0)
        _, g = loss_and_grads(p, cfg, [torch.as_tensor(x, dtype=dtype, device=device)
                                       for x in streams],
                              torch.as_tensor(y, dtype=torch.int64, device=device),
                              torch.as_tensor(mask, dtype=dtype, device=device), gen,
                              window=TrainOptions().window)
        return worker.arrays(g)

    with worker.bottleneck_terms(shape) as taken:
        with plain_float64():
            exact = dict(worker._named(step(torch.float64, "cpu")))
        card = step(torch.float32, dev)
    if len(taken) != 2 or any("dZ" not in d for d in taken):
        raise AssertionError(f"bn_conditioning: took {len(taken)} bottleneck products, "
                             f"expected one a step with its gradient")
    cond = dict(exact=exact, path=path, shape=shape, **taken[0])
    X, dZ, G = cond["X"], cond["dZ"], exact[path]
    print(f"scale, adenet_v1's float32 conditioning ({path}, {X.shape} X, {dZ.shape} dZ): "
          f"X's mean {X.mean():.4f}, its columns' spread {X.std(0).mean():.4f}; dZ's column "
          f"sums {np.abs(dZ.sum(0)).max():.1e} (batch norm makes them 0); X^T dZ's terms "
          f"{np.abs(X).max() * np.abs(dZ).sum(0).max() / np.abs(G).max():.0f}x its max abs; "
          f"the card's one-process step: {dz_share(cond, card, taken[1]['dZ'])}")
    return cond


def dz_share(cond, grads, dZ) -> str:
    """A float32 step's bottleneck-weight gradient (in ``grads``) and its
    factor ``dZ`` against float64's (:func:`bn_conditioning`), each error
    of its reference's max abs: dZ's, the gradient's, that of the exact X
    times ``dZ`` (what dZ's error alone makes), and X's column means times
    the error in dZ's column sums, which are 0 exactly (what that error
    makes through the cancellation alone: X^T dZ's error from a column
    sum s of dZ's error is mean(X) s)."""
    import numpy as np

    from ip_avsr_torch.parallel import _multiprocess_worker as worker

    X, dZ64, G = cond["X"], cond["dZ"], cond["exact"][cond["path"]]
    rel = lambda a, r: float(np.abs(a - r).max() / np.abs(r).max())  # noqa: E731
    sums = np.outer(X.mean(0), (dZ - dZ64).sum(0))
    return (f"dZ {rel(dZ, dZ64):.2e} of max abs from float64's, the gradient "
            f"{rel(dict(worker._named(grads))[cond['path']], G):.2e}, exact X times its dZ "
            f"{rel(X.T @ dZ, G):.2e}, X's column means times the error of dZ's column sums "
            f"{rel(G + sums, G):.2e}")


def phase_scale(dev):
    """Scale-out (``parallel/``) on the card, in ranks that
    ``utils/cpu_mesh.RankPool`` spawns (this process joins no group), each
    mesh step against the one-process Trainer's on the card (adadelta at lr
    1.0, dropout 0, ragged masks; loss TRAIN_LOSS_TOL, gradients
    TRAIN_GRAD_TOL of max abs, parameters TRAIN_PARAM_TOL) with the same
    launches of every kernel:

    (a) one rank, ``nccl``: the full-width flagship at B = 10 through
        ``Trainer`` with use_mesh (gspmd, timed in turns against the plain
        step), shard_map, zero1 and multihost; ``make_server(mesh=)`` at B
        = 8 against the plain server (SCORE_TOL); the 4-stream model of
        configs/oulu_4stream.ini with use_mesh;
    (b) two ranks sharing the card, ``gloo``: the flagship data-parallel at
        global B = 10 (5 rows a rank), and zoo.adenet_v1 with batch-norm
        statistics synced over the ranks, its gradients to BN_GRAD_TOL
        (:func:`bn_conditioning` prints why), and the control: the same
        step with each rank's own statistics must fail that limit.

    model_parallel and sequence_parallel need two cards under nccl (gloo
    has no all_gather, send/recv or all_to_all on CUDA tensors):
    :func:`phase_scale4` runs them on four cards.  Returns {kernel:
    launches over the phase's mesh runs, every rank}."""
    import numpy as np
    import torch

    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.parallel import _multiprocess_worker as worker
    from ip_avsr_torch.utils.cpu_mesh import RankPool

    t0 = time.perf_counter()
    card = smi("name,power.limit")
    spec = KERNEL_COUNTERS
    init = lambda cfg, seed: worker.arrays(adenet.init_adenet_params(  # noqa: E731
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    cfg, cfg4 = flagship(dropout=False), no_dropout(oulu_4stream()[0])
    C = IMAGE_SHAPE[0] * IMAGE_SHAPE[1]
    bn_cfg = zoo.adenet_v1(C, DCT, output_classes=10)
    cases = {name: (c, init(c, SEED + 16 + i), scale_batch(c, TRAIN_B, SEED + 16 + i))
             for i, (name, c) in enumerate((("flagship", cfg), ("4-stream", cfg4),
                                            ("adenet_v1", bn_cfg)))}
    # the one-process card steps every mesh step is held against
    on = dev.type
    refs = {name: worker.chip_step(spec, *case, {}, device=on) for name, case in cases.items()}
    for name, ref in refs.items():
        print(f"scale, one process {name}: loss {ref['loss']:.7f}, launches "
              f"{dict((k, v) for k, v in ref['launches'].items() if v)}")
    expect_launches(refs["flagship"]["launches"], lstm_fwd_train=5, lstm_bwd=5, delta=1)
    expect_launches(refs["4-stream"]["launches"], lstm_peep_fwd_train=6, lstm_peep_bwd=6,
                    delta=1)
    totals = {k: 0 for k in KERNEL_COUNTERS}

    with RankPool(1, backend="nccl" if on == "cuda" else "gloo", timeout_s=600) as pool:
        for name, opts in SCALE_OPTIONS.items():
            got = pool.run(worker.chip_step, spec, *cases["flagship"], opts,
                           refs["flagship"]["result"],
                           turns=SCALE_TURNS if name == "gspmd" else 0, device=on)[0]
            check_scale_step(f"scale (a) 1 rank nccl, flagship {name}", got,
                             refs["flagship"]["launches"])
            count_into(totals, got["launches"])
            if name == "gspmd":
                mesh_ms, plain_ms = (statistics.median(got[k]) for k in ("mesh_ms", "plain_ms"))
                print(f"scale (a): world-size-1 mesh step {mesh_ms:.3f} ms against the plain "
                      f"Trainer's {plain_ms:.3f} ms (host clock, median of {SCALE_TURNS} "
                      f"interleaved turns, B = {TRAIN_B}; {card}); its collectives per step: "
                      f"{got['collectives'] or 'none'} (every group of one rank is the "
                      f"identity)")
        streams, _, mask = scale_batch(cfg, SCALE_SERVE_B, SEED + 19)
        served = pool.run(worker.chip_serve, spec, cfg, cases["flagship"][1], streams, mask,
                          device=on)[0]
        print(f"scale (a) make_server(mesh=) B={SCALE_SERVE_B}: scores max abs gap to the "
              f"plain server {served['max_abs_err']:.2e}; launches "
              f"{dict((k, v) for k, v in served['launches'].items() if v)}")
        if not (served["finite"] and served["max_abs_err"] <= SCORE_TOL):
            raise AssertionError("make_server(mesh=) disagrees with the plain server")
        expect_launches(served["launches"], lstm_fwd=5, delta=1)
        count_into(totals, served["launches"])
        got = pool.run(worker.chip_step, spec, *cases["4-stream"], dict(use_mesh=True),
                       refs["4-stream"]["result"], device=on)[0]
        check_scale_step("scale (a) 1 rank nccl, 4-stream use_mesh", got,
                         refs["4-stream"]["launches"])
        count_into(totals, got["launches"])

    # adenet_v1: the float32 spread of its one-process step (printed, not a
    # limit), the float64 step that shows where it comes from, then the
    # two-rank step at BN_GRAD_TOL and the control that must fail it
    zero = zero_grad_biases(bn_cfg)
    c, p, (streams, y, mask) = cases["adenet_v1"]
    perm = np.random.RandomState(SEED).permutation(TRAIN_B)
    spreads = {
        "permuted rows": (([x[perm] for x in streams], y[perm], mask[perm]), {}, on),
        "the CPU": ((streams, y, mask), {}, "cpu"),
        "the one-process mesh": ((streams, y, mask), dict(use_mesh=True), on)}
    for label, (batch, opts, where) in spreads.items():
        g = worker.chip_step(spec, c, p, batch, opts, refs["adenet_v1"]["result"], zero,
                             device=where)["gaps"]
        print(f"scale: adenet_v1's one-process step on {label} lies {g['grad_rel']:.2e} of max "
              f"abs from the card's ({g['grad_worst']}; zero-gradient biases "
              f"{g['zero_noise']:.2e})")
    cond = bn_conditioning(c, p, (streams, y, mask), dev)
    with RankPool(2, backend="gloo", timeout_s=600) as pool:
        for name, z, tol in (("flagship", (), TRAIN_GRAD_TOL),
                             ("adenet_v1", zero, BN_GRAD_TOL)):
            bn = name == "adenet_v1"
            ranks = pool.run(worker.chip_step, spec, *cases[name], dict(use_mesh=True),
                             None if bn else refs[name]["result"], z, device=on,
                             bottleneck=cond["shape"] if bn else None)
            if bn:
                # each rank's dZ is of the loss's numerator: over the count
                # (adenet_v1's last-step head counts the rows with a frame)
                dZ = np.concatenate([g["bottleneck"]["dZ"] for g in ranks]) / (
                    mask.sum(axis=1) > 0).sum()
                print(f"scale (b) adenet_v1, two ranks against float64: "
                      f"{dz_share(cond, ranks[0]['result'][1], dZ)}; worst gradient "
                      f"{grad_gap(ranks[0]['result'][1], cond['exact'], z):.2e}, the "
                      f"one-process card step's "
                      f"{grad_gap(refs[name]['result'][1], cond['exact'], z):.2e}")
            for r, got in enumerate(ranks):
                if bn:
                    got["gaps"] = worker.step_gaps(got["result"], refs[name]["result"], z)
                check_scale_step(f"scale (b) 2 ranks gloo, {name} rank {r}", got,
                                 refs[name]["launches"], z, tol)
                count_into(totals, got["launches"])
            print(f"scale (b) {name}: step {np.median([g['step_ms'] for g in ranks]):.3f} ms "
                  f"at global B = {TRAIN_B}, of which the gradients' all-reduce alone "
                  f"{np.median([g['allreduce_ms'] for g in ranks]):.3f} ms (two processes "
                  f"sharing one card, time-sliced, gloo through host memory: not a scaling "
                  f"figure; one process {refs[name]['step_ms']:.3f} ms; {card})")
        # the control: each rank's batch norm on its own 5 rows
        for r, got in enumerate(pool.run(worker.chip_step, spec, *cases["adenet_v1"],
                                         dict(use_mesh=True), refs["adenet_v1"]["result"],
                                         zero, device=on, local_bn=True)):
            g = got["gaps"]
            print(f"scale (b) control, adenet_v1 rank {r} with batch-norm statistics of its "
                  f"own rows: loss {g['loss_rel']:.2e}, gradients {g['grad_rel']:.2e} of max "
                  f"abs ({g['grad_worst']}) from one process, against BN_GRAD_TOL "
                  f"{BN_GRAD_TOL:.0e}")
            if not g["grad_rel"] > BN_GRAD_TOL:
                raise AssertionError("BN_GRAD_TOL passes a step whose batch norm is not "
                                     "synced over the ranks")
    print(f"phase_scale: {time.perf_counter() - t0:.1f} s; launches over the mesh runs "
          f"{dict((k, v) for k, v in totals.items() if v)}")
    return totals


# the four-card phase: one nccl rank per card
SCALE4_RANKS = 4
SCALE4_TURNS = 5
# the batch of the sequence-parallel, batch-norm and 4-stream runs: divisible
# by data x seq at every mesh of the phase
SCALE4_B = 12
# the long-stream T of seq = 4: T_local = 12 >= the window of 9
SCALE4_SP_T = 48
# what the trainer raises for seq = 4 at T = 29, as the JAX trainer does
# (ip_avsr_tpu/train/trainer.py:985; tests/test_torch_scale4.py holds the
# port's message to JAX's)
SP4_REFUSAL = ("sequence_parallel=4 leaves T_local=8 < window=9 (halo exchange needs "
               "T_local >= window); use fewer seq shards or a smaller window")
# cli.nstream under torchrun on the four cards: each job's flags, and the
# limit (s) of the jobs, which run together
SCALE4_CLI = (("--mesh",), ("--model_parallel", "2"), ("--sequence_parallel", "2"))
SCALE4_CLI_TIMEOUT_S = 240


def topo_link():
    """The link between the cards: the GPU-to-GPU entries of ``nvidia-smi
    topo -m`` (for example ``NV18``; the whole matrix printed once), or its
    exit code and message where it cannot read the topology; beside it,
    whether card 0 reaches card 1's memory directly (peer access) and the
    rate of a 256 MiB copy from card 0 to card 1 (CUDA events, the median
    of 5 after 2)."""
    import torch

    run = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                         timeout=60)
    if run.returncode == 0:
        print(run.stdout.rstrip())
        rows = [line.split("\t") for line in run.stdout.splitlines() if line.startswith("GPU")]
        topo = "nvidia-smi topo -m: " + ", ".join(sorted(
            {cell.strip() for i, row in enumerate(rows)
             for j, cell in enumerate(row[1:len(rows) + 1]) if i != j}))
    else:
        topo = (f"nvidia-smi topo -m: exit {run.returncode} "
                f"({(run.stdout + run.stderr).strip().splitlines()[-1:]})")
    src = torch.empty(64 << 20, dtype=torch.float32, device="cuda:0")
    dst = torch.empty_like(src, device="cuda:1")
    times = []
    for i in range(7):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        if i >= 2:
            times.append(start.elapsed_time(end))
    rate = src.numel() * 4 / statistics.median(times) / 1e6
    del src, dst
    torch.cuda.empty_cache()
    return (f"{topo}; peer access 0 -> 1 {torch.cuda.can_device_access_peer(0, 1)}, a 256 MiB "
            f"copy 0 -> 1 at {rate:.1f} GB/s")


def pad_frames(batch, T):
    """A numpy batch with its frames zero-padded to ``T`` (mask 0 there), as
    the trainer pads a split under sequence parallelism (``_sp_max_t``)."""
    import numpy as np

    streams, y, mask = batch
    cut = T - mask.shape[1]
    pad = lambda a: np.concatenate(  # noqa: E731
        [a, np.zeros((a.shape[0], cut) + a.shape[2:], a.dtype)], axis=1)
    return [pad(x) for x in streams], y, pad(mask)


def scale4_report(label, ranks, where):
    """Print a four-card run's numbers beside ``where`` (the cards, their
    power limit and their link) and return them: the step (host median of
    5 steps, every rank), the mesh step against the one-process step in
    interleaved turns (rank 0's), the collectives of one step (calls and
    bytes; CUDA-event time per step over 5 steps started together, the
    least and the most over the ranks: the rank that comes last to a
    collective waits for no other), the gradients' all-reduce alone, and
    each rank's busy share from a trace (device time of the kernels but
    the collectives' over the step's median; the collectives' kernels,
    waits included, apart)."""
    import numpy as np

    r0 = ranks[0]
    out = {"step_ms": [g["step_ms"] for g in ranks],
           "collectives": {k: {"calls": c, "bytes": b, "ms": [g["collective_ms"].get(k)
                                                               for g in ranks]}
                           for k, (c, b) in r0["by_collective"].items()}}
    line = (f"{label}: step {np.median(out['step_ms']):.3f} ms (host median, ranks "
            f"{', '.join(f'{v:.3f}' for v in out['step_ms'])})")
    if "mesh_ms" in r0:
        out.update(mesh_ms=statistics.median(r0["mesh_ms"]),
                   plain_ms=statistics.median(r0["plain_ms"]))
        line += (f"; in {len(r0['mesh_ms'])} interleaved turns the mesh step "
                 f"{out['mesh_ms']:.3f} ms against one process's {out['plain_ms']:.3f} ms "
                 f"on the whole batch")
    if "allreduce_ms" in r0:
        out["allreduce_ms"] = [g["allreduce_ms"] for g in ranks]
        line += (f"; the gradients' flat all-reduce alone "
                 f"{np.median(out['allreduce_ms']):.3f} ms")
    print(line + f" ({where})")

    def span(ms):
        ms = [v for v in ms if v is not None]
        return f"{min(ms):.3f}-{max(ms):.3f} ms" if ms else "not timed"

    print(f"{label}: collectives per step (calls, bytes; CUDA events, least-most over the "
          "ranks): " + "; ".join(f"{k} {v['calls']}, {v['bytes']} B, {span(v['ms'])}"
                                 for k, v in out["collectives"].items()))
    if "trace" in r0:
        out["busy"] = [(g["trace"]["device_ms"] - g["trace"]["nccl_ms"]) / g["step_ms"]
                       for g in ranks]
        out["nccl_ms"] = [g["trace"]["nccl_ms"] for g in ranks]
        print(f"{label}: busy share per rank (a traced step's device time but the "
              f"collectives' kernels, over the step's median) "
              f"{', '.join(f'{v:.3f}' for v in out['busy'])}; the collectives' kernels, their "
              f"waits for the other ranks included, {', '.join(f'{v:.3f}' for v in out['nccl_ms'])}"
              f" ms a step, {r0['trace']['nccl_kernels']:.0f} of them")
    return out


def run_torchruns(argvs, timeout_s):
    """``python -m torch.distributed.run --standalone --nproc_per_node 4``
    of each of ``argvs`` from the checkout, all started together (each job
    one rank a card), each in a session of its own that is killed whole at
    the time limit -> ([(exit code, stdout, stderr)], seconds until the
    last one ended)."""
    import signal

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc_per_node", str(SCALE4_RANKS), *argv],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, start_new_session=True) for argv in argvs]
    out = []
    try:
        for proc in procs:
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            stdout, stderr = proc.communicate(timeout=left)
            out.append((proc.returncode, stdout, stderr))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"torchrun jobs not done within {timeout_s} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    return out, time.perf_counter() - t0


def phase_scale4(dev):
    """Scale-out (``parallel/``) on four cards of one host, one ``nccl``
    rank per card (``utils/cpu_mesh.RankPool``; this process joins no
    group, and the kernels are built before any rank starts).  Each rank
    reports its backend and card.  Every mesh step is held against the
    one-process Trainer's step on card 0 (adadelta at lr 1.0, dropout 0,
    ragged masks; TRAIN_LOSS_TOL, TRAIN_GRAD_TOL of max abs,
    TRAIN_PARAM_TOL) with the launches of each rank counted:

    * data 4: the flagship at global B = 10 (rows padded to 12) with
      gspmd, shard_map, zero1 and multihost, and at global B = 40 (10 rows
      a rank); 5 row-3, 5 row-4 and 1 row-2 launches a rank;
    * data 2 x model 2 and data 1 x model 4 (the 50-wide bottleneck
      replicated at 4) at B = 10, the same launches;
    * data 2 x seq 2 at T = 29 padded to 30 and data 1 x seq 4 at T = 48,
      B = 12: 5 row-3 and 5 row-4 launches and no row-2 (the prefix's delta
      is torch ops over the halo); seq 4 at T = 29 must raise SP4_REFUSAL;
    * zoo.adenet_v1 at B = 12 with batch norm synced over data 4 and over
      data 2 x seq 2, to BN_GRAD_TOL, each with its control (each rank's
      own statistics), which must exceed it;
    * the 4-stream model of configs/oulu_4stream.ini, data 4, B = 12: 6
      row-6, 6 row-7 and 1 row-2 launches a rank;
    * ``make_server(mesh=)`` over data 4 at B = 8 (SCORE_TOL against the
      plain server): 5 row-1 and 1 row-2 launches a rank;
    * ``cli.nstream`` under torchrun on the four cards with ``--mesh``,
      ``--model_parallel 2`` and ``--sequence_parallel 2``: exit code 0.

    Before the ranks start, this process steps the flagship on card 1 while
    its current device is card 0: the launches follow the tensors' card.
    Prints each run's step time, collectives and busy shares beside the
    cards, their power limit and their link.  Returns ({kernel: launches
    over the mesh runs, every rank}, numbers)."""
    import numpy as np
    import torch

    from ip_avsr_torch import serve as serve_lib
    from ip_avsr_torch.models import adenet, zoo
    from ip_avsr_torch.parallel import _multiprocess_worker as worker
    from ip_avsr_torch.utils.cpu_mesh import RankPool

    t0 = time.perf_counter()
    on = dev.type
    if on == "cuda" and torch.cuda.device_count() < SCALE4_RANKS:
        raise RuntimeError(f"phase_scale4 needs {SCALE4_RANKS} cards, this host has "
                           f"{torch.cuda.device_count()}")
    cards = sorted(set(smi("name,power.limit").splitlines()))
    link = topo_link()
    where = f"{SCALE4_RANKS} x {'; '.join(cards)}; link {link}"
    spec = KERNEL_COUNTERS
    init = lambda cfg, seed: worker.arrays(adenet.init_adenet_params(  # noqa: E731
        torch.Generator().manual_seed(seed), cfg, device="cpu"))
    cfg, cfg4 = flagship(dropout=False), no_dropout(oulu_4stream()[0])
    bn_cfg = zoo.adenet_v1(IMAGE_SHAPE[0] * IMAGE_SHAPE[1], DCT, output_classes=10)
    p, p4, p_bn = init(cfg, SEED + 40), init(cfg4, SEED + 41), init(bn_cfg, SEED + 42)
    sp2_t = -(-T_FRAMES // 2) * 2
    bn_batch = scale_batch(bn_cfg, SCALE4_B, SEED + 46)
    cases = {"flagship B=10": (cfg, p, scale_batch(cfg, TRAIN_B, SEED + 43)),
             "flagship B=40": (cfg, p, scale_batch(cfg, 4 * TRAIN_B, SEED + 44)),
             "flagship sp2": (cfg, p, pad_frames(scale_batch(cfg, SCALE4_B, SEED + 45), sp2_t)),
             "flagship sp4": (cfg, p, scale_batch(cfg, SCALE4_B, SEED + 45, T=SCALE4_SP_T)),
             "adenet_v1 dp": (bn_cfg, p_bn, bn_batch),
             "adenet_v1 sp2": (bn_cfg, p_bn, pad_frames(bn_batch, sp2_t)),
             "4-stream": (cfg4, p4, scale_batch(cfg4, SCALE4_B, SEED + 47))}
    # the one-process steps on card 0 that every mesh step is held against
    refs = {name: worker.chip_step(spec, *case, {}, device=on) for name, case in cases.items()}
    for name, ref in refs.items():
        print(f"scale4, one process {name}: loss {ref['loss']:.7f}, step {ref['step_ms']:.3f} "
              f"ms, launches {dict((k, v) for k, v in ref['launches'].items() if v)}")
    for name in cases:
        if name.startswith("flagship"):
            expect_launches(refs[name]["launches"], lstm_fwd_train=5, lstm_bwd=5, delta=1)
    expect_launches(refs["4-stream"]["launches"], lstm_peep_fwd_train=6, lstm_peep_bwd=6,
                    delta=1)
    no_delta = lambda name: dict(refs[name]["launches"], delta=0)  # noqa: E731
    zero = zero_grad_biases(bn_cfg)
    streams, _, mask = scale_batch(cfg, SCALE_SERVE_B, SEED + 48)
    numbers = {"cards": cards, "link": link}

    # one process, current device card 0, the flagship's tensors on card 1
    if on == "cuda":
        other = "cuda:1"
        got = worker.chip_step(spec, *cases["flagship B=10"], {}, refs["flagship B=10"][
            "result"], device=other)
        check_scale_step(f"scale4 one process, current device cuda:"
                         f"{torch.cuda.current_device()}, tensors on {got['device']}", got,
                         refs["flagship B=10"]["launches"])
        tree = worker.tensors(p, other)
        scores = serve_lib.make_server(tree, cfg, device=other)(streams, mask).cpu()
        want = serve_lib.make_server(worker.tensors(p, on), cfg, device=on)(streams, mask).cpu()
        err = float((scores - want).abs().max())
        print(f"scale4 one process: the server on {other} against card 0's, max abs {err:.2e}")
        if not err <= SCORE_TOL:
            raise AssertionError(f"the server on {other} disagrees with card 0's: {err}")

    totals = {k: 0 for k in KERNEL_COUNTERS}

    def step(label, case, opts, mesh, launches, z=(), tol=TRAIN_GRAD_TOL, timed=False):
        ranks = pool.run(worker.chip_step, spec, *cases[case], opts, refs[case]["result"], z,
                         device=on, turns=SCALE4_TURNS if timed else 0, trace=timed)
        for r, got in enumerate(ranks):
            if got["mesh"] != mesh or got["world"] != SCALE4_RANKS:
                raise AssertionError(f"{label} rank {r}: mesh {got['mesh']} of world "
                                     f"{got['world']}, expected {mesh}")
            if on == "cuda" and got["device"] != f"cuda:{r}":
                raise AssertionError(f"{label} rank {r} ran on {got['device']}")
            check_scale_step(f"{label} rank {r}", got, launches, z, tol)
            count_into(totals, got["launches"])
        numbers[label] = scale4_report(label, ranks, where)
        return ranks

    with RankPool(SCALE4_RANKS, backend="nccl" if on == "cuda" else "gloo",
                  timeout_s=600) as pool:
        for got in pool.run(worker.rank_card):
            if on == "cuda" and (got["backend"] != "nccl"
                                 or got["device"] != f"cuda:{got['rank']}"):
                raise AssertionError(f"rank {got['rank']} is not an nccl rank on its own card")
        lens = lambda case: cases[case][2][2].sum(axis=1)  # noqa: E731
        for sp, case, want in ((2, "flagship sp2", sp2_t), (4, "flagship sp4", SCALE4_SP_T),
                               (4, "flagship B=10", SP4_REFUSAL)):
            got = pool.run(worker.sp_max_t, cfg, dict(sequence_parallel=sp), lens(case))
            print(f"scale4 sequence_parallel={sp}, lengths up to {int(lens(case).max())}: "
                  f"{got[0]!r}")
            if got != [want] * SCALE4_RANKS:
                raise AssertionError(f"sequence_parallel={sp}: {got}, expected {want!r}")

        flag = refs["flagship B=10"]["launches"]
        for name, opts in SCALE_OPTIONS.items():
            step(f"scale4 data 4 {name}, B = {TRAIN_B}", "flagship B=10", opts, {"data": 4},
                 flag, timed=name == "gspmd")
        step(f"scale4 data 4, B = {4 * TRAIN_B}", "flagship B=40", dict(use_mesh=True),
             {"data": 4}, refs["flagship B=40"]["launches"], timed=True)
        for mp in (2, 4):
            step(f"scale4 data {4 // mp} x model {mp}, B = {TRAIN_B}", "flagship B=10",
                 dict(model_parallel=mp), {"data": 4 // mp, "model": mp}, flag, timed=True)
        for sp, case in ((2, "flagship sp2"), (4, "flagship sp4")):
            step(f"scale4 data {4 // sp} x seq {sp}, B = {SCALE4_B}, T = "
                 f"{cases[case][2][2].shape[1]}", case, dict(sequence_parallel=sp),
                 {"data": 4 // sp, "seq": sp}, no_delta(case), timed=True)
        for case, opts, mesh in (("adenet_v1 dp", dict(use_mesh=True), {"data": 4}),
                                 ("adenet_v1 sp2", dict(sequence_parallel=2),
                                  {"data": 2, "seq": 2})):
            label = f"scale4 adenet_v1 {' x '.join(f'{k} {v}' for k, v in mesh.items())}"
            want = refs[case]["launches"] if "seq" not in mesh else no_delta(case)
            step(label, case, opts, mesh, want, z=zero, tol=BN_GRAD_TOL)
            for r, got in enumerate(pool.run(worker.chip_step, spec, *cases[case], opts,
                                             refs[case]["result"], zero, device=on,
                                             local_bn=True)):
                g = got["gaps"]
                print(f"{label} control, rank {r} with batch-norm statistics of its own "
                      f"block: gradients {g['grad_rel']:.2e} of max abs ({g['grad_worst']}) "
                      f"from one process, against BN_GRAD_TOL {BN_GRAD_TOL:.0e}")
                if not g["grad_rel"] > BN_GRAD_TOL:
                    raise AssertionError(f"{label}: BN_GRAD_TOL passes a step whose batch "
                                         f"norm is not synced over the ranks")
        step(f"scale4 4-stream data 4, B = {SCALE4_B}", "4-stream", dict(use_mesh=True),
             {"data": 4}, refs["4-stream"]["launches"], timed=True)
        served = pool.run(worker.chip_serve, spec, cfg, p, streams, mask, device=on,
                          turns=SCALE4_TURNS)
        for r, got in enumerate(served):
            print(f"scale4 make_server(mesh=) data 4, B = {SCALE_SERVE_B}, rank {r}: scores max "
                  f"abs gap to the plain server {got['max_abs_err']:.2e}; launches "
                  f"{dict((k, v) for k, v in got['launches'].items() if v)}")
            if not (got["finite"] and got["max_abs_err"] <= SCORE_TOL):
                raise AssertionError("make_server(mesh=) disagrees with the plain server")
            expect_launches(got["launches"], lstm_fwd=5, delta=1)
            count_into(totals, got["launches"])
        r0 = served[0]
        numbers["serve"] = {"mesh_ms": statistics.median(r0["mesh_ms"]),
                            "plain_ms": statistics.median(r0["plain_ms"]),
                            "collectives": r0["collectives"],
                            "collective_bytes": r0["collective_bytes"],
                            "collective_ms": r0["collective_ms"]}
        gather_ms = [g["collective_ms"].get("all_gather") for g in served]
        numbers["serve"]["all_gather_ms"] = gather_ms
        print(f"scale4 make_server(mesh=): a request of B = {SCALE_SERVE_B} "
              f"{numbers['serve']['mesh_ms']:.3f} ms on the mesh against "
              f"{numbers['serve']['plain_ms']:.3f} ms on one card (host medians of "
              f"{SCALE4_TURNS} interleaved turns, rank 0); collectives {r0['collectives']} "
              f"({r0['collective_bytes']} B; the all-gather "
              f"{', '.join('not timed' if v is None else f'{v:.3f}' for v in gather_ms)} ms "
              f"by rank, CUDA events) ({where})")

    argvs = [["-m", "ip_avsr_torch.cli.nstream", "--config",
              os.path.join("configs", "synthetic_1stream.ini"), "--synthetic", "60", *flags]
             + ([] if on == "cuda" else ["--device", "cpu"]) for flags in SCALE4_CLI]
    runs, secs = run_torchruns(argvs, SCALE4_CLI_TIMEOUT_S)
    numbers["cli"] = {"s": secs}
    for flags, (code, out, err) in zip(SCALE4_CLI, runs):
        tail = [line for line in out.splitlines() if line.startswith(("CR:", "Epoch"))][-2:]
        print(f"scale4 torchrun x {SCALE4_RANKS} cli.nstream {' '.join(flags)}: exit {code}; "
              f"{' | '.join(tail)}")
        numbers["cli"][" ".join(flags)] = code
        if code != 0 or "terminate called" in err:
            raise AssertionError(f"cli.nstream {' '.join(flags)} under torchrun: exit {code}:\n"
                                 f"{err[-4000:]}")
    print(f"scale4: the {len(SCALE4_CLI)} torchrun jobs, run together, took {secs:.1f} s")
    numbers["phase_s"] = time.perf_counter() - t0
    print(f"phase_scale4: {numbers['phase_s']:.1f} s; launches over the mesh runs "
          f"{dict((k, v) for k, v in totals.items() if v)} ({where})")
    return totals, numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    ab = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--ab" else None
    sass_dir = sys.argv[2] if len(sys.argv) == 3 and sys.argv[1] == "--sass" else None
    bf16_only = sys.argv[1:] == ["--bf16"]
    mesh4_only = sys.argv[1:] == ["--mesh4"]
    tiled_only = sys.argv[1:] == ["--tiled"]
    adam_only = sys.argv[1:] == ["--adam"]
    if len(sys.argv) > 1 and ab is None and sass_dir is None and not (
            bf16_only or mesh4_only or tiled_only or adam_only):
        print(f"usage: {sys.argv[0]} [--ab DIR | --sass DIR | --bf16 | --mesh4 | --tiled | "
              f"--adam]", file=sys.stderr)
        return 2
    if mesh4_only and torch.cuda.device_count() < SCALE4_RANKS:
        print(f"chip_smoke --mesh4: phase_scale4 needs {SCALE4_RANKS} cards, this host has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(ab) if ab else ROOT)
    import ip_avsr_torch  # noqa: F401  (fails outside a checkout of the repo)

    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0])
    if sass_dir:
        same = sass_against(sass_dir)
        print(json.dumps({"sass_identical": same}))
        return 0 if all(same.values()) else 1
    phase_build()
    phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if ab:
        print(json.dumps({"ab": ab_run(dev)}))
        return 0
    if adam_only:
        print(json.dumps({"adam": phase_adam(dev, ADAM_CHUNKS)}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    if mesh4_only:
        scale4_launches, scale4_numbers = phase_scale4(dev)
        print(json.dumps({"scale4": scale4_numbers, "scale4_launches": scale4_launches}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    sass = phase_sass()
    if bf16_only:
        bf16_rows, _, bf16_numbers = phase_bf16(dev)
        for name, numbers in bf16_rows.items():
            numbers.update(sass[row_instance(name)], f32_registers=sass[row_instance(
                name[:-5])]["registers"])
        print(json.dumps({"bf16": bf16_numbers, "bf16_rows": bf16_rows}))
        return 0
    if tiled_only:
        # the large-B bodies alone: their six rows against their plain
        # versions, timed at the cells' batches, their counters on the main
        # path, and the crossover sweeps
        ptxas = tiled_ptxas()
        numbers = {name: tiled_check(dev, name)[1] for name in TILED_CASES}
        numbers.update({f"{name} H={H}": tiled_check(dev, name, H, batches)[1]
                        for name, H, batches in TILED_WIDTHS})
        numbers.update({name: bwd_tiled_check(dev, name)[1] for name in BWD_TILED_CASES})
        print(json.dumps({"ptxas": ptxas, "large_b": numbers, "main_path": tiled_main_path(dev),
                          "sweep": tiled_sweep(dev, TILED_SWEEP + BWD_TILED_SWEEP)}))
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
    # {label: (config, parameter tree[, input])} of the models the phases
    # build, which phase_oracle takes instead of building them again; kept
    # on the host, so that the later phases' memory readings do not see them
    trees = {}
    launches, _ = phase_serve(dev, trees)
    train_launches, _ = phase_train(dev)
    launches4, _ = phase_serve_4stream(dev, trees)
    train_launches4, _ = phase_train_4stream(dev)
    main_path = tiled_main_path(dev)
    adam = phase_adam(dev)
    # the bf16 paths beside the f32 ones: on this card torch.profiler has
    # lost every device record of a cooperative launch when traced after
    # phase_tools, so the phase that traces them runs here
    bf16_rows, bf16_paths, bf16_numbers = phase_bf16(dev)
    print(json.dumps({"bf16": bf16_numbers}))
    stream = phase_stream(dev)
    buckets = phase_serve_buckets(dev)
    print(json.dumps({"lstm_state": state, "stream": stream, "serve_buckets": buckets}))
    fit_launches, fit_epochs, fit4_launches, fit4_epochs, fit_timing = phase_fit(dev)
    print(json.dumps({"fit": fit_timing}))
    cli_launches, cli_numbers = phase_cli(dev)
    print(json.dumps({"cli": cli_numbers}))
    export = phase_export(dev)
    print(json.dumps({"export": export}))
    zoo_launches, zoo_numbers = phase_zoo(dev, trees)
    print(json.dumps({"zoo": zoo_numbers}))
    residual_launches, residual_numbers = phase_residuals(dev)
    print(json.dumps({"residuals": residual_numbers}))
    pretrain_launches, pretrain_numbers = phase_pretrain(dev, trees)
    print(json.dumps({"pretrain": pretrain_numbers}))
    oracle_launches, oracle_numbers = phase_oracle(dev, trees)
    print(json.dumps({"oracle": oracle_numbers}))
    tools_launches, tools_numbers = phase_tools(dev)
    print(json.dumps({"tools": tools_numbers}))
    scale_launches = phase_scale(dev)
    scale4_launches = None
    if torch.cuda.device_count() >= SCALE4_RANKS:
        scale4_launches, scale4_numbers = phase_scale4(dev)
        print(json.dumps({"scale4": scale4_numbers}))
    else:
        print(f"phase_scale4: not run: it needs {SCALE4_RANKS} cards, this host has "
              f"{torch.cuda.device_count()} (python3 chip_smoke.py --mesh4 on a host with "
              f"{SCALE4_RANKS})")

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
        # the tools phase (the rehearsal's fits, the confusion forward), and
        # the oracle phase (the forwards held to the numpy oracle, the clip-0
        # BLSTM gradients)
        row.update(cli_launches=cli_launches[row["name"]],
                   zoo_launches=zoo_launches[row["name"]],
                   residual_launches=residual_launches[row["name"]],
                   pretrain_launches=pretrain_launches[row["name"]],
                   tools_launches=tools_launches[row["name"]],
                   scale_launches=scale_launches[row["name"]],
                   scale4_launches=scale4_launches and scale4_launches[row["name"]],
                   oracle_launches=oracle_launches[row["name"]])
    # the six bf16 instantiations: launches on their bf16 main path (the
    # flagship's serve and train steps for rows 1, 3 and 4, the 4-stream
    # model's for rows 5-7), beside the bf16 CLI's and the artifacts'
    for name, (row, line, _, _) in BF16_ROWS.items():
        path = ("serve" if row.endswith("fwd") else "train") + (
            "_4stream" if "peep" in row else "")
        numbers = bf16_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": bwd_src if row.endswith("bwd") else fwd_src,
            "replaces": f"{pallas}:{line}", "launches": bf16_paths[path][name],
            "max_abs_err": numbers["max_abs_err"], "shape": numbers["shape"],
            **{k: numbers[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "traced_ms", "us_per_step", "f32_ms",
                                       "f32_us_per_step", "traced_us_per_step",
                                       "f32_units_ms")},
            "cli_launches": bf16_paths["cli"][name],
            "export_launches": bf16_paths["export"][name],
            "scale_launches": scale_launches[name],
            "scale4_launches": scale4_launches and scale4_launches[name],
            "oracle_launches": oracle_launches[name]})
    # rows 1 and 3-7: the large-B body at the cells' batches, and each row's
    # launches and large-B launches on its main path at the cells' and the
    # reference batch
    large_b = {"lstm_fwd": lstm_rows["large_b"], **train_rows["large_b"],
               **peep_rows["large_b"]}
    for row in kernels:
        if row["name"] in large_b:
            row["large_b"] = dict(large_b[row["name"]],
                                  main_path_launches=main_path[row["name"]])
    # every LSTM row: registers per thread of its instantiation at its main
    # path's units per block, and its tensor-core instructions (HMMA)
    for row in kernels:
        if row["name"] != "delta":
            row.update(sass[row_instance(row["name"])])
    # the multi-tensor Adam kernel at both training cells' trees
    # with the Trainer step's launches on the main path at the cells' and the
    # reference batch (tiled_main_path)
    kernels.append({"name": "adam", "route": "cuda", "source": "ip_avsr_torch/csrc/adam.cu",
                    "replaces": None, **adam, "main_path_launches": main_path["adam"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
