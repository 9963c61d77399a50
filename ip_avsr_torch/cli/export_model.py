"""Export a trained model as a self-contained serving artifact (.ipax).

The port of ip_avsr_tpu/cli/export_model.py: the traced serving program
(``torch.export``, weights as buffers, the kernels as ``ip_avsr::``
operators), so the serving host needs torch, ``ip_avsr_torch.export`` and
the kernels' registrations (``ip_avsr_torch.ops.kernels``), and not the
model code or the INI parser.  By default both batch and time axes are
symbolic, so ONE artifact serves any request size, on the CPU or the card
(``--platforms``); ``--batch/--time`` pin shapes.  The trace runs on
``--device`` (default ``cuda``; ``cpu`` traces and checks on the CPU).

Examples:
    python -m ip_avsr_torch.cli.export_model --config configs/oulu_4stream.ini \\
        --model best.pkl --out model.ipax --check
    python -m ip_avsr_torch.cli.demo --config ... --artifact model.ipax
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ip_avsr_torch import bridge
from ip_avsr_torch import export as export_lib
from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.io import matio
from ip_avsr_torch.models import adenet
from ip_avsr_torch.serve import make_server
from ip_avsr_torch.train import config as config_lib

# the artifact against the live server on one device: the same kernels on
# both sides in float32; bf16-stored weights round each weight once
CHECK_TOL = 2e-5
CHECK_TOL_BF16 = 5e-2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True, help="model INI (same schema "
                    "as nstream/demo)")
    ap.add_argument("--model", help="trained weights pickle "
                    "(save_model_params of either package); random init if omitted")
    ap.add_argument("--out", required=True, help="artifact path (.ipax)")
    ap.add_argument("--per_step", action="store_true",
                    help="export per-step (B, T, C) scores instead of the "
                         "voted (B, C) head")
    ap.add_argument("--streaming", action="store_true",
                    help="export a STREAMING artifact instead (the session's "
                         "prep and advance programs; requires a forward-only "
                         "head, INI use_blstm = false); consume with "
                         "export.load_streaming_session or demo --streaming "
                         "--artifact")
    ap.add_argument("--batch", type=int, default=None,
                    help="pin the batch axis (default: symbolic, any size)")
    ap.add_argument("--time", type=int, default=None,
                    help="pin the time axis (default: symbolic, any length)")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated devices the artifact may be loaded "
                         "on, of cpu and cuda (default: both)")
    ap.add_argument("--weights_dtype", default=None,
                    help="store the weights in this dtype (bfloat16 roughly "
                         "halves the artifact; the program computes in "
                         "float32)")
    ap.add_argument("--classnames", default=None,
                    help="comma-separated class labels stored in meta.json")
    ap.add_argument("--check", action="store_true",
                    help="reload the artifact and verify its scores match "
                         "the live server on random inputs, on --device")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.streaming and (args.time is not None or args.per_step):
        ap.error("--time/--per_step do not apply to streaming artifacts "
                 "(the chunk axis is symbolic and streaming is inherently "
                 "per-step)")

    device = resolve_device(args.device)
    cp = config_lib.load_config(args.config)
    stream_cfgs = config_lib.parse_streams(cp)
    clf = config_lib.parse_classifier(cp)
    # the builder the trainer uses, so a trained model is rebuilt as trained
    cfg = config_lib.build_model_config(stream_cfgs, clf)

    if args.model:
        params = bridge.params_from_jax(matio.load_model_params(args.model), device=device)
    else:
        print("no --model given: exporting a random init (smoke mode)")
        params = adenet.init_adenet_params(torch.Generator().manual_seed(0), cfg,
                                           device=device)

    labels = (args.classnames.split(",") if args.classnames
              else clf.output_classnames or None)
    platforms = args.platforms.split(",") if args.platforms else None

    if args.streaming:
        export_lib.save_streaming_artifact(
            args.out, params, cfg, batch=args.batch or 1, labels=labels,
            platforms=platforms, weights_dtype=args.weights_dtype, device=device)
    else:
        export_lib.save_artifact(
            args.out, params, cfg, vote=not args.per_step,
            batch=args.batch, time=args.time, platforms=platforms,
            labels=labels, weights_dtype=args.weights_dtype, device=device)
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes, "
          f"{'streaming' if args.streaming else 'batch'}, "
          f"batch={'any' if args.batch is None and not args.streaming else args.batch or 1}, "
          f"time={'any' if args.time is None else args.time})")

    if args.check:
        rng = np.random.RandomState(0)
        T = args.time or max(cfg.window * 2, 8)
        if args.streaming:
            sess = export_lib.load_streaming_session(args.out, device=device)
            live = make_server(params, cfg, vote=False, device=device)
            B = args.batch or 1
            streams = [rng.randn(B, T, s.input_dim).astype(np.float32)
                       for s in cfg.streams]
            got = list(sess.feed(streams))
            tail, _ = sess.finalize()
            got = (np.concatenate([np.stack(got, axis=1), tail], axis=1)
                   if got else tail)
            want = live(streams, np.ones((B, T), np.float32)).cpu().numpy()
        else:
            srv = export_lib.load_server(args.out, device=device)
            live = make_server(params, cfg, vote=not args.per_step, device=device)
            B = args.batch or 3
            streams = [rng.randn(B, T, s.input_dim).astype(np.float32)
                       for s in cfg.streams]
            mask = np.ones((B, T), np.float32)
            got = srv(streams, mask).cpu().numpy()
            want = live(streams, mask).cpu().numpy()
        atol = CHECK_TOL_BF16 if args.weights_dtype else CHECK_TOL
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        print(f"check OK: artifact matches the live server "
              f"(max |diff| {np.abs(got - want).max():.2e}, tolerance {atol:g})")


if __name__ == "__main__":
    main()
