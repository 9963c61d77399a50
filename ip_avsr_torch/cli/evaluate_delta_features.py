"""Delta-feature ablation: train the same model with and without DeltaLayers
and compare classification rates.  The port of
ip_avsr_tpu/cli/evaluate_delta_features.py.

Parity with avletters/evaluate_delta_features.py's role: quantify what the
in-graph delta/acceleration features buy.  Runs the N-stream trainer CLI
twice on one config — once as-is, once with every stream's delta disabled —
and prints a side-by-side report.  Both runs train on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m ip_avsr_torch.cli.evaluate_delta_features \\
        --config configs/synthetic_1stream.ini --synthetic 60 --device cpu
"""

from __future__ import annotations

import argparse
import configparser
import os
import tempfile

from ip_avsr_torch.cli import nstream


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--num_epoch", type=int)
    ap.add_argument("--split", default="subjects", choices=["subjects", "itervec"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    base_args = ["--config", args.config, "--split", args.split, "--device", args.device]
    if args.synthetic:
        base_args += ["--synthetic", str(args.synthetic)]
    if args.num_epoch:
        base_args += ["--num_epoch", str(args.num_epoch)]

    print("=== run 1/2: with delta features ===")
    with_delta = nstream.main(list(base_args))

    # the config again with use_delta = false on every stream
    cp = configparser.ConfigParser()
    cp.read(args.config)
    i = 1
    while cp.has_section(f"stream{i}"):
        cp.set(f"stream{i}", "use_delta", "false")
        i += 1
    with tempfile.TemporaryDirectory() as tmp:
        nodelta_cfg = os.path.join(tmp, "nodelta.ini")
        with open(nodelta_cfg, "w") as f:
            cp.write(f)
        print("=== run 2/2: without delta features ===")
        base_args[1] = nodelta_cfg
        without_delta = nstream.main(list(base_args))

    print("\n=== delta-feature ablation ===")
    print(f"{'':>14} {'val CR':>8} {'test CR':>8} {'best val cost':>14}")
    print(f"{'with delta':>14} {with_delta.best_cr:8.3f} {with_delta.test_cr:8.3f} "
          f"{with_delta.best_val:14.4f}")
    print(f"{'without delta':>14} {without_delta.best_cr:8.3f} "
          f"{without_delta.test_cr:8.3f} {without_delta.best_val:14.4f}")
    return with_delta, without_delta


if __name__ == "__main__":
    main()
