"""The control of each cell's check, and its faults, read at the cell's own
size: the plain reference put in the program's place, computed in the
control's precision (TF32 products, the nearest precision below float32
with TF32 off), or with a fault planted in it, and compared with the
reference in float32 by the cell's own numbers.  Each driver's
``control(cell, seed, device)`` reads them.  The benchmark's runs do
not run it; the limits in ``avsr_bench/limits/`` lie between the program's
readings and these.

    python3 -m avsr_bench.harness.control --workload <name> --seeds 1 2 3

prints one JSON line per seed: ``{"control": {number: value}, "faults":
{fault: {number: value}}}``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from avsr_bench.harness import spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = spec.load_cell(args.workload, spec.ROOT)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        readings = spec.driver(cell.driver).control(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
