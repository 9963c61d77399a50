"""The benchmark of ``ip_avsr_torch`` on NVIDIA H100s: one run of one cell.

    python3 avsr_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of ``BENCHMARK.json``
there; its configuration, traffic mix, limits and per-layer readers are the
files of ``avsr_bench/`` that it names.  The run sets up from ``--seed``,
measures for ``--seconds`` (with ``--trace 1``: traces a fixed window and
reads the per-layer metrics), checks what the window produced against the
plain reference, and prints one JSON line as the last line of standard
output.  It exits non-zero, printing no result, without the cards the cell
needs, and where JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from avsr_bench.harness import report, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    code, out = report.execute(cell, ROOT, args.seed, args.seconds, bool(args.trace), T0)
    if out is not None:
        report.emit(out)
    return code


if __name__ == "__main__":
    sys.exit(main())
