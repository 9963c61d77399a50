"""The control of each cell's check at the cell's own size, on the card: the
reference in TF32 put in the program's place, and each of the cell's faults
planted in the reference, must each fail one of the cell's numbers.  Run on
the chip:

    python3 -m pytest avsr_bench/tests/test_avsr_bench_control.py -m cuda
"""

import json
import os

import pytest

from avsr_bench.harness import spec
from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def _fails(readings: dict, limits: dict) -> bool:
    return any(readings[k] > limits[k] for k in readings if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_every_fault_fail_the_cells_check(card, name):
    cell = spec.load_cell(name, ROOT)
    got = spec.driver(cell.driver).control(cell, 2**31 + 977, card)
    assert _fails(got["control"], cell.limits), got["control"]
    for fault, readings in got["faults"].items():
        assert _fails(readings, cell.limits), (fault, readings)
