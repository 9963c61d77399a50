"""The backward chain's large-B body, by its index arithmetic.

csrc/lstm_bwd.cu's large-B body (``tiled_chain``, planned by ``bwd_plan``
in ip_avsr_torch/ops/kernels/lstm.py; the plan and the dispatch of both
directions are held in test_torch_lstm_tiled_plan.py): its constants as the
source states them, its instantiations as the harness's trace patterns
match them, and every product, staged value and gate-stage (row, unit) of a
block covered once, as the kernel's index arithmetic (mirrored below)
assigns them.
"""

import os
import re

import numpy as np
import pytest
import torch

from avsr_bench.harness import trace
from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
THREADS = 256


def _source_constants():
    """The large-B body's constants as csrc/lstm_bwd.cu states them."""
    with open(os.path.join(_build.CSRC, "lstm_bwd.cu")) as f:
        src = f.read()
    return {name: int(v) for name, v in re.findall(r"constexpr int (kTiled\w+) = (\d+);", src)}


def test_constants_mirror_the_source():
    c = _source_constants()
    assert c["kTiledUnits"] == klstm.TILED_UNITS == 16
    assert c["kTiledRows"] == klstm.TILED_ROWS == 64
    assert c["kTiledK"] == klstm.BWD_TILED_K == 128
    assert klstm.BWD_TILED_K_PAD == klstm.BWD_TILED_K + 4
    assert (c["kTiledTR"], c["kTiledTU"]) == (8, 8)


@pytest.mark.parametrize("peep,row", [(False, "lstm_bwd_chain"), (True, "lstm_peep_bwd_chain")])
def test_tiled_instantiation_matches_the_harness(peep, row):
    """The large-B body is the kernel template's instantiation at 16 units
    and a float W, so the harness's pattern for the row reads its records."""
    with open(os.path.join(_build.CSRC, "lstm_bwd.cu")) as f:
        src = f.read()
    assert f"LSTM_BWD_TILED({str(peep).lower()})" in src
    name = f"void (anonymous namespace)::lstm_bwd_chain_kernel<{str(peep).lower()}, 16, float>"
    assert re.search(trace.ROW_PATTERNS[row], name)
    other = "lstm_peep_bwd_chain" if row == "lstm_bwd_chain" else "lstm_bwd_chain"
    assert not re.search(trace.ROW_PATTERNS[other], name)


@pytest.mark.parametrize("H", [130, 250, 500])
def test_tiled_product_covers_every_sum_once(H):
    """The product's threads: (kq, tu, tr) = (tid / 16, tid / 8 % 2, tid %
    8) sums rows tr + 8 i (i < 8) by units 8 tu .. + 7 over slice kq (8 k)
    of a chunk of 128; together they cover each (slice, row, unit) of a
    block once, the staging threads each (row, k) of a chunk once, the
    gate-stage threads each (row, unit) once, and the chunks, each unit
    group starting at its own, cover 4H once."""
    tid = np.arange(THREADS)
    tr, tu, kq = tid % 8, tid // 8 % 2, tid // 16
    count = np.zeros((16, 64, 16), dtype=np.int64)
    for i in range(8):
        for v in range(8):
            np.add.at(count, (kq, tr + 8 * i, 8 * tu + v), 1)
    assert count.min() == count.max() == 1
    # a quarter warp (8 neighbouring lanes) reads 8 neighbouring rows, 528
    # bytes apart: 8 distinct 16-byte bank groups; one W address
    lanes = tid[:8]
    assert len({(528 * r) % 128 for r in tr[lanes]}) == 8
    assert len({(kq[l], tu[l]) for l in lanes}) == 1
    stage = np.zeros((64, 128), dtype=np.int64)
    for l in range(8):
        for c in range(4):
            np.add.at(stage, (tid // 32 + 8 * l, 4 * (tid % 32) + c), 1)
    assert stage.min() == stage.max() == 1
    gate = np.zeros((64, 16), dtype=np.int64)
    for i in range(4):
        np.add.at(gate, (tid // 16 + 16 * i, tid % 16), 1)
    assert gate.min() == gate.max() == 1
    n_chunks = -(-4 * H // klstm.BWD_TILED_K)
    for bx in range(-(-H // 16)):
        order = [(bx % n_chunks + ch) % n_chunks for ch in range(n_chunks)]
        assert sorted(order) == list(range(n_chunks))
