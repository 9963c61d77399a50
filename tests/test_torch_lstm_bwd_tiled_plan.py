"""The backward chain's large-B plan and the dispatch between its two bodies.

``bwd_tiled_plan`` (ip_avsr_torch/ops/kernels/lstm.py) is the pure-Python
half of csrc/lstm_bwd.cu's large-B body (``tiled_chain``): unit groups by
row groups of one cooperative launch, shared memory and row chunks.  The
card only sees the shapes the smoke run gives it, so the plan is held here to
its invariants: every block resident, shared memory within the limit, one
launch a call at the benchmark cells' shapes (the count the harness
multiplies by), and every (row, unit) of the batch owned by exactly one
thread of one block, as the kernel's index arithmetic (mirrored below)
assigns them.  ``bwd_plan`` is the one place that picks the body: the
large-B one for a float32 W_hid at B >= ``BWD_TILED_MIN_ROWS`` and H >=
``BWD_TILED_MIN_H`` up to ``BWD_TILED_MAX_H`` (where the sweep on the card
measured it: B = 128 at H = 64, 130, 250 and 500), the small-B one
(``bwd_launch_plan``, unchanged) everywhere else, and for every bf16 W_hid.
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
SMS = 132
THREADS = 256
SHAPES = [(H, B) for H in (130, 250, 500, 640, 641) for B in (17, 64, 256, 257, 512, 600)]


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


def _owners(plan, B, H):
    """How many gate-stage threads own each (row, unit) of the batch, by the
    kernel's arithmetic: chunk (b0, b1) of ``chunk_spans``, block (bx, by)
    for by below the row groups the wrapper passes (ceil(plan.rows / 64)),
    thread tid owns unit bx * 16 + tid % 16 and rows by * 64 + tid / 16 + 16
    i (i < 4) of the chunk, where both are live (unit < H, row < the chunk's
    rows)."""
    count = np.zeros((B, H), dtype=np.int64)
    tid = np.arange(THREADS)
    row_groups = -(-plan.rows // klstm.TILED_ROWS)
    for b0, b1 in klstm.chunk_spans(B, plan.chunks):
        assert row_groups * klstm.TILED_ROWS >= b1 - b0
        for bx in range(plan.grid):
            for by in range(row_groups):
                j = bx * klstm.TILED_UNITS + tid % klstm.TILED_UNITS
                for i in range(4):
                    r = by * klstm.TILED_ROWS + tid // klstm.TILED_UNITS + 16 * i
                    live = (j < H) & (r < b1 - b0)
                    np.add.at(count, (b0 + r[live], j[live]), 1)
    return count


@pytest.mark.parametrize("H,B", SHAPES, ids=[f"H{H}-B{B}" for H, B in SHAPES])
def test_bwd_tiled_plan(H, B):
    smem = 4 * (-(-4 * H // 128) * 128 * 16 + 2 * 64 * 132)
    if smem > _build.SMEM_LIMIT:
        # 16 rows of W_hid no longer fit beside the staged chunks (H > 640)
        with pytest.raises(ValueError, match=f"large-B backward chain: H={H}"):
            klstm.bwd_tiled_plan(B, H, SMS)
        assert klstm.bwd_plan(B, H, SMS) == klstm.bwd_launch_plan(B, H, SMS)
        return
    plan = klstm.bwd_tiled_plan(B, H, SMS)
    assert plan.units == 16 and plan.grid == -(-H // 16)
    assert plan.last_units == H - 16 * (plan.grid - 1)
    # every block of a launch co-resident, one a SM
    assert plan.grid * -(-plan.rows // klstm.TILED_ROWS) <= SMS
    # W_hid's 16 rows as 4H k rows of 16 floats, padded to chunks of 128,
    # and two staged chunks of 64 rows of 132 floats
    assert plan.smem_bytes == klstm.bwd_tiled_smem_bytes(H) == smem <= _build.SMEM_LIMIT
    cap = SMS // plan.grid * klstm.TILED_ROWS
    assert plan.chunks == -(-B // cap) and plan.rows == -(-B // plan.chunks) <= cap
    count = _owners(plan, B, H)
    assert count.min() == count.max() == 1


# the cells' shapes: grid and shared memory
@pytest.mark.parametrize("B,H,grid,row_groups,smem", [
    (256, 500, 32, 4, 198656),
    (512, 250, 16, 8, 133120),
])
def test_bwd_tiled_plan_at_the_cells(B, H, grid, row_groups, smem):
    plan = klstm.bwd_plan(B, H, SMS)
    assert isinstance(plan, klstm.TiledPlan)
    assert (plan.grid, -(-plan.rows // klstm.TILED_ROWS), plan.smem_bytes) == (grid, row_groups,
                                                                             smem)
    assert plan.grid * row_groups == 128 <= SMS and smem <= _build.SMEM_LIMIT


@pytest.mark.parametrize("B,H", [(256, 500), (512, 250)])
def test_cells_run_one_launch_a_call(B, H):
    """The harness counts a backward row's launches as ``bwd_launch_plan(B,
    H, sm).chunks`` (avsr_bench/harness/drive._chunks): the large-B plan
    that runs there must launch exactly that often, once a call."""
    assert klstm.bwd_plan(B, H, SMS).chunks == klstm.bwd_launch_plan(B, H, SMS).chunks == 1


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


@pytest.mark.parametrize("B,H,chunks,rows", [
    (600, 500, 3, 200),   # 256 rows a launch at H = 500
    (257, 500, 2, 129),
    (600, 250, 2, 300),   # 512 at H = 250
    (2100, 500, 9, 234),
])
def test_bwd_tiled_plan_chunks(B, H, chunks, rows):
    """Rows above one launch's row groups run as near-equal row chunks, each
    a pointer offset, as the small-B plan's do."""
    plan = klstm.bwd_plan(B, H, SMS)
    assert isinstance(plan, klstm.TiledPlan)
    assert (plan.chunks, plan.rows) == (chunks, rows)
    count = _owners(plan, B, H)
    assert count.min() == count.max() == 1


def test_bwd_tiled_plan_forced_chunks():
    plan = klstm.bwd_tiled_plan(256, 500, SMS, chunks=3)
    assert (plan.chunks, plan.rows) == (3, 86)
    with pytest.raises(ValueError, match="runs in 2 to 512 chunks"):
        klstm.bwd_tiled_plan(512, 500, SMS, chunks=1)
    with pytest.raises(ValueError, match="large-B backward chain: H=500 needs 32 blocks"):
        klstm.bwd_tiled_plan(256, 500, 16)


# (B, H, w_dtype) -> the body bwd_plan picks: each side of the crossover at
# the widths swept, and never below them or for a bf16 W_hid
def test_crossover_is_the_swept_one():
    assert (klstm.BWD_TILED_MIN_ROWS, klstm.BWD_TILED_MIN_H, klstm.BWD_TILED_MAX_H) == (
        128, 64, 500)


DISPATCH = [
    ((1, 500, torch.float32), False),
    ((10, 500, torch.float32), False),
    ((klstm.BWD_TILED_MIN_ROWS - 1, 500, torch.float32), False),
    ((klstm.BWD_TILED_MIN_ROWS, 500, torch.float32), True),
    ((256, 500, torch.float32), True),
    ((klstm.BWD_TILED_MIN_ROWS - 1, 250, torch.float32), False),
    ((klstm.BWD_TILED_MIN_ROWS, 250, torch.float32), True),
    ((512, 250, torch.float32), True),
    ((klstm.BWD_TILED_MIN_ROWS - 1, klstm.BWD_TILED_MIN_H, torch.float32), False),
    ((klstm.BWD_TILED_MIN_ROWS, klstm.BWD_TILED_MIN_H, torch.float32), True),
    ((512, klstm.BWD_TILED_MIN_H - 1, torch.float32), False),
    ((512, 16, torch.float32), False),
    ((128, 130, torch.float32), True),
    ((127, 130, torch.float32), False),
    ((512, klstm.BWD_TILED_MAX_H + 1, torch.float32), False),
    ((512, 640, torch.float32), False),
    ((2100, 500, torch.float32), True),
    ((256, 500, torch.bfloat16), False),
    ((512, 250, torch.bfloat16), False),
    ((512, 641, torch.float32), False),
]


@pytest.mark.parametrize("args,tiled", DISPATCH, ids=[str(a) for a, _ in DISPATCH])
def test_bwd_plan_dispatch(args, tiled):
    B, H, w_dtype = args
    plan = klstm.bwd_plan(B, H, SMS, w_dtype)
    assert isinstance(plan, klstm.TiledPlan) == tiled
    if tiled:
        assert plan == klstm.bwd_tiled_plan(B, H, SMS)
    else:
        assert plan == klstm.bwd_launch_plan(B, H, SMS, w_dtype=w_dtype)


def test_bwd_plan_forcing():
    # units force the small-B body at any B; tiled forces either body
    assert klstm.bwd_plan(256, 500, SMS, units=8) == klstm.bwd_launch_plan(256, 500, SMS, 8)
    assert klstm.bwd_plan(256, 500, SMS, tiled=False) == klstm.bwd_launch_plan(256, 500, SMS)
    assert klstm.bwd_plan(2100, 500, SMS, tiled=False).chunks == 2
    assert klstm.bwd_plan(16, 500, SMS, tiled=True) == klstm.bwd_tiled_plan(16, 500, SMS)
    assert klstm.bwd_plan(256, 500, SMS, chunks=2) == klstm.bwd_tiled_plan(256, 500, SMS, 2)


@pytest.mark.parametrize("dtype,units", [(torch.bfloat16, None), (torch.float32, 4),
                                         (torch.bfloat16, 16)])
def test_bwd_plan_refuses_other_instantiations(dtype, units):
    with pytest.raises(ValueError, match="float32 W_hid at 16 units a block only"):
        klstm.bwd_plan(256, 500, SMS, dtype, units=units, tiled=True)


@pytest.mark.parametrize("name", ["lstm_bwd_chain", "lstm_peep_bwd_chain"])
def test_backward_rows_count_large_b_launches(name):
    counter = getattr(klstm, name)
    assert isinstance(counter.launches_tiled, int)
    before = (counter.launches, counter.launches_bf16, counter.launches_tiled)
    try:
        klstm._count(counter, torch.zeros(1), True)
        assert (counter.launches, counter.launches_bf16, counter.launches_tiled) == (
            before[0] + 1, before[1], before[2] + 1)
    finally:
        counter.launches, counter.launches_bf16, counter.launches_tiled = before
