"""The recurrence's large-B plan and the dispatch between its two bodies.

``fwd_tiled_plan`` (ip_avsr_torch/ops/kernels/lstm.py) is the pure-Python
half of csrc/lstm_fwd.cu's large-B body (``tiled_chain``): unit groups by
row groups of one cooperative launch, shared memory and row chunks.  The
card only sees the shapes the smoke run gives it, so the plan is held here to
its invariants at H in {130, 250, 500, 1000} and B in {17, 64, 250, 256,
257, 512}: every block resident, shared memory within the limit, and every
(row, unit) of the batch owned by exactly one thread of one block, as the
kernel's index arithmetic (mirrored below) assigns them.  ``fwd_plan`` is
the one place that picks the body: the large-B one for a float32 W_hid at B
>= ``TILED_MIN_ROWS`` (twice that below H = ``TILED_WIDE_H``), the small-B
one (``fwd_launch_plan``, unchanged) everywhere else.
"""

import numpy as np
import pytest
import torch

from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
SMS = 132
THREADS = 256
SHAPES = [(H, B) for H in (130, 250, 500, 1000) for B in (17, 64, 250, 256, 257, 512)]


def _owners(plan, B, H):
    """How many gate-stage threads own each (row, unit) of the batch, by the
    kernel's arithmetic: chunk (b0, b1) of ``chunk_spans``, block (bx, by),
    thread tid owns unit bx * 16 + tid % 16 and rows by * 64 + tid / 16 +
    16 i (i < 4) of the chunk, where both are live (unit < H, row < the
    chunk's rows)."""
    count = np.zeros((B, H), dtype=np.int64)
    tid = np.arange(THREADS)
    gate_rows = klstm.TILED_ROWS * klstm.TILED_UNITS // THREADS
    for b0, b1 in klstm.chunk_spans(B, plan.chunks):
        for bx in range(plan.grid):
            # the launch's row groups: grid.y = ceil(chunk rows / 64)
            for by in range(-(-(b1 - b0) // klstm.TILED_ROWS)):
                j = bx * klstm.TILED_UNITS + tid % klstm.TILED_UNITS
                for i in range(gate_rows):
                    r = by * klstm.TILED_ROWS + tid // klstm.TILED_UNITS + 16 * i
                    live = (j < H) & (r < b1 - b0)
                    np.add.at(count, (b0 + r[live], j[live]), 1)
    return count


@pytest.mark.parametrize("H,B", SHAPES, ids=[f"H{H}-B{B}" for H, B in SHAPES])
def test_fwd_tiled_plan(H, B):
    if H > 512:
        # 16 units' W_hid share no longer fits beside the staged chunks
        with pytest.raises(ValueError, match=f"large-B recurrence: H={H}"):
            klstm.fwd_tiled_plan(B, H, SMS)
        assert klstm.fwd_plan(B, H, SMS) == klstm.fwd_launch_plan(B, H, SMS)
        return
    plan = klstm.fwd_tiled_plan(B, H, SMS)
    assert plan.units == klstm.TILED_UNITS == 16
    assert plan.grid == -(-H // 16) and plan.last_units == H - 16 * (plan.grid - 1)
    assert 1 <= plan.last_units <= 16
    # every block of a launch co-resident, one a SM
    assert plan.grid * -(-plan.rows // klstm.TILED_ROWS) <= SMS
    # W_hid's 64 columns as whole chunks of 64 k, two staged chunks of 64
    # rows padded to 68 floats, four slices' partial sums of 64 x 64
    k_rows = -(-H // 64) * 64
    assert plan.smem_bytes == 4 * (64 * k_rows + 2 * 64 * 68 + 4 * 64 * 64)
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    # the fewest near-equal chunks that the row groups allow
    cap = SMS // plan.grid * klstm.TILED_ROWS
    assert plan.chunks == -(-B // cap) and plan.rows == -(-B // plan.chunks) <= cap
    count = _owners(plan, B, H)
    assert count.min() == count.max() == 1


@pytest.mark.parametrize("H", [130, 250, 500])
def test_tiled_product_covers_every_sum_once(H):
    """The product's threads: (kq, tr, tc) = (warp / 2, lane / 8 + 4 (warp
    % 2), lane % 8) sums rows tr + 8 i (i < 8) by columns 4 tc .. + 3 and 32
    + 4 tc .. + 3 (units tc and tc + 8) over slice kq of a chunk; together
    they cover each (row, column, slice) of a block once, and the staging
    threads each (row, k) of a chunk once."""
    tid = np.arange(THREADS)
    warp, lane = tid // 32, tid % 32
    kq, tr, tc = warp // 2, lane // 8 + 4 * (warp % 2), lane % 8
    cols = 4 * klstm.TILED_UNITS
    count = np.zeros((klstm.TILED_SPLIT, klstm.TILED_ROWS, cols), dtype=np.int64)
    for i in range(8):
        for c in range(4):
            for base in (0, cols // 2):
                np.add.at(count, (kq, tr + 8 * i, base + 4 * tc + c), 1)
    assert count.min() == count.max() == 1
    stage = np.zeros((klstm.TILED_ROWS, klstm.TILED_K), dtype=np.int64)
    per_thread = klstm.TILED_ROWS * klstm.TILED_K // THREADS
    for l in range(per_thread):
        np.add.at(stage, (tid // klstm.TILED_K + THREADS // klstm.TILED_K * l,
                          tid % klstm.TILED_K), 1)
    assert stage.min() == stage.max() == 1
    # the chunks, each unit group starting at its own, cover k once
    n_chunks = -(-H // klstm.TILED_K)
    for bx in range(-(-H // 16)):
        order = [(bx % n_chunks + ch) % n_chunks for ch in range(n_chunks)]
        assert sorted(order) == list(range(n_chunks))


def test_fwd_tiled_plan_forced_chunks():
    plan = klstm.fwd_tiled_plan(256, 500, SMS, chunks=3)
    assert (plan.chunks, plan.rows) == (3, 86)
    with pytest.raises(ValueError, match="runs in 2 to 512 chunks"):
        klstm.fwd_tiled_plan(512, 500, SMS, chunks=1)
    with pytest.raises(ValueError, match="runs in 1 to 17 chunks"):
        klstm.fwd_tiled_plan(17, 500, SMS, chunks=18)


def test_fwd_tiled_plan_needs_the_sms():
    # 32 unit groups at H = 500 cannot be resident on 16 SMs
    with pytest.raises(ValueError, match="H=500 needs 32 blocks"):
        klstm.fwd_tiled_plan(256, 500, 16)
    # so the dispatch leaves it to the small-B plan, which does not fit either
    with pytest.raises(ValueError, match="recurrence: H=500 needs more than 8 hidden units"):
        klstm.fwd_plan(256, 500, 16)


# (B, H, w_dtype) -> the body fwd_plan picks
DISPATCH = [
    ((1, 500, torch.float32), False),
    ((10, 500, torch.float32), False),
    ((64, 500, torch.float32), False),
    ((127, 500, torch.float32), False),
    ((128, 500, torch.float32), True),
    ((256, 500, torch.float32), True),
    ((512, 250, torch.float32), True),
    ((6000, 500, torch.float32), True),
    ((256, 500, torch.bfloat16), False),
    ((512, 250, torch.bfloat16), False),
    ((256, 1000, torch.float32), False),
    # below H = 250 from B = 256 only
    ((128, 250, torch.float32), True),
    ((255, 249, torch.float32), False),
    ((256, 249, torch.float32), True),
    ((128, 130, torch.float32), False),
    ((256, 130, torch.float32), True),
    ((255, 16, torch.float32), False),
    ((512, 16, torch.float32), True),
]


@pytest.mark.parametrize("args,tiled", DISPATCH, ids=[str(a) for a, _ in DISPATCH])
def test_fwd_plan_dispatch(args, tiled):
    """The large-B body only for a float32 W_hid at B >= TILED_MIN_ROWS (twice
    that below H = TILED_WIDE_H) and a width whose plan fits; below, and for
    every bf16 W_hid, the small-B plan exactly as ``fwd_launch_plan`` makes
    it."""
    B, H, w_dtype = args
    assert (klstm.TILED_MIN_ROWS, klstm.TILED_WIDE_H) == (128, 250)
    plan = klstm.fwd_plan(B, H, SMS, w_dtype)
    assert isinstance(plan, klstm.TiledPlan) == tiled
    if tiled:
        assert plan == klstm.fwd_tiled_plan(B, H, SMS)
    else:
        assert plan == klstm.fwd_launch_plan(B, H, SMS, w_dtype=w_dtype)


def test_fwd_plan_forcing():
    # units force the small-B body at any B; tiled forces either body
    assert klstm.fwd_plan(256, 500, SMS, units=8) == klstm.fwd_launch_plan(256, 500, SMS, 8)
    assert klstm.fwd_plan(256, 500, SMS, tiled=False) == klstm.fwd_launch_plan(256, 500, SMS)
    assert klstm.fwd_plan(16, 500, SMS, tiled=True) == klstm.fwd_tiled_plan(16, 500, SMS)
    assert klstm.fwd_plan(256, 500, SMS, chunks=2) == klstm.fwd_tiled_plan(256, 500, SMS, 2)
    with pytest.raises(ValueError, match="float32 W_hid at 16 units a block only"):
        klstm.fwd_plan(256, 500, SMS, torch.bfloat16, tiled=True)
    with pytest.raises(ValueError, match="float32 W_hid at 16 units a block only"):
        klstm.fwd_plan(256, 500, SMS, units=4, tiled=True)


@pytest.mark.parametrize("B,H", [(256, 500), (512, 250)])
def test_cells_run_one_launch_a_call(B, H):
    """At the benchmark cells' shapes both plans run one launch a call, so
    the launches counted per call match the launches a trace records."""
    assert klstm.fwd_plan(B, H, SMS).chunks == 1
    assert klstm.fwd_launch_plan(B, H, SMS).chunks == 1


class _Counter:
    launches = launches_bf16 = launches_tiled = 0


@pytest.mark.parametrize("dtype,tiled,expected", [
    (torch.float32, False, (1, 0, 0)),
    (torch.float32, True, (1, 0, 1)),
    (torch.bfloat16, False, (0, 1, 0)),
])
def test_count(dtype, tiled, expected):
    counter = _Counter()
    klstm._count(counter, torch.zeros(1, dtype=dtype), tiled)
    assert (counter.launches, counter.launches_bf16, counter.launches_tiled) == expected


@pytest.mark.parametrize("name", ["lstm_recurrence", "lstm_recurrence_train",
                                  "lstm_peep_recurrence", "lstm_peep_recurrence_train"])
def test_forward_rows_count_large_b_launches(name):
    assert isinstance(getattr(klstm, name).launches_tiled, int)
