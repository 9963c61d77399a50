"""The recurrence's large-B plan and the dispatch between its two bodies.

``fwd_tiled_plan`` (ip_avsr_torch/ops/kernels/lstm.py) is the pure-Python
half of csrc/lstm_fwd.cu's large-B body (``tiled_chain``): unit groups by
row groups of one cooperative launch, shared memory and row chunks.  The
card only sees the shapes the smoke run gives it, so the plan is held here to
its invariants at H in {130, 250, 500, 1000} and B in {17, 64, 250, 256,
257, 512}: every block resident, shared memory within the limit, every
(row, unit) of the batch owned by exactly one thread of one block, and
every product of a step summed once, in one fixed order, as the kernel's
index arithmetic (mirrored below) assigns them, in both forms of the body:
the resident one (W_hid in 128 registers a thread, ``tiled_resident``: H
from 388 to 512 in steps of 4) and the staged one (every other width).  ``fwd_plan`` is
the one place that picks the body: the large-B one for a float32 W_hid at B
>= ``TILED_MIN_ROWS`` (``TILED_RESIDENT_MIN_ROWS`` at the resident widths,
twice ``TILED_MIN_ROWS`` below H = ``TILED_WIDE_H``), the small-B one
(``fwd_launch_plan``, unchanged) everywhere else.
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
    if klstm.tiled_resident(H):
        # W_hid in registers: the 8 warps' rows of h, which their partial
        # sums overwrite, 64 rows x 64 floats each, and 256 threads' 48 gate
        # inputs and carries, the same at every width
        assert plan.smem_bytes == 4 * (8 * 64 * 64 + 48 * 256) == 180224
    else:
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


def test_tiled_resident_widths():
    """The resident body takes exactly the widths whose warp slices fill all
    four groups of 4 k of every quarter warp, 385 to 512, in whole float4
    pieces; every other width up to 512 keeps the staged body."""
    resident = [H for H in range(1, 600) if klstm.tiled_resident(H)]
    assert resident == list(range(388, 513, 4))
    assert all(48 < klstm.tiled_slice_k(H) <= 64 for H in resident)
    assert not klstm.tiled_resident(250) and klstm.tiled_resident(500)


def _product_terms(H, rows):
    """The products of a resident block's step, by the kernel's arithmetic:
    warp w holds k slice w KW .. + KW - 1 (KW = ``tiled_slice_k(H)``), lane l
    of it the groups of 4 k 4 i + l / 8 (i < 4) and the 8 gate columns
    8 (l % 8) .. + 7, for every row of the row group's chunks of 8 that hold
    a row below ``rows``; a product is live at slice k < KW and k < H.
    Returns count[row, column, k] over the live terms and, for each (row,
    column), the k in the order the sums take them: the gate stage adds the
    8 warps' partial sums in warp order, each of them ((q0 + q2) + (q1 +
    q3)) over the warp's quarters, each quarter's groups in order."""
    KW = klstm.tiled_slice_k(H)
    cols = 4 * klstm.TILED_UNITS
    count = np.zeros((klstm.TILED_ROWS, cols, H), dtype=np.int64)
    n_rc = min(klstm.TILED_ROWS // klstm.TILED_CHUNK_ROWS, -(-rows // klstm.TILED_CHUNK_ROWS))
    lane = np.arange(32)
    order = []
    for w in range(klstm.TILED_WARPS):
        quarters = []
        for q in range(4):
            ks = [w * KW + 4 * (4 * i + q) + d for i in range(4) for d in range(4)
                  if 4 * (4 * i + q) + d < KW and w * KW + 4 * (4 * i + q) + d < H]
            quarters.append(ks)
            lanes = lane[lane // 8 == q]
            for c in range(klstm.TILED_CHUNK_ROWS * n_rc):
                for cc in range(8):
                    for k in ks:
                        np.add.at(count, (c, 8 * (lanes % 8) + cc, k), 1)
        order.append(((quarters[0], quarters[2]), (quarters[1], quarters[3])))
    return count, order


def _staged_product_covers_every_sum_once(H):
    """The staged body's threads: (kq, tr, tc) = (warp / 2, lane / 8 + 4 (warp
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




@pytest.mark.parametrize("H", [130, 250, 498, 388, 400, 500, 512])
def test_tiled_product_covers_every_sum_once(H):
    """Every (row, gate column, k < H) product of a block's step is summed
    exactly once, in the form the width takes.  Resident: by one lane of one
    warp, the staging lanes copying each (row, k) of a warp's slice of a
    chunk once, in float4 pieces.  Staged: see
    :func:`_staged_product_covers_every_sum_once`."""
    if not klstm.tiled_resident(H):
        _staged_product_covers_every_sum_once(H)
        return
    count, _ = _product_terms(H, klstm.TILED_ROWS)
    assert count.min() == count.max() == 1
    pieces = klstm.TILED_SLICE_K // 4
    stage = np.zeros((klstm.TILED_CHUNK_ROWS, klstm.TILED_SLICE_K), dtype=np.int64)
    for m in range(klstm.TILED_CHUNK_ROWS * pieces // 32):
        q = np.arange(32) + 32 * m
        for d in range(4):
            np.add.at(stage, (q // pieces, q % pieces * 4 + d), 1)
    assert stage.min() == stage.max() == 1


@pytest.mark.parametrize("H,rows", [(500, 1), (500, 17), (400, 40), (512, 64)])
def test_tiled_product_skips_only_dead_chunks(H, rows):
    """A row group with fewer than 64 rows below B multiplies only the chunks
    of 8 that hold one, every live row's products once; each unit group
    starts at its own chunk and takes every one in turn."""
    count, _ = _product_terms(H, rows)
    assert (count[:rows] == 1).all()
    n_rc = -(-rows // klstm.TILED_CHUNK_ROWS)
    assert (count[n_rc * klstm.TILED_CHUNK_ROWS:] == 0).all()
    for bx in range(-(-H // 16)):
        order = [(bx % n_rc + ch) % n_rc for ch in range(n_rc)]
        assert sorted(order) == list(range(n_rc))


@pytest.mark.parametrize("H", [388, 500, 512])
def test_tiled_partials_meet_in_one_order(H):
    """The sum of every (row, column) takes its k < H in one fixed order,
    whatever the schedule or the chunk order: each quarter its own k in
    ascending order, the four quarters as (q0 + q2) + (q1 + q3) (the two
    shuffle levels; a + b = b + a, so every lane that holds the column sums
    alike), the 8 warps' partials in warp order by the gate stage.  Two
    calls give the same bits."""
    _, order = _product_terms(H, klstm.TILED_ROWS)
    assert len(order) == klstm.TILED_WARPS
    flat = [k for warp in order for pair in warp for quarter in pair for k in quarter]
    assert sorted(flat) == list(range(H))
    for warp in order:
        for pair in warp:
            for quarter in pair:
                assert quarter == sorted(quarter)


def test_tiled_w_register_share():
    """A resident thread holds W_hid's 4 groups x 4 k x 8 columns, 128
    registers, at every resident width: the quarters' groups cover the warp's
    slice of up to 64 k, and the 8 slices cover H."""
    for H in range(1, klstm.TILED_MAX_H + 1):
        if not klstm.tiled_resident(H):
            continue
        KW = klstm.tiled_slice_k(H)
        assert KW % 4 == 0 and klstm.TILED_WARPS * KW >= H > klstm.TILED_WARPS * (KW - 4)
        assert 4 * 4 * 4 * 4 >= KW  # 4 quarters x 4 groups x 4 k
        assert 4 * 4 * 8 == 128
    assert klstm.tiled_slice_k(500) == 64


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
    # at the resident widths from B = 96
    ((95, 500, torch.float32), False),
    ((96, 500, torch.float32), True),
    ((127, 500, torch.float32), True),
    ((127, 498, torch.float32), False),
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
    """The large-B body only for a float32 W_hid at B >= TILED_MIN_ROWS
    (TILED_RESIDENT_MIN_ROWS at the resident widths, twice TILED_MIN_ROWS
    below H = TILED_WIDE_H) and a width whose plan fits; below, and for every
    bf16 W_hid, the small-B plan exactly as ``fwd_launch_plan`` makes it."""
    B, H, w_dtype = args
    assert (klstm.TILED_RESIDENT_MIN_ROWS, klstm.TILED_MIN_ROWS,
            klstm.TILED_WIDE_H) == (96, 128, 250)
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
