"""The large-B plans of both directions and the dispatch between the bodies.

``fwd_plan`` and ``bwd_plan`` (ip_avsr_torch/ops/kernels/lstm.py) are the
one place a recurrence's or a backward chain's body is chosen, and the
pure-Python half of csrc/lstm_fwd.cu's and csrc/lstm_bwd.cu's large-B body
(``tiled_chain``): unit groups by row groups of one cooperative launch,
shared memory and row chunks, in one ``LaunchPlan`` whose ``tiled`` names
the body.  The card only sees the shapes the smoke run gives it, so the
plans are held here to their invariants at H in {130, 250, 500, 1000}
(forward) and {130, 250, 500, 640, 641} (backward) and B from 17 to 600:
every block resident, shared memory within the limit, one launch a call at
the benchmark cells' shapes (the count the harness multiplies by), and
every (row, unit) of the batch owned by exactly one thread of one block, as
the kernels' index arithmetic (mirrored below) assigns them.  The large-B
body is taken for a float32 W_hid only: the recurrence's from B >=
``TILED_MIN_ROWS`` (``TILED_RESIDENT_MIN_ROWS`` at the resident widths,
twice ``TILED_MIN_ROWS`` below H = ``TILED_WIDE_H``), the backward chain's
from B >= ``BWD_TILED_MIN_ROWS`` at H from ``BWD_TILED_MIN_H`` to
``BWD_TILED_MAX_H``; the small-B body (``fwd_launch_plan``,
``bwd_launch_plan``) everywhere else.

The forward large-B body's own arithmetic is held here too, in both of its
forms: the resident one (W_hid in 128 registers a thread,
``tiled_resident``: H from 388 to 512 in steps of 4) and the staged one
(every other width), every product of a step summed once, in one fixed
order.  The backward body's is in test_torch_lstm_bwd_tiled_plan.py.
"""

import numpy as np
import pytest
import torch

from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
SMS = 132
THREADS = 256
DIRECTIONS = ("fwd", "bwd")
PLAN = {"fwd": klstm.fwd_plan, "bwd": klstm.bwd_plan}
SMALL = {"fwd": klstm.fwd_launch_plan, "bwd": klstm.bwd_launch_plan}
NAME = {"fwd": "large-B recurrence", "bwd": "large-B backward chain"}
SHAPES = ([("fwd", H, B) for H in (130, 250, 500, 1000) for B in (17, 64, 250, 256, 257, 512)]
          + [("bwd", H, B) for H in (130, 250, 500, 640, 641)
             for B in (17, 64, 256, 257, 512, 600)])


def _owners(plan, B, H):
    """How many gate-stage threads own each (row, unit) of the batch, by the
    kernels' arithmetic: chunk (b0, b1) of ``chunk_spans``, block (bx, by)
    for by below ``plan.row_groups`` (the backward chain's launch takes
    them; the recurrence's takes ceil(chunk rows / 64), no more, and a row
    group past a chunk's rows owns nothing), thread tid owns unit bx * 16 +
    tid % 16 and rows by * 64 + tid / 16 + 16 i (i < 4) of the chunk, where
    both are live (unit < H, row < the chunk's rows)."""
    count = np.zeros((B, H), dtype=np.int64)
    tid = np.arange(THREADS)
    gate_rows = klstm.TILED_ROWS * klstm.TILED_UNITS // THREADS
    for b0, b1 in klstm.chunk_spans(B, plan.chunks):
        assert plan.row_groups * klstm.TILED_ROWS >= b1 - b0
        for bx in range(plan.grid):
            for by in range(plan.row_groups):
                j = bx * klstm.TILED_UNITS + tid % klstm.TILED_UNITS
                for i in range(gate_rows):
                    r = by * klstm.TILED_ROWS + tid // klstm.TILED_UNITS + 16 * i
                    live = (j < H) & (r < b1 - b0)
                    np.add.at(count, (b0 + r[live], j[live]), 1)
    return count


def _smem(direction, H):
    """A large-B block's shared memory, from the kernels' layouts.  Forward,
    resident: the 8 warps' rows of h, which their partial sums overwrite, 64
    rows x 64 floats each, and 256 threads' 48 gate inputs and carries, the
    same at every width; staged: W_hid's 64 columns as whole chunks of 64 k,
    two staged chunks of 64 rows padded to 68 floats, four slices' partial
    sums of 64 x 64.  Backward: W_hid's 16 rows as 4H k rows of 16 floats,
    padded to chunks of 128, and two staged chunks of 64 rows of 132
    floats."""
    if direction == "bwd":
        return 4 * (-(-4 * H // 128) * 128 * 16 + 2 * 64 * 132)
    if klstm.tiled_resident(H):
        return 4 * (8 * 64 * 64 + 48 * 256)
    return 4 * (64 * -(-H // 64) * 64 + 2 * 64 * 68 + 4 * 64 * 64)


@pytest.mark.parametrize("direction,H,B", SHAPES, ids=[f"{d}-H{H}-B{B}" for d, H, B in SHAPES])
def test_tiled_plan(direction, H, B):
    smem = _smem(direction, H)
    if smem > _build.SMEM_LIMIT:
        # 16 units' W_hid share no longer fits beside the staged chunks
        # (forward H > 512, backward H > 640)
        with pytest.raises(ValueError, match=f"{NAME[direction]}: H={H}"):
            PLAN[direction](B, H, SMS, tiled=True)
        assert PLAN[direction](B, H, SMS) == SMALL[direction](B, H, SMS)
        return
    plan = PLAN[direction](B, H, SMS, tiled=True)
    assert plan.tiled
    assert plan.units == klstm.TILED_UNITS == 16
    assert plan.grid == -(-H // 16) and plan.last_units == H - 16 * (plan.grid - 1)
    assert 1 <= plan.last_units <= 16
    # the fewest row groups that hold a chunk, every block of a launch
    # co-resident, one a SM
    assert (plan.row_groups - 1) * klstm.TILED_ROWS < plan.rows <= (
        plan.row_groups * klstm.TILED_ROWS)
    assert plan.grid * plan.row_groups <= SMS
    assert plan.smem_bytes == smem <= _build.SMEM_LIMIT
    if direction == "fwd" and klstm.tiled_resident(H):
        assert smem == 180224
    if direction == "bwd":
        assert smem == klstm.bwd_tiled_smem_bytes(H)
    # the fewest near-equal chunks that the row groups allow
    cap = SMS // plan.grid * klstm.TILED_ROWS
    assert plan.chunks == -(-B // cap) and plan.rows == -(-B // plan.chunks) <= cap
    count = _owners(plan, B, H)
    assert count.min() == count.max() == 1


# the cells' shapes: (plan, B, H) -> body, grid, row groups, chunks, shared
# memory; the small-B plan the harness counts launches by beside them
CELLS = [
    ("fwd_plan", 256, 500, True, 32, 4, 1, 180224),
    ("bwd_plan", 256, 500, True, 32, 4, 1, 198656),
    ("fwd_plan", 512, 250, True, 16, 8, 1, 165888),
    ("bwd_plan", 512, 250, True, 16, 8, 1, 133120),
    ("fwd_launch_plan", 256, 500, False, 125, 1, 1, 49216),
]


@pytest.mark.parametrize("fn,B,H,tiled,grid,row_groups,chunks,smem", CELLS,
                         ids=[f"{c[0]}-B{c[1]}-H{c[2]}" for c in CELLS])
def test_tiled_plan_at_the_cells(fn, B, H, tiled, grid, row_groups, chunks, smem):
    plan = getattr(klstm, fn)(B, H, SMS)
    assert (plan.tiled, plan.grid, plan.row_groups, plan.chunks, plan.smem_bytes) == (
        tiled, grid, row_groups, chunks, smem)
    assert plan.grid * plan.row_groups <= SMS and smem <= _build.SMEM_LIMIT
    if tiled:
        assert plan.grid * plan.row_groups == 128


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_plans_of_the_two_bodies_differ(direction):
    """A plan names its body: a small-B plan with a large-B plan's geometry
    is not that plan, so a test's equality shows which body was chosen."""
    plan = PLAN[direction](256, 500, SMS)
    assert plan.tiled and plan != plan._replace(tiled=False)
    assert PLAN[direction](256, 500, SMS, tiled=False) == SMALL[direction](256, 500, SMS)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_crossover_is_the_swept_one(direction):
    if direction == "fwd":
        assert (klstm.TILED_RESIDENT_MIN_ROWS, klstm.TILED_MIN_ROWS,
                klstm.TILED_WIDE_H) == (96, 128, 250)
    else:
        assert (klstm.BWD_TILED_MIN_ROWS, klstm.BWD_TILED_MIN_H, klstm.BWD_TILED_MAX_H) == (
            128, 64, 500)


# (B, H, w_dtype) -> whether the dispatch takes the large-B body: each side
# of every crossover, never for a bf16 W_hid or a width that does not fit
DISPATCH = {
    "fwd": [
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
    ],
    "bwd": [
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
    ],
}
DISPATCH_CASES = [(d, args, tiled) for d in DIRECTIONS for args, tiled in DISPATCH[d]]


@pytest.mark.parametrize("direction,args,tiled", DISPATCH_CASES,
                         ids=[f"{d}-{a}" for d, a, _ in DISPATCH_CASES])
def test_plan_dispatch(direction, args, tiled):
    """The large-B body only where its crossover and its width allow, as
    forcing it makes it; else, and for every bf16 W_hid, the small-B plan
    exactly as ``fwd_launch_plan`` or ``bwd_launch_plan`` makes it."""
    B, H, w_dtype = args
    plan = PLAN[direction](B, H, SMS, w_dtype)
    assert plan.tiled == tiled
    if tiled:
        assert plan == PLAN[direction](B, H, SMS, tiled=True)
    else:
        assert plan == SMALL[direction](B, H, SMS, w_dtype=w_dtype)
        assert plan.row_groups == 1


@pytest.mark.parametrize("direction,small_chunks", [("fwd", 1), ("bwd", 2)])
def test_plan_forcing(direction, small_chunks):
    # units force the small-B body at any B; tiled forces either body
    plan = PLAN[direction]
    assert plan(256, 500, SMS, units=8) == SMALL[direction](256, 500, SMS, 8)
    assert plan(256, 500, SMS, tiled=False) == SMALL[direction](256, 500, SMS)
    assert plan(2100, 500, SMS, tiled=False).chunks == small_chunks
    forced = plan(16, 500, SMS, tiled=True)
    assert forced.tiled and (forced.rows, forced.chunks, forced.row_groups) == (16, 1, 1)
    two = plan(256, 500, SMS, chunks=2)
    assert two.tiled and (two.rows, two.chunks, two.row_groups) == (128, 2, 2)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("dtype,units", [(torch.bfloat16, None), (torch.float32, 4),
                                         (torch.bfloat16, 16)])
def test_plan_refuses_other_instantiations(direction, dtype, units):
    with pytest.raises(ValueError, match="float32 W_hid at 16 units a block only"):
        PLAN[direction](256, 500, SMS, dtype, units=units, tiled=True)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tiled_plan_forced_chunks(direction):
    plan = PLAN[direction](256, 500, SMS, chunks=3)
    assert plan.tiled and (plan.chunks, plan.rows, plan.row_groups) == (3, 86, 2)
    with pytest.raises(ValueError, match="runs in 2 to 512 chunks"):
        PLAN[direction](512, 500, SMS, chunks=1)
    with pytest.raises(ValueError, match="runs in 1 to 17 chunks"):
        PLAN[direction](17, 500, SMS, chunks=18, tiled=True)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_tiled_plan_needs_the_sms(direction):
    # 32 unit groups at H = 500 cannot be resident on 16 SMs
    with pytest.raises(ValueError, match=f"{NAME[direction]}: H=500 needs 32 blocks"):
        PLAN[direction](256, 500, 16, tiled=True)
    # so the dispatch leaves it to the small-B plan, which does not fit either
    small = "recurrence" if direction == "fwd" else "backward chain"
    with pytest.raises(ValueError, match=f"{small}: H=500 needs more than 8 hidden units"):
        PLAN[direction](256, 500, 16)


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("B,H", [(256, 500), (512, 250)])
def test_cells_run_one_launch_a_call(direction, B, H):
    """The harness counts a row's launches as ``fwd_launch_plan(B, H,
    sm).chunks`` or ``bwd_launch_plan``'s (avsr_bench/harness/drive._chunks):
    at the benchmark cells' shapes the large-B plan that runs there must
    launch exactly that often, once a call, so the launches counted per call
    match the launches a trace records."""
    assert PLAN[direction](B, H, SMS).chunks == SMALL[direction](B, H, SMS).chunks == 1


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("B,H,chunks,rows", [
    (600, 500, 3, 200),   # 256 rows a launch at H = 500
    (257, 500, 2, 129),
    (600, 250, 2, 300),   # 512 at H = 250
    (2100, 500, 9, 234),
])
def test_tiled_plan_chunks(direction, B, H, chunks, rows):
    """Rows above one launch's row groups run as near-equal row chunks, each
    a pointer offset, as the small-B plan's do."""
    plan = PLAN[direction](B, H, SMS)
    assert plan.tiled and (plan.chunks, plan.rows) == (chunks, rows)
    count = _owners(plan, B, H)
    assert count.min() == count.max() == 1


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
                                  "lstm_peep_recurrence", "lstm_peep_recurrence_train",
                                  "lstm_bwd_chain", "lstm_peep_bwd_chain"])
def test_rows_count_large_b_launches(name):
    counter = getattr(klstm, name)
    assert isinstance(counter.launches_tiled, int)
    before = (counter.launches, counter.launches_bf16, counter.launches_tiled)
    try:
        klstm._count(counter, torch.zeros(1), True)
        assert (counter.launches, counter.launches_bf16, counter.launches_tiled) == (
            before[0] + 1, before[1], before[2] + 1)
    finally:
        counter.launches, counter.launches_bf16, counter.launches_tiled = before


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
