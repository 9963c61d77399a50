"""Row chunks of the persistent LSTM kernels' launches.

The persistent kernels (csrc/lstm_fwd.cu, csrc/lstm_bwd.cu) keep every row's
carries in one block's shared memory beside W_hid, so a batch above a cap
runs as several launches over row chunks.  Held here on the CPU:

* the plans (``fwd_launch_plan``, ``bwd_launch_plan``): a batch of any size
  is accepted, cut into the fewest near-equal chunks whose shared memory
  fits, tiling [0, B) in order (the caps at H = 500 and 250 on 132 SMs are
  those the plans raised above before they cut chunks);
* the split itself (``map_chunks``), driven with the plain versions in
  place of the launches: each chunk's views of the batch-major inputs and
  outputs go to one call, and the pieces reassemble to the unsplit result,
  rows bit-equal (rows are independent), the peephole gradients (summed over
  rows, chunk sums added in chunk order) within 1e-6 of their max abs.
  H = 32 keeps every row on whole SIMD vectors of the CPU's elementwise
  kernels, whose vector and scalar-tail paths of sigmoid and tanh may differ
  in the last bit: at a ragged H a row's rounding would depend on where its
  chunk starts, not on the split.
"""

import numpy as np
import pytest
import torch

from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)

# (plan, H) -> the most rows one launch holds on 132 SMs
CAPS = {("fwd", 500): 5982, ("fwd", 250): 13714, ("bwd", 500): 2077, ("bwd", 250): 4654}
PLANS = {"fwd": klstm.fwd_launch_plan, "bwd": klstm.bwd_launch_plan}


@pytest.mark.parametrize("B", [1, 10, "cap", "cap+1", 4096, 100000])
@pytest.mark.parametrize("H", [500, 250])
@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_chunked_plan_accepts_any_batch(kind, H, B):
    cap = CAPS[kind, H]
    B = {"cap": cap, "cap+1": cap + 1}.get(B, B)
    plan = PLANS[kind](B, H, 132)
    one_row = PLANS[kind](1, H, 132).smem_bytes
    per_row = PLANS[kind](2, H, 132).smem_bytes - one_row
    assert plan.chunks == -(-B // cap)
    assert plan.rows == -(-B // plan.chunks) <= cap
    assert plan.smem_bytes == one_row + per_row * (plan.rows - 1) <= _build.SMEM_LIMIT
    # one row more than the cap would not fit: the cap is the most a launch holds
    assert one_row + per_row * (cap - 1) <= _build.SMEM_LIMIT < one_row + per_row * cap
    spans = klstm.chunk_spans(B, plan.chunks)
    assert len(spans) == plan.chunks
    assert spans[0][0] == 0 and spans[-1][1] == B
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # in order, no gap
    sizes = [b1 - b0 for b0, b1 in spans]
    assert min(sizes) >= 1 and max(sizes) == plan.rows and max(sizes) - min(sizes) <= 1
    assert all(one_row + per_row * (n - 1) <= _build.SMEM_LIMIT for n in sizes)


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_plan_accepts_4096_rows_at_h500(kind):
    """The batch the reference's block_b tiling runs and the single-launch
    plans refused (the backward chain's cap at H = 500 is 2077 rows)."""
    plan = PLANS[kind](4096, 500, 132)
    assert plan.units == 4 and plan.grid == 125
    assert plan.chunks == (1 if kind == "fwd" else 2)
    assert plan.smem_bytes <= _build.SMEM_LIMIT


@pytest.mark.parametrize("chunks,ok", [(3, True), (64, True), (0, False), (65, False)])
def test_forced_chunks(chunks, ok):
    """The measurement override: any count from the fewest that fit up to
    one row a chunk."""
    if not ok:
        with pytest.raises(ValueError, match="chunks"):
            klstm.fwd_launch_plan(64, 250, 132, chunks=chunks)
        return
    plan = klstm.fwd_launch_plan(64, 250, 132, chunks=chunks)
    assert plan.chunks == chunks and plan.rows == -(-64 // chunks)
    assert plan.smem_bytes == klstm.fwd_launch_plan(plan.rows, 250, 132).smem_bytes


def test_forced_chunks_below_the_fewest_that_fit():
    with pytest.raises(ValueError, match="2 to 2078 chunks"):
        klstm.bwd_launch_plan(2078, 500, 132, chunks=1)


def test_plan_raises_where_w_hid_leaves_no_room():
    """Two limits stay: W_hid rows that fill a block's shared memory by
    themselves (H = 1700 at 8 units, on a card with SMs for its grid), and a
    grid that no instantiation fits (H = 1057 on 132 SMs); H = 1056 takes
    any batch."""
    with pytest.raises(ValueError, match="for one row"):
        klstm.fwd_launch_plan(1, 1700, 1000, units=8)
    with pytest.raises(ValueError, match="H=1057"):
        klstm.fwd_launch_plan(1, 1057, 132)
    assert klstm.fwd_launch_plan(10000, 1056, 132).chunks > 1


B, T, H = 19, 7, 32


def _inputs(seed, peep):
    """Recurrence inputs at B = 19 with nonzero initial states and lengths
    T, 0 and 1 among the rows; with ``peep`` the three (H,) vectors."""
    rng = np.random.RandomState(seed)
    x_proj = rng.randn(B, T, 4 * H).astype(np.float32)
    w_hid = rng.randn(H, 4 * H).astype(np.float32) * 0.5
    cell0 = rng.randn(B, H).astype(np.float32)
    hid0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[4], lens[7] = T, 0, 1
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    vecs = [rng.randn(H).astype(np.float32) * 0.5 for _ in range(3 * peep)]
    return [torch.from_numpy(a) for a in (x_proj, w_hid, mask, cell0, hid0)], \
        [torch.from_numpy(v) for v in vecs]


FWD_ROWS = {
    "row1": (klstm.lstm_recurrence_plain, False, False),
    "row3": (klstm.lstm_recurrence_train_plain, True, False),
    "row5": (klstm.lstm_peep_recurrence_plain, False, True),
    "row6": (klstm.lstm_peep_recurrence_train_plain, True, True),
}


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("row", list(FWD_ROWS))
def test_recurrence_chunks_reassemble(row, chunks):
    """The split drives rows 1, 3, 5 and 6's plain versions chunk by chunk,
    each writing into its views of the outputs as the kernel does."""
    plain, train, peep = FWD_ROWS[row]
    (x_proj, w_hid, mask, cell0, hid0), vecs = _inputs(5, peep)
    whole = plain(x_proj, w_hid, mask, cell0, hid0, *vecs)
    whole = whole if train else (whole,)
    outs = [torch.full_like(w, float("nan")) for w in whole]

    def launch(x_c, mask_c, cell0_c, hid0_c, *outs_c):
        got = plain(x_c, w_hid, mask_c, cell0_c, hid0_c, *vecs)
        for o, g in zip(outs_c, got if train else (got,)):
            o.copy_(g)

    klstm.map_chunks(launch, chunks, x_proj, mask, cell0, hid0, *outs)
    for o, w in zip(outs, whole):
        assert torch.equal(o, w)


@pytest.mark.parametrize("chunks", [2, 3])
@pytest.mark.parametrize("peep", [False, True], ids=["row4", "row7"])
def test_bwd_chain_chunks_reassemble(peep, chunks):
    (x_proj, w_hid, mask, cell0, hid0), vecs = _inputs(6, peep)
    fwd = klstm.lstm_peep_recurrence_train_plain if peep else klstm.lstm_recurrence_train_plain
    _, cells, gates = fwd(x_proj, w_hid, mask, cell0, hid0, *vecs)
    cells_prev = torch.cat([cell0[:, None], cells[:, :-1]], dim=1)
    g = torch.from_numpy(np.random.RandomState(7).randn(B, T, H).astype(np.float32))
    chain = klstm.lstm_peep_bwd_chain_plain if peep else klstm.lstm_bwd_chain_plain
    whole = chain(g, gates, cells, cells_prev, mask, w_hid, *vecs, 5.0)
    outs = [torch.full_like(w, float("nan")) for w in whole[:3]]

    def launch(g_c, gates_c, cells_c, prev_c, mask_c, *outs_c):
        got = chain(g_c, gates_c, cells_c, prev_c, mask_c, w_hid, *vecs, 5.0)
        for o, r in zip(outs_c, got[:3]):
            o.copy_(r)
        return torch.stack(got[3:]) if peep else None

    parts = klstm.map_chunks(launch, chunks, g, gates, cells, cells_prev, mask, *outs)
    for o, w in zip(outs, whole[:3]):
        assert torch.equal(o, w)
    assert len(parts) == chunks
    if peep:
        dw = parts[0]
        for part in parts[1:]:
            dw = dw + part
        for got, ref in zip(dw, whole[3:]):
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                       atol=1e-6 * ref.abs().max().item())
