"""The backward chain's launch plan and its oracle at a batch of several row
tiles.

``bwd_launch_plan`` (ip_avsr_torch/ops/kernels/lstm.py) is the pure-Python
half of csrc/lstm_bwd.cu's one cooperative launch: units per block, grid,
shared memory and the last block's live units; it is held to its invariants
here, since the card only sees the shapes the smoke run gives it.

The plain chains (what the kernel is held to on the card) are held to the
TPU kernels ``lstm_pallas_bwd_chain`` and ``lstm_pallas_peep_bwd_chain`` in
interpret mode at B = 19, which ``block_b = 8`` cuts into three row tiles
(the last one ragged), with a fully padded row; H = 6 without peepholes and
H = 5 with them (not multiples of the 2 or 4 units a block owns on the
card).  Tolerance: 1e-5 relative to each output's max abs with a 1e-8
absolute floor (T steps of 4H-term dot products summed in another order;
the floor keeps a near-zero output from asking for more than float32 gives).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops.pallas import lstm_kernel
from ip_avsr_torch.ops.kernels import _build
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
B_TILES = 19


# (B, H, sm_count, units) -> (units, grid, last block's live units), or None
# where no instantiation fits: 4 SMs cannot hold H >= 130 at 8 units a block
PLANS = [
    ((10, 5, 4, None), (2, 3, 1)),
    ((10, 6, 4, None), (2, 3, 2)),
    ((10, 130, 4, None), None),
    ((10, 250, 4, None), None),
    ((10, 500, 4, None), None),
    ((10, 1000, 4, None), None),
    ((10, 5, 132, None), (1, 5, 1)),
    ((10, 6, 132, None), (1, 6, 1)),
    ((10, 130, 132, None), (1, 130, 1)),
    ((10, 250, 132, None), (2, 125, 2)),
    ((10, 500, 132, None), (4, 125, 4)),
    ((10, 1000, 132, None), (8, 125, 8)),
    ((64, 130, 132, 4), (4, 33, 2)),
    ((1, 250, 132, 4), (4, 63, 2)),
    ((10, 500, 132, 1), None),   # 500 blocks on 132 SMs
    ((10, 500, 132, 3), None),   # no such instantiation
]


@pytest.mark.parametrize("args,expected", PLANS, ids=[str(a) for a, _ in PLANS])
def test_bwd_launch_plan(args, expected):
    B, H, sm_count, units = args
    if expected is None:
        with pytest.raises(ValueError, match=f"H={H}"):
            klstm.bwd_launch_plan(B, H, sm_count, units)
        return
    plan = klstm.bwd_launch_plan(B, H, sm_count, units)
    assert (plan.units, plan.grid, plan.last_units) == expected
    assert plan.grid <= sm_count and plan.units * plan.grid >= H
    assert plan.units * (plan.grid - 1) < H  # no block without a live unit
    assert 1 <= plan.last_units <= plan.units
    assert plan.units * (plan.grid - 1) + plan.last_units == H
    # W_hid's rows (U x 4H f32), six carries per (row, unit), the reduction
    assert plan.smem_bytes == plan.units * 16 * H + 24 * B * plan.units + 1024
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    if units is None and plan.units > 1:  # the smallest instantiation that fits
        assert -(-H // (plan.units // 2)) > sm_count


@pytest.mark.parametrize("B,fits", [(538, True), (539, False), (4096, False)])
def test_bwd_launch_plan_shared_memory_limit(B, fits):
    """H = 1000 on 132 SMs takes 8 units (128,000 bytes of W_hid); the
    carries of 538 rows still fit beside them, those of 539 do not, so a
    larger batch runs in the fewest near-equal chunks of at most 538 rows."""
    plan = klstm.bwd_launch_plan(B, 1000, 132)
    assert plan.units == 8 and plan.smem_bytes <= _build.SMEM_LIMIT
    if fits:
        assert (plan.rows, plan.chunks) == (B, 1)
        return
    assert plan.chunks == -(-B // 538) and plan.rows == -(-B // plan.chunks) <= 538
    assert plan.smem_bytes == 128000 + 192 * plan.rows + 1024


def _chain_case(seed, H, peep, backwards, scale):
    """Chain inputs at B = 19, T = 7: residuals from the plain training
    recurrence, ragged lengths with a fully padded row (index 4)."""
    rng = np.random.RandomState(seed)
    B, T, D = B_TILES, 7, 5
    w_in = rng.randn(D, 4 * H).astype(np.float32) * 0.5
    w_hid = rng.randn(H, 4 * H).astype(np.float32) * 0.5
    b = rng.randn(4 * H).astype(np.float32) * 0.1
    vecs = [rng.randn(H).astype(np.float32) * 0.5 for _ in range(3)] if peep else []
    cell0 = np.broadcast_to(rng.randn(1, H).astype(np.float32), (B, H)).copy()
    hid0 = np.broadcast_to(rng.randn(1, H).astype(np.float32) * 0.5, (B, H)).copy()
    x = rng.randn(B, T, D).astype(np.float32)
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[4] = T, 0
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    if backwards:
        x, mask = x[:, ::-1], mask[:, ::-1]
    mask = np.ascontiguousarray(mask)
    x_proj = (x.reshape(B * T, D) @ w_in).reshape(B, T, 4 * H) + b
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    fwd = klstm.lstm_peep_recurrence_train_plain if peep else klstm.lstm_recurrence_train_plain
    _, cells, gates = fwd(t(x_proj), t(w_hid), t(mask), t(cell0), t(hid0), *map(t, vecs))
    cells = cells.numpy()
    cells_prev = np.concatenate([cell0[:, None], cells[:, :-1]], axis=1)
    g = rng.randn(B, T, H).astype(np.float32) * scale
    return (g, gates.numpy(), cells, cells_prev, mask, w_hid), vecs


def _tm(a):
    """(B, T, .) <-> (T, B, .)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _close_rel(got, ref, name):
    ref = np.asarray(ref)
    atol = max(1e-5 * np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=0, err_msg=name)


# scale 100 makes the +-5 clip bite; clip 0 means no clip
@pytest.mark.parametrize("backwards", [False, True])
@pytest.mark.parametrize("clip,scale", [(5.0, 1.0), (5.0, 100.0), (0.0, 100.0)])
@pytest.mark.parametrize("peep", [False, True], ids=["plain", "peephole"])
def test_bwd_chain_plain_matches_pallas_interpret_at_19_rows(peep, clip, scale, backwards):
    H = 5 if peep else 6
    chain, vecs = _chain_case(11 + peep, H, peep, backwards, scale)
    g, gates, cells, cells_prev, mask, w_hid = chain
    tm_args = [jnp.asarray(a) for a in (_tm(g), _tm(gates), _tm(cells), _tm(cells_prev),
                                        _tm(mask[..., None]), w_hid, *vecs)]
    chain_t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (*chain, *vecs)]
    if peep:
        ref = lstm_kernel.lstm_pallas_peep_bwd_chain(*tm_args, clip, block_b=8,
                                                     interpret=True)
        got = klstm.lstm_peep_bwd_chain_plain(*chain_t, clip)
        names = ("dgates", "dcell0", "dhid0", "dw_ci", "dw_cf", "dw_co")
    else:
        ref = lstm_kernel.lstm_pallas_bwd_chain(*tm_args, clip, block_b=8, interpret=True)
        got = klstm.lstm_bwd_chain_plain(*chain_t, clip)
        names = ("dgates", "dcell0", "dhid0")
    assert len(got) == len(ref) == len(names)
    for name, r, o in zip(names, (_tm(ref[0]), *ref[1:]), got):
        _close_rel(o.numpy(), r, name)
    dgates = got[0].numpy()
    if clip:
        assert np.abs(dgates).max() <= clip
        if scale > 1:
            assert (np.abs(dgates) == clip).mean() > 0.01  # the clip bites
    else:
        assert np.abs(dgates).max() > 5.0
    # the fully padded row: no gate gradient, and every step passes the
    # carries through, so dcell0 stays 0 and dhid0 sums the upstream g
    assert not dgates[4].any() and not got[1][4].any()
    np.testing.assert_allclose(got[2][4].numpy(), g[4].sum(0), atol=1e-5 * scale, rtol=1e-5)
