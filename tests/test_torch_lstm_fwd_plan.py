"""The recurrence's launch plan and its oracle at a batch of several row
tiles.

``fwd_launch_plan`` (ip_avsr_torch/ops/kernels/lstm.py) is the pure-Python
half of csrc/lstm_fwd.cu's one cooperative launch of the non-peephole
recurrence: units per block, grid, shared memory and the last block's live
units; it is held to its invariants here, since the card only sees the
shapes the smoke run gives it.

The plain recurrences (what the kernel is held to on the card) are held to
the TPU kernels ``lstm_pallas`` and ``lstm_pallas_train`` in interpret mode
at B = 19, which ``block_b = 8`` cuts into three row tiles (the last one
ragged), with nonzero initial states, lengths 0, 1 and T among the rows,
both directions, and H = 6 (not a multiple of the 4 units a block owns on
the card).  Tolerance: 1e-5 relative to each output's max abs with a 1e-8
absolute floor (T steps of H-term dot products summed in another order; the
floor keeps a near-zero output from asking for more than float32 gives).
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
    ((8, 500, 132, None), (4, 125, 4)),
    ((10, 1000, 132, None), (8, 125, 8)),
    ((64, 130, 132, 4), (4, 33, 2)),
    ((1, 250, 132, 4), (4, 63, 2)),
    ((8, 500, 132, 8), (8, 63, 4)),
    ((10, 500, 132, 1), None),   # 500 blocks on 132 SMs
    ((10, 500, 132, 3), None),   # no such instantiation
]


@pytest.mark.parametrize("args,expected", PLANS, ids=[str(a) for a, _ in PLANS])
def test_fwd_launch_plan(args, expected):
    B, H, sm_count, units = args
    if expected is None:
        with pytest.raises(ValueError, match=f"recurrence: .*H={H}"):
            klstm.fwd_launch_plan(B, H, sm_count, units)
        return
    plan = klstm.fwd_launch_plan(B, H, sm_count, units)
    assert (plan.units, plan.grid, plan.last_units) == expected
    assert plan.grid <= sm_count and plan.units * plan.grid >= H
    assert plan.units * (plan.grid - 1) < H  # no block without a live unit
    assert 1 <= plan.last_units <= plan.units
    assert plan.units * (plan.grid - 1) + plan.last_units == H
    # W_hid's 4U columns as k rows padded to 4U + 4 floats (4 at U = 1), cell
    # and h carries per (row, unit), the warps' partial sums
    row = 4 if plan.units == 1 else 4 * plan.units + 4
    assert klstm.fwd_row_floats(plan.units) == row
    assert plan.smem_bytes == 4 * row * H + 8 * B * plan.units + 1024
    assert plan.smem_bytes <= _build.SMEM_LIMIT
    if units is None and plan.units > 1:  # the smallest instantiation that fits
        assert -(-H // (plan.units // 2)) > sm_count
    # the backward chain plans the same grid, with its own carries
    if units in (None, plan.units):
        bwd = klstm.bwd_launch_plan(B, H, sm_count, units)
        assert (bwd.units, bwd.grid, bwd.last_units) == (plan.units, plan.grid,
                                                        plan.last_units)


@pytest.mark.parametrize("B,fits", [(1366, True), (1367, False), (100000, False)])
def test_fwd_launch_plan_shared_memory_limit(B, fits):
    """H = 1000 on 132 SMs takes 8 units (144,000 bytes of W_hid rows of 36
    floats); the carries of 1366 rows fill the block's shared memory to the
    byte, so 1366 rows run in one launch and a larger batch in the fewest
    near-equal chunks of at most 1366 rows."""
    plan = klstm.fwd_launch_plan(B, 1000, 132)
    assert plan.units == 8 and plan.smem_bytes <= _build.SMEM_LIMIT
    if fits:
        assert (plan.rows, plan.chunks) == (B, 1)
        assert plan.smem_bytes == _build.SMEM_LIMIT
        return
    assert plan.chunks == -(-B // 1366) and plan.rows == -(-B // plan.chunks) <= 1366
    assert plan.smem_bytes == 144000 + 64 * plan.rows + 1024


def _case(seed, T, backwards, H=6):
    """Recurrence inputs at B = 19: nonzero per-row initial states, lengths
    with T (row 0), 0 (row 4) and 1 (row 7), flipped in time for a backwards
    layer as ops/lstm.py flips them."""
    rng = np.random.RandomState(seed)
    B = B_TILES
    x_proj = rng.randn(B, T, 4 * H).astype(np.float32)
    w_hid = rng.randn(H, 4 * H).astype(np.float32) * 0.5
    cell0 = rng.randn(B, H).astype(np.float32)
    hid0 = (rng.randn(B, H) * 0.5).astype(np.float32)
    lens = rng.randint(1, T + 1, B)
    lens[0], lens[4], lens[7] = T, 0, 1
    mask = (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)
    if backwards:
        x_proj, mask = x_proj[:, ::-1], mask[:, ::-1]
    # a copy: at T = 1 a flipped array counts as contiguous with a negative stride
    return [a.copy() for a in (x_proj, w_hid, mask, cell0, hid0)]


def _tm(a):
    """(B, T, .) <-> (T, B, .)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _close_rel(got, ref, name):
    ref = np.asarray(ref)
    atol = max(1e-5 * np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("T", [7, 1])
@pytest.mark.parametrize("backwards", [False, True])
def test_recurrence_plain_matches_pallas_interpret_at_19_rows(T, backwards):
    """Row 1: lstm_recurrence_plain against lstm_pallas."""
    args = _case(21 + T, T, backwards)
    ref = lstm_kernel.lstm_pallas(*(jnp.asarray(a) for a in args), block_b=8, interpret=True)
    got = klstm.lstm_recurrence_plain(*(torch.from_numpy(a) for a in args))
    assert got.shape == (B_TILES, T, 6)
    _close_rel(got.numpy(), ref, "hids")
    # the fully padded row carries hid0 through every step
    np.testing.assert_array_equal(got[4].numpy(), np.broadcast_to(args[4][4], (T, 6)))


@pytest.mark.parametrize("T", [7, 1])
@pytest.mark.parametrize("backwards", [False, True])
def test_recurrence_train_plain_matches_pallas_interpret_at_19_rows(T, backwards):
    """Row 3: lstm_recurrence_train_plain against lstm_pallas_train (hids,
    post-mask cells, pre-activation gates), and its hids bit-equal to the
    inference recurrence's."""
    x_proj, w_hid, mask, cell0, hid0 = _case(31 + T, T, backwards)
    ref = lstm_kernel.lstm_pallas_train(jnp.asarray(_tm(x_proj)), jnp.asarray(w_hid),
                                        jnp.asarray(_tm(mask[..., None])), jnp.asarray(cell0),
                                        jnp.asarray(hid0), block_b=8, interpret=True)
    t_args = [torch.from_numpy(a) for a in (x_proj, w_hid, mask, cell0, hid0)]
    got = klstm.lstm_recurrence_train_plain(*t_args)
    assert len(got) == len(ref) == 3
    for name, r, o in zip(("hids", "cells", "gates"), ref, got):
        _close_rel(o.numpy(), _tm(r), name)
    assert torch.equal(got[0], klstm.lstm_recurrence_plain(*t_args))
    # the fully padded row carries cell0 through every step
    np.testing.assert_array_equal(got[1][4].numpy(), np.broadcast_to(cell0[4], (T, 6)))


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_kernel_launcher_refuses_cpu_tensors(train):
    """The launcher behind the wrappers has no plain fallback: CPU tensors
    are refused before anything is built or launched."""
    args = [torch.from_numpy(a) for a in _case(43, 3, False)]
    name = "lstm_recurrence_train" if train else "lstm_recurrence"
    with pytest.raises(ValueError, match="CUDA device"):
        klstm._run_fwd(name, args, train)
