"""The peephole recurrence's oracle at a batch of several row tiles.

Rows 5 and 6 of the kernel table run as csrc/lstm_fwd.cu's
``lstm_fwd_chain_kernel<EmitResiduals, true, U>``, held on the card to the
plain versions ``lstm_peep_recurrence_plain`` and
``lstm_peep_recurrence_train_plain``.  Those are held here to the TPU
kernels ``lstm_pallas_peep`` and ``lstm_pallas_peep_train`` in interpret
mode at B = 19, which ``block_b = 8`` cuts into three row tiles (the last
one ragged), with nonzero initial states and peephole vectors, lengths 0, 1
and T among the rows, both directions, and H = 6 (not a multiple of the 2 or
4 units a block owns on the card).  Tolerance: 1e-5 relative to each
output's max abs with a 1e-8 absolute floor (T steps of H-term dot products
summed in another order; the floor keeps a near-zero output from asking for
more than float32 gives).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ip_avsr_tpu.ops.pallas import lstm_kernel
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
B_TILES = 19
H = 6


def _case(seed, T, backwards):
    """Peephole recurrence inputs at B = 19: nonzero per-row initial states,
    lengths T (row 0), 0 (row 4) and 1 (row 7), flipped in time for a
    backwards layer as ops/lstm.py flips them, and the three (H,) vectors."""
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
    peep = [rng.randn(H).astype(np.float32) * 0.5 for _ in range(3)]
    # a copy: at T = 1 a flipped array counts as contiguous with a negative stride
    return [a.copy() for a in (x_proj, w_hid, mask, cell0, hid0)], peep


def _tm(a):
    """(B, T, .) <-> (T, B, .)."""
    return np.ascontiguousarray(np.swapaxes(np.asarray(a), 0, 1))


def _close_rel(got, ref, name):
    ref = np.asarray(ref)
    atol = max(1e-5 * np.abs(ref).max(), 1e-8)
    np.testing.assert_allclose(np.asarray(got), ref, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("T", [7, 1])
@pytest.mark.parametrize("backwards", [False, True])
def test_peep_recurrence_plain_matches_pallas_interpret_at_19_rows(T, backwards):
    """Row 5: lstm_peep_recurrence_plain against lstm_pallas_peep."""
    args, peep = _case(51 + T, T, backwards)
    ref = lstm_kernel.lstm_pallas_peep(*(jnp.asarray(a) for a in (*args, *peep)), block_b=8,
                                       interpret=True)
    got = klstm.lstm_peep_recurrence_plain(*(torch.from_numpy(a) for a in (*args, *peep)))
    assert got.shape == (B_TILES, T, H)
    _close_rel(got.numpy(), ref, "hids")
    # the fully padded row carries hid0 through every step
    np.testing.assert_array_equal(got[4].numpy(), np.broadcast_to(args[4][4], (T, H)))


@pytest.mark.parametrize("T", [7, 1])
@pytest.mark.parametrize("backwards", [False, True])
def test_peep_recurrence_train_plain_matches_pallas_interpret_at_19_rows(T, backwards):
    """Row 6: lstm_peep_recurrence_train_plain against lstm_pallas_peep_train
    (hids, post-mask cells, gates before the peephole terms), and its hids
    bit-equal to the inference recurrence's."""
    (x_proj, w_hid, mask, cell0, hid0), peep = _case(61 + T, T, backwards)
    ref = lstm_kernel.lstm_pallas_peep_train(
        jnp.asarray(_tm(x_proj)), jnp.asarray(w_hid), jnp.asarray(_tm(mask[..., None])),
        jnp.asarray(cell0), jnp.asarray(hid0), *(jnp.asarray(v) for v in peep), block_b=8,
        interpret=True)
    t_args = [torch.from_numpy(a) for a in (x_proj, w_hid, mask, cell0, hid0, *peep)]
    got = klstm.lstm_peep_recurrence_train_plain(*t_args)
    assert len(got) == len(ref) == 3
    for name, r, o in zip(("hids", "cells", "gates"), ref, got):
        _close_rel(o.numpy(), _tm(r), name)
    assert torch.equal(got[0], klstm.lstm_peep_recurrence_plain(*t_args))
    # the fully padded row carries cell0 and hid0 through every step
    np.testing.assert_array_equal(got[1][4].numpy(), np.broadcast_to(cell0[4], (T, H)))
    np.testing.assert_array_equal(got[0][4].numpy(), np.broadcast_to(hid0[4], (T, H)))


@pytest.mark.parametrize("train", [False, True], ids=["inference", "train"])
def test_peep_kernel_launcher_refuses_cpu_tensors(train):
    """The launcher behind the peephole wrappers has no plain fallback: CPU
    tensors are refused before anything is built or launched."""
    args, peep = _case(71, 3, False)
    name = "lstm_peep_recurrence_train" if train else "lstm_peep_recurrence"
    with pytest.raises(ValueError, match="CUDA device"):
        klstm._run_fwd(name, [torch.from_numpy(a) for a in args], train,
                       peep=tuple(torch.from_numpy(v) for v in peep))
