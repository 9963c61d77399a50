"""The kernels an exported program calls, as ``torch.library`` operators.

Kernel-table rows 1 and 5 (the inference recurrences, with and without
their final-cell output) and row 2 (the grouped delta FIR) are registered
as ``ip_avsr::`` operators in ip_avsr_torch/ops/kernels/{lstm,delta}.py.
Here, on the CPU: ``torch.library.opcheck`` on each (its schema, the fake
implementation against the real one, no aliasing, dynamic shapes), each
operator's CPU result bit-equal to the plain version it wraps, its
registrations (CPU, CUDA and the fake), and the fake's output shapes.  The
CUDA implementations launch the kernels and run only on the card
(``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ip_avsr_torch.ops import delta as tdelta
from ip_avsr_torch.ops.kernels import delta as kdelta
from ip_avsr_torch.ops.kernels import lstm as klstm

torch.set_num_threads(1)
B, T, H = 3, 6, 5


def _recurrence_args(seed, peep):
    rng = np.random.RandomState(seed)
    mask = (np.arange(T)[None] < np.array([[T], [2], [0]])).astype(np.float32)
    arrays = [rng.randn(B, T, 4 * H), rng.randn(H, 4 * H) * 0.3, mask, rng.randn(B, H),
              rng.randn(B, H)]
    if peep:
        arrays += [rng.randn(H) * 0.1 for _ in range(3)]
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


RECURRENCES = {
    "lstm_recurrence": (klstm.lstm_recurrence, klstm.lstm_recurrence_plain, False),
    "lstm_recurrence_state": (klstm.lstm_recurrence_state, klstm.lstm_recurrence_state_plain,
                              False),
    "lstm_peep_recurrence": (klstm.lstm_peep_recurrence, klstm.lstm_peep_recurrence_plain,
                             True),
    "lstm_peep_recurrence_state": (klstm.lstm_peep_recurrence_state,
                                   klstm.lstm_peep_recurrence_state_plain, True),
}


def _delta_args(seed, widths=(4, 7, 3)):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(B, T, D).astype(np.float32)) for D in widths]


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_opcheck_recurrence(name):
    args = _recurrence_args(0, RECURRENCES[name][2])
    torch.library.opcheck(getattr(torch.ops.ip_avsr, name).default, args)


@pytest.mark.parametrize("window,widths", [(2, (4, 7, 3)), (3, (5,)), (0, (2, 2))])
def test_opcheck_delta_group(window, widths):
    torch.library.opcheck(torch.ops.ip_avsr.delta_group.default,
                          (_delta_args(1, widths), window))


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_recurrence_op_on_the_cpu_is_its_plain_version(name):
    wrapper, plain, peep = RECURRENCES[name]
    args = _recurrence_args(2, peep)
    before = (klstm.lstm_recurrence.launches, klstm.lstm_peep_recurrence.launches)
    got, want = wrapper(*args), plain(*args)
    for g, w in zip(*(o if isinstance(o, tuple) else (o,) for o in (got, want))):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        assert g.is_contiguous()
    assert (klstm.lstm_recurrence.launches, klstm.lstm_peep_recurrence.launches) == before


def test_delta_group_op_on_the_cpu_is_its_plain_version():
    xs = _delta_args(3)
    before = kdelta.append_delta.launches
    got = torch.ops.ip_avsr.delta_group(xs, 2)
    assert len(got) == len(xs)
    for g, x in zip(got, xs):
        torch.testing.assert_close(g, tdelta.append_delta_coeff(x, 2), rtol=0, atol=0)
    assert kdelta.append_delta.launches == before


@pytest.mark.parametrize("name", [*sorted(RECURRENCES), "delta_group"])
def test_op_has_cpu_cuda_and_fake_implementations(name):
    """The CUDA implementation (the kernel's launch) is registered beside the
    CPU one and the fake, so a CUDA tensor reaches the kernel and nothing
    else."""
    qualname = f"ip_avsr::{name}"
    for key in ("CPU", "CUDA", "Meta"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qualname, key), key
    assert not torch._C._dispatch_has_kernel_for_dispatch_key(qualname, "CompositeImplicitAutograd")


@pytest.mark.parametrize("name", sorted(RECURRENCES))
def test_recurrence_fake_gives_the_output_shapes(name):
    _, _, peep = RECURRENCES[name]
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(a) for a in _recurrence_args(0, peep)]
        out = getattr(torch.ops.ip_avsr, name)(*args)
    shapes = [tuple(o.shape) for o in (out if isinstance(out, tuple) else (out,))]
    assert shapes == ([(B, T, H), (B, H)] if name.endswith("_state") else [(B, T, H)])


def test_delta_group_fake_gives_the_output_shapes():
    with FakeTensorMode() as mode:
        xs = [mode.from_tensor(x) for x in _delta_args(0)]
        outs = torch.ops.ip_avsr.delta_group(xs, 2)
    assert [tuple(o.shape) for o in outs] == [(B, T, 12), (B, T, 21), (B, T, 9)]


def test_delta_group_refuses_mixed_devices():
    """A group that is not on one device is refused by the wrapper before
    any implementation runs (a meta tensor would otherwise reach the
    fake)."""
    xs = _delta_args(0)
    with pytest.raises(ValueError):
        kdelta.append_delta_group([xs[0], xs[1].to("meta")], 2)


@pytest.mark.parametrize("case", ["strided", "mixed"])
def test_delta_group_cuda_implementation_checks_its_group(case):
    """The CUDA implementation runs the wrapper's checks itself, since an
    exported program calls the operator with no wrapper around it: a strided
    group and a group on two devices are refused before any launch."""
    xs = _delta_args(4)
    if case == "strided":
        xs[1] = xs[1].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "mixed":
        xs[2] = xs[2].to("meta")
    before = kdelta.append_delta.launches
    with pytest.raises(ValueError):
        kdelta._delta_group_cuda(xs, 2)
    assert kdelta.append_delta.launches == before
