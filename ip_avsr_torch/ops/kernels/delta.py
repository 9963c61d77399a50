"""Wrapper of the grouped delta kernel (``csrc/delta.cu``).

Replaces ip_avsr_tpu/ops/pallas/delta_kernel.py::_delta_kernel.  One launch
computes [x, d, a] for every stream of a group that shares B, T and the
window, each thread applying the composed (3T, T) matrix
``ops/delta.delta_matrix`` to its x column (see the source's header: the
kernel is bound by latency and launches, not bytes).  Its plain version is
``ops/delta.append_delta_coeff``, per stream.  The group is the operator
``ip_avsr::delta_group`` (``torch.library``), so an exported
program records it as one node and launches the kernel when it runs.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from ip_avsr_torch.ops.delta import append_delta_coeff as plain
from ip_avsr_torch.ops.delta import delta_matrix
from ip_avsr_torch.ops.kernels import _build

# the streams one launch takes (csrc/delta.cu kMaxStreams)
MAX_STREAMS = 16


@functools.cache
def _lib():
    lib = _build.load("delta")
    lib.delta_group_forward.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.delta_group_forward.restype = ctypes.c_int
    return lib


@functools.cache
def _launch_args(dev: torch.device, B: int, T: int, window: int, widths: tuple) -> tuple:
    """What a launch over streams of ``widths`` at (B, T, window) on ``dev``
    reuses from call to call: the pointer-array type, the widths array, the
    output shapes and S."""
    n = len(widths)
    return (ctypes.c_void_p * n, (ctypes.c_int * n)(*widths),
            [(B, T, 3 * D) for D in widths], delta_matrix(T, window, dev))


def _check(xs, window) -> tuple:
    """Raise unless ``xs`` is a group of 1 to :data:`MAX_STREAMS` contiguous
    float32 (B, T, D_i) tensors, none empty, on one CPU or CUDA device, that
    share B and T, and ``window`` an int.  Returns (B, T, widths)."""
    if not isinstance(window, int):
        raise TypeError(f"append_delta_group: one int window for the whole group, "
                        f"got {window!r}")
    if not 0 < len(xs) <= MAX_STREAMS:
        raise ValueError(f"append_delta_group takes 1 to {MAX_STREAMS} tensors, "
                         f"got {len(xs)}")
    dev = xs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"append_delta_group: unsupported device {dev}")
    shape = xs[0].shape
    if len(shape) != 3 or 0 in shape:
        raise ValueError(f"append_delta_group expects non-empty (B, T, D) tensors, got "
                         f"{tuple(shape)}")
    B, T = shape[0], shape[1]
    widths = []
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"append_delta_group takes float32, got {x.dtype}")
        shape = x.shape
        if (len(shape) != 3 or shape[0] != B or shape[1] != T or shape[2] == 0
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"append_delta_group: the group must be contiguous, non-empty "
                             f"(B, T, D_i) tensors on one device that share B and T, got "
                             f"{[(tuple(y.shape), str(y.device), y.is_contiguous()) for y in xs]}")
        widths.append(shape[2])
    return B, T, tuple(widths)


def _launch(xs, window: int, outs) -> list:
    """One launch of the kernel over the checked CUDA group ``xs``, into
    ``outs`` (allocated when None)."""
    B, T, widths = xs[0].shape[0], xs[0].shape[1], tuple(x.shape[2] for x in xs)
    dev = xs[0].device
    ptrs, widths_arg, shapes, S = _launch_args(dev, B, T, window, widths)
    if outs is None:
        outs = [torch.empty(s, dtype=torch.float32, device=dev) for s in shapes]
    elif [tuple(o.shape) for o in outs] != shapes or not all(
            o.is_contiguous() and o.dtype == torch.float32 and o.device == dev
            for o in outs):
        raise ValueError("append_delta_group: outs must be contiguous float32 (B, T, 3 D_i) "
                         "tensors on the inputs' device")
    lib = _lib()
    # the launch acts on the host thread's current device, which need not be
    # the tensors' card
    with torch.cuda.device(dev):
        code = lib.delta_group_forward(
            ptrs(*[x.data_ptr() for x in xs]), ptrs(*[o.data_ptr() for o in outs]), widths_arg,
            len(xs), S.data_ptr(), B, T, window, torch.cuda.current_stream(dev).cuda_stream)
    if code < 0:
        _build.check(lib, "delta", -code)
    append_delta.launches += 1
    append_delta.blocks = code
    return outs


# the operator's registrations: a schema without alias annotations (fresh
# outputs, nothing mutated), an implementation per device and a fake; plain
# ``Library`` registration, which adds no Python layer to each call
_LIB = torch.library.Library("ip_avsr", "FRAGMENT")
_LIB.define("delta_group(Tensor[] xs, int window) -> Tensor[]")


def _delta_group_cpu(xs, window):
    """The group as an operator ``torch.export`` records as one opaque node:
    the plain version per stream on the CPU."""
    return [plain(x, window) for x in xs]


def _delta_group_cuda(xs, window):
    """The kernel's launch, after the wrapper's checks: an exported program
    hands the operator its inputs with no wrapper around it, so a group
    that is not contiguous float32 on one device raises here.  The
    cached ctypes arguments and S are keyed by concrete shapes, which only
    an implementation (not the traced wrapper) sees."""
    xs = list(xs)
    _check(xs, window)
    return _launch(xs, window, None)


def _delta_group_fake(xs, window):
    return [x.new_empty((x.shape[0], x.shape[1], 3 * x.shape[2])) for x in xs]


_LIB.impl("delta_group", _delta_group_cpu, "CPU")
_LIB.impl("delta_group", _delta_group_cuda, "CUDA")
torch.library.register_fake("ip_avsr::delta_group", _delta_group_fake, lib=_LIB)


def append_delta_group(xs, window: int, outs=None) -> list:
    """[x, delta, accel] of each (B, T, D_i) float32 tensor of ``xs``, as a
    list of (B, T, 3 D_i): the operator ``ip_avsr::delta_group``.

    CPU tensors take the plain version, one per tensor.  CUDA tensors take one
    launch of the kernel over the whole group, counted in
    ``append_delta.launches`` (its grid in ``append_delta.blocks``), or
    raise; ``outs`` gives their output tensors (for tests; outside the
    operator), else they are allocated."""
    xs = list(xs)
    _check(xs, window)
    if outs is None or xs[0].device.type == "cpu":
        return list(torch.ops.ip_avsr.delta_group(xs, window))
    return _launch(xs, window, outs)


def append_delta(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, D) f32 -> (B, T, 3D) [x, delta, accel]: a group of one."""
    return append_delta_group([x], window)[0]


# the launches of both entry points, and the last launch's grid
append_delta.launches = 0
append_delta.blocks = 0
