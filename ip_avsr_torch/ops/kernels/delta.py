"""Wrapper of the fused delta kernel (``csrc/delta.cu``).

Replaces ip_avsr_tpu/ops/pallas/delta_kernel.py::_delta_kernel.  The kernel
is bound by bytes: it reads x once and writes [x, d, a] once, with both FIR
orders computed in shared memory (see the source's header).  Its plain
version is ``ops/delta.append_delta_coeff``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ip_avsr_torch.ops.delta import append_delta_coeff as plain
from ip_avsr_torch.ops.kernels import _build


@functools.cache
def _lib():
    lib = _build.load("delta")
    lib.delta_forward.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.delta_forward.restype = ctypes.c_int
    lib.delta_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.delta_smem_bytes.restype = ctypes.c_size_t
    return lib


def append_delta(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T, D) f32 -> (B, T, 3D) [x, delta, accel].

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch in ``append_delta.launches``) or raises."""
    if x.device.type == "cpu":
        return plain(x, window)
    if x.device.type != "cuda":
        raise ValueError(f"append_delta: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"append_delta expects (B, T, D), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"append_delta kernel takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("append_delta kernel takes a contiguous tensor")
    B, T, D = x.shape
    if B == 0 or T == 0 or D == 0:
        raise ValueError(f"append_delta: empty input {tuple(x.shape)}")
    lib = _lib()
    window = int(window)
    smem = lib.delta_smem_bytes(T, window)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(
            f"append_delta: T={T} with window={window} needs {smem} bytes of "
            f"shared memory per block, above the {_build.SMEM_LIMIT} a block may use")
    out = torch.empty((B, T, 3 * D), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.delta_forward(x.data_ptr(), out.data_ptr(), B, T, D, window,
                             stream)
    _build.check(lib, "delta", code)
    append_delta.launches += 1
    return out


append_delta.launches = 0
