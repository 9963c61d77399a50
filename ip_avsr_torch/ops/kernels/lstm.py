"""Wrapper of the masked LSTM recurrence kernel (``csrc/lstm_fwd.cu``).

Replaces ip_avsr_tpu/ops/pallas/lstm_kernel.py::_lstm_fwd_kernel as launched
by ``lstm_pallas`` (inference, no peepholes, no residuals).  The recurrence
is bound by its serial chain of T steps, each reading all of W_hid (from L2)
and exchanging h across the card; the kernel partitions the hidden units
across blocks so the gate math stays local and runs one launch per step (see
the source's header).  :func:`lstm_recurrence_plain` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ip_avsr_torch.ops.kernels import _build


def lstm_recurrence_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence in plain PyTorch, step by step.

    x_proj (B, T, 4H) (input projection plus bias), w_hid (H, 4H), mask
    (B, T), cell0/hid0 (B, H) -> hids (B, T, H).  Masked steps carry both
    the cell and the hidden state (Lasagne semantics)."""
    H = w_hid.shape[0]
    cell, hid = cell0, hid0
    outs = []
    for t in range(x_proj.shape[1]):
        gates = x_proj[:, t] + hid @ w_hid
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H: 2 * H])
        c_in = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        cell_cand = f * cell + i * c_in
        hid_cand = o * torch.tanh(cell_cand)
        m = mask[:, t: t + 1]
        cell = m * cell_cand + (1.0 - m) * cell
        hid = m * hid_cand + (1.0 - m) * hid
        outs.append(hid)
    return torch.stack(outs, dim=1)


@functools.cache
def _lib():
    lib = _build.load("lstm_fwd")
    lib.lstm_fwd_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.lstm_fwd_forward.restype = ctypes.c_int
    lib.lstm_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.lstm_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


def lstm_recurrence(x_proj, w_hid, mask, cell0, hid0):
    """The masked recurrence: (B, T, 4H), (H, 4H), (B, T), (B, H), (B, H) ->
    (B, T, H), all float32.

    CPU tensors take :func:`lstm_recurrence_plain`; CUDA tensors launch the
    kernel (one call, T per-step launches, counted once in
    ``lstm_recurrence.launches``) or raise."""
    args = (x_proj, w_hid, mask, cell0, hid0)
    if all(a.device.type == "cpu" for a in args):
        return lstm_recurrence_plain(*args)
    if any(a.device != x_proj.device for a in args) or x_proj.device.type != "cuda":
        raise ValueError("lstm_recurrence: inputs must all be on one CUDA "
                         "device (or all on the CPU), got "
                         f"{[str(a.device) for a in args]}")
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError("lstm_recurrence kernel takes float32 inputs, got "
                        f"{[a.dtype for a in args]}")
    if x_proj.dim() != 3:
        raise ValueError(f"x_proj must be (B, T, 4H), got {tuple(x_proj.shape)}")
    B, T, H4 = x_proj.shape
    H = w_hid.shape[0]
    shapes = {"w_hid": (w_hid, (H, 4 * H)), "mask": (mask, (B, T)),
              "cell0": (cell0, (B, H)), "hid0": (hid0, (B, H))}
    if H4 != 4 * H or B == 0 or T == 0 or H == 0:
        raise ValueError(f"x_proj {tuple(x_proj.shape)} does not match w_hid "
                         f"{tuple(w_hid.shape)}")
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("lstm_recurrence kernel takes contiguous tensors")
    lib = _lib()
    smem = lib.lstm_fwd_smem_bytes(H)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"lstm_recurrence: H={H} needs {smem} bytes of shared "
                         f"memory per block, above the {_build.SMEM_LIMIT} a block "
                         "may use")
    cell = cell0.clone()
    out = torch.empty((B, T, H), dtype=torch.float32, device=x_proj.device)
    stream = torch.cuda.current_stream(x_proj.device).cuda_stream
    code = lib.lstm_fwd_forward(x_proj.data_ptr(), w_hid.data_ptr(),
                                mask.data_ptr(), hid0.data_ptr(),
                                cell.data_ptr(), out.data_ptr(), B, T, H,
                                stream)
    _build.check(lib, "lstm_fwd", code)
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0
