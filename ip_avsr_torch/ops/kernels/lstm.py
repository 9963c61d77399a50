"""Wrappers of the masked LSTM kernels (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``).

They replace, in ip_avsr_tpu/ops/pallas/lstm_kernel.py (no peepholes):

* :func:`lstm_recurrence`: ``_lstm_fwd_kernel`` as launched by ``lstm_pallas``
  (inference, no residuals);
* :func:`lstm_recurrence_train`: the same body as launched by
  ``lstm_pallas_train`` (also writes the training residuals);
* :func:`lstm_bwd_chain`: ``_lstm_bwd_kernel`` as launched by
  ``lstm_pallas_bwd_chain`` (the reverse-time backward chain).

Each is bound by its serial chain of T steps, each reading all of W_hid (from
L2) and exchanging a (B, H) state across the card; the kernels partition the
hidden units across blocks so the gate math stays local and run one launch
per step (see the sources' headers).  The ``*_plain`` functions are their
plain versions.  All sequence tensors are batch-major (B, T, .), the port's
layout, where the JAX package keeps the training residuals time-major
(T, B, .).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ip_avsr_torch.ops.kernels import _build


def _plain_step(x_proj_t, w_hid, m, cell, hid):
    """One masked step: returns the new (hid, cell) and the pre-activation
    gates (B, 4H).  Where ``m`` (B, 1) is 0 both states carry over."""
    H = w_hid.shape[0]
    gates = x_proj_t + hid @ w_hid
    i = torch.sigmoid(gates[:, :H])
    f = torch.sigmoid(gates[:, H: 2 * H])
    c_in = torch.tanh(gates[:, 2 * H: 3 * H])
    o = torch.sigmoid(gates[:, 3 * H:])
    cell_cand = f * cell + i * c_in
    hid_cand = o * torch.tanh(cell_cand)
    return m * hid_cand + (1.0 - m) * hid, m * cell_cand + (1.0 - m) * cell, gates


def lstm_recurrence_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence in plain PyTorch, step by step.

    x_proj (B, T, 4H) (input projection plus bias), w_hid (H, 4H), mask
    (B, T), cell0/hid0 (B, H) -> hids (B, T, H).  Masked steps carry both
    the cell and the hidden state (Lasagne semantics)."""
    cell, hid = cell0, hid0
    outs = []
    for t in range(x_proj.shape[1]):
        hid, cell, _ = _plain_step(x_proj[:, t], w_hid, mask[:, t: t + 1], cell, hid)
        outs.append(hid)
    return torch.stack(outs, dim=1)


def lstm_recurrence_train_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence with its training residuals, in plain PyTorch.

    Inputs as :func:`lstm_recurrence_plain`.  Returns ``(hids, cells,
    gates_pre)``: hids and the post-mask cells (B, T, H) and the
    pre-activation gates ``x_proj[:, t] + h_{t-1} @ W_hid`` (B, T, 4H), the
    residual contract of ip_avsr_tpu/ops/lstm.py::_lstm_core_fwd_impl in the
    port's batch-major layout."""
    cell, hid = cell0, hid0
    hids, cells, gates_all = [], [], []
    for t in range(x_proj.shape[1]):
        hid, cell, gates = _plain_step(x_proj[:, t], w_hid, mask[:, t: t + 1], cell, hid)
        hids.append(hid)
        cells.append(cell)
        gates_all.append(gates)
    return (torch.stack(hids, dim=1), torch.stack(cells, dim=1),
            torch.stack(gates_all, dim=1))


def lstm_bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip):
    """The reverse-time backward chain in plain PyTorch.

    g_out, cells, cells_prev (B, T, H), gates_pre (B, T, 4H), mask (B, T),
    all in the recurrence's own time order (already flipped for a backwards
    layer); w_hid (H, 4H).  Returns ``(dgates (B, T, 4H), dcell0 (B, H),
    dhid0 (B, H))``.  dgates are clipped to +-``clip`` after the gate
    backward and before the W_hid^T product, and not clipped when ``clip``
    is 0 (ip_avsr_tpu/ops/lstm.py::_lstm_core_bwd, back_step)."""
    B, T, H = cells.shape
    dcell = torch.zeros((B, H), dtype=cells.dtype, device=cells.device)
    dhid = torch.zeros_like(dcell)
    dgates_all = [None] * T
    for t in reversed(range(T)):
        m = mask[:, t: t + 1]
        gates = gates_pre[:, t]
        dhid_total = g_out[:, t] + dhid
        dhid_cand = m * dhid_total
        dcell_cand = m * dcell
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H: 2 * H])
        c_in = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        tc = torch.tanh(cells[:, t])
        do = dhid_cand * tc
        dcell_cand = dcell_cand + dhid_cand * o * (1.0 - tc * tc)
        dgates = torch.cat([dcell_cand * c_in * i * (1.0 - i),
                            dcell_cand * cells_prev[:, t] * f * (1.0 - f),
                            dcell_cand * i * (1.0 - c_in * c_in),
                            do * o * (1.0 - o)], dim=-1)
        if clip:
            dgates = torch.clamp(dgates, -clip, clip)
        dhid = dgates @ w_hid.T + (1.0 - m) * dhid_total
        dcell = dcell_cand * f + (1.0 - m) * dcell
        dgates_all[t] = dgates
    return torch.stack(dgates_all, dim=1), dcell, dhid


@functools.cache
def _lib():
    lib = _build.load("lstm_fwd")
    lib.lstm_fwd_forward.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.lstm_fwd_forward.restype = ctypes.c_int
    lib.lstm_fwd_train_forward.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                                           + [ctypes.c_void_p])
    lib.lstm_fwd_train_forward.restype = ctypes.c_int
    lib.lstm_fwd_smem_bytes.argtypes = [ctypes.c_int]
    lib.lstm_fwd_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.cache
def _bwd_lib():
    lib = _build.load("lstm_bwd")
    lib.lstm_bwd_chain.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_float]
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.lstm_bwd_chain.restype = ctypes.c_int
    return lib


def _check_cuda(name, args, shapes):
    """Raise unless ``args`` are contiguous float32 tensors on one CUDA
    device with the ``shapes`` given (name -> (tensor, shape))."""
    dev = args[0].device
    if any(a.device != dev for a in args) or dev.type != "cuda":
        raise ValueError(f"{name}: inputs must all be on one CUDA device (or all "
                         f"on the CPU), got {[str(a.device) for a in args]}")
    if any(a.dtype != torch.float32 for a in args):
        raise TypeError(f"{name} kernel takes float32 inputs, got {[a.dtype for a in args]}")
    if any(0 in a.shape for a in args):
        raise ValueError(f"{name}: empty input {[tuple(a.shape) for a in args]}")
    for arg, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(a.shape)}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def _run_fwd(name, args, train):
    """Check the inputs and launch csrc/lstm_fwd.cu's inference entry point
    (returns hids) or its training one (returns hids, cells, gates)."""
    x_proj, w_hid, mask, cell0, hid0 = args
    if x_proj.dim() != 3 or w_hid.dim() != 2:
        raise ValueError(f"{name}: x_proj must be (B, T, 4H) and w_hid (H, 4H), got "
                         f"{tuple(x_proj.shape)} and {tuple(w_hid.shape)}")
    B, T, _ = x_proj.shape
    H = w_hid.shape[0]
    _check_cuda(name, args, {"x_proj": (x_proj, (B, T, 4 * H)), "w_hid": (w_hid, (H, 4 * H)),
                             "mask": (mask, (B, T)), "cell0": (cell0, (B, H)),
                             "hid0": (hid0, (B, H))})
    lib = _lib()
    smem = lib.lstm_fwd_smem_bytes(H)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: H={H} needs {smem} bytes of shared memory per "
                         f"block, above the {_build.SMEM_LIMIT} a block may use")
    dev = x_proj.device
    cell = cell0.clone()
    hids = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    ptrs = [a.data_ptr() for a in (x_proj, w_hid, mask, hid0, cell, hids)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if train:
        cells = torch.empty((B, T, H), dtype=torch.float32, device=dev)
        gates = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
        code = lib.lstm_fwd_train_forward(*ptrs, cells.data_ptr(), gates.data_ptr(),
                                          B, T, H, stream)
        out = (hids, cells, gates)
    else:
        code = lib.lstm_fwd_forward(*ptrs, B, T, H, stream)
        out = hids
    _build.check(lib, "lstm_fwd", code)
    return out


def lstm_recurrence(x_proj, w_hid, mask, cell0, hid0):
    """The masked recurrence: (B, T, 4H), (H, 4H), (B, T), (B, H), (B, H) ->
    (B, T, H), all float32.

    CPU tensors take :func:`lstm_recurrence_plain`; CUDA tensors launch the
    kernel (one call, T per-step launches, counted once in
    ``lstm_recurrence.launches``) or raise."""
    args = (x_proj, w_hid, mask, cell0, hid0)
    if all(a.device.type == "cpu" for a in args):
        return lstm_recurrence_plain(*args)
    out = _run_fwd("lstm_recurrence", args, train=False)
    lstm_recurrence.launches += 1
    return out


lstm_recurrence.launches = 0


def lstm_recurrence_train(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence with its training residuals: inputs as
    :func:`lstm_recurrence`, returns ``(hids, cells, gates_pre)`` as
    :func:`lstm_recurrence_train_plain` does.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    residual-emitting instantiation (T per-step launches, counted once in
    ``lstm_recurrence_train.launches``) or raise."""
    args = (x_proj, w_hid, mask, cell0, hid0)
    if all(a.device.type == "cpu" for a in args):
        return lstm_recurrence_train_plain(*args)
    out = _run_fwd("lstm_recurrence_train", args, train=True)
    lstm_recurrence_train.launches += 1
    return out


lstm_recurrence_train.launches = 0


def lstm_bwd_chain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip):
    """The reverse-time backward chain: inputs and outputs as
    :func:`lstm_bwd_chain_plain`, all float32, ``clip >= 0``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (T + 1 per-step launches, counted once in ``lstm_bwd_chain.launches``) or
    raise."""
    args = (g_out, gates_pre, cells, cells_prev, mask, w_hid)
    clip = float(clip or 0.0)
    if clip < 0:
        raise ValueError(f"lstm_bwd_chain: clip must be >= 0, got {clip}")
    if all(a.device.type == "cpu" for a in args):
        return lstm_bwd_chain_plain(*args, clip)
    if cells.dim() != 3:
        raise ValueError(f"cells must be (B, T, H), got {tuple(cells.shape)}")
    B, T, H = cells.shape
    _check_cuda("lstm_bwd_chain", args, {
        "g_out": (g_out, (B, T, H)), "gates_pre": (gates_pre, (B, T, 4 * H)),
        "cells_prev": (cells_prev, (B, T, H)), "mask": (mask, (B, T)),
        "w_hid": (w_hid, (H, 4 * H))})
    lib = _bwd_lib()
    dev = cells.device
    dgates = torch.empty((B, T, 4 * H), dtype=torch.float32, device=dev)
    dcell = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dh_pass = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dhid0 = torch.empty((B, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.lstm_bwd_chain(g_out.data_ptr(), gates_pre.data_ptr(), cells.data_ptr(),
                              cells_prev.data_ptr(), mask.data_ptr(), w_hid.data_ptr(),
                              dgates.data_ptr(), dcell.data_ptr(), dh_pass.data_ptr(),
                              dhid0.data_ptr(), clip, B, T, H, stream)
    _build.check(lib, "lstm_bwd", code)
    lstm_bwd_chain.launches += 1
    return dgates, dcell, dhid0


lstm_bwd_chain.launches = 0
