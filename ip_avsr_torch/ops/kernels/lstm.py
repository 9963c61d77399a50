"""Wrappers of the masked LSTM kernels (``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``).

They replace the seven-row kernel table's LSTM rows, in
ip_avsr_tpu/ops/pallas/lstm_kernel.py:

* :func:`lstm_recurrence`: ``_lstm_fwd_kernel`` as launched by ``lstm_pallas``
  (inference, no residuals), and :func:`lstm_recurrence_state`, the same
  launch taking a per-row initial state and also giving back the final
  cell (a streaming caller's carry; the JAX package runs that case as its
  plain scan, ip_avsr_tpu/ops/lstm.py:178-181);
* :func:`lstm_recurrence_train`: the same body as launched by
  ``lstm_pallas_train`` (also writes the training residuals);
* :func:`lstm_bwd_chain`: ``_lstm_bwd_kernel`` as launched by
  ``lstm_pallas_bwd_chain`` (the reverse-time backward chain);
* :func:`lstm_peep_recurrence`, :func:`lstm_peep_recurrence_train` and
  :func:`lstm_peep_bwd_chain`: their peephole twins, ``_lstm_peep_fwd_kernel``
  as launched by ``lstm_pallas_peep`` and ``lstm_pallas_peep_train``, and
  ``_lstm_peep_bwd_kernel`` as launched by ``lstm_pallas_peep_bwd_chain``
  (the same CUDA bodies, instantiated with peepholes), and
  :func:`lstm_peep_recurrence_state`, the peephole twin of
  :func:`lstm_recurrence_state`.

Each is bound by its serial chain of T steps, each needing all of W_hid and
an exchange of state across the card; the kernels partition the hidden units
across blocks so the gate math stays local.  All six run as one persistent
cooperative launch per call, with each block's share of W_hid in shared
memory and a grid barrier between steps (:func:`fwd_launch_plan`,
:func:`bwd_launch_plan`; see the sources' headers).  With a float32 W_hid
the recurrences and the backward chains have a second body for large
batches, whose blocks split the rows as well as the hidden units.
:func:`fwd_plan` and :func:`bwd_plan` are the one place a direction's body
is chosen, from W_hid's dtype, B and H; each returns a :class:`LaunchPlan`
whose ``tiled`` says which.  A batch that does not fit one launch runs as
near-equal row chunks, one launch each (:func:`map_chunks`).
The ``*_plain`` functions are their plain versions.  The four inference wrappers call operators
``ip_avsr::<name>`` (``torch.library``: the plain version on the
CPU, the launch on CUDA, a fake for tracing), so ``torch.export`` records
each as one opaque node; the training rows run only inside the autograd
Functions of ``ops/lstm.py``, which no exported program reaches, and stay
plain Python functions.  All sequence tensors are batch-major (B, T, .), the
port's layout, where the JAX package keeps the training residuals time-major
(T, B, .).

Every kernel has two instantiations by W_hid's dtype, as each Pallas body is
generic over it: float32, and bfloat16 for ``matmul_dtype="bfloat16"`` (and
a bf16-weight artifact's recurrences), whose product runs on the tensor
cores (``mma.sync`` m16n8k16, float32 sums): W_hid sits in shared memory as
bf16 in the tensor cores' fragment order, and the product's other operand
(h_{t-1}, or the clipped dgates in the backward chains) is rounded to bf16
once, by the block that computes it, into a scratch buffer of two steps
that the wrapper allocates (:func:`_run_fwd`, :func:`_run_bwd`).  Every
other tensor, and every output, stays float32.  A wrapper counts a launch
of its float32 instantiation in ``.launches`` and of its bf16 one in
``.launches_bf16``, and the calls that took the large-B body also in
``.launches_tiled``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ip_avsr_torch.ops.kernels import _build


# the dtypes W_hid may have: float32, or bfloat16 for the kernels' bf16
# instantiations (``matmul_dtype="bfloat16"``, a bf16-weight artifact)
W_DTYPES = (torch.float32, torch.bfloat16)


def round_operand(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (float32) as the operand of a product whose other operand has
    ``dtype``: rounded to bfloat16 and widened back for a bfloat16 product,
    else ``x`` itself.  A bf16 x bf16 product is exact in float32, so a
    float32 product of rounded operands, summed in float32, is the bf16
    product with float32 accumulation that the JAX package computes
    (``jnp.dot(a.astype(bf16), b, preferred_element_type=f32)``)."""
    if dtype == torch.bfloat16:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def _w_operand(w_hid: torch.Tensor) -> torch.Tensor:
    """W_hid widened to float32 for the plain versions' products; raises
    ``TypeError`` for a dtype the kernels have no instantiation of."""
    if w_hid.dtype not in W_DTYPES:
        raise TypeError(f"w_hid must be one of {W_DTYPES}, got {w_hid.dtype}")
    return w_hid.to(torch.float32)


def _plain_step(x_proj_t, w_hid, m, cell, hid, peep=None, w_dtype=torch.float32,
                operand=None):
    """One masked step: returns the new (hid, cell) and the pre-activation
    gates (B, 4H), before any peephole term.  Where ``m`` (B, 1) is 0 both
    states carry over.  ``peep`` is None or the (H,) vectors (w_ci, w_cf,
    w_co): c_{t-1} feeds the in and forget gates, the new cell the out
    gate.  ``w_hid`` is float32 (widened); with ``w_dtype`` bfloat16 the
    product's operand h_{t-1} is rounded to bf16, the carry is not.
    ``operand``, when given, is the product's h_{t-1} in place of ``hid``."""
    H = w_hid.shape[0]
    gates = x_proj_t + round_operand(hid if operand is None else operand, w_dtype) @ w_hid
    z_i, z_f, z_c, z_o = gates[:, :H], gates[:, H: 2 * H], gates[:, 2 * H: 3 * H], gates[:, 3 * H:]
    if peep is not None:
        z_i = z_i + cell * peep[0]
        z_f = z_f + cell * peep[1]
    i = torch.sigmoid(z_i)
    f = torch.sigmoid(z_f)
    c_in = torch.tanh(z_c)
    cell_cand = f * cell + i * c_in
    if peep is not None:
        z_o = z_o + cell_cand * peep[2]
    o = torch.sigmoid(z_o)
    hid_cand = o * torch.tanh(cell_cand)
    return m * hid_cand + (1.0 - m) * hid, m * cell_cand + (1.0 - m) * cell, gates


def _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, peep, operands=None):
    """All T steps: (hids, post-mask cells, gates) stacked batch-major.
    W_hid is float32 or bfloat16 (then h_{t-1} is rounded to bf16 before
    each product, and the product accumulates in float32).  ``operands``
    (B, T, H), when given, are the hids whose step t - 1 is step t's
    product operand (hid0 at t = 0) in place of this recurrence's own: fed
    a kernel's hids, each step is that kernel's step from the kernel's own
    operand, so a bf16 rounding that parted the two sums earlier does not
    carry (the carries stay this recurrence's own)."""
    w_dtype, w = w_hid.dtype, _w_operand(w_hid)
    cell, hid = cell0, hid0
    hids, cells, gates_all = [], [], []
    for t in range(x_proj.shape[1]):
        operand = None if operands is None or t == 0 else operands[:, t - 1]
        hid, cell, gates = _plain_step(x_proj[:, t], w, mask[:, t: t + 1], cell, hid, peep,
                                       w_dtype, operand)
        hids.append(hid)
        cells.append(cell)
        gates_all.append(gates)
    return (torch.stack(hids, dim=1), torch.stack(cells, dim=1),
            torch.stack(gates_all, dim=1))


def lstm_recurrence_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence in plain PyTorch, step by step.

    x_proj (B, T, 4H) (input projection plus bias), w_hid (H, 4H), mask
    (B, T), cell0/hid0 (B, H) -> hids (B, T, H).  Masked steps carry both
    the cell and the hidden state (Lasagne semantics).  Every tensor is
    float32 except w_hid, which may be bfloat16: then h_{t-1} is rounded to
    bf16 as the product's operand and the product sums in float32, as
    ``_lstm_fwd_kernel`` does with a bf16 W_hid; the carries and outputs
    stay float32."""
    return _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, None)[0]


def lstm_recurrence_train_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence with its training residuals, in plain PyTorch.

    Inputs as :func:`lstm_recurrence_plain`.  Returns ``(hids, cells,
    gates_pre)``: hids and the post-mask cells (B, T, H) and the
    pre-activation gates ``x_proj[:, t] + h_{t-1} @ W_hid`` (B, T, 4H), the
    residual contract of ip_avsr_tpu/ops/lstm.py::_lstm_core_fwd_impl in the
    port's batch-major layout."""
    return _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, None)


def lstm_recurrence_state_plain(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence with its final state, in plain PyTorch: inputs as
    :func:`lstm_recurrence_plain`, returns ``(hids, cell_T)`` with cell_T
    (B, H) the cell after the last step (the hidden one is hids[:, -1]), a
    fresh contiguous tensor as the kernel writes it."""
    hids, cells, _ = _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, None)
    return hids, cells[:, -1].clone(memory_format=torch.contiguous_format)


def lstm_peep_recurrence_state_plain(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence with its final state, in plain PyTorch:
    inputs as :func:`lstm_peep_recurrence_plain`, returns ``(hids,
    cell_T)`` as :func:`lstm_recurrence_state_plain` does."""
    hids, cells, _ = _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, (w_ci, w_cf, w_co))
    return hids, cells[:, -1].clone(memory_format=torch.contiguous_format)


def lstm_peep_recurrence_plain(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence in plain PyTorch: inputs as
    :func:`lstm_recurrence_plain` plus the (H,) peephole vectors; returns
    hids (B, T, H) (ip_avsr_tpu/ops/lstm.py::_peep_recurrence_scan)."""
    return _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, (w_ci, w_cf, w_co))[0]


def lstm_peep_recurrence_train_plain(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence with its training residuals, in plain
    PyTorch: ``(hids, cells, gates_pre)`` as
    :func:`lstm_recurrence_train_plain` returns them, where gates_pre are
    the pre-activations BEFORE the peephole terms (the residual contract of
    ip_avsr_tpu/ops/lstm.py::_lstm_core_peep_fwd_impl)."""
    return _recurrence_plain(x_proj, w_hid, mask, cell0, hid0, (w_ci, w_cf, w_co))


def _bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip, peep,
                     operands=None):
    """The reverse-time chain; with ``peep`` (w_ci, w_cf, w_co) also the
    peephole routes and the (B, H) per-row partial sums of their gradients.
    ``operands`` (B, T, 4H), when given, are the clipped dgates whose step t
    is the product's operand after step t in place of this chain's own (as
    in :func:`_recurrence_plain`)."""
    B, T, H = cells.shape
    w_dtype, w_hid = w_hid.dtype, _w_operand(w_hid)
    dcell = torch.zeros((B, H), dtype=cells.dtype, device=cells.device)
    dhid = torch.zeros_like(dcell)
    dw = [torch.zeros_like(dcell) for _ in range(3)] if peep is not None else None
    dgates_all = [None] * T
    for t in reversed(range(T)):
        m = mask[:, t: t + 1]
        gates = gates_pre[:, t]
        c_prev, c_t = cells_prev[:, t], cells[:, t]
        dhid_total = g_out[:, t] + dhid
        dhid_cand = m * dhid_total
        dcell_cand = m * dcell
        z_i, z_f, z_o = gates[:, :H], gates[:, H: 2 * H], gates[:, 3 * H:]
        if peep is not None:
            # o from the post-mask cell, as the JAX backward recomputes it
            z_i = z_i + c_prev * peep[0]
            z_f = z_f + c_prev * peep[1]
            z_o = z_o + c_t * peep[2]
        i = torch.sigmoid(z_i)
        f = torch.sigmoid(z_f)
        c_in = torch.tanh(gates[:, 2 * H: 3 * H])
        o = torch.sigmoid(z_o)
        tc = torch.tanh(c_t)
        do_pre = dhid_cand * tc * o * (1.0 - o)
        dcell_cand = dcell_cand + dhid_cand * o * (1.0 - tc * tc)
        if peep is not None:
            dcell_cand = dcell_cand + do_pre * peep[2]
        di_pre = dcell_cand * c_in * i * (1.0 - i)
        df_pre = dcell_cand * c_prev * f * (1.0 - f)
        dgates = torch.cat([di_pre, df_pre, dcell_cand * i * (1.0 - c_in * c_in), do_pre],
                           dim=-1)
        if clip:
            dgates = torch.clamp(dgates, -clip, clip)
        # the clipped dgates as the product's operand (bf16-rounded with a
        # bf16 W_hid); the stored dgates stay unrounded
        operand = dgates if operands is None else operands[:, t]
        dhid = round_operand(operand, w_dtype) @ w_hid.T + (1.0 - m) * dhid_total
        dcell_prev = dcell_cand * f + (1.0 - m) * dcell
        if peep is not None:
            # the peephole routes take the cotangents before the clip
            dcell_prev = dcell_prev + di_pre * peep[0] + df_pre * peep[1]
            dw[0] = dw[0] + di_pre * c_prev
            dw[1] = dw[1] + df_pre * c_prev
            dw[2] = dw[2] + do_pre * c_t
        dcell = dcell_prev
        dgates_all[t] = dgates
    return torch.stack(dgates_all, dim=1), dcell, dhid, dw


def lstm_bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip):
    """The reverse-time backward chain in plain PyTorch.

    g_out, cells, cells_prev (B, T, H), gates_pre (B, T, 4H), mask (B, T),
    all in the recurrence's own time order (already flipped for a backwards
    layer); w_hid (H, 4H).  Returns ``(dgates (B, T, 4H), dcell0 (B, H),
    dhid0 (B, H))``.  dgates are clipped to +-``clip`` after the gate
    backward and before the W_hid^T product, and not clipped when ``clip``
    is 0 (ip_avsr_tpu/ops/lstm.py::_lstm_core_bwd, back_step).  With a
    bfloat16 w_hid the clipped dgates are rounded to bf16 as the product's
    operand (``_lstm_bwd_kernel``); the dgates returned are not rounded."""
    return _bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip, None)[:3]


def lstm_peep_bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask, w_hid,
                              w_ci, w_cf, w_co, clip):
    """The peephole backward chain in plain PyTorch: inputs as
    :func:`lstm_bwd_chain_plain` plus the (H,) peephole vectors, gates_pre
    before the peephole terms.  Returns ``(dgates, dcell0, dhid0, dw_ci,
    dw_cf, dw_co)``, the last three (H,).  The cell carry's peephole routes
    and the three peephole gradients take the gate cotangents before the
    clip; only dgates are clipped (ip_avsr_tpu/ops/lstm.py::
    _lstm_core_peep_bwd, back_step).  The peephole gradients are summed per
    row over time and then over rows, as the kernels sum them."""
    dgates, dcell, dhid, dw = _bwd_chain_plain(g_out, gates_pre, cells, cells_prev, mask,
                                               w_hid, clip, (w_ci, w_cf, w_co))
    return (dgates, dcell, dhid, *(d.sum(dim=0) for d in dw))


@functools.cache
def _lib():
    lib = _build.load("lstm_fwd")
    # w_bf16, B, T, H, units, smem, stream
    chain_tail = [ctypes.c_int] * 5 + [ctypes.c_size_t, ctypes.c_void_p]
    # ..., the outputs[, w_ci, w_cf, w_co], scratch, then the tail
    lib.lstm_fwd_forward.argtypes = [ctypes.c_void_p] * 8 + chain_tail
    lib.lstm_fwd_forward.restype = ctypes.c_int
    lib.lstm_fwd_train_forward.argtypes = [ctypes.c_void_p] * 9 + chain_tail
    lib.lstm_fwd_train_forward.restype = ctypes.c_int
    lib.lstm_fwd_peep_forward.argtypes = [ctypes.c_void_p] * 11 + chain_tail
    lib.lstm_fwd_peep_forward.restype = ctypes.c_int
    lib.lstm_fwd_peep_train_forward.argtypes = [ctypes.c_void_p] * 12 + chain_tail
    lib.lstm_fwd_peep_train_forward.restype = ctypes.c_int
    return lib


class LaunchPlan(NamedTuple):
    """Launch plan of a persistent chain kernel (csrc/lstm_fwd.cu's
    recurrence, csrc/lstm_bwd.cu's backward chain).  ``tiled``: the large-B
    body (``tiled_chain``, whose blocks split the rows as well as the hidden
    units), else the small-B one.  ``units`` hidden units per block on
    ``grid`` unit groups, ``smem_bytes`` of dynamic shared memory per block,
    the live units of the last unit group, and the batch cut into ``chunks``
    launches of at most ``rows`` rows each (:func:`chunk_spans`), for which
    ``smem_bytes`` and ``row_groups`` are sized: the large-B body's
    ceil(rows / :data:`TILED_ROWS`) row groups on the grid's y (a row group
    past a smaller chunk's rows only idles), 1 for the small-B body."""

    tiled: bool
    units: int
    grid: int
    smem_bytes: int
    last_units: int
    rows: int
    chunks: int
    row_groups: int


# the kernels' instantiations (units per block); the float32 products'
# partial sums (8 warps x 32 floats), and the rows and depth of a bf16
# tensor-core tile (mma m16n8k16: 16 rows, k steps of 16)
CHAIN_UNITS = (1, 2, 4, 8)
_RED_BYTES = 8 * 32 * 4
MMA_TILE = 16
# the bf16 backward chain's units per block: the mma tile's n8 columns
MMA_UNITS = 8


def _chain_plan(name, B, H, sm_count, units, chunks, fixed_bytes, carry_floats) -> LaunchPlan:
    """The cooperative launch needs every block resident at once, one block
    per SM, so ``units`` is the smallest of :data:`CHAIN_UNITS` whose grid
    ``ceil(H / units)`` fits ``sm_count`` (or the one given, which must
    fit).  A block keeps its ``units`` units' W_hid and its warps' partial
    sums (``fixed_bytes(units)`` bytes) and ``carry_floats`` per row and
    unit in shared memory.  Rows are independent, so B runs in the fewest
    near-equal chunks whose carries fit beside W_hid (or in ``chunks``, for
    measurement, which must be at least that many and at most B).  Raises
    ``ValueError`` when no instantiation fits the grid or W_hid leaves no
    room for one row's carries under ``_build.SMEM_LIMIT``."""
    if units is None:
        units = next((u for u in CHAIN_UNITS if -(-H // u) <= sm_count), None)
        if units is None:
            raise ValueError(f"{name}: H={H} needs more than {CHAIN_UNITS[-1]} hidden "
                             f"units per block to fit {sm_count} SMs")
    grid = -(-H // units)
    if units not in CHAIN_UNITS or grid > sm_count:
        raise ValueError(f"{name}: {units} units per block at H={H} is not one of "
                         f"{CHAIN_UNITS} with a grid of at most {sm_count} blocks")
    fixed = fixed_bytes(units)
    per_row = 4 * carry_floats * units
    cap = (_build.SMEM_LIMIT - fixed) // per_row
    if cap < 1:
        raise ValueError(f"{name}: H={H} at {units} units per block needs {fixed + per_row} "
                         f"bytes of shared memory per block for one row, above the "
                         f"{_build.SMEM_LIMIT} a block may use")
    need = max(1, -(-B // cap))
    if chunks is None:
        chunks = need
    elif not need <= chunks <= max(B, 1):
        raise ValueError(f"{name}: B={B}, H={H} runs in {need} to {max(B, 1)} chunks "
                         f"of at most {cap} rows, not {chunks}")
    rows = -(-B // chunks)
    return LaunchPlan(False, units, grid, fixed + per_row * rows, H - (grid - 1) * units, rows,
                      chunks, 1)


def fwd_launch_plan(B: int, H: int, sm_count: int, units=None, chunks=None,
                    w_dtype=torch.float32) -> LaunchPlan:
    """Units per block, grid, shared memory and row chunks of the
    recurrence's small-B body (all four instantiations, with W_hid of
    ``w_dtype``) at batch ``B`` and width ``H`` on a card with ``sm_count``
    SMs: the block's 4 * units columns of W_hid (:func:`fwd_w_bytes`), the
    warps' partial sums (:func:`fwd_red_bytes`) and two carries per row and
    unit (cell and hidden state); see :func:`_chain_plan`.  A bf16 W_hid
    takes fewer bytes in the tensor cores' fragment order and more for the
    partial tiles, so one launch holds 6496 rows at H = 500 where float32
    holds 5982."""
    return _chain_plan("recurrence", B, H, sm_count, units, chunks,
                       lambda u: fwd_w_bytes(u, H, w_dtype) + fwd_red_bytes(u, w_dtype),
                       carry_floats=2)


# the large-B body: 16 hidden units by 64 rows a block, in one of two forms
# (csrc/lstm_fwd.cu).  The staged one keeps the block's W_hid columns in
# shared memory, h_{t-1} staged in chunks of TILED_K values of k, each row
# padded to TILED_K_PAD floats, two chunks at a time, each chunk's k cut into
# TILED_SPLIT slices whose partial sums meet in shared memory.  The resident
# one (tiled_resident(H)) keeps them in registers: warp w of TILED_WARPS holds
# W_hid's k slice of tiled_slice_k(H) values, a quarter of it and 8 gate
# columns a lane, over its rows of h_{t-1} staged in chunks of
# TILED_CHUNK_ROWS; shared memory holds the warps' rows of h_{t-1} and
# partial sums, the gate inputs of two steps (x_proj's 4 gates and the mask
# of each of a thread's 4 rows) and the carries, TILED_GATE_IN floats a
# thread
TILED_UNITS = 16
TILED_ROWS = 64
TILED_K = 64
TILED_K_PAD = TILED_K + 4
TILED_SPLIT = 4
TILED_WARPS = 8
TILED_MAX_H = 512
TILED_SLICE_K = TILED_MAX_H // TILED_WARPS
TILED_CHUNK_ROWS = 8
TILED_GATE_IN = 12 * TILED_ROWS * TILED_UNITS // 256
# the smallest batch that takes the large-B body, by width: where it
# overtook the small-B body on an H100 (chip_smoke.tiled_sweep).  At the
# resident widths TILED_RESIDENT_MIN_ROWS (row 1 at H = 500: lost at B = 64,
# won from B = 96); else from H = TILED_WIDE_H, TILED_MIN_ROWS (row 6 at
# H = 250 won at B = 128, lost at 96); below, twice that (at H = 64 and 130
# it tied or lost at B = 128 and won at B = 256).  All are above every round
# of the small-B body (64 rows at 1 unit a block)
TILED_RESIDENT_MIN_ROWS = 96
TILED_MIN_ROWS = 128
TILED_WIDE_H = 250


def tiled_slice_k(H: int) -> int:
    """k of one warp's slice of W_hid in the resident large-B body: H over the
    8 warps in whole groups of 4 (csrc/lstm_fwd.cu::tiled_slice_k)."""
    return -(-H // (4 * TILED_WARPS)) * 4


def tiled_resident(H: int) -> bool:
    """Whether the recurrence's large-B body keeps W_hid in registers at width
    ``H``: where the 8 warps' k slices fill every lane's 128 registers of it
    (H above 384, up to 512) in whole float4 pieces of h (H a multiple of 4)
    (csrc/lstm_fwd.cu::tiled_resident).  Elsewhere the staged body runs; at
    H = 250, 130 and 64 it measured faster on an H100 (chip_smoke.py's
    ``--tiled``, the resident layout's fixed cost a step)."""
    return 3 * TILED_MAX_H // 4 < H <= TILED_MAX_H and H % 4 == 0


def fwd_tiled_smem_bytes(H: int) -> int:
    """Bytes of a large-B block's shared memory (csrc/lstm_fwd.cu::
    tiled_smem_bytes).  Resident: the 8 warps' rows of h_{t-1} (each warp's
    k slice, 64 rows by 64 floats), which the warps' partial sums of the
    block's 64 gate columns overwrite, and the 256 threads' gate inputs and
    carries, the same at every width.  Staged: its 16 units' W_hid columns as
    H rows of 64 floats, padded with zero rows to whole chunks, two staged
    chunks of h_{t-1}, and the k slices' partial sums of the block's 64 rows
    by 64 gate columns."""
    cols = 4 * TILED_UNITS
    if tiled_resident(H):
        return 4 * (TILED_WARPS * TILED_ROWS * cols + TILED_GATE_IN * 256)
    return 4 * (-(-H // TILED_K) * TILED_K * cols + 2 * TILED_ROWS * TILED_K_PAD
                + TILED_SPLIT * TILED_ROWS * cols)


def _tiled_plan(name, B, H, sm_count, w_dtype, units, chunks, smem) -> LaunchPlan:
    """A large-B body's unit groups, row groups and row chunks at batch
    ``B`` and width ``H`` on a card with ``sm_count`` SMs, for blocks of
    ``smem`` bytes of shared memory.  Every block must be resident at once,
    so a launch takes as many row groups of :data:`TILED_ROWS` as fit beside
    the ceil(H / 16) unit groups, and B runs in the fewest near-equal chunks
    of at most that many rows (or in ``chunks``, for measurement, which must
    be at least that many and at most B).  Raises ``ValueError`` for a W_hid
    of ``w_dtype`` other than float32 or ``units`` other than None or
    :data:`TILED_UNITS` (the body has no such instantiation), and when the
    unit groups alone exceed the SMs or a block does not fit
    ``_build.SMEM_LIMIT``."""
    if w_dtype != torch.float32 or units not in (None, TILED_UNITS):
        raise ValueError(f"{name}: float32 W_hid at {TILED_UNITS} units a block only, not "
                         f"{w_dtype} at {units}")
    grid = -(-H // TILED_UNITS)
    if grid > sm_count or smem > _build.SMEM_LIMIT:
        raise ValueError(f"{name}: H={H} needs {grid} blocks of {smem} bytes of shared "
                         f"memory, above the {sm_count} SMs or the {_build.SMEM_LIMIT} bytes "
                         f"a block may use")
    cap = sm_count // grid * TILED_ROWS
    need = max(1, -(-B // cap))
    if chunks is None:
        chunks = need
    elif not need <= chunks <= max(B, 1):
        raise ValueError(f"{name}: B={B}, H={H} runs in {need} to {max(B, 1)} chunks of at "
                         f"most {cap} rows, not {chunks}")
    rows = -(-B // chunks)
    return LaunchPlan(True, TILED_UNITS, grid, smem, H - (grid - 1) * TILED_UNITS, rows, chunks,
                      -(-rows // TILED_ROWS))


def fwd_plan(B: int, H: int, sm_count: int, w_dtype=torch.float32, units=None, chunks=None,
             tiled=None) -> LaunchPlan:
    """The plan :func:`_run_fwd` launches, the one place a recurrence's body
    is chosen.  The large-B body (float32 W_hid, all four instantiations;
    its shared memory :func:`fwd_tiled_smem_bytes`, its row groups and
    chunks :func:`_tiled_plan`) at B at least
    :data:`TILED_RESIDENT_MIN_ROWS` at the widths :func:`tiled_resident`
    takes, else :data:`TILED_MIN_ROWS` (twice that below H =
    :data:`TILED_WIDE_H`), where its unit groups fit the card and its blocks
    the shared memory (H up to 512); a bf16 W_hid keeps its tensor-core body
    at every B.  Else :func:`fwd_launch_plan` (``units`` and ``chunks`` as
    there; forcing ``units`` means the small-B body).  ``tiled`` True or
    False forces the body, for measurement; forced, the large-B body raises
    ``ValueError`` for a bf16 W_hid, other units, or a width that does not
    fit."""
    if tiled is None:
        min_rows = (TILED_RESIDENT_MIN_ROWS if tiled_resident(H)
                    else TILED_MIN_ROWS * (1 if H >= TILED_WIDE_H else 2))
        tiled = (units is None and w_dtype == torch.float32 and B >= min_rows
                 and -(-H // TILED_UNITS) <= sm_count
                 and fwd_tiled_smem_bytes(H) <= _build.SMEM_LIMIT)
    if tiled:
        return _tiled_plan("large-B recurrence", B, H, sm_count, w_dtype, units, chunks,
                           fwd_tiled_smem_bytes(H))
    return fwd_launch_plan(B, H, sm_count, units, chunks, w_dtype)


def fwd_row_floats(units: int) -> int:
    """Floats per k row of a float32 recurrence block's W_hid columns in
    shared memory: 4 * units, padded by 4 above one unit so that
    neighbouring rows' float4 reads hit distinct banks
    (csrc/lstm_fwd.cu::padded_columns)."""
    return 4 if units == 1 else 4 * units + 4


def mma_ksteps(K: int) -> int:
    """k steps of a bf16 tensor-core product of depth ``K``: K padded with
    zeros to a multiple of :data:`MMA_TILE`."""
    return -(-K // MMA_TILE)


def fwd_w_bytes(units: int, H: int, w_dtype=torch.float32) -> int:
    """Bytes of a recurrence block's W_hid columns in shared memory.
    float32: H rows of :func:`fwd_row_floats` floats.  bfloat16: the tensor
    cores' fragment order, 4 * units bf16 values per k with K = H padded to
    a multiple of 16 (csrc/lstm_fwd.cu::mma_w_bytes)."""
    if w_dtype == torch.bfloat16:
        return 2 * 4 * units * MMA_TILE * mma_ksteps(H)
    return 4 * fwd_row_floats(units) * H


def fwd_red_bytes(units: int, w_dtype=torch.float32) -> int:
    """Bytes of a recurrence block's partial sums: float32, 8 warps x 32
    floats; bfloat16, each of the 8 warps' 16-row x 4 * units partial tile
    (csrc/lstm_fwd.cu::mma_red_floats)."""
    if w_dtype == torch.bfloat16:
        return 4 * 8 * MMA_TILE * 4 * units
    return _RED_BYTES


def bwd_launch_plan(B: int, H: int, sm_count: int, units=None, chunks=None,
                    w_dtype=torch.float32) -> LaunchPlan:
    """Units per block, grid, shared memory and row chunks of the backward
    chain's small-B body at batch ``B`` and width ``H`` on a card with
    ``sm_count`` SMs: the block's units rows of W_hid (:func:`bwd_w_bytes`),
    the warps' partial sums (:func:`bwd_red_bytes`) and six carries per row
    and unit (dh_next, dc, the pass-through and three peephole partials);
    see :func:`_chain_plan`.  A bf16 W_hid takes :data:`MMA_UNITS` units per
    block where that grid fits, the units that fill the tensor-core tile's
    8 columns (each block's product costs the same at 2 to 8 units, so
    fewer blocks take less time); one launch then holds 1022 rows at H =
    500 (float32, 4 units: 2077)."""
    if units is None and w_dtype == torch.bfloat16 and -(-H // MMA_UNITS) <= sm_count:
        units = MMA_UNITS
    return _chain_plan("backward chain", B, H, sm_count, units, chunks,
                       lambda u: bwd_w_bytes(u, H, w_dtype) + bwd_red_bytes(u, w_dtype),
                       carry_floats=6)


# the backward chain's large-B body (csrc/lstm_bwd.cu, ``tiled_chain``): the
# recurrence's 16 units by 64 rows a block; W_hid's 16 rows resident
# k-major, dgates_{t+1} staged in chunks of 128 values of k, each row padded
# to 132 floats, two chunks at a time
BWD_TILED_K = 128
BWD_TILED_K_PAD = BWD_TILED_K + 4
# where the backward chain takes its large-B body: from BWD_TILED_MIN_ROWS
# rows at the widths swept, H from BWD_TILED_MIN_H to BWD_TILED_MAX_H, where
# it overtook the small-B body on an H100 (chip_smoke.BWD_TILED_SWEEP: at
# B = 128 it won or tied at H = 64, 130, 250 and 500, at B = 96 it lost);
# at other widths, not measured, the small-B body at every B
BWD_TILED_MIN_ROWS = 128
BWD_TILED_MIN_H = 64
BWD_TILED_MAX_H = 500


def bwd_tiled_smem_bytes(H: int) -> int:
    """Bytes of a backward large-B block's shared memory: its 16 rows of
    W_hid as 4H k rows of 16 floats, padded with zero rows to whole chunks,
    and the staged chunks of dgates_{t+1}, whose space the k slices' partial
    sums take after the last chunk (csrc/lstm_bwd.cu::tiled_smem_bytes)."""
    return 4 * (-(-4 * H // BWD_TILED_K) * BWD_TILED_K * TILED_UNITS
                + 2 * TILED_ROWS * BWD_TILED_K_PAD)


def bwd_plan(B: int, H: int, sm_count: int, w_dtype=torch.float32, units=None, chunks=None,
             tiled=None) -> LaunchPlan:
    """The plan :func:`_run_bwd` launches, the one place a backward chain's
    body is chosen.  The large-B body (float32 W_hid, with or without
    peepholes; its shared memory :func:`bwd_tiled_smem_bytes`, its row
    groups and chunks :func:`_tiled_plan`) at B at least
    :data:`BWD_TILED_MIN_ROWS` and H from :data:`BWD_TILED_MIN_H` to
    :data:`BWD_TILED_MAX_H` where its unit groups fit the card; a bf16 W_hid
    keeps its tensor-core body at every B.  Else :func:`bwd_launch_plan`
    (``units`` and ``chunks`` as there; forcing ``units`` means the small-B
    body).  ``tiled`` True or False forces the body, for measurement;
    forced, the large-B body raises ``ValueError`` for a bf16 W_hid, other
    units, or a width whose blocks do not fit (H above 640)."""
    if tiled is None:
        tiled = (units is None and w_dtype == torch.float32 and B >= BWD_TILED_MIN_ROWS
                 and BWD_TILED_MIN_H <= H <= BWD_TILED_MAX_H
                 and -(-H // TILED_UNITS) <= sm_count)
    if tiled:
        return _tiled_plan("large-B backward chain", B, H, sm_count, w_dtype, units, chunks,
                           bwd_tiled_smem_bytes(H))
    return bwd_launch_plan(B, H, sm_count, units, chunks, w_dtype)


def bwd_w_bytes(units: int, H: int, w_dtype=torch.float32) -> int:
    """Bytes of a backward-chain block's W_hid rows in shared memory:
    float32, units rows of 4H floats; bfloat16, the tensor cores' fragment
    order, units x 4H bf16 values with K = 4H padded to a multiple of 16
    (csrc/lstm_bwd.cu::smem_bytes)."""
    if w_dtype == torch.bfloat16:
        return 2 * units * MMA_TILE * mma_ksteps(4 * H)
    return 16 * units * H


def bwd_red_bytes(units: int, w_dtype=torch.float32) -> int:
    """Bytes of a backward-chain block's partial sums: float32, 8 warps x
    32 floats; bfloat16, each of the 8 warps' 16-row x units partial tile
    (csrc/lstm_bwd.cu::mma_red_floats)."""
    if w_dtype == torch.bfloat16:
        return 4 * 8 * MMA_TILE * units
    return _RED_BYTES


def chunk_spans(B: int, chunks: int) -> list:
    """Rows [0, B) as ``chunks`` consecutive (b0, b1) spans whose sizes differ
    by at most one, the larger ones last."""
    return [(i * B // chunks, (i + 1) * B // chunks) for i in range(chunks)]


def map_chunks(launch, chunks: int, *batched) -> list:
    """``launch(*views)`` for each span of :func:`chunk_spans`, in order,
    where ``views`` are rows [b0, b1) of each tensor of ``batched`` (all
    batch-major with B rows, so each view is one contiguous span at an
    offset: no copy).  Returns the calls' results in order."""
    spans = chunk_spans(batched[0].shape[0], chunks)
    return [launch(*(a[b0:b1] for a in batched)) for b0, b1 in spans]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _bwd_lib():
    lib = _build.load("lstm_bwd")
    # clip, w_bf16, B, T, H, units, row_groups, smem, stream
    tail = [ctypes.c_float] + [ctypes.c_int] * 6 + [ctypes.c_size_t, ctypes.c_void_p]
    # ..., dgates, dcell0, dhid0[, dw], scratch, then the tail
    lib.lstm_bwd_chain.argtypes = [ctypes.c_void_p] * 10 + tail
    lib.lstm_bwd_chain.restype = ctypes.c_int
    lib.lstm_bwd_peep_chain.argtypes = [ctypes.c_void_p] * 14 + tail
    lib.lstm_bwd_peep_chain.restype = ctypes.c_int
    return lib


def _check_cuda(name, args, shapes, w_hid=None):
    """Raise unless ``args`` are contiguous tensors on one CUDA device with
    the ``shapes`` given (name -> (tensor, shape)), all float32 but
    ``w_hid`` (one of ``args``), which may also be bfloat16 (the kernels'
    bf16 instantiations).  The dtypes are checked first, so any other W_hid
    dtype, or a bf16 tensor anywhere else, raises ``TypeError`` wherever the
    tensors lie."""
    if w_hid is not None and w_hid.dtype not in W_DTYPES:
        raise TypeError(f"{name} kernel takes a w_hid of {W_DTYPES}, got {w_hid.dtype}")
    if any(a.dtype != torch.float32 for a in args if a is not w_hid):
        raise TypeError(f"{name} kernel takes float32 inputs besides w_hid, got "
                        f"{[a.dtype for a in args]}")
    dev = args[0].device
    if any(a.device != dev for a in args) or dev.type != "cuda":
        raise ValueError(f"{name}: inputs must all be on one CUDA device (or all "
                         f"on the CPU), got {[str(a.device) for a in args]}")
    if any(0 in a.shape for a in args):
        raise ValueError(f"{name}: empty input {[tuple(a.shape) for a in args]}")
    for arg, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got {tuple(a.shape)}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def _peep_shapes(peep, H):
    return {name: (v, (H,)) for name, v in zip(("w_ci", "w_cf", "w_co"), peep)}


def _outputs(name, args, w_hid, outs, shapes) -> list:
    """Fresh float32 output tensors of ``shapes`` on the inputs' device, or
    ``outs`` (given for measurement) checked against them."""
    if outs is None:
        return [torch.empty(s, dtype=torch.float32, device=args[0].device) for s in shapes]
    if len(outs) != len(shapes):
        raise ValueError(f"{name}: expected {len(shapes)} output tensors, got {len(outs)}")
    _check_cuda(name, (*args, *outs), {f"out {i}": (o, s)
                                       for i, (o, s) in enumerate(zip(outs, shapes))}, w_hid)
    return list(outs)


def _run_fwd(name, args, train, peep=(), units=None, chunks=None, outs=None, state=False,
             tiled=None, counter=None):
    """Check the inputs and launch csrc/lstm_fwd.cu's inference entry point
    (returns hids, or with ``state`` the tuple (hids, cell_T), the final
    cell (B, H) that the kernel writes after its last step) or its training
    one (returns hids, cells, gates), with peepholes when ``peep`` holds
    (w_ci, w_cf, w_co): one cooperative launch per row chunk planned by
    :func:`fwd_plan` (the large-B body or the small-B one, chosen from W_hid's
    dtype and B), each writing its rows of every output.  ``counter``, when
    given, counts the call (:func:`_count`).  For measurement, ``units`` and
    ``chunks`` force the plan's units per block and row chunks, ``tiled``
    forces the body, and ``outs`` gives the output tensors to write
    (contiguous float32 of the output shapes, for example NaN-filled, so a
    value the kernel does not write shows)."""
    x_proj, w_hid, mask, cell0, hid0 = args
    if x_proj.dim() != 3 or w_hid.dim() != 2:
        raise ValueError(f"{name}: x_proj must be (B, T, 4H) and w_hid (H, 4H), got "
                         f"{tuple(x_proj.shape)} and {tuple(w_hid.shape)}")
    B, T, _ = x_proj.shape
    H = w_hid.shape[0]
    _check_cuda(name, (*args, *peep), {
        "x_proj": (x_proj, (B, T, 4 * H)), "w_hid": (w_hid, (H, 4 * H)),
        "mask": (mask, (B, T)), "cell0": (cell0, (B, H)), "hid0": (hid0, (B, H)),
        **_peep_shapes(peep, H)}, w_hid)
    dev = x_proj.device
    plan = fwd_plan(B, H, _sm_count(dev.index), w_hid.dtype, units, chunks, tiled)
    if plan.tiled and tiled_resident(H) and hid0.data_ptr() % 16:
        # the resident body reads h_{t-1} in float4 pieces: hid0 too
        hid0 = hid0.clone()
    outs = _outputs(name, args, w_hid, outs,
                    [(B, T, H), (B, T, H), (B, T, 4 * H)] if train
                    else [(B, T, H), (B, H)] if state else [(B, T, H)])
    lib = _lib()
    if peep:
        entry = lib.lstm_fwd_peep_train_forward if train else lib.lstm_fwd_peep_forward
    else:
        entry = lib.lstm_fwd_train_forward if train else lib.lstm_fwd_forward
    stream = torch.cuda.current_stream(dev).cuda_stream
    w_bf16 = int(w_hid.dtype == torch.bfloat16)
    # the bf16 product's operand: h of the last two steps rounded to bf16,
    # (2, rows, H padded to a multiple of 16), reused by the chunks in turn
    # on the stream (held here until the launches are queued)
    operand = (torch.empty(2 * plan.rows * MMA_TILE * mma_ksteps(H), dtype=torch.bfloat16,
                           device=dev) if w_bf16 else None)
    scratch = None if operand is None else operand.data_ptr()

    def launch(x_c, mask_c, cell0_c, hid0_c, *outs_c):
        ptrs = [o.data_ptr() for o in outs_c]
        if not (train or state):
            ptrs.append(None)  # no cell_last
        code = entry(x_c.data_ptr(), w_hid.data_ptr(), mask_c.data_ptr(), cell0_c.data_ptr(),
                     hid0_c.data_ptr(), *ptrs, *(v.data_ptr() for v in peep), scratch, w_bf16,
                     x_c.shape[0], T, H, plan.units, plan.smem_bytes, stream)
        _build.check(lib, "lstm_fwd", code)

    # the launch and cudaFuncSetAttribute act on the host thread's current
    # device, which need not be the tensors' card
    with torch.cuda.device(dev):
        map_chunks(launch, plan.chunks, x_proj, mask, cell0, hid0, *outs)
    if counter is not None:
        _count(counter, w_hid, plan.tiled)
    return tuple(outs) if train or state else outs[0]


def _on_cpu(args) -> bool:
    return all(a.device.type == "cpu" for a in args)


def _count(counter, w_hid, tiled=False) -> None:
    """One launch of ``counter``'s row: its float32 instantiation counts in
    ``counter.launches``, its bf16 one (a bf16 W_hid) in
    ``counter.launches_bf16``; a call that took the large-B body (``tiled``)
    also counts in ``counter.launches_tiled``."""
    if w_hid.dtype == torch.bfloat16:
        counter.launches_bf16 += 1
    else:
        counter.launches += 1
    if tiled:
        counter.launches_tiled += 1


_OP_ARGS = "Tensor x_proj, Tensor w_hid, Tensor mask, Tensor cell0, Tensor hid0"
# the operators' registrations: plain ``Library`` registration, which adds
# no Python layer to each call
_LIB = torch.library.Library("ip_avsr", "FRAGMENT")


def _recurrence_op(name, plain, counter, peep, state):
    """Register the inference recurrence ``ip_avsr::<name>`` as an operator
    that ``torch.export`` records as one opaque node: ``plain`` on the CPU,
    :func:`_run_fwd`'s launch on CUDA (counted in ``counter.launches``, or
    ``counter.launches_bf16`` for a bf16 W_hid, when it runs, so a run of an
    exported program counts as a live call does),
    and a fake that gives the output shapes only.  The launch plan is made
    inside the CUDA implementation from the concrete B, so a symbolic batch
    axis needs no gate.  The schema has no alias annotations: the outputs
    are fresh tensors and nothing is mutated."""
    _LIB.define(f"{name}({_OP_ARGS}{', Tensor w_ci, Tensor w_cf, Tensor w_co' if peep else ''})"
                f" -> {'(Tensor, Tensor)' if state else 'Tensor'}")

    def _cuda(x_proj, w_hid, mask, cell0, hid0, *peep_args):
        return _run_fwd(name, (x_proj, w_hid, mask, cell0, hid0), train=False, peep=peep_args,
                        state=state, counter=counter)

    def _fake(x_proj, w_hid, *_):
        B, T, H = x_proj.shape[0], x_proj.shape[1], w_hid.shape[0]
        hids = x_proj.new_empty((B, T, H))
        return (hids, x_proj.new_empty((B, H))) if state else hids

    _LIB.impl(name, plain, "CPU")
    _LIB.impl(name, _cuda, "CUDA")
    torch.library.register_fake(f"ip_avsr::{name}", _fake, lib=_LIB)


def lstm_recurrence(x_proj, w_hid, mask, cell0, hid0):
    """The masked recurrence: (B, T, 4H), (H, 4H), (B, T), (B, H), (B, H) ->
    (B, T, H), float32 (w_hid float32 or bfloat16); the operator
    ``ip_avsr::lstm_recurrence``.

    CPU tensors take :func:`lstm_recurrence_plain`; CUDA tensors launch the
    kernel (one cooperative launch per row chunk, the call counted once in
    ``lstm_recurrence.launches``) or raise."""
    return torch.ops.ip_avsr.lstm_recurrence(x_proj, w_hid, mask, cell0, hid0)


lstm_recurrence.launches = 0
lstm_recurrence.launches_bf16 = 0
lstm_recurrence.launches_tiled = 0


def lstm_recurrence_state(x_proj, w_hid, mask, cell0, hid0):
    """The masked recurrence from a per-row initial state, giving back the
    final one: inputs as :func:`lstm_recurrence`, returns ``(hids, cell_T)``
    as :func:`lstm_recurrence_state_plain` does; hid_T is ``hids[:, -1]``.
    The operator ``ip_avsr::lstm_recurrence_state``.

    CPU tensors take the plain version; CUDA tensors launch the same kernel
    as :func:`lstm_recurrence` with its final-cell output (one cooperative
    launch per row chunk, the call counted once in
    ``lstm_recurrence.launches``: it is that table row) or raise."""
    return torch.ops.ip_avsr.lstm_recurrence_state(x_proj, w_hid, mask, cell0, hid0)


def lstm_recurrence_train(x_proj, w_hid, mask, cell0, hid0):
    """The recurrence with its training residuals: inputs as
    :func:`lstm_recurrence`, returns ``(hids, cells, gates_pre)`` as
    :func:`lstm_recurrence_train_plain` does.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    residual-emitting instantiation (one cooperative launch per row chunk,
    the call counted once in ``lstm_recurrence_train.launches``) or raise."""
    args = (x_proj, w_hid, mask, cell0, hid0)
    if _on_cpu(args):
        return lstm_recurrence_train_plain(*args)
    return _run_fwd("lstm_recurrence_train", args, train=True, counter=lstm_recurrence_train)


lstm_recurrence_train.launches = 0
lstm_recurrence_train.launches_bf16 = 0
lstm_recurrence_train.launches_tiled = 0


def lstm_peep_recurrence(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence: inputs as :func:`lstm_recurrence` plus the
    (H,) peephole vectors; returns (B, T, H), float32 (w_hid float32 or
    bfloat16); the operator
    ``ip_avsr::lstm_peep_recurrence``.

    CPU tensors take :func:`lstm_peep_recurrence_plain`; CUDA tensors launch
    the kernel's peephole instantiation (one cooperative launch per row
    chunk, the call counted once in ``lstm_peep_recurrence.launches``) or
    raise."""
    return torch.ops.ip_avsr.lstm_peep_recurrence(x_proj, w_hid, mask, cell0, hid0,
                                                  w_ci, w_cf, w_co)


lstm_peep_recurrence.launches = 0
lstm_peep_recurrence.launches_bf16 = 0
lstm_peep_recurrence.launches_tiled = 0


def lstm_peep_recurrence_state(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence from a per-row initial state, giving back the
    final one: inputs as :func:`lstm_peep_recurrence`, returns ``(hids,
    cell_T)`` as :func:`lstm_peep_recurrence_state_plain` does; the operator
    ``ip_avsr::lstm_peep_recurrence_state``.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    peephole instantiation with its final-cell output (one cooperative
    launch per row chunk, the call counted once in
    ``lstm_peep_recurrence.launches``) or raise."""
    return torch.ops.ip_avsr.lstm_peep_recurrence_state(x_proj, w_hid, mask, cell0, hid0,
                                                        w_ci, w_cf, w_co)


_recurrence_op("lstm_recurrence", lstm_recurrence_plain, lstm_recurrence, False, False)
_recurrence_op("lstm_recurrence_state", lstm_recurrence_state_plain, lstm_recurrence, False,
               True)
_recurrence_op("lstm_peep_recurrence", lstm_peep_recurrence_plain, lstm_peep_recurrence, True,
               False)
_recurrence_op("lstm_peep_recurrence_state", lstm_peep_recurrence_state_plain,
               lstm_peep_recurrence, True, True)


def lstm_peep_recurrence_train(x_proj, w_hid, mask, cell0, hid0, w_ci, w_cf, w_co):
    """The peephole recurrence with its training residuals: inputs as
    :func:`lstm_peep_recurrence`, returns ``(hids, cells, gates_pre)`` as
    :func:`lstm_peep_recurrence_train_plain` does (gates before the
    peephole terms).

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    residual-emitting peephole instantiation (one cooperative launch per row
    chunk, the call counted once in ``lstm_peep_recurrence_train.launches``)
    or raise."""
    args = (x_proj, w_hid, mask, cell0, hid0)
    peep = (w_ci, w_cf, w_co)
    if _on_cpu((*args, *peep)):
        return lstm_peep_recurrence_train_plain(*args, *peep)
    return _run_fwd("lstm_peep_recurrence_train", args, train=True, peep=peep,
                    counter=lstm_peep_recurrence_train)


lstm_peep_recurrence_train.launches = 0
lstm_peep_recurrence_train.launches_bf16 = 0
lstm_peep_recurrence_train.launches_tiled = 0


def _run_bwd(name, args, clip, peep=(), units=None, chunks=None, outs=None, tiled=None,
             counter=None):
    """Check the inputs and launch csrc/lstm_bwd.cu's chain, one cooperative
    launch per row chunk planned by :func:`bwd_plan` (the large-B body or
    the small-B one, chosen from W_hid's dtype, B and H): returns ``(dgates,
    dcell0, dhid0)``, and with ``peep`` also the three (H,) peephole
    gradients, which the kernel reduces over a chunk's rows itself; the
    chunks' partial sums are added in chunk order.  ``counter``, when given,
    counts the call (:func:`_count`).  For measurement, ``units`` and
    ``chunks`` force the plan's units per block and row chunks, ``tiled``
    forces the body, and ``outs`` gives dgates, dcell0 and dhid0 to write
    (contiguous float32 of the output shapes, for example NaN-filled, so a
    value the kernel does not write shows; the chunks' peephole gradients
    then start NaN-filled too)."""
    g_out, gates_pre, cells, cells_prev, mask, w_hid = args
    if cells.dim() != 3:
        raise ValueError(f"{name}: cells must be (B, T, H), got {tuple(cells.shape)}")
    B, T, H = cells.shape
    _check_cuda(name, (*args, *peep), {
        "g_out": (g_out, (B, T, H)), "gates_pre": (gates_pre, (B, T, 4 * H)),
        "cells_prev": (cells_prev, (B, T, H)), "mask": (mask, (B, T)),
        "w_hid": (w_hid, (H, 4 * H)), **_peep_shapes(peep, H)}, w_hid)
    dev = cells.device
    plan = bwd_plan(B, H, _sm_count(dev.index), w_hid.dtype, units, chunks, tiled)
    nan_dw = outs is not None
    outs = _outputs(name, args, w_hid, outs, [(B, T, 4 * H), (B, H), (B, H)])
    lib = _bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    w_bf16 = int(w_hid.dtype == torch.bfloat16)
    # the scratch the chunks use in turn on the stream (held here until the
    # launches are queued): for a bf16 W the product's operand, the clipped
    # dgates of the last two steps rounded to bf16, (2, rows, 4H); for the
    # peephole large-B body each row group's dw sums, (row_groups, 3, H)
    if w_bf16:
        scratch = torch.empty(2 * plan.rows * 4 * H, dtype=torch.bfloat16, device=dev)
    elif plan.tiled and peep:
        scratch = torch.empty((plan.row_groups, 3, H), dtype=torch.float32, device=dev)
    else:
        scratch = None
    scratch_ptr = None if scratch is None else scratch.data_ptr()

    def launch(*views):
        ptrs = [a.data_ptr() for a in views]
        tail = (clip, w_bf16, views[0].shape[0], T, H, plan.units, plan.row_groups,
                plan.smem_bytes, stream)
        if peep:
            dw = (torch.full((3, H), float("nan"), dtype=torch.float32, device=dev) if nan_dw
                  else torch.empty((3, H), dtype=torch.float32, device=dev))
            code = lib.lstm_bwd_peep_chain(*ptrs[:5], w_hid.data_ptr(),
                                           *(v.data_ptr() for v in peep), *ptrs[5:],
                                           dw.data_ptr(), scratch_ptr, *tail)
        else:
            dw = None
            code = lib.lstm_bwd_chain(*ptrs[:5], w_hid.data_ptr(), *ptrs[5:], scratch_ptr,
                                      *tail)
        _build.check(lib, "lstm_bwd", code)
        return dw

    with torch.cuda.device(dev):  # the launch's device, as in _run_fwd
        dws = map_chunks(launch, plan.chunks, g_out, gates_pre, cells, cells_prev, mask, *outs)
    if counter is not None:
        _count(counter, w_hid, plan.tiled)
    if not peep:
        return tuple(outs)
    dw = dws[0]
    for part in dws[1:]:
        dw = dw + part
    return (*outs, *dw)


def _check_clip(name, clip) -> float:
    clip = float(clip or 0.0)
    if clip < 0:
        raise ValueError(f"{name}: clip must be >= 0, got {clip}")
    return clip


def lstm_bwd_chain(g_out, gates_pre, cells, cells_prev, mask, w_hid, clip):
    """The reverse-time backward chain: inputs and outputs as
    :func:`lstm_bwd_chain_plain`, float32 (w_hid float32 or bfloat16),
    ``clip >= 0``.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    cooperative launch per row chunk, the call counted once in
    ``lstm_bwd_chain.launches``, and in ``.launches_tiled`` when it took the
    large-B body) or raise."""
    args = (g_out, gates_pre, cells, cells_prev, mask, w_hid)
    clip = _check_clip("lstm_bwd_chain", clip)
    if _on_cpu(args):
        return lstm_bwd_chain_plain(*args, clip)
    return _run_bwd("lstm_bwd_chain", args, clip, counter=lstm_bwd_chain)


lstm_bwd_chain.launches = 0
lstm_bwd_chain.launches_bf16 = 0
lstm_bwd_chain.launches_tiled = 0


def lstm_peep_bwd_chain(g_out, gates_pre, cells, cells_prev, mask, w_hid, w_ci, w_cf, w_co,
                        clip):
    """The peephole backward chain: inputs and outputs as
    :func:`lstm_peep_bwd_chain_plain`, float32 (w_hid float32 or
    bfloat16), ``clip >= 0``.

    CPU tensors take the plain version; CUDA tensors launch the kernel's
    peephole instantiation (one cooperative launch per row chunk, which also
    reduces the peephole gradients over the chunk's rows; the call counted
    once in ``lstm_peep_bwd_chain.launches``, and in ``.launches_tiled``
    when it took the large-B body) or raise."""
    args = (g_out, gates_pre, cells, cells_prev, mask, w_hid)
    peep = (w_ci, w_cf, w_co)
    clip = _check_clip("lstm_peep_bwd_chain", clip)
    if _on_cpu((*args, *peep)):
        return lstm_peep_bwd_chain_plain(*args, *peep, clip)
    return _run_bwd("lstm_peep_bwd_chain", args, clip, peep, counter=lstm_peep_bwd_chain)


lstm_peep_bwd_chain.launches = 0
lstm_peep_bwd_chain.launches_bf16 = 0
lstm_peep_bwd_chain.launches_tiled = 0
