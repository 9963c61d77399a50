"""Masked LSTM / BLSTM with Lasagne-compatible semantics.

Mirrors ip_avsr_tpu/ops/lstm.py (``grad_clip``, ``init_lstm_params``,
``init_blstm_params``, ``lstm_forward`` with its streaming options
``initial_state`` and ``return_state``, ``_lstm_prep``, the custom-VJP cores
``_lstm_core`` and ``_lstm_core_peep`` with their primals, forwards and
backwards and their residual levers ``remat`` and ``residual_dtype``,
``lstm_forward_grouped``, ``can_group_lstms``, ``blstm_forward``,
``last_valid_step``, ``last_valid_step_gathered``,
``lstm_params_hidden_size``):

  * gate stacking order (ingate, forgetgate, cell, outgate) in ``w_in (D, 4H)``,
    ``w_hid (H, 4H)``, ``b (4H,)``; sigmoid gates, tanh cell input and output;
  * learned initial state ``cell_init``/``hid_init`` (1, H), broadcast over
    the batch;
  * masked steps carry the previous hidden AND cell state unchanged;
  * backwards layers flip input and mask along time, run, and flip the output
    back, so the padded tail of a backwards layer holds its learned initial
    state;
  * Lasagne ``grad_clipping``: the gradients of the stacked gate
    pre-activations are clipped elementwise to +-5 in the backward pass
    (forward values untouched);
  * optional peepholes (the reference default): the (H,) vectors
    ``w_cell_to_ingate``/``w_cell_to_forgetgate`` weight c_{t-1} into the in
    and forget gates and ``w_cell_to_outgate`` the new cell into the out
    gate, added after the clip node, so their gradients and the cell
    carry's peephole routes take unclipped cotangents.

The input projection for all gates and timesteps is one (B*T, D) x (D, 4H)
``torch.matmul`` hoisted out of the recurrence.  Without a gradient to take,
the recurrence goes through ``ops/kernels/lstm.lstm_recurrence`` and stores
no residuals.  With one, :class:`_LSTMCore` runs
``lstm_recurrence_train`` (which also returns the cells and pre-activation
gates) and, in its backward, the reverse-time chain ``lstm_bwd_chain``
followed by the batched weight and input gradients as ``torch.matmul`` over
all (B, T) rows.  Peephole layers take the ``lstm_peep_*`` twins of those
kernels, through the same Function.  Each kernel wrapper runs its CUDA
kernel on the card and its plain loop on the CPU, so the CPU takes the same
Function.

Under ``remat`` the training recurrence still writes its gates (the
transient buffer dies with the forward call) and the backward rebuilds them
before the chain; with ``residual_dtype`` the stacks are cast after the
kernel has written float32.  The grouped forward runs its members one after
another, so a group of G costs G launches of the same rows.

Under ``matmul_dtype="bfloat16"`` every product takes bf16-rounded operands
and sums in float32, as the JAX package's ``matmul_dtype`` does: the input
projection and the batched gradients as float32 ``torch.matmul`` of rounded
operands (a bf16 x bf16 product is exact in float32, so this is the bf16
product with float32 accumulation), the recurrences and chains through the
kernels' bf16 instantiations, which take W_hid as bf16.

A streaming caller passes a per-row ``initial_state`` (cell, hid) and asks
for the final one with ``return_state``.  Without a gradient the
recurrence then runs ``lstm_recurrence_state`` (the same kernel, which also
writes the final cell); with one, the same Functions take the per-row
state, return the last step of their cells residual as cell_T, and give
the initial state its per-row gradients.
"""

from __future__ import annotations

from typing import Optional

import torch

from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops.kernels.lstm import (lstm_bwd_chain, lstm_peep_bwd_chain,
                                            lstm_peep_recurrence, lstm_peep_recurrence_state,
                                            lstm_peep_recurrence_train, lstm_recurrence,
                                            lstm_recurrence_state, lstm_recurrence_train,
                                            round_operand)

_PEEPHOLE_KEYS = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.bound = bound
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -ctx.bound, ctx.bound), None


def grad_clip(x: torch.Tensor, bound: float) -> torch.Tensor:
    """The identity whose backward clamps the incoming gradient to
    +-``bound`` elementwise (``theano.gradient.grad_clip``)."""
    return _GradClip.apply(x, float(bound))


def init_lstm_params(generator, input_dim: int, hidden: int,
                     w_init=inits.glorot_uniform, use_peepholes: bool = False,
                     peephole_init=inits.normal(0.1), dtype=torch.float32) -> dict:
    """One LSTM layer's parameters on the CPU: each gate's block is an
    independent draw, stacked (the JAX package's layout); with peepholes,
    three (H,) vectors drawn from ``peephole_init`` after the eight gate
    blocks."""
    w_in = torch.cat([w_init(generator, (input_dim, hidden), dtype) for _ in range(4)], dim=1)
    w_hid = torch.cat([w_init(generator, (hidden, hidden), dtype) for _ in range(4)], dim=1)
    params = {
        "w_in": w_in,
        "w_hid": w_hid,
        "b": torch.zeros(4 * hidden, dtype=dtype),
        "cell_init": torch.zeros(1, hidden, dtype=dtype),
        "hid_init": torch.zeros(1, hidden, dtype=dtype),
    }
    if use_peepholes:
        for key in _PEEPHOLE_KEYS:
            params[key] = peephole_init(generator, (hidden,), dtype)
    return params


def init_blstm_params(generator, input_dim: int, hidden: int,
                      w_init=inits.glorot_uniform, use_peepholes: bool = False,
                      dtype=torch.float32) -> tuple:
    """``(fwd, bwd)`` parameters of a bidirectional layer, drawn in turn."""
    return tuple(init_lstm_params(generator, input_dim, hidden, w_init, use_peepholes,
                                  dtype=dtype) for _ in range(2))


def lstm_params_hidden_size(params) -> int:
    return params["w_hid"].shape[0]


def matmul_dtype_of(matmul_dtype) -> Optional[torch.dtype]:
    """The products' operand dtype: None (float32 operands) for None and
    float32, ``torch.bfloat16`` for bfloat16 (a name or a torch dtype);
    ``ValueError`` for any other, which no kernel instantiation takes."""
    if matmul_dtype is None:
        return None
    dtype = matmul_dtype if isinstance(matmul_dtype, torch.dtype) else getattr(
        torch, str(matmul_dtype), None)
    if dtype == torch.float32:
        return None
    if dtype != torch.bfloat16:
        raise ValueError(f"matmul_dtype must be None, float32 or bfloat16, got "
                         f"{matmul_dtype!r}")
    return dtype


def _w_mm(w_hid, mm):
    """W_hid as the recurrence kernels take it: bf16 under a bf16
    ``matmul_dtype`` (a bf16 W_hid, as a bf16-weight artifact holds it,
    stays bf16 either way), contiguous."""
    return (w_hid.to(mm) if mm is not None else w_hid).contiguous()


def _prep(w_in, b, cell_init, hid_init, x, mask, backwards, mm=None):
    """The prologue of ip_avsr_tpu/ops/lstm.py::_lstm_prep: time flip, the
    hoisted input projection plus bias, initial states broadcast from (1, H)
    (or taken as they are when (B, H)).  Returns (x, mask, x_proj, cell0,
    hid0) with x and mask flipped when ``backwards``.  With ``mm`` bfloat16
    the projection's operands x and W_in are rounded to bf16 and the
    product sums in float32 (x_proj stays float32)."""
    B, T, D = x.shape
    H = cell_init.shape[-1]
    if backwards:
        x = torch.flip(x, dims=(1,))
        mask = torch.flip(mask, dims=(1,))
    x_proj = torch.matmul(round_operand(x, mm).reshape(B * T, D),
                          round_operand(w_in, mm)).reshape(B, T, 4 * H) + b
    cell0 = cell_init.expand(B, H).contiguous()
    hid0 = hid_init.expand(B, H).contiguous()
    return x.contiguous(), mask.contiguous(), x_proj, cell0, hid0


def _batched_grads(need, w_in, x, hids, hid0, dgates, dcell0, dhid0, backwards, per_row,
                   mm=None):
    """The weight and input gradients after a backward chain, as single
    products over all (B, T) rows: ``(dw_in, dw_hid, db, dcell_init,
    dhid_init, dx)``, each None where ``need`` (six booleans in that order)
    says it is not wanted.  The initial state's gradients are the chain's
    per row when ``per_row`` (a (B, H) state), else summed over the rows
    (the learned (1, H) ``cell_init``/``hid_init``).  With ``mm`` bfloat16
    every product's operands are rounded to bf16 and the products sum in
    float32, as ip_avsr_tpu/ops/lstm.py:559-568 computes dW_hid = bf16(
    hids_prev)^T bf16(dg), dW_in = bf16(x)^T bf16(dg) and dx = bf16(dg)
    bf16(W_in)^T; db stays the float32 sum of the unrounded dg."""
    B, T, H = hids.shape
    D = x.shape[-1]
    dg = dgates.reshape(B * T, 4 * H)
    dg_mm = round_operand(dg, mm)
    dw_in = dw_hid = db = dcell_init = dhid_init = dx = None
    if need[0]:
        dw_in = round_operand(x.reshape(B * T, D), mm).T @ dg_mm
    if need[1]:
        hids_prev = torch.cat([hid0[:, None], hids[:, :-1]], dim=1)
        dw_hid = round_operand(hids_prev.reshape(B * T, H), mm).T @ dg_mm
    if need[2]:
        db = dg.sum(dim=0)
    if need[3]:
        dcell_init = dcell0 if per_row else dcell0.sum(dim=0, keepdim=True)
    if need[4]:
        dhid_init = dhid0 if per_row else dhid0.sum(dim=0, keepdim=True)
    if need[5]:
        dx = (dg_mm @ round_operand(w_in, mm).T).reshape(B, T, D)
        if backwards:
            dx = torch.flip(dx, dims=(1,))
    return dw_in, dw_hid, db, dcell_init, dhid_init, dx


# a gate pre-activation that saturates sigmoid to exactly 0 or 1 in float32
_SATURATE = 1e4


def _chain_inputs(ctx, g_out, g_state, hids, gates_pre, cells, cell0, mask):
    """The backward chain's inputs ``(g_out, gates_pre, cells, cells_prev,
    mask)`` in the recurrence's time order.

    ``g_state`` holds the upstream gradient of cell_T when the forward
    returned the state and cell_T is used.  The chain starts its cell carry
    at zero, so that gradient enters through one pass-through step appended
    at t = T: valid, its gates saturated to i = 0, f = o = 1 with c = 0,
    its cell 0 and its upstream gradient the one of cell_T.  Its gate
    cotangents are then exactly 0 and it hands the chain a dcell of exactly
    that gradient (o (1 - tanh(0)^2) = 1, f = 1), whatever the peepholes;
    the caller drops its dgates."""
    if g_out is None:
        g_out = torch.zeros_like(hids)
    if ctx.backwards:
        g_out = torch.flip(g_out, dims=(1,))
    cells_prev = torch.cat([cell0[:, None], cells[:, :-1]], dim=1)
    g_cell = g_state[0] if g_state else None
    if g_cell is None:
        return g_out.contiguous(), gates_pre, cells, cells_prev, mask
    B, _, H = cells.shape
    sat = torch.tensor([-_SATURATE, _SATURATE, 0.0, _SATURATE], dtype=cells.dtype,
                       device=cells.device).repeat_interleave(H)
    return (torch.cat([g_out, g_cell[:, None]], dim=1).contiguous(),
            torch.cat([gates_pre, sat.expand(B, 1, 4 * H)], dim=1),
            torch.cat([cells, torch.zeros_like(cells[:, :1])], dim=1),
            torch.cat([cells_prev, cells[:, -1:]], dim=1),
            torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1))


def _outputs(ctx, hids, cells, return_state):
    ctx.set_materialize_grads(False)
    out = torch.flip(hids, dims=(1,)) if ctx.backwards else hids
    return (out, cells[:, -1].clone()) if return_state else out


def _save_residuals(ctx, hids, cells, gates_pre, remat, residual_dtype):
    """The per-step residual stacks a core keeps for its backward: without
    ``remat`` all three, with it hids and cells alone (the gates are rebuilt
    in the backward); with ``residual_dtype`` each stored in that dtype,
    cast after the kernel has written float32.  ``hids`` is the layer's
    output: rounded, the stored copy is a new tensor and the output stays
    float32."""
    ctx.remat, ctx.residual_dtype = remat, residual_dtype
    stacks = (hids, cells) if remat else (hids, cells, gates_pre)
    if residual_dtype is not None:
        stacks = tuple(t.to(residual_dtype) for t in stacks)
    return stacks


def _load_residuals(ctx, x, w_in, w_hid, b, hid0, stacks):
    """``(hids, cells, gates_pre)`` in float32 for the backward: the stored
    stacks upcast, and under ``remat`` the pre-activation gates rebuilt as
    ``x W_in + b + hids_prev W_hid`` with two products over all (B, T)
    rows, ``hids_prev`` being ``hid0`` then the stored (rounded) hids
    shifted by one step; under a bf16 ``ctx.mm`` both products take
    bf16-rounded operands and sum in float32 (ip_avsr_tpu/ops/lstm.py:
    497-503)."""
    stacks = tuple(t.to(torch.float32) for t in stacks)
    if not ctx.remat:
        return stacks
    hids, cells = stacks
    B, T, H = hids.shape
    D = x.shape[-1]
    mm = ctx.mm
    hids_prev = torch.cat([hid0[:, None], hids[:, :-1]], dim=1)
    xp = torch.matmul(round_operand(x.reshape(B * T, D), mm),
                      round_operand(w_in, mm)).reshape(B, T, 4 * H) + b
    rec = torch.matmul(round_operand(hids_prev.reshape(B * T, H), mm),
                       round_operand(w_hid, mm)).reshape(B, T, 4 * H)
    return hids, cells, xp + rec


class _LSTMCore(torch.autograd.Function):
    """The training core: counterpart of ``_lstm_core_fwd`` /
    ``_lstm_core_bwd`` (ip_avsr_tpu/ops/lstm.py:375-588) and, with the three
    (H,) peephole vectors as ``peep``, of ``_lstm_core_peep_fwd`` /
    ``_lstm_core_peep_bwd`` (:629-832), with their residual levers
    ``remat`` and ``residual_dtype`` and the products' operand dtype ``mm``
    (None or bfloat16: the kernels then take a bf16 W_hid, their bf16
    instantiations).  The forward saves the gates before any peephole term
    (or, under ``remat``, nothing of them: the rebuild needs only x and
    hids_prev); the peephole backward chain recomputes the peephole terms
    from the saved cells and also returns the three peephole gradients."""

    @staticmethod
    def forward(ctx, w_in, w_hid, b, cell_init, hid_init, x, mask, backwards, clip,
                return_state, remat, residual_dtype, mm, *peep):
        w_hid = _w_mm(w_hid, mm)
        peep = tuple(v.contiguous() for v in peep)
        x, mask, x_proj, cell0, hid0 = _prep(w_in, b, cell_init, hid_init, x, mask,
                                             backwards, mm)
        recurrence = lstm_peep_recurrence_train if peep else lstm_recurrence_train
        hids, cells, gates_pre = recurrence(x_proj, w_hid, mask, cell0, hid0, *peep)
        stacks = _save_residuals(ctx, hids, cells, gates_pre, remat, residual_dtype)
        ctx.save_for_backward(w_in, w_hid, b, x, mask, cell0, hid0, *peep, *stacks)
        ctx.backwards, ctx.clip, ctx.per_row = backwards, clip, cell_init.shape[0] != 1
        ctx.mm, ctx.n_peep = mm, len(peep)
        return _outputs(ctx, hids, cells, return_state)

    @staticmethod
    def backward(ctx, g_out, *g_state):
        w_in, w_hid, b, x, mask, cell0, hid0, *rest = ctx.saved_tensors
        peep, stacks = rest[:ctx.n_peep], rest[ctx.n_peep:]
        hids, cells, gates_pre = _load_residuals(ctx, x, w_in, w_hid, b, hid0, stacks)
        chain = _chain_inputs(ctx, g_out, g_state, hids, gates_pre, cells, cell0, mask)
        bwd_chain = lstm_peep_bwd_chain if peep else lstm_bwd_chain
        dgates, dcell0, dhid0, *dpeep = bwd_chain(*chain, w_hid, *peep, ctx.clip)
        grads = _batched_grads(ctx.needs_input_grad[:6], w_in, x, hids, hid0,
                               dgates[:, :hids.shape[1]], dcell0, dhid0, ctx.backwards,
                               ctx.per_row, ctx.mm)
        return (*grads, None, None, None, None, None, None, None, *dpeep)


def _residual_dtype(residual_dtype) -> Optional[torch.dtype]:
    """A dtype name ("bfloat16") or a torch dtype; None stays None."""
    if residual_dtype is None or isinstance(residual_dtype, torch.dtype):
        return residual_dtype
    dtype = getattr(torch, str(residual_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown residual_dtype {residual_dtype!r}")
    return dtype


def lstm_forward(params: dict, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 backwards: bool = False,
                 grad_clipping: float = 5.0,
                 initial_state=None,
                 return_state: bool = False,
                 remat: bool = False,
                 residual_dtype=None,
                 matmul_dtype=None):
    """Run a masked LSTM over ``x`` (B, T, D); returns hidden states (B, T, H).

    Parameters with the three peephole vectors run the peephole recurrence.
    When autograd is on and ``x``, a parameter or the initial state requires
    a gradient, the call goes through :class:`_LSTMCore`, whose backward
    clips the gate pre-activation gradients to +-``grad_clipping`` (0 or
    None: no clip).  Otherwise it runs the inference recurrence, which
    stores no residuals (as ``_lstm_core_primal_impl`` and
    ``_lstm_core_peep_primal_impl`` do).

    ``initial_state`` ((B, H) cell, (B, H) hid) replaces the learned
    ``cell_init``/``hid_init`` broadcast, and ``return_state=True`` makes
    the call return ``(out, (cell_T, hid_T))``: together they advance the
    recurrence chunk by chunk with the one-shot result (masked steps carry
    the state, so zero-mask chunk padding changes nothing).  Either option
    with ``backwards=True`` raises ``ValueError``, as in the JAX package.

    ``remat`` and ``residual_dtype`` are the training residual levers: the
    first keeps no (B, T, 4H) gate stack and rebuilds it at the start of
    the backward from ``x`` and the stored hids (two products; the
    recurrence is not run again), the second stores the hids, cells and
    gates in that dtype (e.g. ``"bfloat16"``) and upcasts them in the
    backward, which then computes from the rounded stacks.  Outputs and
    gradients stay float32, and neither lever changes inference.  As in
    the JAX package they do not combine with ``initial_state`` or
    ``return_state`` (``ValueError``).

    ``matmul_dtype`` ("bfloat16" or ``torch.bfloat16``; None or float32
    change nothing) rounds every product's operands to bf16 and sums the
    products in float32, as the JAX package's ``matmul_dtype`` does: the
    input projection, the recurrence's h_{t-1} @ W_hid (the kernels' bf16
    instantiations, W_hid passed as bf16), and in the backward the chain's
    dgates @ W_hid^T and the batched weight and input gradients.  States,
    gates, outputs, residuals and gradients stay float32.  A bf16
    ``params["w_hid"]`` (a bf16-weight artifact) runs the bf16 recurrence
    whatever ``matmul_dtype`` says, as the JAX package rounds h_{t-1} to
    W_hid's dtype.  With a gradient through ``initial_state`` the port
    runs the custom-VJP core, whose cotangents stay float32, where the JAX
    package's plain-autodiff scan rounds them to bf16."""
    B, T, D = x.shape
    stateful = initial_state is not None or return_state
    if stateful and backwards:
        raise ValueError("initial_state/return_state require a forward recurrence "
                         "(backwards=True has no streamable carry)")
    if stateful and (remat or residual_dtype is not None):
        raise ValueError("remat / residual_dtype are training residual levers of the "
                         "stateless recurrence; initial_state/return_state take none")
    residual_dtype = _residual_dtype(residual_dtype)
    mm = matmul_dtype_of(matmul_dtype)
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    if initial_state is not None:
        H = lstm_params_hidden_size(params)
        cell0, hid0 = (s.to(torch.float32).contiguous() for s in initial_state)
        if cell0.shape != (B, H) or hid0.shape != (B, H):
            raise ValueError(f"initial_state must be two ({B}, {H}) tensors, got "
                             f"{tuple(cell0.shape)} and {tuple(hid0.shape)}")
    else:
        cell0, hid0 = params["cell_init"], params["hid_init"]
    tensors = [params["w_in"], params["w_hid"], params["b"], cell0, hid0]
    peep = [params[k] for k in _PEEPHOLE_KEYS] if _PEEPHOLE_KEYS[0] in params else []
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, *peep, x)):
        res = _LSTMCore.apply(*tensors, x, mask, bool(backwards), float(grad_clipping or 0.0),
                              bool(return_state), bool(remat), residual_dtype, mm, *peep)
    else:
        _, mask, x_proj, cell0, hid0 = _prep(params["w_in"], params["b"], cell0, hid0, x,
                                             mask, backwards, mm)
        # the inference row by (peepholes, return_state), looked up at the
        # call: parallel/_multiprocess_worker.counted_on_cpu replaces these names
        recurrence = ((lstm_peep_recurrence_state if peep else lstm_recurrence_state)
                      if return_state else (lstm_peep_recurrence if peep else lstm_recurrence))
        res = recurrence(x_proj, _w_mm(params["w_hid"], mm), mask, cell0, hid0,
                         *(v.contiguous() for v in peep))
        if backwards:  # never with return_state
            res = torch.flip(res, dims=(1,))
    if not return_state:
        return res
    out, cell_T = res
    # the kernel reads hid0 with row stride H: hand on a contiguous copy
    return out, (cell_T, out[:, -1].contiguous())


def blstm_forward(fwd_params: dict, bwd_params: dict, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  merge: str = "sum", grad_clipping: float = 5.0,
                  matmul_dtype=None) -> torch.Tensor:
    """Bidirectional LSTM; ``merge`` is "sum" (the reference default) or
    "concat"; ``grad_clipping`` and ``matmul_dtype`` as :func:`lstm_forward`,
    for both directions."""
    f = lstm_forward(fwd_params, x, mask, False, grad_clipping, matmul_dtype=matmul_dtype)
    b = lstm_forward(bwd_params, x, mask, True, grad_clipping, matmul_dtype=matmul_dtype)
    if merge == "sum":
        return f + b
    if merge == "concat":
        return torch.cat([f, b], dim=-1)
    raise ValueError(f"unknown merge: {merge}")


def can_group_lstms(params_list) -> bool:
    """Whether LSTMs may run as one group: at least two, equal hidden sizes
    and the same peephole setting."""
    if len(params_list) < 2:
        return False
    H = lstm_params_hidden_size(params_list[0])
    peep = _PEEPHOLE_KEYS[0] in params_list[0]
    return all(lstm_params_hidden_size(p) == H and (_PEEPHOLE_KEYS[0] in p) == peep
               for p in params_list)


def lstm_forward_grouped(params_list, xs, mask: Optional[torch.Tensor], backwards_flags,
                         grad_clipping: float = 5.0, matmul_dtype=None) -> list:
    """G independent LSTMs over the same mask: the counterpart of the JAX
    package's ``lstm_forward_grouped``, whose grouped scan is numerically
    the separate recurrences.  The members run one after another through
    :func:`lstm_forward` (on the card one recurrence launch each, and one
    backward chain each under training); inputs may differ in width and
    ``backwards_flags[g]`` flips member g in time; ``matmul_dtype`` as
    :func:`lstm_forward` (the grouped core's products round the same
    operands).  Returns the (B, T, H) outputs in input order."""
    if not len(params_list) == len(xs) == len(backwards_flags):
        raise ValueError(f"{len(params_list)} parameter sets, {len(xs)} inputs and "
                         f"{len(backwards_flags)} direction flags")
    if len(params_list) > 1 and not can_group_lstms(params_list):
        raise ValueError("grouped LSTMs need equal hidden sizes and peephole settings")
    return [lstm_forward(p, x, mask, bool(bwd), grad_clipping, matmul_dtype=matmul_dtype)
            for p, x, bwd in zip(params_list, xs, backwards_flags)]


def last_valid_step(outputs: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Hidden state at the last *timestep* (index -1); ``mask`` is unused.

    With a mask-carrying recurrence the padded tail holds the last valid
    forward state, and in a summed BLSTM the backward half's learned initial
    state: exactly what the reference's SliceLayer(-1) reads."""
    del mask
    return outputs[:, -1, :]


def last_valid_step_gathered(outputs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each row's output at its true last valid frame, max(len - 1, 0) (an
    all-pad row reads frame 0).  Equal to :func:`last_valid_step` for a
    forward mask-carrying recurrence, and right for upstreams that zero
    their padded steps; not the reference's reading of a summed BLSTM,
    whose index -1 holds the backward half's learned initial state."""
    lengths = (mask > 0).sum(dim=1)
    idx = torch.clamp(lengths - 1, min=0)
    return outputs.gather(1, idx[:, None, None].expand(-1, 1, outputs.shape[-1]))[:, 0, :]
