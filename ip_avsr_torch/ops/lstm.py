"""Masked LSTM / BLSTM with Lasagne-compatible semantics.

Mirrors ip_avsr_tpu/ops/lstm.py (``init_lstm_params``, ``init_blstm_params``,
``lstm_forward``, ``_lstm_prep``, the custom-VJP cores ``_lstm_core`` and
``_lstm_core_peep`` with their primals, forwards and backwards,
``blstm_forward``, ``last_valid_step``):

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
kernels, through :class:`_LSTMCorePeep`.  Each kernel wrapper runs its CUDA
kernel on the card and its plain loop on the CPU, so the CPU takes the same
Function.
"""

from __future__ import annotations

from typing import Optional

import torch

from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops.kernels.lstm import (lstm_bwd_chain, lstm_peep_bwd_chain,
                                            lstm_peep_recurrence, lstm_peep_recurrence_train,
                                            lstm_recurrence, lstm_recurrence_train)

_PEEPHOLE_KEYS = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")


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


def _prep(w_in, b, cell_init, hid_init, x, mask, backwards):
    """The prologue of ip_avsr_tpu/ops/lstm.py::_lstm_prep: time flip, the
    hoisted input projection plus bias, broadcast initial states.  Returns
    (x, mask, x_proj, cell0, hid0) with x and mask flipped when
    ``backwards``."""
    B, T, D = x.shape
    H = cell_init.shape[-1]
    if backwards:
        x = torch.flip(x, dims=(1,))
        mask = torch.flip(mask, dims=(1,))
    x_proj = torch.matmul(x.reshape(B * T, D), w_in).reshape(B, T, 4 * H) + b
    cell0 = cell_init.expand(B, H).contiguous()
    hid0 = hid_init.expand(B, H).contiguous()
    return x.contiguous(), mask.contiguous(), x_proj, cell0, hid0


def _batched_grads(need, w_in, x, hids, hid0, dgates, dcell0, dhid0, backwards):
    """The weight and input gradients after a backward chain, as single
    products over all (B, T) rows: ``(dw_in, dw_hid, db, dcell_init,
    dhid_init, dx)``, each None where ``need`` (six booleans in that order)
    says it is not wanted."""
    B, T, H = hids.shape
    D = x.shape[-1]
    dg = dgates.reshape(B * T, 4 * H)
    dw_in = dw_hid = db = dcell_init = dhid_init = dx = None
    if need[0]:
        dw_in = x.reshape(B * T, D).T @ dg
    if need[1]:
        hids_prev = torch.cat([hid0[:, None], hids[:, :-1]], dim=1)
        dw_hid = hids_prev.reshape(B * T, H).T @ dg
    if need[2]:
        db = dg.sum(dim=0)
    if need[3]:
        dcell_init = dcell0.sum(dim=0, keepdim=True)
    if need[4]:
        dhid_init = dhid0.sum(dim=0, keepdim=True)
    if need[5]:
        dx = (dg @ w_in.T).reshape(B, T, D)
        if backwards:
            dx = torch.flip(dx, dims=(1,))
    return dw_in, dw_hid, db, dcell_init, dhid_init, dx


def _chain_inputs(ctx, g_out, cells, cell0):
    """The upstream gradient in the recurrence's time order, and cells_prev."""
    if ctx.backwards:
        g_out = torch.flip(g_out, dims=(1,))
    cells_prev = torch.cat([cell0[:, None], cells[:, :-1]], dim=1)
    return g_out.contiguous(), cells_prev


class _LSTMCore(torch.autograd.Function):
    """The training core: counterpart of ``_lstm_core_fwd`` /
    ``_lstm_core_bwd`` (ip_avsr_tpu/ops/lstm.py:375-588), non-peephole."""

    @staticmethod
    def forward(ctx, w_in, w_hid, b, cell_init, hid_init, x, mask, backwards, clip):
        w_hid = w_hid.contiguous()
        x, mask, x_proj, cell0, hid0 = _prep(w_in, b, cell_init, hid_init, x, mask,
                                             backwards)
        hids, cells, gates_pre = lstm_recurrence_train(x_proj, w_hid, mask, cell0, hid0)
        ctx.save_for_backward(w_in, w_hid, x, mask, hids, cells, gates_pre, cell0, hid0)
        ctx.backwards, ctx.clip = backwards, clip
        return torch.flip(hids, dims=(1,)) if backwards else hids

    @staticmethod
    def backward(ctx, g_out):
        w_in, w_hid, x, mask, hids, cells, gates_pre, cell0, hid0 = ctx.saved_tensors
        g_out, cells_prev = _chain_inputs(ctx, g_out, cells, cell0)
        dgates, dcell0, dhid0 = lstm_bwd_chain(g_out, gates_pre, cells, cells_prev, mask,
                                               w_hid, ctx.clip)
        grads = _batched_grads(ctx.needs_input_grad[:6], w_in, x, hids, hid0, dgates,
                               dcell0, dhid0, ctx.backwards)
        return (*grads, None, None, None)


class _LSTMCorePeep(torch.autograd.Function):
    """The peephole training core: counterpart of ``_lstm_core_peep_fwd`` /
    ``_lstm_core_peep_bwd`` (ip_avsr_tpu/ops/lstm.py:629-832).  The forward
    saves the pre-peephole gates; the backward chain recomputes the peephole
    terms from the saved cells and also returns the three (H,) peephole
    gradients."""

    @staticmethod
    def forward(ctx, w_in, w_hid, b, cell_init, hid_init, w_ci, w_cf, w_co, x, mask,
                backwards, clip):
        w_hid = w_hid.contiguous()
        peep = tuple(v.contiguous() for v in (w_ci, w_cf, w_co))
        x, mask, x_proj, cell0, hid0 = _prep(w_in, b, cell_init, hid_init, x, mask,
                                             backwards)
        hids, cells, gates_pre = lstm_peep_recurrence_train(x_proj, w_hid, mask, cell0, hid0,
                                                            *peep)
        ctx.save_for_backward(w_in, w_hid, *peep, x, mask, hids, cells, gates_pre, cell0,
                              hid0)
        ctx.backwards, ctx.clip = backwards, clip
        return torch.flip(hids, dims=(1,)) if backwards else hids

    @staticmethod
    def backward(ctx, g_out):
        (w_in, w_hid, w_ci, w_cf, w_co, x, mask, hids, cells, gates_pre, cell0,
         hid0) = ctx.saved_tensors
        g_out, cells_prev = _chain_inputs(ctx, g_out, cells, cell0)
        dgates, dcell0, dhid0, dw_ci, dw_cf, dw_co = lstm_peep_bwd_chain(
            g_out, gates_pre, cells, cells_prev, mask, w_hid, w_ci, w_cf, w_co, ctx.clip)
        need = ctx.needs_input_grad
        dw_in, dw_hid, db, dcell_init, dhid_init, dx = _batched_grads(
            (*need[:5], need[8]), w_in, x, hids, hid0, dgates, dcell0, dhid0, ctx.backwards)
        return (dw_in, dw_hid, db, dcell_init, dhid_init, dw_ci, dw_cf, dw_co, dx,
                None, None, None)


def lstm_forward(params: dict, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 backwards: bool = False,
                 grad_clipping: float = 5.0) -> torch.Tensor:
    """Run a masked LSTM over ``x`` (B, T, D); returns hidden states (B, T, H).

    Parameters with the three peephole vectors run the peephole recurrence.
    When autograd is on and ``x`` or a parameter requires a gradient, the
    call goes through :class:`_LSTMCore` (or :class:`_LSTMCorePeep`), whose
    backward clips the gate pre-activation gradients to +-``grad_clipping``
    (0 or None: no clip).  Otherwise it runs the inference recurrence, which
    stores no residuals (as ``_lstm_core_primal_impl`` and
    ``_lstm_core_peep_primal_impl`` do)."""
    B, T, D = x.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    keys = ("w_in", "w_hid", "b", "cell_init", "hid_init")
    tensors = [params[k] for k in keys]
    peep = [params[k] for k in _PEEPHOLE_KEYS] if _PEEPHOLE_KEYS[0] in params else []
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*tensors, *peep, x)):
        core = _LSTMCorePeep if peep else _LSTMCore
        return core.apply(*tensors, *peep, x, mask, bool(backwards),
                          float(grad_clipping or 0.0))
    _, mask, x_proj, cell0, hid0 = _prep(params["w_in"], params["b"], params["cell_init"],
                                         params["hid_init"], x, mask, backwards)
    w_hid = params["w_hid"].contiguous()
    if peep:
        out = lstm_peep_recurrence(x_proj, w_hid, mask, cell0, hid0,
                                   *(v.contiguous() for v in peep))
    else:
        out = lstm_recurrence(x_proj, w_hid, mask, cell0, hid0)
    return torch.flip(out, dims=(1,)) if backwards else out


def blstm_forward(fwd_params: dict, bwd_params: dict, x: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  merge: str = "sum") -> torch.Tensor:
    """Bidirectional LSTM; ``merge`` is "sum" (the reference default) or
    "concat"."""
    f = lstm_forward(fwd_params, x, mask, False)
    b = lstm_forward(bwd_params, x, mask, True)
    if merge == "sum":
        return f + b
    if merge == "concat":
        return torch.cat([f, b], dim=-1)
    raise ValueError(f"unknown merge: {merge}")


def last_valid_step(outputs: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Hidden state at the last *timestep* (index -1); ``mask`` is unused.

    With a mask-carrying recurrence the padded tail holds the last valid
    forward state, and in a summed BLSTM the backward half's learned initial
    state: exactly what the reference's SliceLayer(-1) reads."""
    del mask
    return outputs[:, -1, :]
