"""Masked LSTM / BLSTM inference with Lasagne-compatible semantics.

Mirrors the inference path of ip_avsr_tpu/ops/lstm.py (``lstm_forward``,
``_lstm_prep``, ``_lstm_core_primal_impl``, ``blstm_forward``,
``last_valid_step``):

  * gate stacking order (ingate, forgetgate, cell, outgate) in ``w_in (D, 4H)``,
    ``w_hid (H, 4H)``, ``b (4H,)``; sigmoid gates, tanh cell input and output;
  * learned initial state ``cell_init``/``hid_init`` (1, H), broadcast over
    the batch;
  * masked steps carry the previous hidden AND cell state unchanged;
  * backwards layers flip input and mask along time, run, and flip the output
    back, so the padded tail of a backwards layer holds its learned initial
    state.

The input projection for all gates and timesteps is one (B*T, D) x (D, 4H)
``torch.matmul`` hoisted out of the recurrence; the recurrence itself goes
through ``ops/kernels/lstm.lstm_recurrence`` (the CUDA kernel on the card, the
plain loop on the CPU).
"""

from __future__ import annotations

from typing import Optional

import torch

from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops.kernels.lstm import lstm_recurrence

_PEEPHOLE_KEYS = ("w_cell_to_ingate", "w_cell_to_forgetgate", "w_cell_to_outgate")
_PEEPHOLE_TODO = ("peephole LSTMs are not ported yet (ROADMAP Queue 1 item 6 "
                  "and Queue 2 item 5)")


def init_lstm_params(generator, input_dim: int, hidden: int,
                     w_init=inits.glorot_uniform, use_peepholes: bool = False,
                     dtype=torch.float32) -> dict:
    """One LSTM layer's parameters on the CPU: each gate's block is an
    independent draw, stacked (the JAX package's layout)."""
    if use_peepholes:
        raise NotImplementedError(_PEEPHOLE_TODO)
    w_in = torch.cat([w_init(generator, (input_dim, hidden), dtype) for _ in range(4)], dim=1)
    w_hid = torch.cat([w_init(generator, (hidden, hidden), dtype) for _ in range(4)], dim=1)
    return {
        "w_in": w_in,
        "w_hid": w_hid,
        "b": torch.zeros(4 * hidden, dtype=dtype),
        "cell_init": torch.zeros(1, hidden, dtype=dtype),
        "hid_init": torch.zeros(1, hidden, dtype=dtype),
    }


def lstm_forward(params: dict, x: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 backwards: bool = False) -> torch.Tensor:
    """Run a masked LSTM over ``x`` (B, T, D); returns hidden states (B, T, H)."""
    if any(k in params for k in _PEEPHOLE_KEYS):
        raise NotImplementedError(_PEEPHOLE_TODO)
    B, T, D = x.shape
    H = params["w_hid"].shape[0]
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=x.device)
    mask = mask.to(torch.float32)
    if backwards:
        x = torch.flip(x, dims=(1,))
        mask = torch.flip(mask, dims=(1,))
    x_proj = (torch.matmul(x.reshape(B * T, D), params["w_in"])
              .reshape(B, T, 4 * H) + params["b"])
    cell0 = params["cell_init"].expand(B, H).contiguous()
    hid0 = params["hid_init"].expand(B, H).contiguous()
    out = lstm_recurrence(x_proj, params["w_hid"].contiguous(),
                          mask.contiguous(), cell0, hid0)
    if backwards:
        out = torch.flip(out, dims=(1,))
    return out


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
