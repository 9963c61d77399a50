"""Greedy layerwise DBN stacking (dbn/trainDBN.m:27-53): the port of
ip_avsr_tpu/pretrain/dbn.py.

Each layer's RBM is trained on the previous layer's hidden *activations*
(probs, not states), exactly as trainDBN.m:48-51 feeds ``posHidProbs`` to the
next RBM.  The input activation function is 'sigm' by default
(dbn/dbnParamsInit.m inputActivationFunction).  The data goes to the device
once; each layer's probs stay there as the next layer's data.  Layer ``i``
(from 0) trains with the seed ``seed + i``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ip_avsr_torch.device import resolve_device
from ip_avsr_torch.pretrain import rbm as rbm_lib


def train_dbn(seed: int, data, hidden_layers: Sequence[int],
              hidden_activations: Sequence[str], input_activation: str = "sigm",
              hyper: rbm_lib.RBMHyperParams = rbm_lib.RBMHyperParams(), log_fn=print,
              device=None):
    """Returns a dbn dict of numpy arrays: {"W": [...], "hidbiases": [...],
    "visbiases": [...]}, the biases as (1, H) rows.  Trains on ``device``
    (default ``cuda``)."""
    if len(hidden_layers) != len(hidden_activations):
        raise ValueError(f"{len(hidden_layers)} hidden layers but "
                         f"{len(hidden_activations)} activations")
    device = resolve_device(device)
    activations_all = [input_activation] + list(hidden_activations)
    dbn = {"W": [], "hidbiases": [], "visbiases": []}
    x = torch.as_tensor(data, dtype=torch.float32).to(device)
    for i, num_hid in enumerate(hidden_layers):
        vl_type, hl_type = activations_all[i], activations_all[i + 1]
        log_fn(f"Pretraining Layer {i + 1} with RBM: {x.shape[1]}-{num_hid} "
               f"({vl_type}->{hl_type})")
        state, _ = rbm_lib.train_rbm(seed + i, x, num_hid, vl_type, hl_type, hyper, log_fn,
                                     device=device)
        dbn["W"].append(state["weights"].cpu().numpy())
        dbn["hidbiases"].append(state["hidbiases"].cpu().numpy().reshape(1, -1))
        dbn["visbiases"].append(state["visbiases"].cpu().numpy().reshape(1, -1))
        with torch.no_grad():
            x, _ = rbm_lib.rbm_up(x, state["weights"], state["hidbiases"], hl_type)
    log_fn("DBN training done")
    return dbn
