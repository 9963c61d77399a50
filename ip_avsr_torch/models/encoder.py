"""Dense "DBNF" encoder stacks.

Mirrors ip_avsr_tpu/models/encoder.py: a chain of dense layers named
fc1, fc2, fc3, bottleneck (then fc5, fc6, ...) with per-layer
nonlinearities, applied to (B*T, D) flattened frames.  The dense products are
``torch.matmul``: the JAX package has no Pallas kernel for them either.
Under ``matmul_dtype="bfloat16"`` each product takes bf16-rounded operands
and sums in float32.  Autograd of the casts rounds each operand's cotangent
to bf16 (the backward of ``.to(float32)`` from bf16 casts the gradient to
bf16), which is what JAX's autodiff of that product gives:
``da = bf16(g bf16(b)^T)`` and ``db = bf16(bf16(a)^T g)``.

Under tensor parallelism (``parallel/mesh.adenet_param_rules``) a layer's
``w`` and ``b`` hold this rank's block of its output columns: the rank
computes its block of the layer's output and the blocks are all-gathered
over the ``model`` ranks before the next layer
(``parallel/collectives.all_gather``, whose backward keeps the rank's block
of the gradient); the layer's input, read whole by every rank, gets the sum
over the ranks of their columns' gradients
(``parallel/collectives.all_reduce_grad``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ip_avsr_torch.ops import initializers as inits
from ip_avsr_torch.ops.kernels.lstm import round_operand
from ip_avsr_torch.ops.lstm import matmul_dtype_of
from ip_avsr_torch.ops.nonlinearities import select_nonlinearity, softmax
from ip_avsr_torch.parallel import collectives

DEFAULT_NAMES = ("fc1", "fc2", "fc3", "bottleneck")


def init_encoder_params(generator, input_dim: int, shapes: Sequence[int],
                        w_init=inits.glorot_uniform, dtype=torch.float32) -> dict:
    """Fresh dense stack on the CPU."""
    params = {}
    fan_in = input_dim
    for i, units in enumerate(shapes):
        name = DEFAULT_NAMES[i] if i < len(DEFAULT_NAMES) else f"fc{i + 1}"
        params[name] = {
            "w": w_init(generator, (fan_in, int(units)), dtype),
            "b": torch.zeros(int(units), dtype=dtype),
        }
        fan_in = int(units)
    return params


def pretrained_encoder_params(weights, biases, names=DEFAULT_NAMES) -> dict:
    """Loaded (weights, biases) lists as the encoder's parameter tree on the
    CPU, float32 (JAX ``encoder.pretrained_encoder_params``)."""
    params = {}
    for i, (w, b) in enumerate(zip(weights, biases)):
        name = names[i] if i < len(names) else f"fc{i + 1}"
        params[name] = {"w": torch.as_tensor(np.asarray(w, np.float32)),
                        "b": torch.as_tensor(np.asarray(b, np.float32)).reshape(-1)}
    return params


def product(a: torch.Tensor, b: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """``a @ b`` (a (N, K), b (K, M)), with bf16 operands and float32 sums
    under a bf16 ``matmul_dtype``: the float32 product of the rounded
    operands, exact per term, as JAX's ``jnp.dot(a.astype(bf16),
    b.astype(bf16), preferred_element_type=f32)``."""
    mm = matmul_dtype_of(matmul_dtype)
    return torch.matmul(round_operand(a, mm), round_operand(b, mm))


def encoder_forward(params: dict, x: torch.Tensor, nonlinearities: Sequence,
                    names=None, matmul_dtype=None, widths=None, group=None) -> torch.Tensor:
    """Apply the dense stack to (..., D) inputs; ``matmul_dtype`` None,
    float32 or bfloat16 (ip_avsr_tpu/models/encoder.py:66-73).

    With ``group`` (the ``model`` ranks) and ``widths`` (each layer's
    output width), a layer whose ``w`` has fewer columns than its width is
    this rank's column block: its output block is all-gathered over
    ``group`` (after the nonlinearity when that is elementwise, before a
    softmax)."""
    names = names or sorted(params.keys(), key=_layer_sort_key)
    if len(nonlinearities) != len(names):
        raise ValueError(
            f"encoder has {len(names)} layers {list(names)} but "
            f"{len(nonlinearities)} nonlinearities {list(nonlinearities)}")
    out = x
    for i, (name, nl) in enumerate(zip(names, nonlinearities)):
        w = params[name]["w"]
        fn = select_nonlinearity(nl)
        if group is None or widths is None or w.shape[1] == int(widths[i]):
            out = fn(product(out, w, matmul_dtype) + params[name]["b"])
            continue
        z = product(collectives.all_reduce_grad(out, group), w, matmul_dtype) + params[name]["b"]
        if fn is softmax:
            out = fn(collectives.all_gather(z, -1, group))
        else:
            out = collectives.all_gather(fn(z), -1, group)
    return out


def _layer_sort_key(name: str):
    """fc1 < fc2 < fc3 < bottleneck < fc5 < ... < fc10: the overflow names
    sort numerically, so deep stacks keep their order."""
    order = {n: i for i, n in enumerate(DEFAULT_NAMES)}
    if name in order:
        return (order[name], 0)
    digits = "".join(c for c in name if c.isdigit())
    return (99, int(digits) if digits else 0)


def encoder_output_dim(params: dict, names=None) -> int:
    """The width of the stack's last layer (in ``names`` order, default the
    fc1 < ... < bottleneck < fc5 order)."""
    names = names or sorted(params.keys(), key=_layer_sort_key)
    return int(params[names[-1]]["w"].shape[1])
