"""Weight initializers with Lasagne-compatible semantics, on a
``torch.Generator``.

Mirrors ip_avsr_tpu/ops/initializers.py.  Every initializer has the signature ``init(generator, shape, dtype)`` and
draws on the CPU (a CPU generator cannot fill a CUDA tensor); the caller moves
the finished parameters to their device.  Draws differ from JAX's for the same
seed, so the tests check statistics, and parity tests carry JAX parameters
across with ``bridge.params_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch


def glorot_uniform(generator, shape, dtype=torch.float32, gain=1.0):
    if len(shape) < 2:
        # Lasagne raises here; biases are initialized to zeros instead.
        raise ValueError("glorot_uniform requires >=2D shapes")
    fan_in, fan_out = shape[0], shape[1]
    limit = gain * float(np.sqrt(6.0 / (fan_in + fan_out)))
    out = torch.empty(tuple(shape), dtype=dtype)
    return out.uniform_(-limit, limit, generator=generator)


def normal(std=0.1, mean=0.0):
    def init(generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        return out.normal_(mean, std, generator=generator)

    return init


def uniform(rng_range=0.01):
    def init(generator, shape, dtype=torch.float32):
        out = torch.empty(tuple(shape), dtype=dtype)
        return out.uniform_(-rng_range, rng_range, generator=generator)

    return init


def orthogonal(generator, shape, dtype=torch.float32, gain=1.0):
    """Orthogonal init via SVD of a Gaussian (Lasagne init.Orthogonal).
    The SVD runs on the host in float64 NumPy: it is one-time work."""
    flat_shape = (shape[0], int(np.prod(shape[1:])))
    a = torch.empty(flat_shape, dtype=torch.float32).normal_(
        0.0, 1.0, generator=generator).numpy()
    u, _, vt = np.linalg.svd(a.astype(np.float64), full_matrices=False)
    q = u if u.shape == flat_shape else vt
    return torch.as_tensor(gain * q.reshape(shape), dtype=dtype)


def constant(value=0.0):
    """Fills with ``value``; draws nothing from the generator."""

    def init(generator, shape, dtype=torch.float32):
        del generator
        return torch.full(tuple(shape), value, dtype=dtype)

    return init


_REGISTRY = {
    "glorot": glorot_uniform,
    "norm": normal(0.1),
    "uniform": uniform(),
    "ortho": orthogonal,
}


def select_weight_init(name):
    """Config string -> initializer; a callable passes through."""
    if callable(name):
        return name
    return _REGISTRY[name]
