"""The JAX guard: the run must not have loaded JAX, the JAX package, or the
repo's scripts of the JAX package's benchmark and the card's bring-up."""

from __future__ import annotations

import sys

# top-level module names a run may not hold, compared whole: JAX, the JAX
# package and the JAX package's old benchmark and the card's bring-up check
# (``bench.py``, ``chip_smoke.py``); the port, ``ip_avsr_torch``, begins
# with the JAX package's name and is allowed
FORBIDDEN = ("jax", "jaxlib", "flax", "ip_avsr_tpu", "bench", "chip_smoke")


def forbidden_modules() -> list:
    """The forbidden top-level names found in ``sys.modules``."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))
