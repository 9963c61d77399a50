"""The numbers that decide ``correct``, each worked out from the program's
output and the plain reference's (``avsr_bench/reference/adenet_ref.py``).

Scoring: the widest gap between a served utterance's log-probability and
the reference's, over a seeded sample of the requests the window finished.

Training: the relative gap of each of the first three steps' losses; by the
worst leaf, the gap between the norms of the first step's gradient (the
program's worked out from Adam's first moment after one step) and the gap
between the norms of the parameters' change over the three steps, each
over the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone under Adam and are left out of the
change.
"""

from __future__ import annotations

import statistics
import sys

import torch

ADAM_BETA1 = 0.9
NEGLIGIBLE_GRAD = 1e-3


def score_gap(probs, probs_ref) -> float:
    """max |log p - log p_ref| over every utterance and class; infinite
    for an answer of the wrong shape."""
    p = torch.as_tensor(probs, dtype=torch.float32, device=probs_ref.device)
    if p.shape != probs_ref.shape:
        return float("inf")
    return float((p.clamp_min(1e-30).log() - probs_ref.clamp_min(1e-30).log()).abs().max())


def program_readings(p0, p3, m1, losses) -> dict:
    """What the program's first three steps give: their losses, the first
    step's gradient norms by leaf (Adam's first moment after one step is
    (1 - beta1) g) and the norms of each leaf's change over the three."""
    from avsr_bench.reference.adenet_ref import leaves

    first = {path: float((m.detach().double() / (1.0 - ADAM_BETA1)).norm())
             for path, m in leaves(m1)}
    before = dict(leaves(p0))
    change = {path: float((t.detach().double() - before[path].detach().double()).norm())
              for path, t in leaves(p3)}
    return {"losses": [float(v) for v in losses], "grad": first, "change": change}


def reference_readings(p0, losses, first_grads, p3) -> dict:
    from avsr_bench.reference.adenet_ref import leaves

    before = dict(leaves(p0))
    return {"losses": list(losses),
            "grad": {k: float(g.double().norm()) for k, g in first_grads.items()},
            "change": {k: float((t.double() - before[k].detach().double()).norm())
                       for k, t in p3.items()}}


def _worst_leaf(got: dict, ref: dict, keep, what: str) -> float:
    """The largest gap over the leaves ``keep``; the leaf is named on
    standard error."""
    median = statistics.median(ref[k] for k in keep)
    gap, leaf = max((abs(got[k] - ref[k]) / max(ref[k], median), k) for k in keep)
    print(f"{what}: worst leaf {leaf} ({gap!r}; its reference norm {ref[leaf]!r}, the "
          f"median leaf's {median!r})", file=sys.stderr)
    return gap


def train_gaps(got: dict, ref: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program's
    readings against the reference's (both from :func:`program_readings`
    and :func:`reference_readings`)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    leaves_all = list(ref["grad"])
    median_grad = statistics.median(ref["grad"][k] for k in leaves_all)
    moving = [k for k in leaves_all if ref["grad"][k] >= NEGLIGIBLE_GRAD * median_grad]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_leaf(got["grad"], ref["grad"], leaves_all, "grad_gap"),
            "change_gap": _worst_leaf(got["change"], ref["change"], moving, "change_gap")}
