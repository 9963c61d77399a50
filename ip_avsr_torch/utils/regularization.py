"""Early-stopping rules over a validation-cost window.

A copy of ip_avsr_tpu/utils/regularization.py:
  * ``early_stop``: stop when the window rises strictly, entry by entry.
  * ``early_stop2``: stop when at least ``threshold`` window entries exceed
    the best validation cost seen.
"""

from __future__ import annotations


def early_stop(cost_window) -> bool:
    costs = list(cost_window)
    if len(costs) < 2:
        return False
    curr = costs[0]
    for idx, cost in enumerate(costs):
        if curr < cost or idx == 0:
            curr = cost
        else:
            return False
    return True


def early_stop2(cost_window, min_val_cost, threshold) -> bool:
    costs = list(cost_window)
    if len(costs) < 2:
        return False
    count = 0
    for cost in costs:
        if cost > min_val_cost:
            count += 1
        if count == threshold:
            return True
    return False
