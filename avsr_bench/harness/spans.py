"""The arithmetic of the readers of the program's spans
(``ip_avsr_torch/utils/spans.py``): a layer's milliseconds per training
step or per scoring request, on the card's clock (CUDA events around the
span) or the host's.

A reader reads the records of the process that ran the cell, and of them
the first traced window's alone: the first ``trace_steps`` step ids (the
``train.step`` spans) or ``trace_requests`` request ids (``serve.forward``,
a stacked dispatch counting its requests), in the order they opened.
Nothing arms the spans before the traced windows (a profiler arms them), so
the records start at window one; the second window traces the host's
operators with their shapes, which slows the host, and is left out.  A
span belongs to the window by its id; a wait by the request ids it
carries, all of which must be the window's.

Each returns the sum of the layer's spans over the window divided by its
steps or requests, or None: off the card, untraced, where the program has
no spans (a checkout older than them), or where the records do not hold
the whole window or the layer.
"""

from __future__ import annotations

# the root span that opens each step or request, and the traffic key that
# counts the first window's
WINDOWS = {"train": ("train.step", "trace_steps"), "score": ("serve.forward", "trace_requests")}


def program_records():
    """The program's span records in this process; None where it has none."""
    try:
        from ip_avsr_torch.utils import spans
    except ImportError:
        return None
    return spans.records()


def first_window(records: list, kind: str, n: int):
    """The ids of the first ``n`` steps or requests of ``records``; None
    where fewer are recorded."""
    root = WINDOWS[kind][0]
    ids, counted = set(), 0
    for r in records:
        if counted >= n:
            break
        if r["name"] == root and r["id"] is not None and r["id"] not in ids:
            ids.add(r["id"])
            counted += r["count"] or 1
    return ids if counted >= n else None


def layer_ms(run, kind: str, name: str, clock: str, records: list = None):
    """Milliseconds of the spans ``name`` per step or request of the first
    traced window of ``run``; ``clock`` is ``"device"`` (the card's time
    between the span's events) or ``"host"``.  ``records`` default to the
    program's."""
    if run.kind != kind or not run.traced or run.device.type != "cuda":
        return None
    records = program_records() if records is None else records
    if not records:
        return None
    n = int(run.traffic[WINDOWS[kind][1]])
    ids = first_window(records, kind, n)
    if ids is None:
        return None
    key = "device_ms" if clock == "device" else "host_ms"
    values = [r[key] for r in records if r["name"] == name and (
        r["id"] in ids if r["ids"] is None else all(i in ids for i in r["ids"]))]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / n
