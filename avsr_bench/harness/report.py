"""A run's result: its metrics read by their readers, the device, the
breakdown and the check, as the last line of standard output."""

from __future__ import annotations

import json
import statistics
import sys

import torch

from avsr_bench.harness import drive, guard, spec


def readings(metrics: list, run) -> dict:
    """``{name: value}`` of each metric of ``metrics`` (BENCHMARK.json
    entries) whose reader (``avsr_bench/metrics/<name>.py``) finds
    something to read in ``run``."""
    out = {}
    for m in metrics:
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = float(value)
    return out


def checks(cell: spec.Cell, run) -> dict:
    """``{number: {"value", "limit"}}`` for every limit of the cell; a
    number the run did not produce reads NaN and fails."""
    got = run.checks or {}
    return {name: {"value": float(got.get(name, float("nan"))), "limit": float(limit)}
            for name, limit in cell.limits.items()}


def _mean(values):
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def result(cell: spec.Cell, run, ranks=None) -> dict:
    """The result line's object.  ``ranks`` holds each rank's (window_s,
    busy_s, per-layer readings, memory peak, forbidden modules) on a
    multi-card cell: per-layer readings and busy time are their means,
    the memory peak the fullest card's."""
    traced = run.traced
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if traced:
        if ranks:
            names = {n for r in ranks for n in r[2]}
            values = {n: _mean([r[2].get(n) for r in ranks]) for n in sorted(names)}
        else:
            values = readings(cell.per_layer, run)
    else:
        values = readings(cell.end_to_end, run)
    peak = max([run.memory_peak_bytes] + [r[3] for r in ranks or []])
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": peak}
    if traced:
        device["busy_s"] = _mean([r[1] for r in ranks]) if ranks else run.busy_s
        device["window_s"] = _mean([r[0] for r in ranks]) if ranks else run.window_s
    found = checks(cell, run)
    correct = all(c["value"] <= c["limit"] for c in found.values())  # NaN compares false
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed,
           "metrics": {n: {"value": v, "unit": units[n]} for n, v in values.items()},
           "device": device}
    if traced:
        out["breakdown"] = {"device_ops": run.summary["device_ops"],
                            "idle_gaps": run.summary["idle_gaps"]}
    out["checks"] = found
    return out


def execute(cell: spec.Cell, root: str, seed: int, seconds: float, traced: bool, t0: float,
            device=None):
    """Run ``cell`` once and return ``(exit code, result line or None)``.
    No line where the run loaded JAX or the JAX package, in this process
    or in a rank's."""
    run, ranks = drive.run_cell(cell, root, seed, seconds, traced, t0, device)
    found = sorted(set(guard.forbidden_modules()).union(
        run.unexpected or [], *[r[4] or [] for r in ranks or []]))
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3, None
    return 0, result(cell, run, ranks)


def emit(out: dict) -> None:
    """Print each compared number beside its limit as the last lines on
    standard error, then the result as the last line on standard output."""
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
