"""The traced window: a ``torch.profiler`` trace of host and card, reduced to
what the per-layer metrics read.

:func:`summarize` walks the trace's events once: the card's operations
(their union is the busy time; by name they make the breakdown), the LSTM
kernel rows' records (checked against the port's launch counters by
:func:`row_time`), the ``aten::mm`` and ``aten::addmm`` calls with their
shapes and device time, the host's kernel-launch calls, the nccl kernels,
and the idle gaps on the card named by what the issuing thread was doing.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys

import torch

# the host API calls that put a kernel on the card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
# the LSTM rows' float32 instantiations as a trace names them:
# lstm_fwd_chain_kernel<EmitResiduals, Peephole, U, float> and
# lstm_bwd_chain_kernel<Peephole, U, float>
ROW_PATTERNS = {
    "lstm_recurrence": r"lstm_fwd_chain_kernel<false, false, \d+, float\s*>",
    "lstm_peep_recurrence": r"lstm_fwd_chain_kernel<false, true, \d+, float\s*>",
    "lstm_recurrence_train": r"lstm_fwd_chain_kernel<true, false, \d+, float\s*>",
    "lstm_peep_recurrence_train": r"lstm_fwd_chain_kernel<true, true, \d+, float\s*>",
    "lstm_bwd_chain": r"lstm_bwd_chain_kernel<false, \d+, float\s*>",
    "lstm_peep_bwd_chain": r"lstm_bwd_chain_kernel<true, \d+, float\s*>",
}
GEMM_OPS = ("aten::mm", "aten::addmm")
TOP = 10


def profiler(device: torch.device, host: bool = True):
    """A profiler of the card and, with ``host``, of the host's operators
    with their input shapes (the GEMMs' operations come from them)."""
    acts = []
    if host or device.type != "cuda":
        acts.append(torch.profiler.ProfilerActivity.CPU)
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=host)


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _device_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _gemm_shape(e):
    shapes = [s for s in (e.input_shapes or []) if len(s) == 2]
    if len(shapes) < 2:
        return None
    (M, K), (K2, N) = shapes[-2], shapes[-1]
    return (M, K, N) if K == K2 else None


def summarize(prof) -> dict:
    """The trace reduced: times in seconds.  ``busy_s`` is the union of the
    card's operations; ``rows`` maps each LSTM row to (records, seconds);
    ``gemms`` lists (M, K, N, seconds) per product; ``launch_calls`` counts
    the host's launch calls; ``nccl_s`` sums the nccl kernels;
    ``device_ops`` and ``idle_gaps`` are the breakdown's two lists."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    # the card's operations; ranges that the host annotated on the card's
    # timeline ("nccl:all_reduce" around nccl's kernel) are not operations
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = collections.Counter()
    rows = {row: [0, 0.0] for row in ROW_PATTERNS}
    nccl = 0.0
    for e in dev:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur
        if re.match(r"nccl(Dev)?Kernel", e.name):
            nccl += dur
        for row, pat in ROW_PATTERNS.items():
            if re.search(pat, e.name):
                rows[row][0] += 1
                rows[row][1] += dur / 1e6
    gemms = []
    for e in cpu:
        if e.name in GEMM_OPS:
            shape = _gemm_shape(e)
            if shape is not None:
                gemms.append((*shape, _device_us(e) / 1e6))
    launches = [e for e in cpu if e.name in LAUNCH_CALLS]
    threads = collections.Counter(e.thread for e in launches)
    issuing = threads.most_common(1)[0][0] if threads else None
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                   if e.thread == issuing), key=lambda t: t[0])
    starts = [h[0] for h in host]
    gaps = collections.Counter()
    merged = _merged(spans)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + nxt)
        name = "no host op"
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if host[i][1] >= mid:
                name = host[i][2]
                break
            if mid - host[i][0] > 1e6:
                break
        gaps[name] += (nxt - end) / 1e6
    return {
        "busy_s": sum(e - s for s, e in merged) / 1e6,
        "rows": {k: tuple(v) for k, v in rows.items()},
        "gemms": gemms,
        "launch_calls": len(launches),
        "nccl_s": nccl / 1e6,
        "device_ops": [[n, us / 1e6] for n, us in by_name.most_common(TOP)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)],
    }


def row_time(summary: dict, row: str, launches: int):
    """The seconds of ``launches`` launches of ``row`` by the trace: the
    mean of its recorded launches times the count the port's counters
    gave, never the sum of whatever was recorded.  None where the trace
    holds no record of it.  A count that differs from the records is
    reported on standard error."""
    records, seconds = summary["rows"][row]
    if records == 0:
        if launches:
            print(f"trace: {row}: no record of its {launches} counted launches", file=sys.stderr)
        return None
    if records != launches:
        print(f"trace: {row}: {records} records against {launches} counted launches; "
              f"time taken as the records' mean x the count", file=sys.stderr)
    return seconds / records * launches
