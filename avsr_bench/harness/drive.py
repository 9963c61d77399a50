"""One run of one cell: set-up, the measured window (or, with ``--trace 1``,
the traced window), then the check of what the window produced.

What a run does is its traffic mix's driver, ``avsr_bench/drivers/<driver>.py``
(the traffic file's ``"driver"``), found by name.  A driver exports
``run(cell, seed, seconds, traced, device, t0, world=1, rank=0,
flag_group=None) -> Run`` and ``control(cell, seed, device) -> dict`` (the
readings of its check's control and faults, ``harness/control.py``).  This
module holds what every driver shares: the ``Run`` record, the traced
window, and the launch of one process per card for a cell on several cards
(``ranks`` > 1 in its traffic file), each rank running the driver on its
share with rank 0 reporting.

Set-up makes everything from ``--seed`` (``inputs.py``), runs the cell's
own shapes until every kernel is built and loaded, and ends where the
window starts.
"""

from __future__ import annotations

import dataclasses
import gc
import socket
import time

import torch

from avsr_bench.harness import spec, trace, yardstick


@dataclasses.dataclass
class Run:
    """What a run measured, and what the per-layer readers read."""

    kind: str                    # the driver that made it
    config: dict
    traffic: dict
    device: torch.device
    traced: bool = False
    world: int = 1               # ranks the cell's batch is split over
    setup_s: float = 0.0
    window_s: float = 0.0
    busy_s: float = 0.0           # the card's busy seconds in the traced window
    attempted: int = 0           # requests sent or steps started
    failed: int = 0              # of them, those that never came back
    completed: int = 0           # requests or steps done within the window
    utterances: int = 0          # utterances scored or trained on within it
    valid_frames: int = 0
    memory_peak_bytes: int = 0
    summary: dict = None         # trace.summarize of the window traced with the host
    launches: dict = None        # each LSTM row's (calls, launches) counted in it
    spans: list = None           # the benchmark's own host spans, seconds
    lstm_shape: tuple = None     # (B, T) of the rows' calls
    checks: dict = None          # {number: value}
    unexpected: list = None      # forbidden modules found after the window


def adenet_config(model: dict):
    """The program's ``AdeNetConfig`` for a configuration's ``model``."""
    from ip_avsr_torch.models import adenet

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    streams = [adenet.StreamSpec(**fields(s)) for s in model["streams"]]
    return adenet.AdeNetConfig(streams=streams,
                               **fields({k: v for k, v in model.items() if k != "streams"}))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_precision(config: dict):
    tf32 = bool(config["precision"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _rows_launched() -> dict:
    from ip_avsr_torch.ops.kernels import lstm as lstm_kernels

    return {row: getattr(lstm_kernels, row).launches for row in trace.ROW_PATTERNS}


def _chunks(row: str, B: int, H: int, device) -> int:
    """Cooperative launches per call of ``row`` at (B, H) on ``device``."""
    from ip_avsr_torch.ops.kernels import lstm as lstm_kernels

    sm = torch.cuda.get_device_properties(device).multi_processor_count
    plan = lstm_kernels.bwd_launch_plan if "bwd" in row else lstm_kernels.fwd_launch_plan
    return plan(B, H, sm).chunks


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def trace_window(run: Run, body, device):
    """Run ``body()`` twice under the profiler.  The first window traces the
    card alone, which costs the host next to nothing: its host seconds, the
    card's busy seconds, the nccl kernels' seconds and the top device
    operations in it are the traced window's.  The second traces the host's
    operators too, with their shapes, for the kernels' and GEMMs' times,
    the launch calls and the idle gaps (its host times read slower); the
    LSTM rows' launches are counted over it."""
    sync(device)
    with trace.profiler(device, host=False) as prof:
        t = time.perf_counter()
        body()
        sync(device)
        run.window_s = time.perf_counter() - t
    card = trace.summarize(prof)
    run.busy_s = card["busy_s"]
    before = _rows_launched()
    with trace.profiler(device) as prof:
        body()
        sync(device)
    after = _rows_launched()
    B, H = run.lstm_shape[0], yardstick.lstm_layers(run.config["model"])[0][2]
    run.launches = {row: (after[row] - before[row], (after[row] - before[row]) * (
        _chunks(row, B, H, device) if device.type == "cuda" else 1)) for row in before}
    # the card's own times from the first window, the host's from the second
    run.summary = dict(trace.summarize(prof), **{k: card[k] for k in (
        "busy_s", "nccl_s", "device_ops")})


# -- several cards ------------------------------------------------------------

def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_main(rank: int, world: int, port: int, backend: str, cell_name: str, root: str,
              seed: int, seconds: float, traced: bool, t0: float, queue):
    """One rank of a multi-card cell (the target of :func:`launch`): joins
    the process group, runs its share and puts ``(rank, Run or error)`` on
    ``queue``."""
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
        else:
            device = torch.device("cpu")
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        flags = dist.new_group(backend="gloo")
        try:
            cell = spec.load_cell(cell_name, root)
            run = spec.driver(cell.driver).run(cell, seed, seconds, traced, device, t0,
                                               world=world, rank=rank, flag_group=flags)
            from avsr_bench.harness import report

            readings = report.readings(cell.per_layer, run) if traced else {}
            mine = (run.window_s, run.busy_s, readings,
                    run.memory_peak_bytes, run.unexpected)
            gathered = [None] * world if rank == 0 else None
            dist.gather_object(mine, gathered, dst=0, group=flags)
            run.summary = run.summary if traced else None
            queue.put((rank, (run, gathered)))
        finally:
            dist.destroy_process_group()
    except BaseException as e:  # the parent reports it and fails the run
        import traceback

        queue.put((rank, f"rank {rank}: {type(e).__name__}: {e}\n{traceback.format_exc()}"))
        if not isinstance(e, Exception):
            raise


def launch(cell: spec.Cell, root: str, seed: int, seconds: float, traced: bool, t0: float,
           backend: str = "nccl", target=rank_main, timeout_s: float = 330.0):
    """Start one process per rank (as ``torchrun`` starts ``cli.nstream
    --mesh``), wait for all of them and return rank 0's ``(Run, per-rank
    tuples)``.  Raises if a rank failed; every process has ended on
    return."""
    import multiprocessing as mp

    if backend == "nccl":  # one build of the kernels, before the ranks load them
        from ip_avsr_torch.ops.kernels import _build

        _build.build()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target, args=(r, cell.chips, port, backend, cell.name, root,
                                              seed, seconds, traced, t0, queue))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    got, deadline = {}, time.time() + timeout_s
    try:
        while len(got) < len(procs) and time.time() < deadline:
            try:
                r, payload = queue.get(timeout=1.0)
                got[r] = payload
            except Exception:  # queue.Empty: look whether a rank died silently
                if any(p.exitcode not in (None, 0) for p in procs) and queue.empty():
                    break
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.time()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [v for v in got.values() if isinstance(v, str)]
    if errors or len(got) < len(procs):
        raise RuntimeError("ranks failed:\n" + "\n".join(errors) if errors else
                           f"only {len(got)} of {len(procs)} ranks reported "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return got[0]


def run_cell(cell: spec.Cell, root: str, seed: int, seconds: float, traced: bool, t0: float,
             device=None):
    """The run of ``cell``: ``(Run, per-rank tuples or None)``."""
    if cell.chips > 1:
        return launch(cell, root, seed, seconds, traced, t0,
                      backend="nccl" if (device is None or device.type == "cuda") else "gloo")
    device = device or torch.device("cuda", 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return spec.driver(cell.driver).run(cell, seed, seconds, traced, device, t0), None
