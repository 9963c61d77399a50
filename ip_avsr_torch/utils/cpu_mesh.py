"""Ranks of a process group on one host: the port's counterpart of
ip_avsr_tpu/utils/cpu_mesh.py.

The JAX package provisions a mesh of virtual CPU devices inside one process
(``XLA_FLAGS=--xla_force_host_platform_device_count``).  In PyTorch a device
of a mesh is a process of a ``torch.distributed`` group, so its counterpart
starts ranks: :class:`RankPool` spawns ``n`` processes, each joins one group
(rendezvous on a free ``localhost`` port, a group timeout of tens of
seconds) and then runs the tasks it is sent, one at a time, every rank the
same task, as one SPMD program; :func:`spawn_ranks` runs one task in a pool
of its own.  A task is a module-level function (pickled by its import path)
with picklable arguments; every rank's return value comes back to the
caller, by rank.  A rank that raises, exits or misses the deadline makes
the call raise, after the pool has stopped every rank.

The backend is ``nccl`` when CUDA is available and ``gloo`` otherwise
unless the caller names one (``gloo`` runs ``all_reduce`` and
``broadcast`` on CUDA tensors too, so two ranks can share one card);
nothing here switches it.  Each rank runs ``torch.set_num_threads(1)``
and, under ``nccl``, ``torch.cuda.set_device(rank % device_count)``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import time
import traceback

import torch

# seconds a task may take on every rank before the pool gives up on it
TASK_TIMEOUT_S = 120.0
# seconds a collective waits for its peers (torch.distributed's timeout)
GROUP_TIMEOUT_S = 30.0
# seconds the ranks get to leave the group and exit after the last task
JOIN_TIMEOUT_S = 30.0


def free_port() -> int:
    """A TCP port that is free on ``localhost`` now (bound through port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _rank_main(rank, n, port, backend, group_timeout_s, tasks, results):
    """A rank's life: join the group, run tasks until ``None``, leave."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=n,
                            rank=rank, timeout=datetime.timedelta(seconds=group_timeout_s))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                value = fn(*args, **kwargs)
            except BaseException:
                results.put((rank, False, traceback.format_exc()))
                # the group may be left mid-collective: this rank stops here
                raise
            results.put((rank, True, value))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``n`` spawned ranks of one process group that run tasks on request.

    ``run(fn, *args, **kwargs)`` sends the task to every rank and returns
    the list of their return values, by rank; it raises ``TimeoutError``
    when not every rank answered within ``timeout_s`` and ``RuntimeError``
    when a rank raised or exited, and in both cases stops every rank first
    (the next ``run`` starts a fresh pool).  ``close`` ends the ranks and
    joins them within ``JOIN_TIMEOUT_S``, raising if one had to be killed
    or exited with another code than 0.  Use it as a context manager."""

    def __init__(self, n: int, backend=None, timeout_s: float = TASK_TIMEOUT_S,
                 group_timeout_s: float = GROUP_TIMEOUT_S):
        if n < 1:
            raise ValueError(f"a pool needs at least one rank, got {n}")
        self.n = int(n)
        self.backend = backend or default_backend()
        self.timeout_s = float(timeout_s)
        self.group_timeout_s = float(group_timeout_s)
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(check=exc[0] is None)

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        port = free_port()
        self._tasks = [ctx.Queue() for _ in range(self.n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, self.n, port, self.backend, self.group_timeout_s,
                                         self._tasks[r], self._results))
                       for r in range(self.n)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self._kill()
            raise

    def _kill(self):
        started = [p for p in self._procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(5)
        self._procs = None

    def run(self, fn, *args, **kwargs) -> list:
        if self._procs is None:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        deadline = time.monotonic() + self.timeout_s
        out, got = [None] * self.n, 0
        while got < self.n:
            left = deadline - time.monotonic()
            if left <= 0:
                self._kill()
                raise TimeoutError(f"{fn.__name__}: not every rank of {self.n} answered "
                                   f"within {self.timeout_s:.0f} s")
            try:
                rank, ok, value = self._results.get(timeout=min(left, 0.5))
            except queue.Empty:
                gone = [(r, p.exitcode) for r, p in enumerate(self._procs) if not p.is_alive()]
                if gone:
                    self._kill()
                    raise RuntimeError(f"{fn.__name__}: rank(s) exited without a result "
                                       f"(rank, exit code): {gone}") from None
                continue
            if not ok:
                self._kill()
                raise RuntimeError(f"{fn.__name__} failed on rank {rank} of {self.n}:\n{value}")
            out[rank], got = value, got + 1
        return out

    def close(self, check: bool = True):
        """End the ranks; with ``check``, raise if one would not end or
        ended with another code than 0."""
        if self._procs is None:
            return
        for q in self._tasks:
            q.put(None)
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in self._procs]
        hung = [r for r, p in enumerate(self._procs) if p.is_alive()]
        self._kill()
        if check and (hung or any(codes)):
            raise RuntimeError(f"ranks did not end cleanly: hung {hung}, exit codes {codes}")


def spawn_ranks(n: int, fn, *args, backend=None, timeout_s: float = TASK_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``n`` fresh ranks of one process group and
    return the ranks' results, by rank (a :class:`RankPool` of one task)."""
    with RankPool(n, backend=backend, timeout_s=timeout_s) as pool:
        return pool.run(fn, *args)
