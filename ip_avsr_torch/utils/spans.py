"""Named spans at the port's layer boundaries: a training step split into
forward, backward and optimizer, a scoring request into staging, pipeline,
encoders, head and the wait for its block, and the collectives.

``with span("train.forward"): ...`` does nothing but one bool check unless
the spans are *armed*: after :func:`enable`, or while a ``torch.profiler``
session records (so a profiled run, ``TrainOptions.profile_dir`` among
them, fills them without a switch).  They are never armed while
``torch.compile`` or ``torch.export`` traces, so an exported program
carries none of them.

An armed span

* enters ``record_function("ip_avsr::<name>")`` (its fast form, a tenth of
  the public one's cost), so the range lands in the profiler's trace, on
  its clock and on the issuing thread;
* keeps a record (at most :data:`MAX_RECORDS`, later spans are traced but
  not kept): its name, its parent's index in the list, the id of the step
  or request it serves (a span opened with ``ident=new_id()`` starts one,
  nested spans inherit it), host start and end from ``time.time_ns()``
  (the Unix-epoch nanoseconds of the profiler's events), and what the site
  attaches: ``count`` (requests in a stacked dispatch), ``ids`` (the
  requests a wait brings home) and ``nbytes`` (a collective's buffer);
* on the card, unless opened with ``device=False``, records a pair of
  timing events on the current stream, from a pool; :func:`records` turns
  them into milliseconds of the card's time between the two points,
  synchronising once.

No span sits inside a loop over leaves, timesteps, row chunks or streams.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "ip_avsr::"
MAX_RECORDS = 1 << 15
_POOL_CHUNK = 64

_enabled = False
_records: list = []
_pool: list = []
_ids = itertools.count()
_local = threading.local()


class _Noop:
    """The shared context of a span that is not armed."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def enable() -> None:
    """Arm the spans until :func:`disable`, with or without a profiler."""
    global _enabled
    _enabled = True
    if torch.cuda.is_initialized():
        _refill()


def disable() -> None:
    """Leave the spans armed only while a profiler records."""
    global _enabled
    _enabled = False


def armed() -> bool:
    """Whether a span opened now would be kept and traced."""
    return (_enabled or _profiler._is_profiler_enabled) and not torch.compiler.is_compiling()


def new_id():
    """A fresh step or request id while armed, else None."""
    return next(_ids) if armed() else None


def clear() -> None:
    """Forget every record (their events go back to the pool)."""
    for r in _records:
        if r.events is not None:
            _pool.extend(r.events)
    _records.clear()


def span(name: str, ident=None, device: bool = True, count=None, ids=None, nbytes=None):
    """The context of the span ``ip_avsr::<name>``: a shared no-op unless
    armed.  ``ident`` is the step or request id (default: the enclosing
    span's); ``device=False`` keeps host times alone."""
    if not (_enabled or _profiler._is_profiler_enabled) or torch.compiler.is_compiling():
        return _NOOP
    return _Span(name, ident, device, count, ids, nbytes)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _refill() -> None:
    _pool.extend(torch.cuda.Event(enable_timing=True) for _ in range(_POOL_CHUNK))


def _event():
    if not _pool:
        _refill()
    return _pool.pop()


class _Span:
    """An armed span and, once entered, its record."""

    __slots__ = ("name", "ident", "device", "count", "ids", "nbytes", "index", "parent",
                 "start_ns", "end_ns", "events", "cuda_index", "device_ms", "_rf")

    def __init__(self, name, ident, device, count, ids, nbytes):
        self.name, self.ident, self.device = name, ident, device
        self.count, self.ids, self.nbytes = count, ids, nbytes
        self.events = self.end_ns = self.device_ms = None

    def __enter__(self):
        st = _stack()
        outer = st[-1] if st else None
        self.parent = None if outer is None else outer.index
        if self.ident is None and outer is not None:
            self.ident = outer.ident
        self.index = None
        if len(_records) < MAX_RECORDS:
            self.index = len(_records)
            _records.append(self)
        self._rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._rf.__enter__()
        if self.device and self.index is not None and torch.cuda.is_initialized():
            self.cuda_index = torch.cuda.current_device()
            self.events = (_event(), _event())
            self.events[0].record()
        st.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _stack().pop()
        self._rf.__exit__(*exc)
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "id": self.ident,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "host_ms": None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6,
                "device_ms": self.device_ms, "count": self.count, "ids": self.ids,
                "nbytes": self.nbytes}


def records() -> list:
    """Every kept record, in the order the spans opened, as dicts:
    ``name``, ``parent`` (index in this list, or None), ``id``,
    ``start_ns``, ``end_ns``, ``host_ms`` (None while open), ``device_ms``
    (None off the card, for host spans and while open), ``count``, ``ids``
    and ``nbytes``.  Waits once for the card where events are pending."""
    pending = [r for r in _records if r.events is not None and r.end_ns is not None]
    for index in sorted({r.cuda_index for r in pending}):
        torch.cuda.synchronize(index)
    for r in pending:
        r.device_ms = r.events[0].elapsed_time(r.events[1])
        _pool.extend(r.events)
        r.events = None
    return [r.as_dict() for r in _records]
