"""Background prefetching for batch generators.

A copy of ip_avsr_tpu/data/prefetch.py: ``prefetch`` runs an iterator on a
daemon thread a bounded number of items ahead, so host-side batch assembly
overlaps the device's work on the current step.  Order is kept, and an
exception of the producer is raised in the consumer where the failing item
would have been consumed.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _End:
    pass


_END = _End()
# seconds an abandoned prefetch waits for its producer to stop
JOIN_TIMEOUT_S = 10.0


class _Raised:
    """A forwarded producer exception, kept apart from the data so that an
    iterator that yields exception objects still delivers them as values."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable, buffer_size: int = 2) -> Iterator:
    """Iterate ``iterable`` on a daemon thread, ``buffer_size`` items ahead.

    Abandoning the returned generator (break, exception, garbage
    collection) stops the producer: its puts give up once the consumer is
    gone, and the generator waits (``JOIN_TIMEOUT_S`` at most) for the item
    it is making."""
    if buffer_size < 1:
        raise ValueError("buffer_size must be >= 1")
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- forwarded to the consumer
            _put(_Raised(e))
            return
        _put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item
    finally:
        stop.set()
        # drain so a producer blocked mid-put sees the stop promptly
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        # let the producer finish the item it is making: a daemon thread
        # still inside torch when the interpreter exits aborts the process
        t.join(JOIN_TIMEOUT_S)
