"""Fixed-size sliding window of recent values (the validation-cost window).

A copy of ip_avsr_tpu/utils/data_structures.py (``CircularList``): push
evicts the oldest item once full; supports indexing, iteration and len().
"""

from __future__ import annotations

from collections import deque


class CircularList:
    def __init__(self, size: int, init=None):
        self._data = deque(maxlen=size)
        self.max_size = size
        if init is not None:
            for _ in range(size):
                self._data.append(init)

    def push(self, item):
        self._data.append(item)

    def pop(self):
        return self._data.popleft() if self._data else None

    def __iter__(self):
        return iter(list(self._data))

    def __getitem__(self, index):
        return list(self._data)[index]

    def __setitem__(self, index, value):
        items = list(self._data)
        items[index] = value
        self._data = deque(items, maxlen=self.max_size)

    def __len__(self):
        return len(self._data)
