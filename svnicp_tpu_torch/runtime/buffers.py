"""Host-side timestamped ring buffers.

The port's own copy of `svnicp_tpu/runtime/buffers.py`, the replacement for
the reference's mutex-guarded `CircularDataBuffer<T>` (ref:
svn-icp/include/data/Buffer.h:29-275): timestamped append, FIFO pop,
nearest-time query, id access and bulk drain over a bounded deque. A full
buffer drops its oldest entry on push, as the reference's does; the scan
queue of the threaded ingest is `io/native.ScanRing`, which refuses the new
scan instead.
"""

from __future__ import annotations

import bisect
import collections
import threading
from typing import Generic, TypeVar

T = TypeVar("T")


class TimedRingBuffer(Generic[T]):
    """Bounded FIFO of (time, value) pairs, thread-safe, O(log n) time query."""

    def __init__(self, capacity: int = 10000):
        self._values: collections.deque = collections.deque(maxlen=capacity)
        self._times: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._values)

    def push(self, value: T, t: float) -> None:
        """ref: update_buffer (Buffer.h:78-109)."""
        with self._lock:
            self._values.append(value)
            self._times.append(t)

    def pop_first(self) -> tuple[T, float]:
        """ref: get_first_buffer_time_pair_and_pop (Buffer.h:127-136)."""
        with self._lock:
            return self._values.popleft(), self._times.popleft()

    def first_time(self) -> float:
        with self._lock:
            return self._times[0]

    def last(self) -> tuple[T, float]:
        with self._lock:
            return self._values[-1], self._times[-1]

    def at(self, i: int) -> tuple[T, float]:
        """ref: get_buffer_from_id (Buffer.h:202-217): clamps to the last
        element, as the reference warns and returns the last on misuse."""
        with self._lock:
            i = min(i, len(self._values) - 1)
            return self._values[i], self._times[i]

    def nearest(self, t: float) -> tuple[T, float]:
        """The value whose time is closest to t (ref: the time-sorted query,
        Buffer.h:156-200)."""
        with self._lock:
            times = list(self._times)
            i = bisect.bisect_left(times, t)
            if i == 0:
                j = 0
            elif i >= len(times):
                j = len(times) - 1
            else:
                j = i if times[i] - t < t - times[i - 1] else i - 1
            return self._values[j], self._times[j]

    def drain(self) -> list[tuple[T, float]]:
        """ref: bulk drain (Buffer.h:230-261)."""
        with self._lock:
            out = list(zip(self._values, self._times))
            self._values.clear()
            self._times.clear()
            return out
