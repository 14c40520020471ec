"""Host-side caching and throttling helpers.

Counterpart of ``blackhole_simulation_tpu/utils/cache.py``:

 - ``PhysicsCache``: an LRU memo keyed by the JSON of its inputs, for the
   scalar physics a UI frame asks for again and again;
 - ``Debouncer``: a trailing-edge debounce of expensive parameter updates;
 - ``IdleDetector``: the "no input for N seconds" latch that throttles the
   frame and physics loops.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict
from typing import Any, Callable


class PhysicsCache:
    """LRU memo keyed by JSON-serialized inputs."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._store: OrderedDict[str, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _key(args, kwargs) -> str:
        return json.dumps([args, kwargs], sort_keys=True, default=float)

    def get_or_compute(self, fn: Callable, *args, **kwargs):
        key = f"{getattr(fn, '__qualname__', fn)}:{self._key(args, kwargs)}"
        if key in self._store:
            self.hits += 1
            self._store.move_to_end(key)
            return self._store[key]
        self.misses += 1
        val = fn(*args, **kwargs)
        self._store[key] = val
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return val

    def wrap(self, fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return self.get_or_compute(fn, *args, **kwargs)

        return wrapped

    def clear(self) -> None:
        self._store.clear()


class Debouncer:
    """Trailing-edge debounce: ``push(value)`` arms the timer; ``poll()``
    fires the callback once ``delay_s`` has passed without a newer push."""

    def __init__(self, callback: Callable[[Any], None], delay_s: float = 0.15,
                 clock: Callable[[], float] = time.monotonic):
        self.callback = callback
        self.delay_s = delay_s
        self.clock = clock
        self._pending: Any = None
        self._armed_at: float | None = None

    def push(self, value: Any) -> None:
        self._pending = value
        self._armed_at = self.clock()

    def poll(self) -> bool:
        if self._armed_at is None:
            return False
        if self.clock() - self._armed_at >= self.delay_s:
            self.callback(self._pending)
            self._armed_at = None
            self._pending = None
            return True
        return False


class IdleDetector:
    """Latched idle detection with threshold (3 s in the reference)."""

    def __init__(self, threshold_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold_s = threshold_s
        self.clock = clock
        self._last_activity = clock()

    def activity(self) -> None:
        self._last_activity = self.clock()

    @property
    def idle(self) -> bool:
        return self.clock() - self._last_activity >= self.threshold_s

    @property
    def idle_seconds(self) -> float:
        return max(self.clock() - self._last_activity, 0.0)
