"""A bounded in-memory log of runtime errors with severity and context.

Counterpart of ``blackhole_simulation_tpu/utils/errors.py``
(``ErrorRecord``, ``ErrorTracker`` and the process-wide ``tracker``).
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from collections import deque


@dataclasses.dataclass(frozen=True)
class ErrorRecord:
    timestamp: float
    severity: str       # "info" | "warning" | "error" | "fatal"
    message: str
    context: str = ""
    trace: str = ""


class ErrorTracker:
    """Bounded ring of ErrorRecords. Thread-safe enough for CPython (deque
    appends are atomic); use one module-level instance per process."""

    def __init__(self, capacity: int = 100):
        self._ring: deque[ErrorRecord] = deque(maxlen=capacity)

    def record(self, severity: str, message: str, context: str = "",
               exc: BaseException | None = None) -> ErrorRecord:
        rec = ErrorRecord(
            timestamp=time.time(),
            severity=severity,
            message=message,
            context=context,
            trace="".join(traceback.format_exception(exc)) if exc else "",
        )
        self._ring.append(rec)
        return rec

    def recent(self, n: int = 20, severity: str | None = None) -> list[ErrorRecord]:
        out = [r for r in self._ring if severity is None or r.severity == severity]
        return out[-n:]

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self._ring:
            out[r.severity] = out.get(r.severity, 0) + 1
        return out

    def clear(self) -> None:
        self._ring.clear()


tracker = ErrorTracker()
