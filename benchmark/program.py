"""The program's own spans and counters of a traced window
(``blackhole_simulation_tpu_torch/perf/spans.py``: the port records them
while a profiler session is active, on the host's Unix clock, as the
device trace's launches are stamped). A port without that recorder, or a
window in which it recorded no ``frame`` span, gives None."""

from __future__ import annotations

import types

from benchmark.trace import _merge


def recorded():
    """The spans (start and end in seconds), the counters and the number
    of ``frame`` spans; None where there is nothing to read."""
    try:
        from blackhole_simulation_tpu_torch.perf import spans
    except ImportError:
        return None
    got = [types.SimpleNamespace(name=s.name, start=s.start_ns * 1e-9,
                                 end=s.end_ns * 1e-9, parent=s.parent)
           for s in spans.recorded()]
    frames = sum(s.name == "frame" for s in got)
    if not frames:
        return None
    return types.SimpleNamespace(spans=got, counters=spans.counters(),
                                 frames=frames)


def seconds(got, name: str) -> float:
    """The summed duration of the spans called ``name``."""
    return sum(s.end - s.start for s in got.spans if s.name == name)


def self_seconds(got, name: str) -> float:
    """The summed duration of the spans called ``name`` less that of their
    children."""
    ids = {i for i, s in enumerate(got.spans) if s.name == name}
    inner = sum(s.end - s.start for s in got.spans if s.parent in ids)
    return seconds(got, name) - inner


def idle_within(ops, intervals) -> float:
    """Seconds of the union of ``intervals`` (start, end) in which no device
    operation ran: every gap between the operations, not only the
    longest."""
    busy = _merge((o.start, o.end) for o in ops)
    total, j = 0.0, 0
    for s, e in _merge(intervals):
        total += e - s
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total -= min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return total
