"""The program's spans and counters of a traced window of inverse steps
(``blackhole_simulation_tpu_torch/perf/spans.py``: ``inverse_step`` a
step, ``inverse_forward``, ``inverse_backward`` and ``adam`` in it, the
``stream_syncs`` counter). A port without that recorder, or a window in
which it recorded no ``inverse_step`` span, gives None."""

from __future__ import annotations

import types


def recorded():
    """The spans (start and end in seconds), the counters and the number
    of ``inverse_step`` spans; None where there is nothing to read."""
    try:
        from blackhole_simulation_tpu_torch.perf import spans
    except ImportError:
        return None
    got = [types.SimpleNamespace(name=s.name, start=s.start_ns * 1e-9,
                                 end=s.end_ns * 1e-9, parent=s.parent)
           for s in spans.recorded()]
    steps = sum(s.name == "inverse_step" for s in got)
    if not steps:
        return None
    return types.SimpleNamespace(spans=got, counters=spans.counters(),
                                 steps=steps)
