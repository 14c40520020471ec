"""The host's waits on the device per inverse step: the program's
``stream_syncs`` counter (counted where each wait happens on the step's
path) over its ``inverse_step`` spans."""

from benchmark import step_spans


def read(ctx):
    got = step_spans.recorded()
    if got is None:
        return None
    return got.counters.get("stream_syncs", 0) / got.steps
