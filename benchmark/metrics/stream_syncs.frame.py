"""The host's waits on the device per frame: the program's
``stream_syncs`` counter (counted where each wait happens on the frame
path) over its ``frame`` spans."""

from benchmark import program


def read(ctx):
    got = program.recorded()
    if got is None:
        return None
    return got.counters.get("stream_syncs", 0) / got.frames
