"""Device-idle milliseconds per frame inside the program's ``sample``
spans: every interval in which no operation ran on the device (from the
trace's operations, all gaps counted), intersected with the union of the
``sample`` spans. The idle time that the sample loop (host row, upload,
launch) leaves the device."""

from benchmark import program


def read(ctx):
    got = program.recorded()
    ops = ctx["trace"].ops
    if got is None or not ops:
        return None
    samples = [(s.start, s.end) for s in got.spans if s.name == "sample"]
    return 1e3 * program.idle_within(ops, samples) / got.frames
