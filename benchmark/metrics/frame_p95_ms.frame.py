"""The 95th percentile of the traced window's frame times (each frame's
call to the synchronise after it), in ms: the tail where it is too
unsteady between machines to hold a bound end to end."""

from benchmark.drivers.frames import p95


def read(ctx):
    lat = ctx.get("latencies_s")
    if not lat:
        return None
    return 1e3 * p95(lat)
