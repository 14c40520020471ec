"""The tone map's share of its roofline (%): the least time to read the
(H, W, 3) float32 image once and write it once, per frame, over the device
time of the kernels launched inside the ``post`` span (the benchmark's
span around the program's ``render/post.py::tonemap``)."""

from benchmark import peaks


def read(ctx):
    tr = ctx["trace"]
    t = tr.seconds(tr.launched_in(tr.kernels(), "post"))
    if t <= 0.0 or "post_bytes" not in ctx:
        return None
    return 100.0 * peaks.least_seconds(0.0, ctx["post_bytes"]) / t
