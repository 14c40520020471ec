"""The render kernel's share of its roofline over the traced window's
frames (%): the least time for their work (the frozen operation counts on
the reference's step totals, at the float32 peak; or their bytes at the
memory rate) over the kernel's device time."""

from benchmark import peaks


def read(ctx):
    tr = ctx["trace"]
    t = tr.seconds(tr.kernels(r"\brender_kernel\b"))
    if t <= 0.0 or "render_ops" not in ctx:
        return None
    return 100.0 * peaks.least_seconds(ctx["render_ops"],
                                       ctx["render_bytes"]) / t
