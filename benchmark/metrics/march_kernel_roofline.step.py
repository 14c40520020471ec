"""The march kernel's share of its roofline over the traced window's
inverse steps (%): the least time for their forward marches (the frozen
operation count on the reference's steps, at the float32 peak; or their
bytes at the memory rate) over the kernel's device time."""

from benchmark import peaks


def read(ctx):
    tr = ctx["trace"]
    t = tr.seconds(tr.kernels(r"\bmarch_kernel\b"))
    if t <= 0.0 or "march_ops" not in ctx:
        return None
    return 100.0 * peaks.least_seconds(ctx["march_ops"],
                                       ctx["march_bytes"]) / t
