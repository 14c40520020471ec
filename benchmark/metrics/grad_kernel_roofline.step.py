"""The gradient kernel's share of its roofline over the traced window's
inverse steps (%): the least time for their reverse marches (5 x 340
operations a live step of the reference's, at the float32 peak; or their
bytes at the memory rate) over the kernel's device time."""

from benchmark import peaks


def read(ctx):
    tr = ctx["trace"]
    t = tr.seconds(tr.kernels(r"\bmarch_grad_kernel\b"))
    if t <= 0.0 or "grad_ops" not in ctx:
        return None
    return 100.0 * peaks.least_seconds(ctx["grad_ops"],
                                       ctx["grad_bytes"]) / t
