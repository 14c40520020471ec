"""Device milliseconds of the gradient kernel per inverse step."""


def read(ctx):
    tr = ctx["trace"]
    ks = tr.kernels(r"\bmarch_grad_kernel\b")
    if not ks or not ctx.get("steps"):
        return None
    return 1e3 * tr.seconds(ks) / ctx["steps"]
