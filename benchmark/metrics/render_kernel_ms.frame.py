"""Device milliseconds of the render kernel per frame."""


def read(ctx):
    tr = ctx["trace"]
    ks = tr.kernels(r"\brender_kernel\b")
    if not ks or not ctx.get("frames"):
        return None
    return 1e3 * tr.seconds(ks) / ctx["frames"]
