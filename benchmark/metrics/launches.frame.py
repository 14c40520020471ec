"""Kernel launches per frame."""


def read(ctx):
    if not ctx.get("frames"):
        return None
    return len(ctx["trace"].kernels()) / ctx["frames"]
