"""Kernel launches per inverse step."""


def read(ctx):
    if not ctx.get("steps"):
        return None
    return len(ctx["trace"].kernels()) / ctx["steps"]
