"""The share of the traced window of inverse steps in which no operation
ran on the device (%)."""


def read(ctx):
    if not ctx["trace"].ops or not ctx.get("steps"):
        return None
    return 100.0 * (1.0 - ctx["trace"].busy() / ctx["window_s"])
