"""The share of the traced window in which no operation ran on the device
(%)."""


def read(ctx):
    if not ctx["trace"].ops:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy() / ctx["window_s"])
