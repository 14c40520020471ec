"""One reader per per-layer metric, found by the metric's name: ``read(ctx)``
takes the traced window's context (``trace``: ``benchmark.trace.Trace``;
``window_s``; the driver's counts and work) and returns the number, or None
where the trace holds nothing to read."""
