"""Device milliseconds per inverse step of the kernels launched inside the
program's ``inverse_backward`` spans (``torch.autograd.grad`` of the
step's loss: the gradient kernel, the composite's and the birth's
backward)."""

from benchmark import step_spans
from benchmark.trace import Trace


def read(ctx):
    got = step_spans.recorded()
    if got is None or not ctx["trace"].ops:
        return None
    back = Trace(ops=[], host=[(s.start, s.end, s.name) for s in got.spans
                               if s.name == "inverse_backward"])
    ks = back.launched_in(ctx["trace"].kernels(), "inverse_backward")
    return 1e3 * ctx["trace"].seconds(ks) / got.steps
