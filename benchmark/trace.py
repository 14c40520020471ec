"""The device trace of a ``--trace 1`` run: a Kineto session over the card
(CUPTI: kernels, copies and the CUDA runtime's calls) for the measured
window, read from its raw events: every device operation with its
interval and the host time of its launch; and the spans that the
benchmark records around its calls into the program's layers (``spans``:
host clock intervals, in traced runs only), so that a kernel can be
attributed to the layer whose call launched it. Kineto stamps host events
with the Unix clock in nanoseconds (``time.time_ns``), which the spans
use too."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import functools
import re


class Profiler:
    """A Kineto session over the card (CUPTI: kernels, copies, the CUDA
    runtime's calls); its raw result is read by ``read``, without the
    per-event objects that ``torch.profiler`` builds (minutes for a window
    of a million launches), and without recording the framework's host
    ops, which doubled a live frame's time."""

    def __enter__(self):
        import torch
        from torch.autograd import _enable_profiler, _prepare_profiler
        from torch.autograd.profiler import profile
        from torch.profiler import ProfilerActivity

        cuda = torch.cuda.is_available()
        self.acts = {ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU}
        self.cfg = profile(use_device="cuda" if cuda else None).config()
        _prepare_profiler(self.cfg, self.acts)
        _enable_profiler(self.cfg, self.acts)
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import _disable_profiler

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.result = _disable_profiler()
        return False


@contextlib.contextmanager
def spans(targets, out: list):
    """Within the block, each (owner, name, label) of ``targets`` runs the
    callable ``owner.name`` as a span: (start, end, label) in seconds of
    the Unix clock appended to ``out``; restored after."""
    import time

    saved = []
    try:
        for owner, name, label in targets:
            fn = getattr(owner, name)

            @functools.wraps(fn)
            def wrapped(*a, _fn=fn, _label=label, **k):
                t0 = time.time_ns()
                try:
                    return _fn(*a, **k)
                finally:
                    out.append((t0 * 1e-9, time.time_ns() * 1e-9, _label))
            saved.append((owner, name, fn))
            setattr(owner, name, wrapped)
        yield
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float   # seconds, on the trace's clock
    end: float
    launch: float | None   # host time of its launch, if known
    kernel: bool   # False for copies and sets


@dataclasses.dataclass
class Trace:
    ops: list            # DeviceOp, by start
    host: list           # (start, end, label) of the spans, by start

    def __post_init__(self):
        self.host.sort()
        self._starts = [s for s, _, _ in self.host]
        self._reach = []            # the latest end among spans[:i + 1]
        for _, e, _ in self.host:
            self._reach.append(max(e, self._reach[-1]) if self._reach else e)

    def kernels(self, pattern: str = "") -> list:
        rx = re.compile(pattern)
        return [o for o in self.ops if o.kernel and rx.search(o.name)]

    def seconds(self, ops) -> float:
        return sum(o.end - o.start for o in ops)

    def busy(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        the intervals)."""
        total, hi = 0.0, None
        for o in self.ops:
            if hi is None or o.start > hi:
                total += o.end - o.start
                hi = o.end
            elif o.end > hi:
                total += o.end - hi
                hi = o.end
        return total

    def launched_in(self, ops, label: str) -> list:
        """The ops launched inside a span named ``label``."""
        spans = _merge([(s, e) for s, e, n in self.host if n == label])
        starts = [s for s, _ in spans]
        out = []
        for o in ops:
            if o.launch is None:
                continue
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and spans[i][1] >= o.launch:
                out.append(o)
        return out

    def host_at(self, t: float) -> str:
        """The innermost span running at time ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        while i >= 0 and self._reach[i] >= t:
            s, e, n = self.host[i]
            if e >= t:
                return n
            i -= 1
        return "outside the spans"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps grouped by what the host was doing."""
        by_name: dict = {}
        for o in self.ops:
            key = _short(o.name)
            by_name[key] = by_name.get(key, 0.0) + (o.end - o.start)
        gaps, hi = [], None
        for o in self.ops:
            if hi is not None and o.start > hi:
                gaps.append((o.start - hi, hi, o.start))
            hi = o.end if hi is None else max(hi, o.end)
        gaps.sort(reverse=True)
        by_host: dict = {}
        for g, s, e in gaps[:2000]:
            key = _short(self.host_at(0.5 * (s + e)))
            by_host[key] = by_host.get(key, 0.0) + g
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in order(by_name)],
                "idle_gaps": [[k, v] for k, v in order(by_host)]}


def _short(name: str) -> str:
    name = re.sub(r"\(.*", "", name) if name.startswith("void ") else name
    return name.replace("void ", "")[:80]


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(prof: Profiler, host_spans=()) -> Trace:
    """The Trace of a finished ``Profiler``, with the spans recorded in its
    window."""
    from torch.autograd import DeviceType

    runtime, device = {}, []
    for e in prof.result.events():
        kind = e.device_type()
        if kind == DeviceType.CPU:       # the CUDA runtime's calls
            runtime.setdefault(e.correlation_id(), e.start_ns() * 1e-9)
        elif kind == DeviceType.CUDA and not e.is_user_annotation():
            device.append(e)
    ops = []
    for e in device:
        name = e.name()
        ops.append(DeviceOp(name, e.start_ns() * 1e-9, e.end_ns() * 1e-9,
                            runtime.get(e.correlation_id()),
                            not re.match(r"(?i)mem(cpy|set)", name)))
    ops.sort(key=lambda o: o.start)
    return Trace(ops=ops, host=list(host_spans))
