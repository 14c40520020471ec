"""The readers of the program's spans and counters (``benchmark/program.py``
and the ``host_row_ms``, ``host_wait_ms``, ``stream_syncs`` and
``idle_in_samples_ms`` metrics) on known spans, and a traced frame session
on the CPU, whose program records one ``frame`` span a frame."""

from __future__ import annotations

import sys

import pytest

from benchmark import session
from benchmark.drivers import frames
from benchmark.run import HERE, load_module
from benchmark.trace import DeviceOp, Trace
from blackhole_simulation_tpu_torch import perf
from blackhole_simulation_tpu_torch.perf import spans

NEW = ("host_row_ms.frame", "host_wait_ms.frame", "stream_syncs.frame",
       "idle_in_samples_ms.frame")
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "t_spans_" + name.replace(".", "_"))


def _recorded(base):
    """Two frames: the first of two samples, the second of one; each sample
    a host row with its upload inside it (times in ms after ``base`` ns)."""
    S = spans.Span
    at = lambda ms: base + round(ms * MS)
    rows = [("frame", 0, 10, 0, None),
            ("sample", 1, 4, 0, 0), ("host_row", 1, 2.5, 0, 1),
            ("row_upload", 2, 2.4, 0, 2),
            ("sample", 5, 8, 0, 0), ("host_row", 5, 6, 0, 4),
            ("row_upload", 5.8, 6, 0, 5),
            ("frame", 10, 20, 1, None),
            ("sample", 11, 15, 1, 7), ("host_row", 11, 12, 1, 8),
            ("row_upload", 11.5, 11.7, 1, 9)]
    return [S(n, at(s), at(e), f, p) for n, s, e, f, p in rows]


def _ops(base):
    """Device operations (seconds) straddling the samples' edges: busy
    [1.5, 3] and [3.5, 4.5] against the sample [1, 4]; [4.8, 5.2] and
    [6.5, 9] against [5, 8]; [12, 14] (two overlapping ops) against
    [11, 15]."""
    t = lambda ms: (base + ms * MS) * 1e-9
    busy_ms = [(1.5, 3.0), (3.5, 4.5), (4.8, 5.2), (6.5, 9.0), (12.0, 13.5),
                (13.0, 14.0)]
    return [DeviceOp("k", t(s), t(e), None, True) for s, e in busy_ms]


@pytest.mark.parametrize("base, tol", [
    (0, dict(rel=1e-9)),
    # a Unix time in ns: the seconds' float64 ulp is 0.24 us
    (1_760_000_000 * 10**9, dict(abs=2e-3))])
def test_readers_on_known_spans(monkeypatch, base, tol):
    monkeypatch.setattr(spans, "recorded", lambda: _recorded(base))
    monkeypatch.setattr(spans, "counters", lambda: {"stream_syncs": 3})
    ctx = {"trace": Trace(_ops(base), []), "window_s": 20e-3, "frames": 2}
    want = {
        # self time: (1.5 - 0.4) + (1.0 - 0.2) + (1.0 - 0.2) ms
        "host_row_ms.frame": 2.7 / 2,
        "host_wait_ms.frame": (0.4 + 0.2 + 0.2) / 2,
        "stream_syncs.frame": 3 / 2,
        # idle: [1, 1.5] + [3, 3.5]; [5.2, 6.5]; [11, 12] + [14, 15]
        "idle_in_samples_ms.frame": (1.0 + 1.3 + 2.0) / 2,
    }
    for name in NEW:
        assert _reader(name).read(ctx) == pytest.approx(want[name], **tol)


def test_readers_find_nothing_to_read(monkeypatch):
    ctx = {"trace": Trace(_ops(0), []), "window_s": 20e-3, "frames": 2}
    for name in NEW:               # no frame recorded
        assert _reader(name).read(ctx) is None
    monkeypatch.setattr(spans, "recorded", lambda: _recorded(0))
    assert _reader("idle_in_samples_ms.frame").read(
        dict(ctx, trace=Trace([], []))) is None
    assert _reader("stream_syncs.frame").read(ctx) == 0.0
    # A port without the recorder (an older commit): nothing, no error.
    monkeypatch.delattr(perf, "spans")
    monkeypatch.setitem(sys.modules,
                        "blackhole_simulation_tpu_torch.perf.spans", None)
    for name in NEW:
        assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("cell, n_samples", [
    ("flagship_1080p.live_1spp", 1), ("flagship_1080p.ss16_orbit", 2)])
def test_traced_session_records_a_frame_span_per_frame(spec_of, cell,
                                                       n_samples):
    spec = spec_of(cell, trace=1, n_samples=n_samples)
    out = session.run(spec, frames.Frames(spec))
    assert out["correct"], out["checks"]
    got = spans.recorded()
    n = out["layer"]["frames"]
    assert n >= 1 and sum(s.name == "frame" for s in got) == n
    assert sum(s.name == "sample" for s in got) == n * n_samples
    ctx = out["layer"]
    assert _reader("host_row_ms.frame").read(ctx) > 0.0
    assert _reader("host_wait_ms.frame").read(ctx) > 0.0
    assert _reader("stream_syncs.frame").read(ctx) == 0.0   # no card here
