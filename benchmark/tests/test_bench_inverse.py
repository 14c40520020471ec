"""The inverse cell (``inverse_1080p.ad_curriculum``): its files found by
name, its seven readers on a known trace and on nothing, a port without
the recorder, and sessions of its driver on the CPU at a small size,
untraced and traced; the bfloat16 control fails its check there."""

from __future__ import annotations

import json
import sys
import time
import types

import pytest

from benchmark import session, step_spans
from benchmark.drivers import fits
from benchmark.run import HERE, ROOT, cell_spec, load_module
from benchmark.trace import DeviceOp, Trace
from blackhole_simulation_tpu_torch import perf
from blackhole_simulation_tpu_torch.perf import spans

CELL = "inverse_1080p.ad_curriculum"
NEW = ("march_kernel_roofline.step", "grad_kernel_roofline.step",
       "grad_kernel_ms.step", "backward_ms.step", "launches.step",
       "idle_share.step", "stream_syncs.step")
MS = 1_000_000   # ns


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _reader(name):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "t_inverse_" + name.replace(".", "_"))


def test_cell_files_found_by_name():
    spec = cell_spec(CELL)
    assert spec.driver is fits
    checked = {"loss_rel", "grad_rel", "update_rel"}
    assert set(spec.limits) == checked | {"why"}
    assert set(spec.limits["why"]) == checked
    assert [m["name"] for m in spec.per_layer] == list(NEW)
    assert {m["name"] for m in spec.end_to_end} == {"frame_ms", "setup_s"}
    assert spec.config["name"] == spec.cell["config"] == "inverse_1080p"
    for m in spec.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms"


def _trace():
    k = lambda name, s, e, launch=None: DeviceOp(name, s * 1e-3, e * 1e-3,
                                                  None if launch is None
                                                  else launch * 1e-3, True)
    return Trace(ops=[k("void march_kernel<0, true>(float const*)", 0, 1),
                      k("void march_grad_kernel<true, false>(float*)", 2, 4,
                        launch=1.5),
                      k("elementwise_kernel", 4.2, 4.3, launch=1.6),
                      k("elementwise_kernel", 5.0, 5.2, launch=4.95),
                      DeviceOp("Memcpy HtoD", 6e-3, 6.5e-3, None, False)],
                 host=[])


def _recorded():
    """Two steps (ms): the first [0, 10] with its phases, the second [10,
    20] launching nothing."""
    S = spans.Span
    rows = [("inverse_step", 0, 10, 0, None), ("inverse_forward", 0, 1, 0, 0),
            ("inverse_backward", 1.2, 4.8, 0, 0), ("adam", 4.9, 5.1, 0, 0),
            ("inverse_step", 10, 20, 1, None),
            ("inverse_forward", 10, 12, 1, 4),
            ("inverse_backward", 12, 16, 1, 4), ("adam", 16, 17, 1, 4)]
    return [S(n, round(s * MS), round(e * MS), f, p)
            for n, s, e, f, p in rows]


def test_readers_on_a_known_trace(monkeypatch):
    monkeypatch.setattr(spans, "recorded", _recorded)
    monkeypatch.setattr(spans, "counters", lambda: {"stream_syncs": 26})
    ctx = {"trace": _trace(), "window_s": 20e-3, "steps": 2,
           "march_ops": 67e9, "march_bytes": 0.0,     # 1 ms at the peak
           "grad_ops": 134e9, "grad_bytes": 3.35e9 * 1e-3}   # 2 ms
    want = {"march_kernel_roofline.step": 100.0,
            "grad_kernel_roofline.step": 100.0,
            "grad_kernel_ms.step": 1.0,
            # the gradient kernel and the kernel launched at 1.6 ms
            "backward_ms.step": 2.1 / 2,
            "launches.step": 2.0,
            # busy 1 + 2 + 0.1 + 0.2 + 0.5 ms of 20
            "idle_share.step": 100.0 * (1 - 3.8 / 20),
            "stream_syncs.step": 13.0}
    for name in NEW:
        assert _reader(name).read(ctx) == pytest.approx(want[name],
                                                        rel=1e-9), name


def test_readers_find_nothing_to_read(monkeypatch):
    empty = {"trace": Trace([], []), "window_s": 1.0}
    for name in NEW:               # no device operation, no step recorded
        assert _reader(name).read(empty) is None, name
    # A port without the recorder (an older commit): nothing, no error.
    monkeypatch.delattr(perf, "spans")
    monkeypatch.setitem(sys.modules,
                        "blackhole_simulation_tpu_torch.perf.spans", None)
    assert step_spans.recorded() is None
    ctx = {"trace": _trace(), "window_s": 20e-3, "steps": 2}
    assert _reader("backward_ms.step").read(ctx) is None
    assert _reader("stream_syncs.step").read(ctx) is None


def _small(trace=0, seed=987654321123, **traffic):
    spec = cell_spec(CELL)
    spec.config = dict(spec.config, width=32, height=16)
    spec.traffic = dict(spec.traffic, steps=6, steps_sample=64, **traffic)
    spec.seed, spec.seconds, spec.trace = seed, 0.1, trace
    spec.device, spec.t_start = "cpu", time.perf_counter()
    return spec


@pytest.mark.parametrize("trace", [0, 1])
def test_session_on_the_cpu(trace):
    spec = _small(trace)
    out = session.run(spec, fits.Fits(spec))
    assert out["correct"], out["checks"]
    # the window ends with a whole fit
    assert out["attempted"] == 6 and out["failed"] == 0
    assert out["metrics"]["frame_ms"] > 0 and out["metrics"]["setup_s"] > 0
    # The CPU's port divides exactly, as the reference: sums round in
    # another order, and the update's Adam step divides by a leaf's own
    # moment, so a small leaf's rounding shows there most.
    bars = {"loss_rel": 1e-5, "grad_rel": 1e-4, "update_rel": 1e-3}
    assert all(c["value"] < bars[k] for k, c in out["checks"].items())
    if trace:
        ctx = out["layer"]
        assert ctx["steps"] == 6 and len(ctx["steps_per_ray"]) == 3
        assert ctx["march_ops"] > 0 and ctx["grad_ops"] == 5 * ctx[
            "march_ops"]
        got = step_spans.recorded()
        assert got.steps == 6
        assert _reader("stream_syncs.step").read(ctx) == 0.0   # no card
        assert _reader("backward_ms.step").read(ctx) is None   # no device op


def test_control_fails_on_the_cpu():
    spec = _small()
    numbers = fits.Fits(spec).control()
    assert any(v > spec.limits[k] for k, v in numbers.items()), numbers


def test_seed_picks_the_checked_steps():
    a, b = (fits.Fits(types.SimpleNamespace(
        config=json.loads((HERE / "configs" / "inverse_1080p.json")
                          .read_text()),
        traffic=json.loads((HERE / "traffic" / "ad_curriculum.json")
                           .read_text()),
        seed=seed, device="cpu")) for seed in (1, 2**31 + 12345))
    for run in (a, b):
        assert len(run.checked) == 3
        assert all(0 <= i < run.per == 20 for i in run.checked)
    assert (ROOT / "benchmark" / "limits" / f"{CELL}.json").is_file()
