"""The frame path's spans and counters (``perf/spans.py``): nothing is
recorded without a profiler session; under one a fused ``render`` records
its frame, samples, host rows and row uploads, nested by parent and by
time, and a staged one its frame and samples only. On the card: the
``stream_syncs`` counter against PyTorch's own count of synchronising
calls (``torch.cuda.set_sync_debug_mode``), and the spans' clock against
the device trace's launch times.

This file imports neither JAX nor the JAX package; its card tests (marked
``gpu``) run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_spans.py
"""

import warnings

import pytest
import torch

from blackhole_simulation_tpu_torch.models.nrs import nrs_init
from blackhole_simulation_tpu_torch.perf import spans
from blackhole_simulation_tpu_torch.render import (
    Camera,
    Features,
    MarchConfig,
    PostParams,
    Scene,
)
from blackhole_simulation_tpu_torch.render.pipeline import (
    render,
    render_radiance,
)

torch.set_num_threads(1)

FUSED = MarchConfig(max_steps=24, use_pallas=True, fused=True,
                    shadow_precull=True)
CPU = [torch.profiler.ProfilerActivity.CPU]


def _scene(cfg=FUSED, width=16, height=12, mass=1.0, **kw):
    cam = Camera.create(r=30.0, theta=1.3, fov=0.5, width=width,
                        height=height)
    return Scene.create(mass=mass, spin=0.9, camera=cam, march_cfg=cfg,
                        post=PostParams(bloom_passes=1), **kw)


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _children(got, i):
    return [s for s in got if s.parent == i]


def _check_nesting(got):
    """Every span closed, inside its parent in time, in its parent's frame;
    a frame has no parent."""
    for s in got:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.name == "frame"
            continue
        p = got[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.frame == p.frame


def test_no_profiler_records_nothing():
    assert not torch.autograd._profiler_enabled()
    render(_scene(), n_samples=2, device="cpu")
    render_radiance(_scene(), device="cpu")
    assert spans.recorded() == [] and spans.counters() == {}
    assert not spans.on


def test_fused_render_under_the_profiler():
    with torch.profiler.profile(activities=CPU):
        render(_scene(), n_samples=2, device="cpu")
    assert not spans.on
    got = spans.recorded()
    names = [s.name for s in got]
    assert sorted(names) == sorted(["frame"] + 2 * ["sample", "host_row",
                                                    "row_upload"])
    assert {s.frame for s in got} == {0}
    _check_nesting(got)
    frame = names.index("frame")
    samples = _children(got, frame)
    assert [s.name for s in samples] == ["sample", "sample"]
    assert samples[0].end_ns <= samples[1].start_ns
    for sample in samples:
        (row,) = _children(got, got.index(sample))
        assert row.name == "host_row"
        (up,) = _children(got, got.index(row))
        assert up.name == "row_upload" and _children(got, got.index(up)) == []
    # The CPU path waits on no device.
    assert spans.counters().get("stream_syncs", 0) == 0


def test_frames_are_numbered_and_reset():
    scene = _scene()
    with torch.profiler.profile(activities=CPU):
        for _ in range(3):
            render(scene, device="cpu")
    frames = [s for s in spans.recorded() if s.name == "frame"]
    assert [s.frame for s in frames] == [0, 1, 2]
    assert len(spans.recorded()) == 3 * 4
    spans.reset()
    assert spans.recorded() == []
    with torch.profiler.profile(activities=CPU):
        render(scene, device="cpu")
    assert [s.frame for s in spans.recorded()] == [0] * 4


def test_staged_render_records_frame_and_samples_only():
    staged = _scene(MarchConfig(max_steps=24))
    with torch.profiler.profile(activities=CPU):
        render(staged, n_samples=2, device="cpu")
    got = spans.recorded()
    assert sorted(s.name for s in got) == ["frame", "sample", "sample"]
    _check_nesting(got)


def test_render_radiance_alone_records_nothing():
    """Only ``render`` opens a frame: a sample rendered outside one is not
    recorded, under the profiler or not."""
    with torch.profiler.profile(activities=CPU):
        render_radiance(_scene(), device="cpu")
    assert spans.recorded() == []


def test_a_raising_frame_closes_its_spans(monkeypatch):
    import blackhole_simulation_tpu_torch.ops.render as ops_render

    def planted(row, st):
        raise RuntimeError("planted")

    scene = _scene()
    with torch.profiler.profile(activities=CPU):
        with monkeypatch.context() as m:
            m.setattr(ops_render, "render_planes_kernel", planted)
            with pytest.raises(RuntimeError, match="planted"):
                render(scene, n_samples=2, device="cpu")
        assert not spans.on
        render(scene, device="cpu")
    got = spans.recorded()
    assert all(s.end_ns > 0 for s in got)
    _check_nesting(got)
    assert [s.frame for s in got if s.name == "frame"] == [0, 1]
    assert [s.name for s in got if s.frame == 0] == [
        "frame", "sample", "host_row", "row_upload"]


# ---- on the card -----------------------------------------------------------

# The flagship march (benchmark/configs/flagship_1080p.json) at 1080p.
FLAGSHIP = MarchConfig(max_steps=256, use_pallas=True, fused=True,
                       shadow_precull=True, step_rate=0.2,
                       far_step_cap_rate=0.4, far_boost_radius=20.0,
                       approx_recip=True, midpoint_iters=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flagship(device):
    cam = Camera.create(r=30.0, theta=1.3207963267948966, fov=0.5,
                        width=1920, height=1080)
    return Scene.create(mass=1.0, spin=0.999, camera=cam, march_cfg=FLAGSHIP,
                        features=Features(spectral_lut=True),
                        post=PostParams(exposure=1.2))


def _nrs_tensor_leaves(device):
    """A fused NRS scene whose mass is a tensor on the card: its row reads
    the mass and the weights back (``host``, ``nrs_flat_weights``)."""
    cam = Camera.create(r=30.0, theta=1.3, fov=1.0, width=480, height=270)
    cfg = MarchConfig(max_steps=48, use_pallas=True, fused=True,
                      shadow_precull=True, step_rate=0.2,
                      far_step_cap_rate=0.4, far_boost_radius=20.0,
                      midpoint_iters=1)
    return Scene.create(mass=torch.tensor(1.0, device=device), spin=0.9,
                        camera=cam, march_cfg=cfg,
                        features=Features(nrs_far_field=True),
                        nrs_params=nrs_init(0, device))


@pytest.mark.gpu
@pytest.mark.parametrize("make, n_samples, want", [
    (_flagship, 16, 16), (_flagship, 1, 1), (_nrs_tensor_leaves, 4, None)])
def test_stream_syncs_match_the_sync_debug_mode(cuda, make, n_samples, want):
    scene = make(cuda)
    from benchmark import trace

    render(scene, n_samples=n_samples, device=cuda)      # builds, warms
    torch.cuda.synchronize()
    with trace.Profiler():
        before = spans.counters().get("stream_syncs", 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                render(scene, n_samples=n_samples, device=cuda)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        grew = spans.counters().get("stream_syncs", 0) - before
        torch.cuda.synchronize()
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert grew == len(syncs), [str(w.message) for w in caught]
    if want is not None:
        assert grew == want


@pytest.mark.gpu
def test_render_launches_lie_inside_their_samples(cuda):
    """The spans' clock is the device trace's: every render kernel launch
    in a traced window falls inside one ``sample`` span, after that
    sample's ``row_upload`` ended, and each sample of a 16-sample frame
    holds one. The window holds two frames and the second is counted: the
    trace can miss the first launch after the session starts."""
    from benchmark import trace

    scene = _flagship(cuda)
    render(scene, n_samples=16, device=cuda)
    torch.cuda.synchronize()
    prof = trace.Profiler()
    with prof:
        for _ in range(2):
            render(scene, n_samples=16, device=cuda)
    launches = [o.launch for o in trace.read(prof).kernels(
        r"\brender_kernel\b")]
    got = spans.recorded()
    samples = [i for i, s in enumerate(got) if s.name == "sample"]
    assert len(samples) == 32 and len(launches) >= 16
    held = {i: 0 for i in samples}
    for t in launches:
        inside = [i for i in samples
                  if got[i].start_ns * 1e-9 <= t <= got[i].end_ns * 1e-9]
        assert len(inside) == 1, t
        (row,) = _children(got, inside[0])
        (up,) = _children(got, got.index(row))
        assert up.name == "row_upload" and up.end_ns * 1e-9 <= t
        held[inside[0]] += 1
    assert [held[i] for i in samples if got[i].frame == 1] == [1] * 16
