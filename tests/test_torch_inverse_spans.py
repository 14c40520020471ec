"""The inverse step's spans and counters (``perf/spans.py``): nothing is
recorded without a profiler session; under one each call of an AD step
(``make_ad_inverse_step``, ``make_inverse_step``) is the root span
``inverse_step`` holding ``inverse_forward``, ``inverse_backward`` and
``adam``, in that order; the CPU waits on no device. On the card: the
``stream_syncs`` counter against PyTorch's own count of synchronising
calls (``torch.cuda.set_sync_debug_mode``), and the march kernel's
launches inside ``inverse_forward``, the gradient kernel's inside
``inverse_backward``.

This file imports neither JAX nor the JAX package; its card tests (marked
``gpu``) run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_inverse_spans.py
"""

import dataclasses
import warnings

import pytest
import torch

from blackhole_simulation_tpu_torch.configs.simulation import (
    SimulationParams,
    scene_from_params,
)
from blackhole_simulation_tpu_torch.parallel import train
from blackhole_simulation_tpu_torch.perf import spans
from blackhole_simulation_tpu_torch.render import render_radiance

torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]
PHASES = ["inverse_forward", "inverse_backward", "adam"]


@pytest.fixture(autouse=True)
def fresh():
    spans.reset()
    yield
    spans.reset()


def _scene(device, width=16, height=8, max_steps=24):
    scene = scene_from_params(SimulationParams(), width=width,
                              height=height, device=device)
    return dataclasses.replace(scene, march_cfg=dataclasses.replace(
        scene.march_cfg, max_steps=max_steps))


@pytest.fixture(scope="module")
def small():
    scene = _scene("cpu")
    return scene, render_radiance(scene, device="cpu")


def _ad(scene, device="cpu", **kw):
    return train.make_ad_inverse_step(scene, pool=2, march_steps=16,
                                      total_steps=4, device=device, **kw)


def _raw(scene, device="cpu"):
    return train.make_inverse_step(scene, total_steps=4, device=device)


def _check(got, n_steps):
    """``n_steps`` roots numbered 0, 1, ..., each holding the three phases
    in order, every span closed and inside its parent."""
    roots = [i for i, s in enumerate(got) if s.parent is None]
    assert [got[i].name for i in roots] == ["inverse_step"] * n_steps
    assert [got[i].frame for i in roots] == list(range(n_steps))
    for i in roots:
        kids = [s for s in got if s.parent == i]
        assert [s.name for s in kids] == PHASES
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns <= b.start_ns
        for s in kids:
            assert got[i].start_ns <= s.start_ns <= s.end_ns <= got[i].end_ns
            assert s.frame == got[i].frame
    assert len(got) == 4 * n_steps


def test_no_profiler_records_nothing(small):
    scene, target = small
    assert not torch.autograd._profiler_enabled()
    state, _ = _ad(scene)(train.InverseParams.init(), target)
    _raw(scene)(state, target)
    assert spans.recorded() == [] and spans.counters() == {}
    assert not spans.on


@pytest.mark.parametrize("make", [_ad, _raw], ids=["ad", "raw"])
def test_steps_under_the_profiler(small, make):
    scene, target = small
    step = make(scene)
    with torch.profiler.profile(activities=CPU):
        state, _ = step(train.InverseParams.init(), target)
        step(state, target)
    assert not spans.on
    _check(spans.recorded(), 2)
    # The CPU path waits on no device.
    assert spans.counters().get("stream_syncs", 0) == 0


def test_a_raising_step_closes_its_spans(small, monkeypatch):
    scene, target = small
    step = _ad(scene)

    def planted(*args, **kwargs):
        raise RuntimeError("planted")

    with torch.profiler.profile(activities=CPU):
        with monkeypatch.context() as m:
            m.setattr(torch.autograd, "grad", planted)
            with pytest.raises(RuntimeError, match="planted"):
                step(train.InverseParams.init(), target)
        assert not spans.on
        step(train.InverseParams.init(), target)
    got = spans.recorded()
    assert all(s.end_ns > 0 for s in got)
    assert [s.name for s in got if s.frame == 0] == [
        "inverse_step", "inverse_forward", "inverse_backward"]
    assert [s.name for s in got if s.frame == 1] == ["inverse_step"] + PHASES


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_steps(cuda):
    """The configuration's scene (``benchmark/configs/inverse_1080p.json``:
    ``scene_from_params`` on the card) at 256x128, its target, and the
    curriculum's three stages' steps."""
    scene = scene_from_params(SimulationParams(), width=256, height=128,
                              device=cuda)
    target = render_radiance(scene, device=cuda)
    steps = [train.make_ad_inverse_step(scene, None, lr, pool=pool,
                                        march_steps=ms, total_steps=20,
                                        device=cuda)
             for (ms, pool), lr in zip(train._AD_STAGES,
                                       (3e-2, 1.2e-2, 6e-3))]
    return target, steps


@pytest.mark.gpu
def test_stream_syncs_match_the_sync_debug_mode(cuda):
    from benchmark import trace

    target, steps = _card_steps(cuda)
    init = train.InverseParams.init(device=cuda)
    for step in steps:                                  # builds, warms
        step(init, target)
    torch.cuda.synchronize()
    grew = []
    with trace.Profiler():
        for step in steps:
            before = spans.counters().get("stream_syncs", 0)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(init, target)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            grew.append(spans.counters().get("stream_syncs", 0) - before)
            syncs = [w for w in caught if "called a synchronizing CUDA "
                     "operation" in str(w.message)]
            assert grew[-1] == len(syncs), [str(w.message) for w in caught]
        torch.cuda.synchronize()
    # the mass, the fit's two reads and five copies (the birth kernel takes
    # the camera's numbers as launch arguments)
    assert grew == [8, 8, 8]


@pytest.mark.gpu
def test_kernels_launch_inside_their_phases(cuda):
    """The spans' clock is the device trace's: each march-kernel launch of
    a traced step falls inside its step's ``inverse_forward``, each
    gradient-kernel launch (made by autograd's own thread) inside its
    ``inverse_backward``. Two steps, the second counted whole: the trace
    can miss the first launch after the session starts."""
    from benchmark import trace

    target, steps = _card_steps(cuda)
    state = train.InverseParams.init(device=cuda)
    steps[0](state, target)
    torch.cuda.synchronize()
    prof = trace.Profiler()
    with prof:
        for _ in range(2):
            state, _ = steps[0](state, target)
    tr = trace.read(prof)
    got = spans.recorded()
    for pattern, phase in ((r"\bmarch_kernel\b", "inverse_forward"),
                           (r"\bmarch_grad_kernel\b", "inverse_backward")):
        launches = [o.launch for o in tr.kernels(pattern)]
        held = [s for s in got if s.name == phase]
        assert len(held) == 2 and launches
        where = [[i for i, s in enumerate(held)
                  if s.start_ns * 1e-9 <= t <= s.end_ns * 1e-9]
                 for t in launches]
        assert all(len(w) == 1 for w in where), (pattern, where)
        assert sum(w == [1] for w in where) == 1
