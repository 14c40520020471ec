"""The engine facade and the native bridge on the port against the JAX
package's, on the CPU.

``PhysicsEngine(device="cpu")`` with ``prefer_native`` True and False
against JAX's ``PhysicsEngine`` over tests/test_engine.py's API and the
rest of the facade: every float64 number and array at rel 1e-10
(measured: at most 5.3e-16, the Kretschmann field; the float32 LUTs and
meshes and the shadow curves equal), ``integrate_ray_relativistic`` with
the same termination and step count (its final states within rel 1e-6,
measured 2.0e-8: the step controller turns last-bit differences in the
right-hand side into other step sizes). The
bridges: tests/test_engine.py's behavioural bars on the port's
``NativeBridge`` and ``PyBridge``, the native shadow curve against the
port's ``bardeen_shadow``, seqlock reads under the heartbeat. The port's
loader writes nothing under ``native/``: with a stale library it builds
its copy elsewhere, and without a compiler it logs its fall back to
``PyBridge``.
"""

import logging
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.engine import PhysicsEngine as JPhysicsEngine
from blackhole_simulation_tpu_torch.engine import (
    NativeBridge,
    PhysicsEngine,
    PyBridge,
    load_bridge,
)
from blackhole_simulation_tpu_torch.engine import native as tnative
from blackhole_simulation_tpu_torch.geodesic import TERM_ESCAPE, TERM_HORIZON
from blackhole_simulation_tpu_torch.geometry.radii import (
    event_horizon,
    isco,
    photon_sphere,
)
from blackhole_simulation_tpu_torch.physics import bardeen_shadow

torch.set_num_threads(1)

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
R_GRID = np.linspace(1.2, 20.0, 64)
TH_GRID = np.linspace(0.01, math.pi - 0.01, 33)
RAYS = {
    "infall": [0.0, 20.0, math.pi / 2, 0.0, -1.0, -0.5, 0.0, 0.0],
    "escape": [0.0, 50.0, math.pi / 2, 0.0, -1.0, 0.5, 0.0, 20.0],
}


def _snapshot(path: Path):
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in path.iterdir())


# name: a call on an engine; each returns floats or arrays.
CALLS = {
    "horizon": lambda e: e.compute_horizon(),
    "isco": lambda e: (e.compute_isco(), e.compute_isco(False)),
    "photon_sphere": lambda e: (e.compute_photon_sphere(),
                                e.compute_photon_sphere(False)),
    "dilation": lambda e: (e.compute_dilation(10.0),
                           e.compute_dilation(4.0, 0.7)),
    "hawking": lambda e: (e.compute_hawking_temperature(),
                          e.compute_hawking_temperature(10.0)),
    "disk_lut": lambda e: e.generate_disk_lut(width=64, mdot=2.5),
    "spectrum_lut": lambda e: e.generate_spectrum_lut(width=32, height=8),
    "embedding_mesh": lambda e: e.generate_embedding_mesh(16, 12),
    "ergosphere_mesh": lambda e: e.generate_ergosphere_mesh(8, 8),
    "shadow_curve": lambda e: (e.compute_shadow_curve(math.pi / 2)[:2]
                               + e.compute_shadow_curve(1.0)[:2]),
    "shadow_radius": lambda e: e.compute_shadow_radius(),
    "shadow_shift": lambda e: e.compute_shadow_shift(),
    "disk_flux": lambda e: (e.compute_disk_flux(8.0),
                            e.compute_disk_flux(8.0, 2.5)),
    "g_factor": lambda e: (e.compute_g_factor(8.0),
                           e.compute_g_factor(8.0, 2.0)),
    "kretschmann_field": lambda e: e.compute_kretschmann_field(R_GRID,
                                                               TH_GRID),
    "frame_drag_field": lambda e: e.compute_frame_drag_field(R_GRID, TH_GRID),
    "light_cone_field_ks": lambda e: e.compute_light_cone_field(R_GRID,
                                                                TH_GRID),
    "light_cone_field_bl": lambda e: e.compute_light_cone_field(
        R_GRID, TH_GRID, use_ks=False),
    "flamm_height": lambda e: e.compute_flamm_height(5.0),
    "proper_distance": lambda e: e.compute_proper_distance(3.0, 10.0),
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return np.concatenate([_flat(o) for o in out])
    return np.asarray(out, np.float64).ravel()


@pytest.fixture(scope="module")
def jax_engine():
    eng = JPhysicsEngine(1.0, 0.9, prefer_native=False)
    yield eng
    eng.close()


@pytest.fixture(params=[True, False], ids=["native", "python"])
def engine(request):
    before = _snapshot(NATIVE_DIR)
    eng = PhysicsEngine(1.0, 0.9, prefer_native=request.param, device="cpu")
    yield eng
    eng.close()
    assert _snapshot(NATIVE_DIR) == before


@pytest.mark.parametrize("name", sorted(CALLS))
def test_facade_matches_jax(engine, jax_engine, name):
    ref = _flat(CALLS[name](jax_engine))
    out = _flat(CALLS[name](engine))
    assert out.shape == ref.shape and np.isfinite(ref).all()
    np.testing.assert_allclose(out, ref, rtol=1e-10, atol=0.0)


@pytest.mark.parametrize("prefer_native", [True, False])
def test_engine_types_and_bridge(prefer_native):
    engine = PhysicsEngine(1.0, 0.9, prefer_native=prefer_native,
                           device="cpu")
    assert isinstance(engine.compute_horizon(), float)
    r, th, k = engine.compute_kretschmann_field(R_GRID, TH_GRID)
    assert all(isinstance(x, np.ndarray) for x in (r, th, k))
    assert k.shape == (64, 33)
    assert isinstance(engine.bridge,
                      NativeBridge if prefer_native else PyBridge)
    snap = engine.tick(0.02)
    assert {"camera", "physics", "shadow_curve", "shadow_extents"} <= set(snap)
    assert snap["shadow_curve"].shape == (64, 2)
    engine.close()


@pytest.mark.parametrize("ray", sorted(RAYS))
def test_integrate_ray_matches_jax(jax_engine, ray):
    eng = PhysicsEngine(1.0, 0.9, prefer_native=False, device="cpu")
    out = eng.integrate_ray_relativistic(RAYS[ray], max_steps=20_000)
    ref = jax_engine.integrate_ray_relativistic(RAYS[ray], max_steps=20_000)
    assert out["termination"] == ref["termination"] == (
        TERM_HORIZON if ray == "infall" else TERM_ESCAPE)
    assert out["steps_taken"] == ref["steps_taken"]
    assert out["max_hamiltonian_drift"] < 1e-6
    np.testing.assert_allclose(out["final_state"], ref["final_state"],
                               rtol=1e-6, atol=1e-9)


def test_update_parameters_rebuilds():
    eng = PhysicsEngine(1.0, 0.9, prefer_native=False, device="cpu")
    h1 = eng.compute_horizon()
    eng.update_parameters(spin=0.0)
    h2 = eng.compute_horizon()
    np.testing.assert_allclose(h2, 2.0, rtol=1e-12)
    assert h2 > h1 and eng.bridge.spin == 0.0


# --- tests/test_engine.py's bridge bars on the port ---------------------------

def _bars(bridge):
    phi0 = bridge.camera()["phi"]
    for _ in range(10):
        bridge.tick(0.02)
    np.testing.assert_allclose(bridge.camera()["phi"] - phi0, 0.15 * 0.2,
                               rtol=1e-5)
    bridge.input(dx=100.0)
    bridge.tick(0.02)
    v1 = abs(bridge.camera()["yaw_vel"])
    for _ in range(50):
        bridge.tick(0.02)
    assert v1 > 0 and abs(bridge.camera()["yaw_vel"]) < v1 * 0.05
    r0 = bridge.camera()["r"]
    bridge.input(zoom=1.0)
    bridge.tick(0.01)
    assert bridge.camera()["r"] < r0
    for _ in range(200):
        bridge.input(zoom=5.0)
        bridge.tick(0.01)
    assert bridge.camera()["r"] >= 4.0
    good_phi = bridge.camera()["phi"]
    bridge.input(dx=math.nan)
    bridge.tick(0.02)
    cam = bridge.camera()
    assert math.isfinite(cam["phi"]) and abs(cam["phi"] - good_phi) < 0.1
    p = bridge.physics()
    np.testing.assert_allclose(p["horizon"], float(event_horizon(1.0, 0.9)),
                               rtol=1e-6)
    np.testing.assert_allclose(p["isco"], float(isco(1.0, 0.9)), rtol=1e-6)
    np.testing.assert_allclose(p["photon_sphere"],
                               float(photon_sphere(1.0, 0.9)), rtol=1e-6)
    bridge.start(hz=200.0)
    time.sleep(0.15)
    bridge.stop()
    assert bridge.ticks > 5


@pytest.mark.parametrize("kind", ["native", "python"])
def test_bridge_bars(kind):
    bridge = NativeBridge(1.0, 0.9) if kind == "native" else PyBridge(1.0,
                                                                      0.9)
    try:
        _bars(bridge)
    finally:
        bridge.close()


def test_native_shadow_curve_matches_bardeen():
    b = NativeBridge(1.0, 0.9)
    try:
        b.tick(0.01)
        pts, _ = b.shadow_curve()
        alpha, beta, valid = bardeen_shadow(1.0, 0.9, b.camera()["theta"],
                                            n=32)
        np.testing.assert_allclose(pts[valid, 0], alpha[valid], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(pts[valid, 1], beta[valid], rtol=1e-4,
                                   atol=1e-4)
        # PyBridge's curve is the same function's.
        py = PyBridge(1.0, 0.9)
        py.theta = b.camera()["theta"]
        np.testing.assert_allclose(py.shadow_curve()[0], pts, rtol=1e-4,
                                   atol=1e-4)
    finally:
        b.close()


def test_seqlock_reads_consistent_under_heartbeat():
    b = NativeBridge(1.0, 0.9)
    try:
        b.start(hz=2000.0)
        for _ in range(300):
            cam, p = b.camera(), b.physics()
            assert all(math.isfinite(v) for v in cam.values())
            assert all(math.isfinite(v) for v in p.values())
            assert abs(p["mass"] - 1.0) < 1e-6
        b.stop()
    finally:
        b.close()


def test_stale_library_builds_outside_native(monkeypatch, tmp_path, caplog):
    """A library older than its source is rebuilt into the build directory;
    ``native/`` keeps its files, byte for byte and time for time."""
    before = _snapshot(NATIVE_DIR)
    monkeypatch.setattr(tnative, "_SO_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    with caplog.at_level(logging.INFO, logger=tnative.__name__):
        bridge = load_bridge(1.0, 0.9)
    try:
        assert isinstance(bridge, NativeBridge)
        assert bridge.path == tmp_path / "native" / "libbridge.so"
        assert bridge.path.exists()
        assert "loaded the native bridge" in caplog.text
        bridge.tick(0.02)
        assert bridge.physics()["mass"] == 1.0
    finally:
        bridge.close()
    assert _snapshot(NATIVE_DIR) == before


def test_no_compiler_falls_back_loudly(monkeypatch, tmp_path, caplog):
    def no_gxx(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tnative, "_SO_PATH", tmp_path / "missing.so")
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(subprocess, "run", no_gxx)
    with caplog.at_level(logging.INFO, logger=tnative.__name__):
        bridge = load_bridge(1.0, 0.9, prefer_native=True)
    assert isinstance(bridge, PyBridge)
    assert "native bridge unavailable" in caplog.text
    assert any(r.levelno == logging.WARNING for r in caplog.records)


def test_engine_resolves_the_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PhysicsEngine(1.0, 0.9, prefer_native=False)
