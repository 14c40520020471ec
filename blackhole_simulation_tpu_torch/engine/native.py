"""ctypes binding to the native seqlock engine (``native/bridge.cpp``).

Counterpart of ``blackhole_simulation_tpu/engine/native.py``: a C++ engine
owns a float32 state block written under a seqlock while a heartbeat thread
integrates the camera's kinematics; Python reads torn-free snapshots. The
block's offsets (float32 indices) and every function's signature are the
JAX package's (:57-150). ``PyBridge`` is the same engine in Python, for
machines without a C++ compiler.

Where the library comes from: ``native/libbridge.so`` as the repository
holds it, when it is at least as new as ``bridge.cpp``. Otherwise the port
compiles its own copy with g++ into ``build/native/`` at the repository
root and loads that; it never writes under ``native/`` (the JAX package's
loader rebuilds in place there). ``load_bridge`` logs which bridge it
loaded, and why it fell back to ``PyBridge`` when it did.
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

CONTROL_OFFSET = 0
CAMERA_OFFSET = 64
PHYSICS_OFFSET = 128
TELEMETRY_OFFSET = 256
LUTS_OFFSET = 2048
N_SHADOW_POINTS = 64

_ROOT = Path(__file__).resolve().parents[2]
_SO_PATH = _ROOT / "native" / "libbridge.so"
_SRC_PATH = _ROOT / "native" / "bridge.cpp"
BUILD_DIR = _ROOT / "build" / "native"

log = logging.getLogger(__name__)


def _fresh(lib: Path) -> bool:
    return lib.exists() and lib.stat().st_mtime >= _SRC_PATH.stat().st_mtime


def _build_native() -> Path:
    """The library to load: the repository's when it is current, else a
    copy compiled into ``build/native/`` (written under a temporary name
    and renamed, so concurrent builders never load a partial file).
    Raises RuntimeError when g++ fails or is missing."""
    if _fresh(_SO_PATH):
        return _SO_PATH
    out = BUILD_DIR / "libbridge.so"
    if _fresh(out):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libbridge.{os.getpid()}.tmp.so"
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
             "-o", str(tmp), str(_SRC_PATH), "-lpthread"],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as err:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native bridge build failed: {err}") from err
    os.replace(tmp, out)
    return out


class NativeBridge:
    """The C++ engine, bound with ctypes."""

    def __init__(self, mass: float = 1.0, spin: float = 0.9,
                 so_path: str | None = None):
        self.path = Path(so_path) if so_path else _build_native()
        lib = ctypes.CDLL(str(self.path))
        lib.engine_create.restype = ctypes.c_void_p
        lib.engine_create.argtypes = [ctypes.c_double, ctypes.c_double]
        lib.engine_destroy.argtypes = [ctypes.c_void_p]
        lib.engine_set_params.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                          ctypes.c_double]
        lib.engine_set_auto_spin.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.engine_input.argtypes = [ctypes.c_void_p] + [ctypes.c_double] * 3
        lib.engine_tick.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.engine_start.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.engine_stop.argtypes = [ctypes.c_void_p]
        lib.engine_read.restype = ctypes.c_uint32
        lib.engine_read.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int, ctypes.c_int]
        lib.engine_ticks.restype = ctypes.c_uint64
        lib.engine_ticks.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.engine_create(mass, spin)
        self._last_good: dict[str, np.ndarray] = {}

    def set_params(self, mass: float, spin: float) -> None:
        self._lib.engine_set_params(self._h, mass, spin)

    def set_auto_spin(self, rate: float) -> None:
        self._lib.engine_set_auto_spin(self._h, rate)

    def input(self, dx: float = 0.0, dy: float = 0.0, zoom: float = 0.0):
        self._lib.engine_input(self._h, dx, dy, zoom)

    def tick(self, dt: float) -> None:
        self._lib.engine_tick(self._h, dt)

    def start(self, hz: float = 75.0) -> None:
        self._lib.engine_start(self._h, hz)

    def stop(self) -> None:
        self._lib.engine_stop(self._h)

    @property
    def ticks(self) -> int:
        return int(self._lib.engine_ticks(self._h))

    def _read(self, offset: int, count: int, key: str) -> np.ndarray:
        """A seqlock snapshot; the last good one after a torn or
        non-finite read."""
        buf = (ctypes.c_float * count)()
        seq = self._lib.engine_read(self._h, buf, offset, count)
        arr = np.ctypeslib.as_array(buf).copy()
        if seq == 0 or not np.all(np.isfinite(arr)):
            return self._last_good.get(key, arr)
        self._last_good[key] = arr
        return arr

    def camera(self) -> dict:
        c = self._read(CAMERA_OFFSET, 6, "camera")
        return {"r": float(c[0]), "theta": float(c[1]), "phi": float(c[2]),
                "yaw_vel": float(c[3]), "pitch_vel": float(c[4]),
                "auto_spin": float(c[5])}

    def physics(self) -> dict:
        p = self._read(PHYSICS_OFFSET, 8, "physics")
        return {"mass": float(p[0]), "spin": float(p[1]),
                "horizon": float(p[2]), "isco": float(p[3]),
                "photon_sphere": float(p[4]), "time_dilation": float(p[5]),
                "ergosphere_eq": float(p[6]), "surface_gravity": float(p[7])}

    def shadow_curve(self) -> tuple[np.ndarray, np.ndarray]:
        data = self._read(LUTS_OFFSET, 2 * N_SHADOW_POINTS + 4, "shadow")
        pts = data[:2 * N_SHADOW_POINTS].reshape(N_SHADOW_POINTS, 2)
        return pts, data[2 * N_SHADOW_POINTS:]

    def close(self) -> None:
        if self._h:
            self._lib.engine_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class PyBridge:
    """The native engine in Python: friction exp(-5 dt), auto-spin
    0.15 rad/s, multiplicative zoom, NaN rollback; a lock in place of the
    seqlock."""

    FRICTION = 5.0
    AUTO_SPIN = 0.15
    MOUSE_GAIN = 0.005
    ZOOM_GAIN = 1.1

    def __init__(self, mass: float = 1.0, spin: float = 0.9):
        self.mass, self.spin = mass, spin
        self.auto_spin = self.AUTO_SPIN
        self.r, self.theta, self.phi = 30.0, math.pi / 2 - 0.25, 0.0
        self.yaw_vel = self.pitch_vel = 0.0
        self._pending = [0.0, 0.0, 0.0]
        self._last_good = (self.r, self.theta, self.phi, 0.0, 0.0)
        self._lock = threading.Lock()
        self._thread = None
        self._running = False
        self.ticks = 0

    def set_params(self, mass, spin):
        self.mass, self.spin = mass, spin

    def set_auto_spin(self, rate):
        self.auto_spin = rate

    def input(self, dx=0.0, dy=0.0, zoom=0.0):
        with self._lock:
            self._pending[0] += dx
            self._pending[1] += dy
            self._pending[2] += zoom

    def tick(self, dt: float) -> None:
        dt = min(max(dt, 0.0), 0.033)
        with self._lock:
            dx, dy, dz = self._pending
            self._pending = [0.0, 0.0, 0.0]
            self.yaw_vel += dx * self.MOUSE_GAIN
            self.pitch_vel += dy * self.MOUSE_GAIN
            damp = math.exp(-self.FRICTION * dt)
            self.yaw_vel *= damp
            self.pitch_vel *= damp
            self.phi += (self.yaw_vel + self.auto_spin) * dt
            self.theta = min(max(self.theta + self.pitch_vel * dt, 0.05),
                             math.pi - 0.05)
            if dz:
                self.r = min(max(self.r * self.ZOOM_GAIN ** (-dz), 4.0),
                             200.0)
            state = (self.r, self.theta, self.phi, self.yaw_vel,
                     self.pitch_vel)
            if all(math.isfinite(v) for v in state):
                self._last_good = state
            elif self._last_good:
                (self.r, self.theta, self.phi, self.yaw_vel,
                 self.pitch_vel) = self._last_good
            self.ticks += 1

    def start(self, hz: float = 75.0) -> None:
        if self._running:
            return
        self._running = True

        def loop():
            prev = time.perf_counter()
            while self._running:
                now = time.perf_counter()
                self.tick(now - prev)
                prev = now
                time.sleep(1.0 / hz)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join()
            self._thread = None

    def camera(self) -> dict:
        with self._lock:
            return {"r": self.r, "theta": self.theta, "phi": self.phi,
                    "yaw_vel": self.yaw_vel, "pitch_vel": self.pitch_vel,
                    "auto_spin": self.auto_spin}

    def physics(self) -> dict:
        from blackhole_simulation_tpu_torch.geometry.radii import (
            event_horizon,
            isco,
            photon_sphere,
            time_dilation,
        )

        return {
            "mass": self.mass,
            "spin": self.spin,
            "horizon": float(event_horizon(self.mass, self.spin)),
            "isco": float(isco(self.mass, self.spin)),
            "photon_sphere": float(photon_sphere(self.mass, self.spin)),
            "time_dilation": float(time_dilation(self.mass, self.spin,
                                                 self.r, self.theta)),
        }

    def shadow_curve(self):
        from blackhole_simulation_tpu_torch.physics.shadow import (
            bardeen_shadow,
        )

        a, b, _ = bardeen_shadow(self.mass, self.spin, self.theta,
                                 n=N_SHADOW_POINTS // 2)
        pts = np.stack([np.asarray(a), np.asarray(b)], axis=-1).astype(
            np.float32)
        ext = np.array([a.min(), a.max(), b.min(), b.max()], np.float32)
        return pts, ext

    def close(self) -> None:
        self.stop()


def load_bridge(mass: float = 1.0, spin: float = 0.9,
                prefer_native: bool = True):
    """``NativeBridge`` when ``prefer_native`` and the library loads or
    builds, else ``PyBridge``; logs which one it returns and, on a
    fallback, why."""
    if prefer_native:
        try:
            bridge = NativeBridge(mass, spin)
        except (RuntimeError, OSError) as err:
            log.warning("native bridge unavailable (%s); using PyBridge", err)
        else:
            log.info("loaded the native bridge from %s", bridge.path)
            return bridge
    else:
        log.info("using PyBridge (prefer_native=False)")
    return PyBridge(mass, spin)
