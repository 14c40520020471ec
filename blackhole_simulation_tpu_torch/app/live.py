"""Live interactive session: the real-time loop, closed.

Counterpart of ``blackhole_simulation_tpu/app/live.py``:

  keyboard or scripted input -> the seqlock engine's heartbeat
  (``engine/native.py``: the C++ bridge, or its Python twin) -> camera
  state -> the render at the adaptive resolution
  (``perf/adaptive_resolution.py``: -10 % after 2 s below 60 FPS, +10 %
  after 5 s above 75 FPS), snapped to a fixed ladder -> an antialiased
  downsample to the display size -> temporal accumulation there -> a
  truecolor half-block terminal frame (or a PNG stream).

The frame program is two module-level functions: ``render_live_frame``
(camera, scene, ``render``) and ``display_program`` (resize, reprojected
TAA at display size, uint8). On ``cuda`` the render takes the fused kernel
path (``use_pallas``, ``fused`` and ``approx_recip`` on); on ``"cpu"`` the
staged plain path, as the JAX package does off its accelerator. The rung
sizes keep the JAX program's rounding (a multiple of 128 wide and of 32
high: 1280x704 at 1280x720), so the two packages' images compare.

Frames are pipelined: each displayed frame is copied without blocking
into pinned host memory with a CUDA event recorded after the copy, and
the fetch of the oldest in-flight frame waits on its event alone, so the
copy of frame N overlaps the render of frame N+1.

Input: when stdin is a TTY, raw-mode keyboard (arrows orbit, +/- zoom,
space toggles auto-spin, q quits); otherwise ``script`` drives a canned
input stream so the loop runs headless.
"""

from __future__ import annotations

import os
import select
import sys
import time

import numpy as np
import torch

SCALE_LADDER = (0.5, 0.65, 0.8, 1.0)


def _pick_scale(raw: float) -> float:
    for s in SCALE_LADDER:
        if raw <= s + 1e-6:
            return s
    return SCALE_LADDER[-1]


def _pipeline_depth(pipelined) -> int:
    """Frames kept in flight before the oldest is fetched: 2 for ``True``.
    An integer depth is squared (``3`` keeps 9), as in the JAX package
    (live.py:311): a reference fault reproduced on purpose."""
    return int(pipelined) * (2 if pipelined is True else pipelined)


class _Keyboard:
    """Raw-mode nonblocking keyboard."""

    def __init__(self):
        import termios
        import tty

        self._termios = termios
        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)

    def poll(self):
        events = []
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # arrow escape sequence
                seq = sys.stdin.read(2)
                events.append({"A": "up", "B": "down", "C": "right",
                               "D": "left"}.get(seq[-1:], None))
            else:
                events.append(ch)
        return [e for e in events if e]

    def close(self):
        self._termios.tcsetattr(self._fd, self._termios.TCSADRAIN, self._saved)


class _Script:
    """Canned input stream: named gestures per frame (headless driver)."""

    def __init__(self, name: str, n_frames: int):
        self.name = name
        self.n = n_frames
        self.i = 0

    def poll(self):
        i = self.i
        self.i += 1
        if self.name == "orbit":
            return [("drag", 18.0, 3.0 * np.sin(i * 0.05), 0.0)]
        if self.name == "dive":
            return [("drag", 6.0, 0.0, -0.012)]
        if self.name == "shake":
            return [("drag", 40.0 * np.sin(i * 0.3), 10.0 * np.cos(i * 0.2),
                     0.005 * np.sin(i * 0.1))]
        return []

    def close(self):
        pass


def _ansi_frame(img: np.ndarray) -> str:
    """(rows*2, cols, 3) uint8 -> truecolor half-block string."""
    top = img[0::2]
    bot = img[1::2]
    lines = []
    for yr in range(top.shape[0]):
        parts = []
        for x in range(top.shape[1]):
            tr, tg, tb = top[yr, x]
            br, bg, bb = bot[yr, x]
            parts.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀"
            )
        lines.append("".join(parts) + "\x1b[0m")
    return "\n".join(lines)


def rung_size(width: int, height: int, s: float) -> tuple[int, int]:
    """Render size of ladder rung ``s``: (width, height) of the frame."""
    w = int(width * s) // 128 * 128 or 128
    h = int(height * s) // 32 * 32 or 32
    return w, h


def live_march_config(quality: str, fused: bool):
    """The session's MarchConfig at ``quality``; ``fused`` selects the
    render kernel path (and its approximate reciprocal)."""
    from blackhole_simulation_tpu_torch.configs.simulation import (
        QUALITY_RAY_STEPS,
    )
    from blackhole_simulation_tpu_torch.render import MarchConfig

    return MarchConfig(
        max_steps=QUALITY_RAY_STEPS.get(quality, 128) or 128,
        use_pallas=fused,
        fused=fused,
        shadow_precull=True,
        step_rate=0.2,
        far_step_cap_rate=0.4,
        far_boost_radius=20.0,
        approx_recip=fused,
        midpoint_iters=1,
    )


def live_camera(r, theta, phi, spin) -> tuple[float, ...]:
    """(r, theta, phi, spin) rounded to float32, as the frame program takes
    them: the TAA camera (r, theta, phi, fov 0.5, roll 0) is built from the
    same values."""
    return tuple(float(np.float32(v)) for v in (r, theta, phi, spin))


def render_live_frame(cam, mass, cfg, w: int, h: int, device):
    """The frame program's render: the (h, w, 3) tone-mapped frame of
    ``cam`` = (r, theta, phi, spin) (``live_camera``)."""
    from blackhole_simulation_tpu_torch.render import Camera, Scene, render

    r, theta, phi, spin = cam
    camera = Camera.create(r=r, theta=theta, phi=phi, fov=0.5, width=w,
                           height=h)
    scene = Scene.create(mass=mass, spin=spin, camera=camera, march_cfg=cfg)
    return render(scene, n_samples=1, device=device)


def resize_linear(img: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``jax.image.resize(img, (rows, cols, 3), method="linear")`` of an
    (H, W, 3) image: bilinear with half-pixel centres, and, when
    downsampling, JAX's antialiasing (a triangle kernel widened by the
    scale), which ``antialias=True`` reproduces."""
    x = img.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(
        x, size=(rows, cols), mode="bilinear", align_corners=False,
        antialias=True)
    return y[0].permute(1, 2, 0)


def display_program(img, hist, prev_cam, cam_now, have_hist: bool,
                    term_rows: int, term_cols: int, taa: bool = True):
    """The frame program after the render: the frame resized to the display
    (term_rows, term_cols), accumulated there against the history
    reprojected from ``prev_cam`` to ``cam_now`` (each (r, theta, phi,
    fov, roll); feedback 0.8, clamp 1.5) when there is one, and cast to
    uint8. Returns (display uint8, resolved float32), on the frame's
    device."""
    from blackhole_simulation_tpu_torch.render.accumulate import (
        taa_resolve_reprojected,
    )

    small = resize_linear(img, term_rows, term_cols)
    if taa and have_hist:
        resolved = taa_resolve_reprojected(hist, small, prev_cam, cam_now,
                                           0.8, 1.5)
    else:
        resolved = small
    disp = torch.clamp(resolved * 255.0, 0, 255).to(torch.uint8)
    return disp, resolved


class _Fetch:
    """A display frame on its way to the host: on a card, a non-blocking
    copy into pinned memory and the CUDA event recorded after it."""

    def __init__(self, disp: torch.Tensor):
        if disp.device.type == "cuda":
            self.host = torch.empty(disp.shape, dtype=disp.dtype,
                                    pin_memory=True)
            self.host.copy_(disp, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = disp, None

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def run_live(width=1280, height=720, mass=1.0, spin=0.9, frames=0,
             script=None, out_dir=None, term_cols=120, quality="high",
             use_pallas=None, calibrate=True, taa=True, pipelined=True,
             device=None):
    """Run the live session on ``device`` (``cuda`` unless the caller
    passes ``"cpu"``); returns a stats dict (fps, frames, scales)."""
    from blackhole_simulation_tpu_torch.engine.native import load_bridge
    from blackhole_simulation_tpu_torch.perf.adaptive_resolution import (
        AdaptiveResolutionController,
    )
    from blackhole_simulation_tpu_torch.perf.monitor import PerformanceMonitor
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    device = resolve_device(device)
    on_card = device.type == "cuda"
    if use_pallas is None:
        use_pallas = on_card
    cfg = live_march_config(quality, use_pallas)

    # Native C++ seqlock engine with heartbeat; pure-Python twin fallback.
    engine = load_bridge(mass, spin)
    engine.start(hz=75.0)
    engine.set_auto_spin(0.15)

    interactive = script is None and sys.stdin.isatty()
    inp = _Keyboard() if interactive else _Script(script or "orbit",
                                                  frames or 300)
    monitor = PerformanceMonitor()
    ctrl = AdaptiveResolutionController()
    scale = 1.0 if not on_card else _pick_scale(
        ctrl.update(60.0, time.monotonic())
    )

    term_rows = max(2, (term_cols * height // width) // 2) * 2

    # Temporal accumulation at display size: history on the device, per
    # ladder rung (history, its camera, have_history).
    hist_state = {}

    def frame_fn(s):
        w, h = rung_size(width, height, s)

        def call(r, theta, phi, spin_now):
            cam = live_camera(r, theta, phi, spin_now)
            cam_now = (*cam[:3], 0.5, 0.0)
            hist, prev_cam, have_hist = hist_state.get(s, (None, None, False))
            img = render_live_frame(cam, mass, cfg, w, h, device)
            disp, resolved = display_program(img, hist, prev_cam, cam_now,
                                             have_hist, term_rows, term_cols,
                                             taa)
            hist_state[s] = (resolved, cam_now, True)
            return _Fetch(disp)

        return call

    # Startup calibration stress test: ~3 s of frames at the requested
    # quality; below 30 FPS the session demotes one tier.
    spin_now = spin

    STRESS_BATCH = 4

    def _stress():
        # Sustained throughput: queue a batch, fetch once.
        fn = frame_fn(scale)
        outs = [fn(8.0, 1.3, 0.0, spin_now) for _ in range(STRESS_BATCH)]
        outs[-1].result()

    if calibrate:
        _stress()  # first-call work outside the timed stress window
        new_quality = monitor.calibrate(_stress, quality=quality,
                                        frames_per_call=STRESS_BATCH)
        if new_quality != quality:
            quality = new_quality
            cfg = live_march_config(quality, use_pallas)
            hist_state.clear()

    stats = {"frames": 0, "scales": [], "fps": [],
             "quality": quality, "calibrated_fps": monitor.calibrated_fps}
    auto = True
    last = time.monotonic()
    inflight = []  # (fetch, t0, camera, frame index)
    try:
        n = 0
        while True:
            if frames and n >= frames:
                break
            events = inp.poll()
            dx = dy = zoom = 0.0
            for e in events:
                if e == "q":
                    raise KeyboardInterrupt
                if isinstance(e, tuple) and e[0] == "drag":
                    dx += e[1]
                    dy += e[2]
                    zoom += e[3]
                elif e == "left":
                    dx -= 30.0
                elif e == "right":
                    dx += 30.0
                elif e == "up":
                    dy -= 20.0
                elif e == "down":
                    dy += 20.0
                elif e in ("+", "="):
                    zoom -= 0.05
                elif e == "-":
                    zoom += 0.05
                elif e == " ":
                    auto = not auto
                    engine.set_auto_spin(0.15 if auto else 0.0)
            if isinstance(inp, _Script) and inp.i >= inp.n:
                break
            engine.input(dx=dx, dy=dy, zoom=zoom)

            cam_state = engine.camera()
            t0 = monitor.begin_frame()
            fn = frame_fn(scale)
            fetch = fn(cam_state["r"], cam_state["theta"], cam_state["phi"],
                       spin_now)
            inflight.append((fetch, t0, cam_state, n))
            if len(inflight) <= _pipeline_depth(pipelined):
                # Keep frames in flight: the copy to the host overlaps the
                # next frame's render; the display lags by the depth.
                n += 1
                continue
            fetch_p, t0_p, cam_p, idx_p = inflight.pop(0)
            img = fetch_p.result()  # waits for the oldest frame's copy
            monitor.end_frame(t0_p)
            now = time.monotonic()
            dt_frame = now - last
            last = now
            fps = 1.0 / max(dt_frame, 1e-6)
            new_scale = _pick_scale(ctrl.update(fps, now))
            if new_scale != scale:
                scale = new_scale
                inflight.clear()  # old-rung frames: drop, not display

            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                from blackhole_simulation_tpu_torch.app.screenshot import (
                    save_png,
                )

                save_png(img.astype(np.float32) / 255.0,
                         os.path.join(out_dir, f"live_{idx_p:04d}.png"))
            elif sys.stdout.isatty():
                sys.stdout.write("\x1b[H\x1b[2J" if n == 0 else "\x1b[H")
                sys.stdout.write(_ansi_frame(img))
                sys.stdout.write(
                    f"\n\x1b[0m fps {fps:5.1f}  scale {scale:.2f}  "
                    f"r {cam_p['r']:.1f}  theta {cam_p['theta']:.2f} "
                    f" phi {cam_p['phi']:.2f}  [arrows orbit, +/- zoom, "
                    f"space auto-spin, q quit]\n"
                )
                sys.stdout.flush()

            stats["frames"] += 1
            stats["scales"].append(scale)
            stats["fps"].append(fps)
            n += 1
        # drain the pipeline so every dispatched frame is accounted for
        for fetch_p, t0_p, cam_p, idx_p in inflight:
            fetch_p.result()
            monitor.end_frame(t0_p)
            stats["frames"] += 1
    except KeyboardInterrupt:
        pass
    finally:
        inp.close()
        engine.stop()
        engine.close()
    stats["monitor"] = monitor.get_metrics()
    return stats
