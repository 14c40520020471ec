"""The port's app layer (``app/``) against the JAX package's, on the CPU:
the state codec and settings storage, the PNG writer, the animation
driver, the live loop's display program and helpers, and the CLI.

Renders on the JAX side run op by op (``jax.disable_jit``), as in the
other port tests: compiled as one program, XLA contracts multiply-adds,
and last-bit differences grow along the photon-ring orbits. Bars are the
staged ones (tests/test_fused.py): p99 |d| < 1e-4, mean |d| < 1e-5.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.app import animate as janimate
from blackhole_simulation_tpu.app import cli as jcli
from blackhole_simulation_tpu.app import live as jlive
from blackhole_simulation_tpu.app import screenshot as jshot
from blackhole_simulation_tpu.app import state as jstate
from blackhole_simulation_tpu.configs import simulation as jsim
from blackhole_simulation_tpu.engine.cinema import CameraRig as JCameraRig
from blackhole_simulation_tpu.perf.monitor import (
    PerformanceMonitor as JPerformanceMonitor,
)
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
from blackhole_simulation_tpu.render import Scene as JScene
from blackhole_simulation_tpu.render import render as j_render
from blackhole_simulation_tpu.render.accumulate import (
    taa_resolve_reprojected as j_taa_reprojected,
)
from blackhole_simulation_tpu_torch.app import animate as tanimate
from blackhole_simulation_tpu_torch.app import cli as tcli
from blackhole_simulation_tpu_torch.app import live as tlive
from blackhole_simulation_tpu_torch.app import screenshot as tshot
from blackhole_simulation_tpu_torch.app import state as tstate
from blackhole_simulation_tpu_torch.configs import simulation as tsim
from blackhole_simulation_tpu_torch.engine.cinema import CameraRig
from blackhole_simulation_tpu_torch.render import render

torch.set_num_threads(1)


# -- state codec, settings, PNG ---------------------------------------------

def _param_sets(sim):
    base = sim.SimulationParams()
    return [
        base,
        dataclasses.replace(base, mass=2.0, spin=0.5, enable_jets=True),
        sim.apply_preset(base, "balanced"),
        dataclasses.replace(base, fov=0.123456789, quality="low",
                            exposure=1.7, enable_bloom=False),
    ]


FRAGMENTS = ["#mass=3&bogus=1&spin=abc&fov=nan&quality=ultra",
             "#mass=99999", "mass=2&enable_disk=0&enable_jets=true", "",
             "#&&=&spin=-5&quality=nope&render_scale=0.25"]


def test_state_codec_equal():
    for tp, jp in zip(_param_sets(tsim), _param_sets(jsim)):
        for full in (False, True):
            frag = tstate.encode_state(tp, full=full)
            assert frag == jstate.encode_state(jp, full=full)
            assert dataclasses.asdict(tstate.decode_state(frag)) == \
                dataclasses.asdict(jstate.decode_state(frag))
            assert tstate.decode_state(frag) == tp
    for frag in FRAGMENTS:
        assert dataclasses.asdict(tstate.decode_state(frag)) == \
            dataclasses.asdict(jstate.decode_state(frag))


SETTINGS_FILES = {
    "corrupt": "{not json at all",
    "binary": b"\xff\xfe\x00garbage",
    "wrong-version": json.dumps({"version": 2, "params": {"mass": 4.0}}),
    "not-a-dict": json.dumps([1, 2, 3]),
    "partial": json.dumps({"version": 1,
                           "params": {"mass": 4.0, "spin": "bad",
                                      "quality": 7, "fov": float("inf"),
                                      "enable_jets": True},
                           "preset": "nonexistent"}),
    "valid": json.dumps({"version": 1, "params": {"spin": 0.7},
                         "preset": "quality"}),
}


@pytest.mark.parametrize("case", sorted(SETTINGS_FILES))
def test_settings_storage_load_equal(case, tmp_path):
    path = tmp_path / "settings.json"
    data = SETTINGS_FILES[case]
    (path.write_bytes if isinstance(data, bytes) else path.write_text)(data)
    tp, tpre = tstate.SettingsStorage(str(path)).load()
    jp, jpre = jstate.SettingsStorage(str(path)).load()
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp) and tpre == jpre


def test_settings_storage_round_trip_equal(tmp_path):
    for i, (tp, jp) in enumerate(zip(_param_sets(tsim), _param_sets(jsim))):
        tpath, jpath = tmp_path / f"t{i}.json", tmp_path / f"j{i}.json"
        tstate.SettingsStorage(str(tpath)).save(tp, preset="balanced")
        jstate.SettingsStorage(str(jpath)).save(jp, preset="balanced")
        assert tpath.read_text() == jpath.read_text()
        loaded, preset = tstate.SettingsStorage(str(tpath)).load()
        assert loaded == tp and preset == "balanced"
    assert tstate.SettingsStorage(str(tmp_path / "none.json")).load() == (
        tsim.SimulationParams(), None)


def _images():
    rng = np.random.default_rng(5)
    f = rng.uniform(-0.2, 1.2, (13, 17, 3)).astype(np.float32)
    f[0, 0] = [np.inf, -np.inf, 0.5 / 255.0]
    rgba = rng.integers(0, 256, (6, 5, 4)).astype(np.uint8)
    return {"float32": f, "float64": f.astype(np.float64),
            "uint8": rng.integers(0, 256, (9, 4, 3)).astype(np.uint8),
            "rgba": rgba, "gray": rng.uniform(0, 1, (3, 7))}


@pytest.mark.parametrize("case", sorted(_images()))
def test_encode_png_bytes_equal(case, tmp_path):
    img = _images()[case]
    data = tshot.encode_png(img)
    assert data == jshot.encode_png(img)
    path = tshot.save_png(img, str(tmp_path / "x.png"))
    back = tshot.load_png_rgb(path)
    np.testing.assert_array_equal(back, jshot.load_png_rgb(path))
    with pytest.raises(ValueError):
        tshot.encode_png(np.zeros((4, 4, 2)))


# -- the animation driver ----------------------------------------------------

def _stub_render(cam, scale):
    """A frame that depends on the camera and the scale."""
    r, theta, phi = cam
    y, x = np.mgrid[0:12, 0:16].astype(np.float32)
    base = 0.5 + 0.4 * np.sin(0.3 * x + phi) * np.cos(0.2 * y - theta)
    img = np.stack([base, base * 0.8 + 0.01 * r, base * scale], axis=-1)
    return img.astype(np.float32)


def _drive(mod, rig_cls, director):
    t = {"now": 0.0}
    rig = None if director else rig_cls(auto_spin=True)
    drv = mod.AnimationDriver(_stub_render, director=director, rig=rig,
                              clock=lambda: t["now"], fov=0.5)
    reports = []
    for i in range(24):
        t["now"] += 1.0 / 60.0 + 0.004 * (i % 3) + (0.5 if i == 9 else 0.0)
        if i in (3, 4, 15):
            drv.input(dx=40.0, dy=-10.0, zoom=0.97)
        if i == 12:
            t["now"] += 5.0   # idle, then the frame gate
        reports.append(dataclasses.asdict(drv.tick()))
    return reports, np.asarray(drv.last_frame), drv.accumulator.frame_count


@pytest.mark.parametrize("director", [None, "grand_survey", "descent"])
def test_animation_driver_equal(director):
    t_rep, t_last, t_n = _drive(tanimate, CameraRig, director)
    with jax.disable_jit():
        j_rep, j_last, j_n = _drive(janimate, JCameraRig, director)
    assert t_rep == j_rep and t_n == j_n
    assert any(r["idle"] for r in t_rep) == (director is None)
    np.testing.assert_allclose(t_last, j_last, rtol=0, atol=1e-6)


# -- the live loop -------------------------------------------------------------

def test_pick_scale_and_ladder_equal():
    assert tlive.SCALE_LADDER == jlive.SCALE_LADDER
    for raw in np.linspace(0.0, 1.3, 53).tolist() + [0.65 + 1e-7, 0.8]:
        assert tlive._pick_scale(raw) == jlive._pick_scale(raw)


def test_ansi_frame_equal():
    img = np.random.default_rng(6).integers(0, 256, (6, 5, 3)).astype(
        np.uint8)
    assert tlive._ansi_frame(img) == jlive._ansi_frame(img)


@pytest.mark.parametrize("name", ["orbit", "dive", "shake", "none"])
def test_script_poll_equal(name):
    t, j = tlive._Script(name, 40), jlive._Script(name, 40)
    for _ in range(40):
        assert t.poll() == j.poll()
    assert t.i == j.i == t.n


def test_pipeline_depth_reproduces_the_reference():
    """live.py:311 squares an integer depth (a reference fault kept on
    purpose): True keeps 2 frames in flight, 3 keeps 9, False none."""
    assert tlive._pipeline_depth(True) == 2
    assert tlive._pipeline_depth(3) == 9
    assert tlive._pipeline_depth(False) == 0
    assert tlive._pipeline_depth(1) == 1


def test_rung_sizes_keep_the_reference_rounding():
    assert tlive.rung_size(1280, 720, 1.0) == (1280, 704)
    assert tlive.rung_size(1280, 720, 0.65) == (768, 448)
    assert tlive.rung_size(100, 20, 0.5) == (128, 32)


@pytest.mark.parametrize("shape", [((704, 1280), (66, 120)),
                                   ((32, 128), (8, 16)),
                                   ((256, 384), (34, 60)),
                                   ((12, 20), (30, 50))])
def test_resize_matches_jax(shape):
    (h, w), (rows, cols) = shape
    img = np.random.default_rng(7).uniform(0, 1, (h, w, 3)).astype(
        np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (rows, cols, 3),
                                      method="linear"))
    got = tlive.resize_linear(torch.from_numpy(img), rows, cols).numpy()
    assert got.shape == ref.shape == (rows, cols, 3)
    assert np.abs(got - ref).max() <= 1e-6


# The frame's camera (r, theta, phi, spin) and the history's: the display
# history is an earlier resolved frame, here a seeded image.
LIVE_CAM = (29.6, 1.32, 0.31, 0.9)
PREV_CAM = (30.0, 1.3, 0.2, 0.5, 0.0)


def _history(rows, cols):
    return np.random.default_rng(8).uniform(0, 0.6, (rows, cols, 3)).astype(
        np.float32)


def _jax_display(cfg, rows, cols):
    """JAX's frame program (live.py:183-216) from its public pieces, op by
    op, on one frame accumulated on the history."""
    with jax.disable_jit():
        f = [jnp.float32(v) for v in LIVE_CAM]
        cam = JCamera.create(r=f[0], theta=f[1], phi=f[2], fov=0.5,
                             width=128, height=32)
        scene = JScene.create(mass=1.0, spin=f[3], camera=cam, march_cfg=cfg)
        img = j_render(scene, n_samples=1, dtype=jnp.float32)
        cam_now = jnp.stack([f[0], f[1], f[2], jnp.float32(0.5),
                             jnp.float32(0.0)])
        small = jax.image.resize(img, (rows, cols, 3), method="linear")
        resolved = j_taa_reprojected(
            jnp.asarray(_history(rows, cols)), small,
            jnp.asarray(PREV_CAM, jnp.float32), cam_now, 0.8, 1.5)
        disp = jnp.clip(resolved * 255.0, 0, 255).astype(jnp.uint8)
    return np.asarray(resolved), np.asarray(disp)


def test_display_program_matches_jax():
    """The live frame program at 128x32 -> 8x16 (render, antialiased
    resize, reprojected TAA, uint8) against JAX's, off the card (the
    staged plain path, as JAX's live loop runs off its accelerator), at
    the "medium" quality's 64-step horizon: the staged bars are
    short-horizon bars (test_fused.py marches 48 steps). Over 128 steps
    the ulp by which XLA's float32 transcendentals differ from correctly
    rounded ones (ROADMAP Queue 3 item 4) moves a few photon-ring and
    star-spot pixels of such a frame by up to 0.18."""
    rows, cols = 8, 16
    cfg = tlive.live_march_config("medium", False)
    # remat_every=0 runs JAX's march as one loop (op by op, each
    # rematerialized unit would compile); its values do not depend on it.
    jcfg = JMarchConfig(**{**dataclasses.asdict(cfg), "remat_every": 0})
    assert (jcfg.max_steps, jcfg.use_pallas, jcfg.step_rate) == (64, False,
                                                                 0.2)
    ref, ref_disp = _jax_display(jcfg, rows, cols)
    cam = tlive.live_camera(*LIVE_CAM)
    img = tlive.render_live_frame(cam, 1.0, cfg, 128, 32, "cpu")
    disp, resolved = tlive.display_program(
        img, torch.from_numpy(_history(rows, cols)), PREV_CAM,
        (*cam[:3], 0.5, 0.0), True, rows, cols)
    got = resolved.numpy()
    assert got.shape == (rows, cols, 3) and disp.dtype == torch.uint8
    d = np.abs(got - ref)
    assert np.percentile(d, 99) < 1e-4, np.percentile(d, 99)
    assert d.mean() < 1e-5, d.mean()
    assert np.abs(disp.numpy().astype(int) - ref_disp.astype(int)).max() <= 1
    # without a history the display is the resized frame
    _, first = tlive.display_program(img, None, None, PREV_CAM, False, rows,
                                     cols)
    assert torch.equal(first, tlive.resize_linear(img, rows, cols))


def test_run_live_smoke(tmp_path):
    """Headless, on the CPU. The scripted stream ends the loop at its last
    poll and the two in-flight frames are drained without being written,
    as in the JAX loop: 7 scripted frames dispatch 6 and write 4 PNGs."""
    stats = tlive.run_live(device="cpu", width=128, height=32, frames=7,
                           script="orbit", calibrate=False,
                           out_dir=str(tmp_path), term_cols=16)
    assert set(stats) == {"frames", "scales", "fps", "quality",
                          "calibrated_fps", "monitor"}
    assert stats["monitor"].keys() == JPerformanceMonitor().get_metrics().keys()
    assert stats["frames"] == 6 and stats["quality"] == "high"
    names = sorted(os.listdir(tmp_path))
    assert names == [f"live_{i:04d}.png" for i in range(4)]
    img = tshot.load_png_rgb(str(tmp_path / names[-1]))
    assert img.shape == (4, 16, 3)


# -- the CLI -------------------------------------------------------------------

def _json_out(capsys):
    return json.loads(capsys.readouterr().out)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300),
                        initial=0.0))


@pytest.mark.parametrize("args", [["--set", "spin=0.7"],
                                  ["--preset", "cinematic", "--set",
                                   "mass=2.5"]])
def test_info_matches_jax(args, capsys):
    assert tcli.main(["--device", "cpu", "info", *args]) == 0
    got = _json_out(capsys)
    assert jcli.main(["info", *args]) == 0
    want = _json_out(capsys)
    assert got.keys() == want.keys()
    for k in got:
        assert _rel(got[k], want[k]) <= 1e-12, k


@pytest.mark.parametrize("args", [["--set", "mass=2"], ["--full"],
                                  ["--preset", "balanced", "--state",
                                   "#spin=0.3&enable_jets=1"]])
def test_state_matches_jax(args, capsys, tmp_path):
    settings = ["--settings", str(tmp_path / "s.json")]
    assert tcli.main(["--device", "cpu", "state", *args, *settings]) == 0
    got = capsys.readouterr().out
    assert jcli.main(["state", *args, *settings]) == 0
    assert got == capsys.readouterr().out


def test_fields_matches_jax(tmp_path, capsys):
    t, j = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    assert tcli.main(["--device", "cpu", "fields", "--n-r", "8",
                      "--n-theta", "5", "--out", t]) == 0
    assert jcli.main(["fields", "--n-r", "8", "--n-theta", "5",
                      "--out", j]) == 0
    with np.load(t) as a, np.load(j) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].shape == b[k].shape, k
            assert _rel(a[k], b[k]) <= 1e-10, k


def test_render_matches_jax(tmp_path, capsys):
    """``render --width 32 --height 24 --preset minimal``: JAX's CLI
    (compiled) and the port's PNG have one shape (the preset renders at
    half scale) and agree to one level on >= 99% of values; behind them
    the float images agree at the staged bars against JAX op by op."""
    argv = ["render", "--width", "32", "--height", "24", "--preset",
            "minimal", "--out"]
    t, j = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert tcli.main(["--device", "cpu", *argv, t]) == 0
    assert jcli.main([*argv, j]) == 0
    a, b = tshot.load_png_rgb(t), tshot.load_png_rgb(j)
    assert a.shape == b.shape == (12, 16, 3)
    assert np.mean(np.abs(a.astype(int) - b.astype(int)) <= 1) >= 0.99

    params = tsim.apply_preset(tsim.SimulationParams(), "minimal")
    scene = tsim.scene_from_params(params, 32, 24, device="cpu")
    got = render(scene, device="cpu").numpy()
    jscene = jsim.scene_from_params(
        jsim.apply_preset(jsim.SimulationParams(), "minimal"), 32, 24)
    with jax.disable_jit():
        ref = np.asarray(j_render(jscene, dtype=jnp.float32))
    d = np.abs(got - ref)
    assert np.percentile(d, 99) < 1e-4 and d.mean() < 1e-5
    assert np.array_equal(a, tshot.load_png_rgb(
        tshot.save_png(np.clip(got, 0, 1), str(tmp_path / "d.png"))))


def test_animate_writes_director_frames(tmp_path, capsys):
    out = tmp_path / "frames"
    assert tcli.main(["--device", "cpu", "animate", "--frames", "2",
                      "--width", "16", "--height", "8", "--set",
                      "quality=low", "--outdir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]
    assert tshot.load_png_rgb(str(out / "frame_00001.png")).shape == (8, 16,
                                                                      3)


def test_inverse_reports_json(capsys):
    assert tcli.main(["--device", "cpu", "inverse", "--width", "16",
                      "--height", "12", "--steps", "2", "--init-spin", "0.6",
                      "--set", "quality=low"]) == 0
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last.keys() == {"true_spin", "recovered_spin", "error"}
    assert all(math.isfinite(v) for v in last.values())


def test_sweep_waits_for_multi_device(tmp_path, capsys):
    """The sweep, which waited for the multi-device slice, runs: JAX's
    test_sweep_tiny (tests/test_app.py:195) on a one-device mesh, with the
    frames equal to render_sharded of the director's cameras."""
    from blackhole_simulation_tpu_torch.engine.cinema import grand_survey
    from blackhole_simulation_tpu_torch.parallel import (
        make_mesh,
        render_sharded,
    )
    from blackhole_simulation_tpu_torch.render import Camera

    out = str(tmp_path / "sweep.npz")
    assert tcli.main(["--device", "cpu", "sweep", "--frames", "2", "--width",
                      "24", "--height", "16", "--set", "quality=low",
                      "--out", out]) == 0
    with np.load(out) as data:
        frames = data["frames"]
    assert frames.shape == (2, 16, 24, 3) and np.isfinite(frames).all()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["devices"] == 1 and line["shape"] == [2, 16, 24, 3]
    assert "mrays_per_s" in line and line["out"] == out
    params = dataclasses.replace(tsim.SimulationParams(), quality="low")
    scene0 = tsim.scene_from_params(params, width=24, height=16,
                                    device="cpu")
    for i in range(2):
        r, theta, phi = grand_survey(float(i))
        cam = Camera.create(r=r, theta=theta, phi=phi, fov=params.fov,
                            width=24, height=16)
        img = render_sharded(dataclasses.replace(scene0, camera=cam),
                             make_mesh(device="cpu"))
        assert np.array_equal(frames[i], img.numpy())


@pytest.mark.parametrize("cmd", ["info", "render", "animate", "sweep",
                                 "bench", "validate", "fields", "inverse",
                                 "live", "state"])
def test_no_device_raises_without_cuda(cmd, monkeypatch):
    """Without --device every subcommand resolves to cuda and raises where
    there is none: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main([cmd])
    with pytest.raises(RuntimeError):
        tcli.main(["--device", "cuda", cmd])


def test_parser_matches_jax():
    """Every subcommand and option of the JAX CLI, with its default; the
    port adds only the top-level --device."""
    def table(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, jcli.argparse._SubParsersAction))
        return {name: {a.dest: (a.default, a.choices)
                       for a in p._actions if a.dest != "help"}
                for name, p in sub.choices.items()}

    assert table(tcli.build_parser()) == table(jcli.build_parser())
