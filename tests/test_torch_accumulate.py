"""Temporal accumulation on the port against the JAX package's, on the CPU.

Each function of ``render/accumulate.py`` on seeded 37x53 frames against
its JAX twin run op by op (``jax.disable_jit``), atol 1e-6: the colour
transforms, the 3x3 statistics, ``taa_resolve`` (still and moving),
``_cam_basis``, ``reproject_uv`` (an orbit with roll and a change of fov),
``_bilinear`` and ``taa_resolve_reprojected`` (measured: bit-equal, the
reprojected pixel coordinates and validity masks included, once the
camera's sin/cos/tan and the square roots round once through float64 as
XLA's float32 ones do here). ``TemporalAccumulator`` over 8-frame static,
moving and reprojected sequences against JAX's: every returned frame
within 1e-6 (measured: bit-equal), the frame counts, jitter indices and
previous cameras equal. Then tests/test_accumulate.py's behavioural bars
on the port, one case each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackhole_simulation_tpu.render.accumulate as jacc
import blackhole_simulation_tpu_torch.render.accumulate as tacc

torch.set_num_threads(1)

H, W = 37, 53
RNG = np.random.default_rng(5)
FRAMES = RNG.random((8, H, W, 3)).astype(np.float32) * 2.0
CAM_PREV = (25.0, 1.25, 0.25, 0.40, 0.0)
CAM_CURR = (25.5, 1.20, 0.30, 0.42, 0.1)
PY = RNG.uniform(-2.0, H + 1.0, (H, W)).astype(np.float32)
PX = RNG.uniform(-2.0, W + 1.0, (H, W)).astype(np.float32)


def _pair(name):
    """(JAX result, port result) of one function on the seeded inputs."""
    f0, f1 = FRAMES[0], FRAMES[1]
    j0, j1, t0, t1 = (jnp.asarray(f0), jnp.asarray(f1), torch.from_numpy(f0),
                      torch.from_numpy(f1))
    if name == "rgb_to_ycocg":
        return jacc.rgb_to_ycocg(j0), tacc.rgb_to_ycocg(t0)
    if name == "ycocg_to_rgb":
        return jacc.ycocg_to_rgb(j0), tacc.ycocg_to_rgb(t0)
    if name == "neighborhood_stats":
        return (jacc._neighborhood_stats(j0),
                tacc._neighborhood_stats(t0))
    if name.startswith("taa_resolve_"):
        moving = name.endswith("moving")
        return (jacc.taa_resolve(j0, j1, jnp.asarray(moving), 0.85),
                tacc.taa_resolve(t0, t1, moving, 0.85))
    if name == "cam_basis":
        args = [np.float32(v) for v in CAM_CURR[:3]]
        return (jacc._cam_basis(*[jnp.asarray(v) for v in args]),
                tacc._cam_basis(*[torch.tensor(v) for v in args]))
    if name == "bilinear":
        return (jacc._bilinear(j0, jnp.asarray(PY), jnp.asarray(PX)),
                tacc._bilinear(t0, torch.from_numpy(PY), torch.from_numpy(PX)))
    if name == "resolve_reprojected":
        cams = [np.asarray(c, np.float32) for c in (CAM_PREV, CAM_CURR)]
        return (jacc.taa_resolve_reprojected(j0, j1, *map(jnp.asarray, cams),
                                             0.85),
                tacc.taa_resolve_reprojected(t0, t1, *map(torch.from_numpy,
                                                          cams), 0.85))
    raise KeyError(name)


def _arrays(x):
    """A result, or each of a tuple of results, as numpy arrays."""
    xs = x if isinstance(x, tuple) else (x,)
    return [v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for v in xs]


@pytest.mark.parametrize("name", [
    "rgb_to_ycocg", "ycocg_to_rgb", "neighborhood_stats", "taa_resolve_still",
    "taa_resolve_moving", "cam_basis", "bilinear", "resolve_reprojected"])
def test_function_matches_jax(name):
    with jax.disable_jit():
        ref, out = _pair(name)
    ref, out = _arrays(ref), _arrays(out)
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        assert o.shape == r.shape and o.dtype == np.float32
        np.testing.assert_allclose(o, r, rtol=0.0, atol=1e-6)


def test_reproject_uv_matches_jax():
    with jax.disable_jit():
        py, px, valid = jacc.reproject_uv(CAM_PREV, CAM_CURR, H, W)
        py1, px1, valid1 = jacc.reproject_uv(CAM_CURR, CAM_CURR, H, W)
    ty, tx, tvalid = tacc.reproject_uv(CAM_PREV, CAM_CURR, H, W)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    assert 0 < int(tvalid.sum()) < H * W
    np.testing.assert_allclose(ty.numpy(), np.asarray(py), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(px), rtol=0, atol=1e-6)
    # The identity: every pixel onto itself, all valid.
    ty, tx, tvalid = tacc.reproject_uv(CAM_CURR, CAM_CURR, H, W)
    assert bool(tvalid.all()) and bool(np.asarray(valid1).all())
    np.testing.assert_allclose(ty.numpy(), np.asarray(py1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.numpy(), np.asarray(px1), rtol=0, atol=1e-6)


def _orbit(k):
    return (25.0, 1.25, 0.2 + 0.01 * k, 0.4, 0.0)


@pytest.mark.parametrize("mode", ["static", "moving", "reprojected"])
def test_accumulator_sequence_matches_jax(mode):
    jacc_ = jacc.TemporalAccumulator(feedback=0.85)
    tacc_ = tacc.TemporalAccumulator(feedback=0.85)
    with jax.disable_jit():
        for k, f in enumerate(FRAMES):
            moving = mode != "static" and k % 3 == 2
            cam = _orbit(k) if mode == "reprojected" else None
            moving = moving or mode == "reprojected"
            ref = np.asarray(jacc_.resolve(jnp.asarray(f), moving=moving,
                                           camera=cam))
            out = tacc_.resolve(torch.from_numpy(f), moving=moving,
                                camera=cam)
            assert isinstance(out, torch.Tensor)
            np.testing.assert_allclose(out.numpy(), ref, rtol=0.0, atol=1e-6)
            assert tacc_.frame_count == jacc_.frame_count
            assert tacc_.jitter_index == jacc_.jitter_index
            assert tacc_.prev_camera == jacc_.prev_camera


# --- tests/test_accumulate.py's bars on the port -----------------------------

def _round_trip():
    rgb = torch.from_numpy(np.random.default_rng(0).random((5, 7, 3)).astype(
        np.float32))
    back = tacc.ycocg_to_rgb(tacc.rgb_to_ycocg(rgb))
    np.testing.assert_allclose(back.numpy(), rgb.numpy(), atol=1e-6)


def _luma_weights():
    white = tacc.rgb_to_ycocg(torch.ones((1, 1, 3)))
    np.testing.assert_allclose(white[..., 0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(white[..., 1:].numpy(), 0.0, atol=1e-6)


def _static_converges():
    rng = np.random.default_rng(1)
    truth = np.full((8, 8, 3), 0.5, np.float32)
    acc = tacc.TemporalAccumulator(feedback=0.9)
    for _ in range(60):
        noisy = truth + rng.normal(0, 0.05, truth.shape).astype(np.float32)
        frame = acc.resolve(torch.from_numpy(noisy)).numpy()
    assert np.abs(frame - truth).mean() < 0.05 * np.sqrt(2 / np.pi) / 2


def _moving_resets():
    acc = tacc.TemporalAccumulator()
    acc.resolve(torch.zeros((4, 4, 3)))
    out = acc.resolve(torch.ones((4, 4, 3)), moving=True)
    np.testing.assert_allclose(out.numpy(), 1.0)


def _clamp_rejects_stale():
    out = tacc.taa_resolve(torch.full((6, 6, 3), 10.0),
                           torch.full((6, 6, 3), 0.2), False, 0.9)
    np.testing.assert_allclose(out.numpy(), 0.2, atol=1e-5)


def _shape_change_resets():
    acc = tacc.TemporalAccumulator()
    acc.resolve(torch.zeros((4, 4, 3)))
    out = acc.resolve(torch.ones((8, 8, 3)))
    np.testing.assert_allclose(out.numpy(), 1.0)


def _jitter_advances():
    acc = tacc.TemporalAccumulator()
    acc.resolve(torch.zeros((4, 4, 3)))
    i0 = acc.jitter_index
    acc.resolve(torch.zeros((4, 4, 3)))
    assert acc.jitter_index == i0 + 1


def _identity_reprojection():
    cam = (30.0, 1.3, 0.0, 0.4, 0.0)
    py, px, valid = tacc.reproject_uv(cam, cam, 12, 20)
    yy, xx = np.meshgrid(np.arange(12), np.arange(20), indexing="ij")
    np.testing.assert_allclose(py.numpy(), yy, atol=1e-3)
    np.testing.assert_allclose(px.numpy(), xx, atol=1e-3)
    assert bool(valid.all())


def _basis(c):
    r, th, ph = c[:3]
    e_r = np.array([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)])
    e_th = np.array([np.cos(th) * np.cos(ph), np.cos(th) * np.sin(ph),
                     -np.sin(th)])
    e_ph = np.array([-np.sin(ph), np.cos(ph), 0.0])
    return r * e_r, e_r, e_th, e_ph


def _orbit_matches_projection():
    h, w = 32, 48
    cur = (25.0, 1.2, 0.30, 0.4, 0.1)
    prv = (25.0, 1.25, 0.25, 0.4, 0.0)

    def project(c, wpt):
        pos, e_r, e_th, e_ph = _basis(c)
        v = wpt - pos
        cx, cy = (v @ e_ph) / (v @ e_r), (v @ e_th) / (v @ e_r)
        roll = c[4]
        cx, cy = (cx * np.cos(roll) + cy * np.sin(roll),
                  -cx * np.sin(roll) + cy * np.cos(roll))
        k2 = np.tan(c[3] / 2)
        return ((1.0 - cy / k2) * 0.5 * h - 0.5,
                (cx / (k2 * w / h) + 1.0) * 0.5 * w - 0.5)

    pos0, e_r0, e_th0, e_ph0 = _basis(cur)
    k2 = np.tan(cur[3] / 2)
    py, px, valid = (t.numpy() for t in tacc.reproject_uv(prv, cur, h, w))
    for iy, ix in [(5, 7), (16, 24), (28, 40), (0, 0)]:
        cx = ((ix + 0.5) / w * 2 - 1) * k2 * w / h
        cy = (1 - (iy + 0.5) / h * 2) * k2
        rc, rs = np.cos(cur[4]), np.sin(cur[4])
        cx, cy = cx * rc - cy * rs, cx * rs + cy * rc
        d = -e_r0 - cx * e_ph0 - cy * e_th0
        ref_y, ref_x = project(prv, pos0 + cur[0] * d / np.linalg.norm(d))
        if (iy, ix) != (0, 0):
            assert valid[iy, ix]
        np.testing.assert_allclose(py[iy, ix], ref_y, atol=1e-2)
        np.testing.assert_allclose(px[iy, ix], ref_x, atol=1e-2)


def _behind_camera_invalid():
    _, _, valid = tacc.reproject_uv((5.0, 1.3, 0.0, 0.4, 0.0),
                                    (30.0, 1.3, 0.0, 0.4, 0.0), 9, 9,
                                    depth=10.0)
    assert not bool(valid[4, 4])


def _orbit_keeps_accumulation():
    rng = np.random.default_rng(7)
    h, w, sigma, r0, fov = 24, 36, 0.08, 30.0, 0.3

    def clean_frame(phi):
        pos, e_r, e_th, e_ph = _basis((r0, 1.3, phi))
        nx, ny = np.meshgrid((np.arange(w) + 0.5) / w * 2 - 1,
                             1 - (np.arange(h) + 0.5) / h * 2, indexing="xy")
        k2 = np.tan(fov / 2)
        cx, cy = nx * k2 * w / h, ny * k2
        d = (-e_r[:, None, None] - cx[None] * e_ph[:, None, None]
             - cy[None] * e_th[:, None, None])
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        wpt = pos[:, None, None] + r0 * d
        g = (np.sin(1.3 * wpt[0]) * np.sin(1.1 * wpt[1])
             + 0.3 * np.sin(2.1 * wpt[2]))
        return np.repeat((0.5 + 0.25 * g)[:, :, None], 3, axis=2).astype(
            np.float32)

    def run(use_camera):
        acc = tacc.TemporalAccumulator(feedback=0.85)
        phi = 0.0
        for _ in range(40):
            phi += 0.004
            clean = clean_frame(phi)
            noisy = clean + rng.normal(0, sigma, clean.shape).astype(
                np.float32)
            cam = (r0, 1.3, phi, fov, 0.0) if use_camera else None
            out = acc.resolve(torch.from_numpy(noisy), moving=True,
                              camera=cam).numpy()
        return np.abs(out - clean)[3:-3, 3:-3].mean()

    floor = sigma * np.sqrt(2 / np.pi)
    assert run(True) < 0.55 * floor
    assert run(False) > 0.8 * floor


BARS = {f.__name__[1:]: f for f in (
    _round_trip, _luma_weights, _static_converges, _moving_resets,
    _clamp_rejects_stale, _shape_change_resets, _jitter_advances,
    _identity_reprojection, _orbit_matches_projection,
    _behind_camera_invalid, _orbit_keeps_accumulation)}


@pytest.mark.parametrize("name", sorted(BARS))
def test_behavioural_bar(name):
    BARS[name]()
