"""The public names the port gained last against their JAX twins, on seeded
numpy inputs, float32 unless stated.

* ``ops/ks_kernel.py``: the packed theta forms (``ks_rhs``,
  ``ks_renormalize``, ``ks_symplectic_step``), the transposed ones
  (``*_t``), the u forms (``ks_hamiltonian_u``, ``ks_rhs_u``,
  ``ks_symplectic_step_u``, with and without ``recip``) and ``set_row``:
  rtol 1e-5 / atol 1e-6 in float32 with JAX run op by op (the bar of
  tests/test_torch_ks.py for the same step math; the theta forms' sin and
  cos round once from float64 in the port), and rtol 1e-12 in float64;
* ``render/precull.py::capture_mask``: equal to JAX's, ray for ray;
* ``render/camera.py``: ``zamo_tetrad``, ``bl_to_ks_momentum`` and
  ``camera_scalars``, atol 1e-6;
* ``geometry/metrics.py``: ``kerr_sigma`` and ``kerr_delta`` exactly;
* ``constants``: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blackhole_simulation_tpu.constants as jconst
import blackhole_simulation_tpu_torch as tpkg
import blackhole_simulation_tpu_torch.constants as tconst
from blackhole_simulation_tpu.geometry import metrics as jmetrics
from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
from blackhole_simulation_tpu.ops import ks_kernel as jks
from blackhole_simulation_tpu.render import camera as jcamera
from blackhole_simulation_tpu.render import precull as jprecull
from blackhole_simulation_tpu_torch.geometry import metrics as tmetrics
from blackhole_simulation_tpu_torch.ops import ks_kernel as tks
from blackhole_simulation_tpu_torch.render import camera as tcamera
from blackhole_simulation_tpu_torch.render import precull as tprecull

torch.set_num_threads(1)

N = 512
SPINS = [0.0, 0.7, 0.999]
DTYPES = {"float32": (np.float32, dict(rtol=1e-5, atol=1e-6)),
          "float64": (np.float64, dict(rtol=1e-12, atol=1e-12))}


def _theta_states(seed=0):
    """(N, 8) theta-form states as tests/test_ops.py draws them."""
    rng = np.random.default_rng(seed)
    return np.stack([
        rng.uniform(0, 10, N), rng.uniform(1.3, 50.0, N),
        rng.uniform(0.15, np.pi - 0.15, N), rng.uniform(0, 2 * np.pi, N),
        -rng.uniform(0.5, 1.5, N), rng.normal(0, 1, N), rng.normal(0, 2, N),
        rng.normal(0, 3, N)], axis=-1)


def _u_rows(seed=1):
    """(8, N) u-chart rows, a quarter of them at or next to the pole."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.999, 0.999, N)
    u[: N // 4] = (1.0 - 10.0 ** rng.uniform(-8, -2, N // 4)) * rng.choice(
        [-1.0, 1.0], N // 4)
    return np.stack([
        rng.uniform(0.0, 50.0, N), rng.uniform(1.6, 60.0, N), u,
        rng.uniform(-3, 3, N), -np.ones(N), rng.normal(0.0, 1.0, N),
        rng.normal(0.0, 2.0, N), rng.normal(0.0, 3.0, N)])


def _dlam(seed=2):
    return np.random.default_rng(seed).uniform(0.005, 2.0, N)


def _pair(x, dt):
    x = np.asarray(x, dt)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(t, j, tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _recip_pair(dt):
    """The same non-exact reciprocal on both sides, so the ``recip`` hook
    is seen to be used."""
    k = np.asarray(1.0 + 1e-3, dt)
    return (lambda x: (1.0 / x) * jnp.asarray(k),
            lambda x: (1.0 / x) * torch.tensor(k))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("a", SPINS)
@pytest.mark.parametrize("form", ["packed", "transposed"])
def test_theta_forms(form, a, dtype):
    dt, tol = DTYPES[dtype]
    y = _theta_states()
    if form == "transposed":
        y = y.T
    jy, ty = _pair(y, dt)
    jd, td = _pair(_dlam(), dt)
    jm, tm = _pair(1.0, dt)
    ja, ta = _pair(a, dt)
    suffix = "" if form == "packed" else "_t"
    rhs = lambda mod: getattr(mod, "ks_rhs" + suffix)
    ren = lambda mod: getattr(mod, "ks_renormalize" + suffix)
    step = lambda mod: getattr(mod, "ks_symplectic_step" + suffix)
    with jax.disable_jit():
        j_rhs = rhs(jks)(jm, ja, jy)
        j_ren = ren(jks)(jm, ja, jy)
        j_step = step(jks)(jm, ja, jy, jd)
        j_step1 = step(jks)(jm, ja, jy, jd, 1)
    _close(rhs(tks)(tm, ta, ty), j_rhs, tol)
    _close(ren(tks)(tm, ta, ty), j_ren, tol)
    _close(step(tks)(tm, ta, ty, td), j_step, tol)
    _close(step(tks)(tm, ta, ty, td, 1), j_step1, tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("a", SPINS)
@pytest.mark.parametrize("recip", [False, True])
def test_u_forms(a, recip, dtype):
    dt, tol = DTYPES[dtype]
    jy, ty = _pair(_u_rows(), dt)
    jd, td = _pair(_dlam(), dt)
    jm, tm = _pair(1.0, dt)
    ja, ta = _pair(a, dt)
    jr, tr = _recip_pair(dt) if recip else (None, None)
    with jax.disable_jit():
        j_h = jks.ks_hamiltonian_u(jm, ja, jy)
        j_rhs = jks.ks_rhs_u(jm, ja, jy, recip=jr)
        j_step = jks.ks_symplectic_step_u(jm, ja, jy, jd, recip=jr)
        j_step1 = jks.ks_symplectic_step_u(jm, ja, jy, jd, 1, recip=jr)
    _close(tks.ks_hamiltonian_u(tm, ta, ty), j_h, tol)
    _close(tks.ks_rhs_u(tm, ta, ty, recip=tr), j_rhs, tol)
    _close(tks.ks_symplectic_step_u(tm, ta, ty, td, recip=tr), j_step, tol)
    _close(tks.ks_symplectic_step_u(tm, ta, ty, td, 1, recip=tr), j_step1,
           tol)
    if recip:   # the hook is used: the result moves off the exact divide
        exact = tks.ks_rhs_u(tm, ta, ty)
        assert not torch.equal(exact, tks.ks_rhs_u(tm, ta, ty, recip=tr))


@pytest.mark.parametrize("k", [0, 5, 7])
def test_set_row(k):
    jy, ty = _pair(_u_rows(), np.float32)
    jv, tv = _pair(np.random.default_rng(k).normal(size=N), np.float32)
    with jax.disable_jit():
        ref = jks.set_row(jy, k, jv)
    assert np.array_equal(tks.set_row(ty, k, tv).numpy(), np.asarray(ref))


def _camera_rays(a, width=48, height=32):
    bh = Kerr(mass=jnp.asarray(1.0, jnp.float32),
              spin=jnp.asarray(a, jnp.float32), chart=KS)
    cam = jcamera.Camera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                                width=width, height=height)
    with jax.disable_jit():
        return bh, np.array(jcamera.camera_rays(cam, bh))


@pytest.mark.parametrize("a", [0.0, 0.9, 0.999, -0.6])
def test_capture_mask(a):
    """The packed-form precull on the camera's theta-form rays
    (tests/test_precull.py's setup) and on seeded states."""
    bh, rays = _camera_rays(a)
    for y in (rays, _theta_states().astype(np.float32)):
        with jax.disable_jit():
            ref = np.asarray(jprecull.capture_mask(bh.mass, bh.spin,
                                                   jnp.asarray(y)))
        got = tprecull.capture_mask(torch.tensor(1.0), torch.tensor(a,
                                    dtype=torch.float32), torch.from_numpy(y))
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), ref)
    assert ref.dtype == bool


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("a", [0.0, 0.9, 0.999])
def test_camera_functions(a, dtype):
    dt, _ = DTYPES[dtype]
    rng = np.random.default_rng(3)
    r = rng.uniform(3.0, 80.0, 64).astype(dt)
    th = rng.uniform(0.1, np.pi - 0.1, 64).astype(dt)
    p = rng.normal(size=(64, 4)).astype(dt)
    jm, tm = _pair(1.0, dt)
    ja, ta = _pair(a, dt)
    with jax.disable_jit():
        j_tet = jcamera.zamo_tetrad(jm, ja, jnp.asarray(r), jnp.asarray(th))
        j_p = jcamera.bl_to_ks_momentum(jm, ja, jnp.asarray(r),
                                        jnp.asarray(p))
    t_tet = tcamera.zamo_tetrad(tm, ta, torch.from_numpy(r),
                                torch.from_numpy(th))
    for tv, jv in zip(t_tet, j_tet):
        assert tv.shape == (64, 4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tcamera.bl_to_ks_momentum(tm, ta, torch.from_numpy(r),
                                  torch.from_numpy(p)).numpy(),
        np.asarray(j_p), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("a", [0.0, 0.9, 0.999])
def test_camera_scalars(a):
    bh = Kerr(mass=jnp.asarray(1.0, jnp.float32),
              spin=jnp.asarray(a, jnp.float32), chart=KS)
    jcam = jcamera.Camera.create(r=30.0, theta=jnp.pi / 2 - 0.25, fov=0.5,
                                 width=96, height=54, roll=0.1)
    tcam = tcamera.Camera.create(r=30.0, theta=float(jnp.pi / 2 - 0.25),
                                 fov=0.5, width=96, height=54, roll=0.1)
    with jax.disable_jit():
        ref = jcamera.camera_scalars(jcam, bh)
    got = tcamera.camera_scalars(tcam, torch.tensor(1.0),
                                 torch.tensor(a, dtype=torch.float32))
    assert len(got) == len(ref) == 8
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("a", [0.0, 0.7, 0.999])
def test_kerr_sigma_delta(a):
    rng = np.random.default_rng(4)
    r = rng.uniform(1.0, 100.0, 256)
    th = rng.uniform(0.0, np.pi, 256)
    got_s = tmetrics.kerr_sigma(torch.tensor(a, dtype=torch.float64),
                                torch.from_numpy(r), torch.from_numpy(th))
    got_d = tmetrics.kerr_delta(torch.tensor(1.0, dtype=torch.float64),
                                torch.tensor(a, dtype=torch.float64),
                                torch.from_numpy(r))
    with jax.disable_jit():
        ref_s = jmetrics.kerr_sigma(jnp.asarray(a), jnp.asarray(r),
                                    jnp.asarray(th))
        ref_d = jmetrics.kerr_delta(jnp.asarray(1.0), jnp.asarray(a),
                                    jnp.asarray(r))
    assert np.array_equal(got_s.numpy(), np.asarray(ref_s))
    assert np.array_equal(got_d.numpy(), np.asarray(ref_d))


def test_constants_equal():
    names = [n for n in dir(jconst) if not n.startswith("_")
             and isinstance(getattr(jconst, n), float)]
    assert len(names) == 11
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    for n_suns in (1.0, 4.3e6, 6.5e9):
        assert tconst.solar_mass_m(n_suns) == jconst.solar_mass_m(n_suns)
        assert tconst.geometric_mass_m(n_suns) == jconst.geometric_mass_m(
            n_suns)
    assert tpkg.constants is tconst
