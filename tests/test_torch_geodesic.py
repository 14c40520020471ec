"""The port's oracle geometry and geodesic layers against the JAX package's,
in float64 on the CPU.

Metrics (both charts, Schwarzschild, Minkowski), Hamiltonians, the closed
forms of (dH/dr, dH/dtheta) against ``jax.grad`` and of g^{mu nu} p_nu
against the tensor contraction, the tensor algebra, Christoffel symbols and
radii: rel 1e-12 on seeded points that include both sides of the pole
clamp (sin^2(theta) = 1e-12) and points near the horizon. A derivative is a
sum of terms that can cancel, so its bar is 1e-12 of the size of its terms
(sum over mu, nu of |d g^{mu nu}| |p_mu| |p_nu| / 2, from ``jax.jvp`` of
JAX's contravariant metric). The three steppers, ``step_controller``,
``renormalize_null`` and ``constants_of_motion`` at rel 1e-12 against JAX
run op by op (``jax.disable_jit``). ``integrate`` on the photon-capture
scan (b in [-8, 8], a = 0.999, r = 100, both charts) against the jitted JAX
driver: termination codes identical, and the H drift within the bounds per
chart (escaped rays < 1e-7 in both; captured rays < 1e-6 in Kerr-Schild;
captured rays in Boyer-Lindquist, which is singular at the horizon,
< 5e-2).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geodesic import integrator as j_integrator
from blackhole_simulation_tpu.geodesic import invariants as j_invariants
from blackhole_simulation_tpu.geodesic.state import null_ray as j_null_ray
from blackhole_simulation_tpu.geometry import metrics as jm
from blackhole_simulation_tpu.geometry import radii as j_radii
from blackhole_simulation_tpu.geometry import tensor as j_tensor
from blackhole_simulation_tpu_torch.geodesic import (
    TERM_ESCAPE,
    TERM_HORIZON,
    IntegrationMethod,
    IntegrationOptions,
    constants_of_motion,
    hamiltonian,
    integrate,
    integrate_path,
    null_ray,
    renormalize_null,
    rk4_step,
    rkf45_step,
    step_controller,
    symplectic_step,
)
from blackhole_simulation_tpu_torch.geometry import metrics as tm
from blackhole_simulation_tpu_torch.geometry import radii as t_radii
from blackhole_simulation_tpu_torch.geometry import tensor as t_tensor

# The JAX package re-exports the function ``integrate`` under its module's
# name.
j_integrate_mod = importlib.import_module(
    "blackhole_simulation_tpu.geodesic.integrate")

REL = 1e-12
A_EXTREME = 0.999


def _points(spin, n=64, seed=0):
    """(r, theta, p) float64: seeded points, then both sides of the pole
    clamp at sin(theta) = 1e-6, the poles, and radii just outside r+."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.2, 60.0, n)
    th = rng.uniform(0.05, math.pi - 0.05, n)
    p = rng.normal(size=(n, 4))
    r_plus = 1.0 + math.sqrt(1.0 - spin * spin)
    pole = [0.0, 1e-7, 0.9e-6, 1.1e-6, 1e-3, math.pi - 0.9e-6,
            math.pi - 1.1e-6, math.pi]
    near = [r_plus * (1.0 + e) for e in (1e-9, 1e-6, 1e-3, 1e-1)]
    r[:len(pole)] = rng.uniform(2.0, 20.0, len(pole))
    th[:len(pole)] = pole
    r[len(pole):len(pole) + len(near)] = near
    return r, th, p


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _close(got, want, scale=None, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bound = np.abs(want) if scale is None else np.abs(want) + scale
    bad = np.abs(got - want) > rel * bound
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} differ; worst at "
        f"{np.unravel_index(np.argmax(np.abs(got - want) - rel * bound), got.shape)}:"
        f" {got[bad][:3]} vs {want[bad][:3]}")


def _metrics(spin, chart):
    return (jm.Kerr(mass=jnp.float64(1.0), spin=jnp.float64(spin), chart=chart),
            tm.KerrMetric.create(1.0, spin, chart=chart))


ALL_METRICS = [("kerr", 0.5, "bl"), ("kerr", A_EXTREME, "bl"),
               ("kerr", 0.5, "ks"), ("kerr", A_EXTREME, "ks"),
               ("schwarzschild", 0.0, "bl"), ("minkowski", 0.0, "bl")]


def _pair(kind, spin, chart):
    if kind == "kerr":
        return _metrics(spin, chart)
    if kind == "schwarzschild":
        return (jm.Schwarzschild(mass=jnp.float64(1.0)),
                tm.Schwarzschild.create(1.0))
    return jm.Minkowski(), tm.Minkowski()


@pytest.mark.parametrize("kind,spin,chart", ALL_METRICS)
def test_metric_tensors_and_hamiltonian(kind, spin, chart):
    jmet, tmet = _pair(kind, spin, chart)
    r, th, p = _points(spin)
    if kind == "schwarzschild":
        r = np.maximum(r, 2.0 + 1e-6)
    jr, jth, jp = jnp.asarray(r), jnp.asarray(th), jnp.asarray(p)
    _close(tmet.covariant(_t(r), _t(th)), jmet.covariant(jr, jth))
    _close(tmet.contravariant(_t(r), _t(th)), jmet.contravariant(jr, jth))
    _close(tmet.hamiltonian(_t(r), _t(th), _t(p)), jmet.hamiltonian(jr, jth, jp),
           scale=np.abs(np.asarray(jmet.contravariant(jr, jth))
                        * np.abs(p)[:, :, None] * np.abs(p)[:, None, :]
                        ).sum(axis=(1, 2)) * 0.5)


@pytest.mark.parametrize("kind,spin,chart", ALL_METRICS)
def test_closed_form_derivatives_match_jax_grad(kind, spin, chart):
    jmet, tmet = _pair(kind, spin, chart)
    r, th, p = _points(spin, seed=1)
    if kind == "schwarzschild":
        r = np.maximum(r, 2.0 + 1e-6)
    jr, jth, jp = jnp.asarray(r), jnp.asarray(th), jnp.asarray(p)
    want_r, want_th = jmet.hamiltonian_derivatives(jr, jth, jp)
    dx, got_r, got_th = tmet.flow(_t(r), _t(th), _t(p))
    pp = np.abs(p)[:, :, None] * np.abs(p)[:, None, :]
    ones = jnp.ones_like(jr)
    for x, got, want in ((0, got_r, want_r), (1, got_th, want_th)):
        tangents = (ones, 0 * ones) if x == 0 else (0 * ones, ones)
        dg = jax.jvp(jmet.contravariant, (jr, jth), tangents)[1]
        size = 0.5 * (np.abs(np.asarray(dg)) * pp).sum(axis=(1, 2))
        _close(got, want, scale=size)
    g = np.asarray(jmet.contravariant(jr, jth))
    _close(dx, np.einsum("...ij,...j->...i", g, p),
           scale=(np.abs(g) * np.abs(p)[:, None, :]).sum(axis=2))
    assert torch.isfinite(got_th).all()


def test_pole_clamp_passes_no_theta_derivative_through_s2():
    """Where sin^2(theta) < 1e-12 the clamp holds: dH/dtheta has no term
    from s2, as jax.grad gives; just outside it the term is back."""
    jmet, tmet = _metrics(A_EXTREME, "ks")
    r = np.array([8.0, 8.0])
    th = np.array([0.5e-6, 2e-6])
    p = np.array([[-1.0, 0.3, 0.2, 1e-6], [-1.0, 0.3, 0.2, 1e-6]])
    want = np.asarray(jmet.hamiltonian_derivatives(
        jnp.asarray(r), jnp.asarray(th), jnp.asarray(p))[1])
    got = tmet.flow(_t(r), _t(th), _t(p))[2].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-10)
    assert abs(got[1]) > 100 * abs(got[0])


@pytest.mark.parametrize("spin", [0.5, A_EXTREME])
def test_tensor_algebra_and_christoffel(spin):
    """On seeded points and one 1e-3 rad from the pole; the metric tests
    above cover the horizon and the clamp, where the inverse and the
    determinant are ill-conditioned (their rounding scales with the
    condition number, not the value)."""
    jmet, tmet = _metrics(spin, "bl")
    r, th, p = _points(spin, n=20, seed=2)
    keep = [4] + list(range(12, 20))
    r, th, p = r[keep], th[keep], p[keep]
    q = p[:, ::-1].copy()
    jr, jth = jnp.asarray(r), jnp.asarray(th)
    g = jmet.contravariant(jr, jth)
    gc = jmet.covariant(jr, jth)
    tg, tgc = _t(np.asarray(g)), _t(np.asarray(gc))
    size = lambda m, v, w: (np.abs(np.asarray(m)) * np.abs(v)[:, :, None]
                            * np.abs(w)[:, None, :]).sum(axis=(1, 2))
    _close(t_tensor.contract(tg, _t(p)), j_tensor.contract(g, jnp.asarray(p)),
           scale=size(g, p, p))
    _close(t_tensor.contract(tg, _t(p), _t(q)),
           j_tensor.contract(g, jnp.asarray(p), jnp.asarray(q)),
           scale=size(g, p, q))
    _close(t_tensor.raise_index(tg, _t(p)),
           j_tensor.raise_index(g, jnp.asarray(p)),
           scale=(np.abs(np.asarray(g)) * np.abs(p)[:, None, :]).sum(axis=2))
    _close(t_tensor.lower_index(tgc, _t(p)),
           j_tensor.lower_index(gc, jnp.asarray(p)),
           scale=(np.abs(np.asarray(gc)) * np.abs(p)[:, None, :]).sum(axis=2))
    det = np.asarray(j_tensor.determinant(gc))
    gn = np.abs(np.asarray(gc))
    _close(t_tensor.determinant(tgc), det,
           scale=gn[:, 1, 1] * gn[:, 2, 2] * (gn[:, 0, 0] * gn[:, 3, 3]
                                               + gn[:, 0, 3] ** 2))
    want = np.asarray(j_tensor.christoffel(jmet, jr, jth))
    got = t_tensor.christoffel(tmet, _t(r), _t(th)).numpy()
    assert got.shape == (9, 4, 4, 4)
    _close(got, want,
           scale=np.abs(want).max(axis=(1, 2, 3))[:, None, None, None])


@pytest.mark.parametrize("spin", [0.0, 0.5, A_EXTREME])
def test_radii(spin):
    for name in ("event_horizon", "cauchy_horizon"):
        _close(getattr(t_radii, name)(1.0, spin),
               getattr(j_radii, name)(1.0, spin))
    for pro in (True, False):
        _close(t_radii.photon_sphere(1.0, spin, pro),
               j_radii.photon_sphere(1.0, spin, pro))
        _close(t_radii.isco(1.0, spin, pro), j_radii.isco(1.0, spin, pro))
        _close(t_radii.keplerian_omega(1.0, spin, 7.0, pro),
               j_radii.keplerian_omega(1.0, spin, 7.0, pro))
    for th in (0.3, 1.2):
        _close(t_radii.ergosphere(1.0, spin, th),
               j_radii.ergosphere(1.0, spin, th))
        _close(t_radii.frame_dragging(1.0, spin, 5.0, th),
               j_radii.frame_dragging(1.0, spin, 5.0, th))
        _close(t_radii.time_dilation(1.0, spin, 5.0, th),
               j_radii.time_dilation(1.0, spin, 5.0, th))


def _states(metric_pair, n=24, seed=3):
    """Seeded null states (N, 8) around the hole, both packages."""
    jmet, tmet = metric_pair
    rng = np.random.default_rng(seed)
    x = np.stack([np.zeros(n), rng.uniform(3.0, 40.0, n),
                  rng.uniform(0.2, math.pi - 0.2, n), rng.uniform(0, 6, n)],
                 axis=1)
    ps = np.stack([rng.uniform(-1.0, 1.0, n), rng.normal(size=n) * 2.0,
                   rng.normal(size=n) * 4.0], axis=1)
    y = np.asarray(j_null_ray(jnp.asarray(x), jnp.asarray(ps), jmet))
    return x, ps, y


@pytest.mark.parametrize("chart", ["bl", "ks"])
def test_steppers_and_invariants(chart):
    pair = _metrics(A_EXTREME, chart)
    jmet, tmet = pair
    x, ps, y = _states(pair)
    _close(null_ray(_t(x), _t(ps), tmet), y, scale=np.abs(y).max(axis=1,
                                                              keepdims=True))
    h = np.full(y.shape[0], 0.05)
    jy, jh, ty, th_ = jnp.asarray(y), jnp.asarray(h), _t(y), _t(h)
    with jax.disable_jit():
        j5, jerr = j_integrator.rkf45_step(jmet, jy, jh)
        j4 = j_integrator.rk4_step(jmet, jy, jh)
        jsym = j_integrator.symplectic_step(jmet, jy, jh)
        ren = j_invariants.renormalize_null(jy + 1e-3, jmet)
        com = j_invariants.constants_of_motion(jy, jmet)
        jham = j_invariants.hamiltonian(jy + 1e-3, jmet)
    scale = np.abs(y).max(axis=1, keepdims=True)
    t5, terr = rkf45_step(tmet, ty, th_)
    _close(t5, j5, scale=scale)
    _close(terr, jerr, scale=1e-4 * scale[:, 0])
    _close(rk4_step(tmet, ty, th_), j4, scale=scale)
    _close(symplectic_step(tmet, ty, th_), jsym, scale=scale)
    _close(renormalize_null(ty + 1e-3, tmet), ren, scale=scale)
    _close(hamiltonian(ty + 1e-3, tmet), jham, scale=scale[:, 0] ** 2)
    tcom = constants_of_motion(ty, tmet)
    for f in ("energy", "angular_momentum", "carter_constant"):
        _close(getattr(tcom, f), getattr(com, f),
               scale=scale[:, 0] ** 2)
    _close(tcom.hamiltonian, com.hamiltonian, scale=scale[:, 0] ** 2)
    assert tcom.walker_penrose.dtype == torch.complex128
    wp = np.asarray(com.walker_penrose)
    _close(tcom.walker_penrose.real, wp.real, scale=np.abs(wp))
    _close(tcom.walker_penrose.imag, wp.imag, scale=np.abs(wp))


def test_step_controller():
    rng = np.random.default_rng(4)
    h = np.concatenate([rng.uniform(1e-5, 10.0, 40), [1e-5, 1e-5 * (1 + 1e-13),
                                                      2e-5, 10.0]])
    err = np.concatenate([10.0 ** rng.uniform(-16, -6, 40),
                          [1.0, 0.0, 1e-8, 0.0]])
    for tol in (1e-8, 1e-10):
        with jax.disable_jit():
            ja, jh = j_integrator.step_controller(
                jnp.asarray(h), jnp.asarray(err), tol)
        ta, th_ = step_controller(_t(h), _t(err), tol)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        _close(th_, jh)


def _capture_scan(chart):
    """The equatorial photon-capture scan: b in [-8, 8], a = 0.999, r0 =
    100, ingoing, both packages."""
    bs = np.linspace(-8.0, 8.0, 17)
    x = np.tile([0.0, 100.0, math.pi / 2, 0.0], (bs.size, 1))
    ps = np.stack([-np.ones_like(bs), np.zeros_like(bs), bs], axis=1)
    jmet, tmet = _metrics(A_EXTREME, chart)
    return x, ps, jmet, tmet


@pytest.mark.parametrize("chart", ["bl", "ks"])
def test_integrate_capture_scan(chart):
    x, ps, jmet, tmet = _capture_scan(chart)
    opts = IntegrationOptions(max_steps=20_000, escape_radius=200.0)
    jopts = j_integrator.IntegrationOptions(max_steps=20_000,
                                            escape_radius=200.0)
    y0 = j_null_ray(jnp.asarray(x), jnp.asarray(ps), jmet)
    jt = jax.jit(j_integrate_mod.integrate, static_argnums=(2,))(y0, jmet,
                                                                 jopts)
    tt = integrate(null_ray(_t(x), _t(ps), tmet), tmet, opts)
    term = tt.termination.numpy()
    np.testing.assert_array_equal(term, np.asarray(jt.termination))
    assert {TERM_HORIZON, TERM_ESCAPE} <= set(term.tolist())
    drift = tt.max_hamiltonian_drift.numpy()
    escaped, captured = term == TERM_ESCAPE, term == TERM_HORIZON
    assert drift[escaped].max() < 1e-7
    assert drift[captured].max() < (1e-6 if chart == "ks" else 5e-2)
    np.testing.assert_array_equal(tt.steps_taken.numpy()[escaped],
                                  np.asarray(jt.steps_taken)[escaped])


def test_integrate_exit_test_every_block_is_every_trial():
    """A ray that has ended never changes, so testing the exit after each
    block of trials gives what a test after every trial gives."""
    x, ps, _, tmet = _capture_scan("ks")
    y0 = null_ray(_t(x), _t(ps), tmet)
    opts = IntegrationOptions(max_steps=3_000, escape_radius=150.0)
    a = integrate(y0, tmet, opts, exit_every=1)
    b = integrate(y0, tmet, opts, exit_every=37)
    for f in ("final_state", "termination", "steps_taken",
              "max_hamiltonian_drift"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("method", [IntegrationMethod.RK4,
                                    IntegrationMethod.SYMPLECTIC])
def test_integrate_path_matches_jax(method):
    x, ps, jmet, tmet = _capture_scan("ks")
    jmethod = getattr(j_integrator.IntegrationMethod, method.name)
    y0 = j_null_ray(jnp.asarray(x[::4]), jnp.asarray(ps[::4]), jmet)
    with jax.disable_jit():
        jt = j_integrate_mod.integrate_path(y0, jmet, n_steps=12,
                                            step_size=1.0, method=jmethod)
    tt = integrate_path(_t(np.asarray(y0)), tmet, n_steps=12, step_size=1.0,
                        method=method)
    assert tuple(tt.path.shape) == (13, 5, 8)
    _close(tt.path, jt.path, scale=np.abs(np.asarray(jt.path)).max())
    np.testing.assert_array_equal(tt.termination.numpy(),
                                  np.asarray(jt.termination))
