"""The composite's hand-written VJP (``ops/composite.py::composite_vjp_plain``,
the chain that ``csrc/composite.cu``'s VJP kernel computes) on the CPU.

Against ``torch.autograd.grad`` of the plain ``render/pipeline.py::
_composite``: every cotangent, per ray for the rows and summed for the 0-d
inputs (mass, spin, the ISCO and the photon sphere taken as inputs of
their own, the density and intensity scales), at rel <= 1e-5 in float64
and, in float32, <= 1e-4 of each row's largest value. Against ``jax.grad``
of the JAX package's ``shade_march_rows`` run op by op (the ISCO and the
photon sphere chained into mass and spin): rel < 5e-3 of each row's
largest value, the bar of tests/test_grad_kernel.py. The cases cover the
analytic and the Chebyshev disk, the starfield, glow and jets on and off,
K = 4 and 8, float32 and float64; each case's rays hold filled and
unfilled slots, crossings inside, below and past the disk (one at its
outer edge), escaped, captured and unfinished rays, and values on clip
bounds (u = +-1, a crossing at the ISCO's 1 + 1e-4, a density scale that
saturates the opacity). The kernel's forward values are the plain
composite's: ``composite_forward_plain`` equals ``_composite`` bit for bit.
Also: which path ``shade_march_rows`` takes (the CPU and the LUT branch
keep the plain composite), and the refusals. About 40 s on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render.march import MarchRows as JMarchRows
from blackhole_simulation_tpu.render.pipeline import Features as JFeatures
from blackhole_simulation_tpu.render.pipeline import Scene as JScene
from blackhole_simulation_tpu.render.pipeline import (
    shade_march_rows as j_shade_march_rows,
)
from blackhole_simulation_tpu.render.shading import DiskParams as JDisk
from blackhole_simulation_tpu_torch.geometry import metrics
from blackhole_simulation_tpu_torch.ops import composite as C
from blackhole_simulation_tpu_torch.ops import shade
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import MarchRows
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    _composite,
    _DUMMY_U,
    shade_march_rows,
)
from blackhole_simulation_tpu_torch.render.shading import (
    DiskParams,
    escape_direction_u_rows,
    spectral_kernel_tables,
)

torch.set_num_threads(1)

N = 96
SPIN = 0.9
ROWS = ("cross_r", "cross_phi", "cross_t", "state_u", "r_min_ph", "lam",
        "jet_rows")
# name -> (disk branch, Features overrides, K, DiskParams overrides)
CASES = {
    "analytic": ("analytic", {}, 4, {}),
    "cheb": ("cheb", {}, 4, {}),
    "analytic_k8": ("analytic", {}, 8, {}),
    "cheb_k8": ("cheb", {}, 8, {}),
    "jets": ("analytic", dict(jets=True), 4, {}),
    "no_sky": ("analytic", dict(starfield=False, photon_ring_glow=False), 4,
               {}),
    "stars_only": ("analytic", dict(photon_ring_glow=False, jets=True), 4,
                   {}),
    "glow_only": ("cheb", dict(starfield=False), 4, {}),
    "no_disk": (None, {}, 4, {}),
    # a beaming exponent that _powi raises by a plain pow, and fixed colours
    "pow_beam": ("analytic", {}, 4, dict(beaming_exponent=3.3)),
    "artistic": ("analytic", dict(jets=True), 4,
                 dict(artistic_rgb=(0.9, 0.6, 0.3))),
}
DTYPES = [torch.float32, torch.float64]


def scene_of(name):
    branch, feats, k, disk = CASES[name]
    f = Features(disk=branch is not None, spectral_lut=branch == "cheb",
                 **feats)
    scene = Scene.create(mass=1.0, spin=SPIN, camera=Camera.create(),
                         features=f, disk=DiskParams(**disk))
    if branch == "cheb":
        scene = dataclasses.replace(scene, spectral_coeffs=(
            spectral_kernel_tables(1.0, SPIN, scene.disk)))
    return scene, k


def make_rows(n, k, dtype, seed, at_isco=True):
    """Seeded rays: crossings filled and not, inside the disk, below the
    ISCO and past the edge (one on it and, with ``at_isco``, one at the
    ISCO's 1 + 1e-4), hits escaped, captured and unfinished, u on its clip
    bounds."""
    g = np.random.default_rng(seed)
    r_in = float(metrics.isco_t(torch.tensor(1.0, dtype=dtype),
                                torch.tensor(SPIN, dtype=dtype)))
    cr = g.uniform(1.0, 21.0, (k, n))
    cr[:, ::9] = 0.0
    cr[0, 1] = 18.0
    if at_isco:
        cr[0, 2] = float(torch.tensor(r_in, dtype=dtype)
                         * torch.tensor(1 + 1e-4, dtype=dtype))
    st = np.stack([
        g.uniform(0, 100, n), g.uniform(50, 300, n), g.uniform(-1, 1, n),
        g.uniform(-20, 20, n), -1.0 + 0.01 * g.standard_normal(n),
        g.uniform(-1, 1, n), g.uniform(-3, 3, n), g.uniform(-6, 6, n)])
    st[2, ::11] = 1.0
    st[2, 5::11] = -1.0
    t = lambda x: torch.tensor(x, dtype=dtype)
    hit = g.integers(0, 3, n)
    hit[:4] = 2
    return dict(
        hit=torch.tensor(hit, dtype=torch.int32), cross_r=t(cr),
        cross_phi=t(g.uniform(-10, 10, (k, n))),
        cross_t=t(g.uniform(-50, 200, (k, n))),
        n_crossings=torch.tensor(g.integers(0, k + 1, n), dtype=torch.int32),
        r_min_ph=t(g.uniform(0, 5, n)), lam=t(g.uniform(-7, 7, n)),
        state_u=t(st), jet_rows=t(g.uniform(0, 0.1, (3, n))))


def scalars(dtype, ds=1.3):
    m = torch.tensor(1.0, dtype=dtype)
    a = torch.tensor(SPIN, dtype=dtype)
    return dict(m=m, a=a, r_in=metrics.isco_t(m, a),
                r_ph=metrics.photon_sphere_t(m, a),
                ds=torch.tensor(ds, dtype=dtype),
                **{"is": torch.tensor(0.8, dtype=dtype)})


def autograd_vjp(scene, rows, sc, g):
    """autograd of the plain composite, with the ISCO and photon sphere as
    inputs of their own."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in {**sc, **{r: rows[r] for r in ROWS}}.items()}
    saved = metrics.isco_t, metrics.photon_sphere_t
    metrics.isco_t = lambda m_, a_: leaves["r_in"]
    metrics.photon_sphere_t = lambda m_, a_: leaves["r_ph"]
    try:
        out = _composite(
            scene, leaves["m"], leaves["a"], rows["hit"],
            (leaves["cross_r"], leaves["cross_phi"], leaves["cross_t"]),
            rows["n_crossings"], leaves["r_min_ph"], leaves["lam"],
            leaves["state_u"], escape_direction_u_rows, _DUMMY_U,
            leaves["jet_rows"], leaves["ds"], leaves["is"],
            scene.spectral_coeffs, None)
    finally:
        metrics.isco_t, metrics.photon_sphere_t = saved
    names = list(leaves)
    grads = torch.autograd.grad(
        sum((o * gg).sum() for o, gg in zip(out, g)),
        [leaves[k] for k in names], allow_unused=True)
    return {k: torch.zeros_like(leaves[k]) if v is None else v
            for k, v in zip(names, grads)}, out


def plain_vjp(scene, rows, sc, g):
    return C.composite_vjp_plain(
        C.CompositeStatic.of(scene), sc["m"], sc["a"], sc["r_in"],
        sc["r_ph"], rows["hit"], rows["cross_r"], rows["cross_phi"],
        rows["cross_t"], rows["n_crossings"], rows["r_min_ph"], rows["lam"],
        rows["state_u"], rows["jet_rows"], g, sc["ds"], sc["is"])


def rel(got, want):
    """Largest |got - want| of each row over the row's largest |want|."""
    d = (got - want).abs()
    if want.dim() < 2:
        return float(d.max() / want.abs().max().clamp(min=1e-30))
    return float((d.amax(-1) / want.abs().amax(-1).clamp(min=1e-30)).max())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_vjp_matches_autograd(name, dtype):
    scene, k = scene_of(name)
    rows = make_rows(N, k, dtype, seed=11 + k)
    # a density scale of 3 saturates the opacity of the denser crossings
    sc = scalars(dtype, ds=3.0 if name == "analytic" else 1.3)
    g = torch.tensor(np.random.default_rng(5).uniform(-1, 1, (3, N)),
                     dtype=dtype)
    want, out = autograd_vjp(scene, rows, sc, g)
    got = plain_vjp(scene, rows, sc, g)
    tol = 1e-5 if dtype == torch.float64 else 1e-4
    for key in (*ROWS, *C.SCALARS):
        w = want[key]
        if key in C.SCALARS and float(w.abs()) == 0.0:
            assert float(got[key]) == 0.0, key
            continue
        assert rel(got[key], w) <= tol, (key, rel(got[key], w))
    # the kernel's forward values are the plain composite's, bit for bit
    fwd = C.composite_forward_plain(
        C.CompositeStatic.of(scene), sc["m"], sc["a"], sc["r_in"],
        sc["r_ph"], rows["hit"], rows["cross_r"], rows["cross_phi"],
        rows["cross_t"], rows["n_crossings"], rows["r_min_ph"], rows["lam"],
        rows["state_u"], rows["jet_rows"], sc["ds"], sc["is"])
    for a, b in zip(fwd, out):
        assert torch.equal(a, b.detach())


def jax_vjp(scene, rows, sc, g):
    """jax.grad of the JAX composite, op by op, over the rows, lam, mass,
    spin and the two scales (float32)."""
    f = scene.features
    jf = JFeatures(disk=f.disk, starfield=f.starfield,
                   photon_ring_glow=f.photon_ring_glow, jets=f.jets,
                   spectral_lut=f.spectral_lut)
    coeffs = (None if scene.spectral_coeffs is None else
              tuple(jnp.asarray(x) for x in scene.spectral_coeffs))
    js = JScene.create(mass=1.0, spin=SPIN, features=jf,
                       disk=JDisk(**dataclasses.asdict(scene.disk)),
                       spectral_coeffs=coeffs)
    n = lambda x: jnp.asarray(x.numpy())
    k = rows["cross_r"].shape[0]

    def loss(cr, cphi, ct, st, rmin, lam, jets, m, a, ds, is_):
        jr = JMarchRows(state_u=st, hit=n(rows["hit"]),
                        steps=jnp.zeros((N,), jnp.int32), cross_r=cr,
                        cross_phi=cphi, cross_t=ct,
                        n_crossings=n(rows["n_crossings"]),
                        jet_radiance=jets, r_min_ph=rmin)
        bh = JKerr(mass=m, spin=a, chart=KS)
        out = j_shade_march_rows(jr, bh, dataclasses.replace(js, bh=bh),
                                 jnp.float32, lam, ds, is_)
        return sum(jnp.sum(o * n(g[i])) for i, o in enumerate(out))

    args = (n(rows["cross_r"]), n(rows["cross_phi"]), n(rows["cross_t"]),
            n(rows["state_u"]), n(rows["r_min_ph"]), n(rows["lam"]),
            n(rows["jet_rows"]), jnp.float32(1.0), jnp.float32(SPIN),
            jnp.float32(float(sc["ds"])), jnp.float32(float(sc["is"])))
    assert k == args[0].shape[0]
    with jax.disable_jit():
        grads = jax.grad(loss, argnums=tuple(range(11)))(*args)
    names = (*ROWS, "m", "a", "ds", "is")
    return {k_: torch.tensor(np.asarray(v)) for k_, v in zip(names, grads)}


@pytest.mark.parametrize("name", ["analytic", "cheb_k8", "jets", "no_disk"])
def test_vjp_matches_jax(name):
    scene, k = scene_of(name)
    # no crossing at the ISCO's edge: there the Chebyshev disk's observed
    # temperature sits on its 900 K floor, where pow(0, 0.4)'s infinite
    # derivative meets a routed zero, which JAX's gradient turns into NaN
    # where autograd's masked gradient (and the kernel's) gives 0; two
    # crossings of the K = 8 case, whose g-factor clips to 0.05, still
    # meet it
    rows = make_rows(N, k, torch.float32, seed=21, at_isco=False)
    sc = scalars(torch.float32)
    g = torch.tensor(np.random.default_rng(6).uniform(-1, 1, (3, N)),
                     dtype=torch.float32)
    got = plain_vjp(scene, rows, sc, g)
    # the ISCO and the photon sphere chained into mass and spin
    m, a = (sc[s].clone().requires_grad_(True) for s in ("m", "a"))
    chain = got["r_in"] * metrics.isco_t(m, a) + got["r_ph"] * (
        metrics.photon_sphere_t(m, a))
    dm, da = torch.autograd.grad(chain, (m, a))
    got["m"] = got["m"] + dm
    got["a"] = got["a"] + da
    want = jax_vjp(scene, rows, sc, g)
    for key, w in want.items():
        assert torch.isfinite(got[key]).all(), key
        # JAX's NaNs: a Chebyshev temperature on its floor (above)
        finite = torch.isfinite(w)
        assert int((~finite).sum()) <= 2, key
        got_k, w = torch.where(finite, got[key], 0.0), torch.where(
            finite, w, 0.0)
        if float(w.abs().max()) == 0.0:
            assert float(got_k.abs().max()) == 0.0, key
            continue
        assert rel(got_k, w) < 5e-3, (key, rel(got_k, w))


def _march_rows(rows):
    return MarchRows(state_u=rows["state_u"], hit=rows["hit"],
                     steps=torch.zeros(N, dtype=torch.int32),
                     cross_r=rows["cross_r"], cross_phi=rows["cross_phi"],
                     cross_t=rows["cross_t"],
                     n_crossings=rows["n_crossings"],
                     r_min_ph=rows["r_min_ph"], jet_radiance=rows["jet_rows"])


@pytest.mark.parametrize("name", ["analytic", "lut"])
def test_dispatch_keeps_the_plain_composite(name, monkeypatch):
    """The CPU takes the plain composite under autograd (the kernels'
    counters stay 0); a spectral scene without Chebyshev tables, the LUT
    branch, is refused by the kernels' configuration, so it stays plain on
    the card too."""
    f = Features(spectral_lut=name == "lut")
    scene = Scene.create(mass=1.0, spin=SPIN, features=f)
    if name == "lut":
        scene = dataclasses.replace(scene, spectral_coeffs=None)
        with pytest.raises(ValueError, match="LUT"):
            C.CompositeStatic.of(scene)
    called = []
    monkeypatch.setattr(C, "composite_rows",
                        lambda *a, **k: called.append(1))
    rows = make_rows(N, 4, torch.float32, seed=3)
    sc = scalars(torch.float32)
    a = sc["a"].clone().requires_grad_(True)
    before = (C.composite_kernel.launches, C.composite_vjp_kernel.launches)
    rgb = shade_march_rows(_march_rows(rows), sc["m"], a, scene,
                           rows["lam"], density_scale=sc["ds"])
    torch.autograd.grad(sum(c.sum() for c in rgb), a)
    assert not called and rgb[0].grad_fn is not None
    assert (C.composite_kernel.launches,
            C.composite_vjp_kernel.launches) == before


def test_refusals():
    """What the kernels do not take, said before any device is asked:
    another dtype, the CPU, mismatched rows and scalars."""
    scene, k = scene_of("analytic")
    c = C.CompositeStatic.of(scene)
    rows = make_rows(8, k, torch.float32, seed=1)
    sc = scalars(torch.float32)

    def reason(**over):
        kw = dict(m=sc["m"], a=sc["a"], r_in=sc["r_in"], r_ph=sc["r_ph"],
                  hit=rows["hit"], cross_r=rows["cross_r"],
                  cross_phi=rows["cross_phi"], cross_t=rows["cross_t"],
                  n_crossings=rows["n_crossings"],
                  r_min_ph=rows["r_min_ph"], lam=rows["lam"],
                  state_u=rows["state_u"], jet_rows=rows["jet_rows"],
                  density_scale=1.0, intensity_scale=sc["is"])
        kw.update(over)
        return C.refusal(c, **kw)

    assert "CUDA" in reason()
    assert "float32 or float64" in reason(lam=rows["lam"].half())
    with pytest.raises(ValueError, match="CUDA"):
        C.composite_kernel(c, sc["m"], sc["a"], sc["r_in"], sc["r_ph"],
                           rows["hit"], rows["cross_r"], rows["cross_phi"],
                           rows["cross_t"], rows["n_crossings"],
                           rows["r_min_ph"], rows["lam"], rows["state_u"],
                           rows["jet_rows"])


def test_exponent_routes():
    """_powi's plans go to the kernel as they are; a plain pow takes
    torch.pow's route of p and of p - 1."""
    pow2 = (shade.POW, shade.POW)
    assert shade.plan_fields(4.0, torch.float32) == ((0, 4, 0), pow2)
    assert shade.plan_fields(-2.0, torch.float32) == ((0, 2, 1), pow2)
    assert shade.plan_fields(3.3, torch.float32) == ((-1, 0, 0), pow2)
    # 3.0000001 is not a plan; rounded to float32 it is 3: torch.pow cubes
    plan, routes = shade.plan_fields(3.0000001, torch.float32)
    assert plan == (-1, 0, 0) and routes == (shade.CUBE, shade.SQUARE)


@pytest.mark.parametrize("disk", [{}, dict(artistic_rgb=(1.0, 0.6, 0.3),
                                           beaming_exponent=2.7)],
                         ids=["default", "artistic_pow"])
def test_render_and_composite_take_one_set_of_numbers(disk):
    """The render kernel's static configuration and the composite's
    arguments carry the disk's and the stars' numbers of one builder
    (``ops/shade.py::shade_args``): the composite's in float64, the render
    kernel's the same numbers rounded to float32."""
    from blackhole_simulation_tpu_torch.ops.render import _c_static
    from blackhole_simulation_tpu_torch.render.pipeline import kernel_inputs

    scene = Scene.create(mass=1.0, spin=SPIN, features=Features())
    scene = dataclasses.replace(
        scene, disk=dataclasses.replace(scene.disk, **disk))
    _, st = kernel_inputs(scene, None, "cpu")
    st = _c_static(st)
    args = C._c_args(C.CompositeStatic.of(scene), 1, 4, torch.float32, 1.0,
                     1.0)
    for ours, theirs in ((st.disk, args.disk), (st.stars, args.stars)):
        for name, _ in theirs._fields_:
            want = np.asarray(getattr(theirs, name))
            got = np.asarray(getattr(ours, name))
            if want.dtype == np.float64:
                want = want.astype(np.float32)
            assert np.array_equal(got, want), name
    assert args.disk.one_minus_turb == 1.0 - scene.disk.turbulence
    assert list(st.disk.beam_plan) == ([-1, 0, 0] if disk else [0, 4, 0])
