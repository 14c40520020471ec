"""The float64 gradient kernel's tape and block length, on the CPU.

The float64 gradient kernel (``csrc/march_grad.cu``) re-forwards each
4-step block into a tape in shared memory, one forward per step
(``march_adjoint.cuh::step_tape``), and reverses each step from the tape
(``march_step_vjp_tape``). Its CPU mirror, ``ops/march_adjoint.py``, has
the same two functions; here, on seeded float64 rays (numpy draws the
camera and the cotangents):

* the tape round trip: at every step of a short march, the state the
  kernel rebuilds from the previous step's stored words (``tape_rows``,
  ``tape_state``: u clipped, p_r renormalized where that was due) is the
  march's own state bit for bit, and the reverse from the stored tape is
  bit-equal to the unsplit ``march_step_vjp`` (forward, then reverse) at
  the march's state, at live, crossing, renormalizing and frozen steps,
  with one and two midpoint rounds and a renormalization cadence that is
  not a multiple of the block length;
* the reverse from the tape against ``torch.autograd`` through
  ``ops/march.py::march_step_rows`` at rel 1e-12 (per element, with an
  absolute floor of 1e-12 times the row's largest |reference|);
* the plain ``march_grad`` in float64 at the kernel's block length (4) and
  at 8 and 3: bit-equal, the replay being deterministic;
* the float64 gradient of the port's differentiable ``march_rows``
  (``march_grad`` backward) against ``jax.grad`` through the JAX package's
  float64 jnp ``march_rows`` at rel 1e-7 (tests/test_torch_f64_ad.py's
  bar), 32 rays, 64 steps without jets and 96 with them. The JAX
  references run jitted in a child process without fused multiply-adds
  (tests/test_torch_render_ad.py's ``JaxChild``): op by op they took 72 s
  a case on the CPU, the jitted child 16 s for both;
* the census's pieces that run without a card: the reverse-loop finder of
  ``tools/sass_census.py`` and ``tools/grad_census.py``'s one-thread-per-
  ray lane efficiency.
"""

import dataclasses as dc
import json
import math
import sys

import numpy as np
import pytest
import torch

from blackhole_simulation_tpu_torch._elementwise import clip
from blackhole_simulation_tpu_torch.ops.march import march_step_rows
from blackhole_simulation_tpu_torch.ops.march_adjoint import (
    U_CLIP,
    march_step_vjp,
    march_step_vjp_tape,
    step_tape,
    tape_rows,
    tape_state,
)
from blackhole_simulation_tpu_torch.ops.march_grad import (
    CKPT_F64,
    march_grad,
    scratch_words,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import march_u_plain
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import (
    HIT_NONE,
    MarchConfig,
    _march_inputs,
    march_rows,
)
from blackhole_simulation_tpu_torch.render.shading import JetParams
from blackhole_simulation_tpu_torch.tools import grad_census, sass_census

torch.set_num_threads(1)

F64 = torch.float64
# The flagship physics (the float64 AD frame's), cut short; the mirror's
# march renormalizes every 3 steps, so renormalizations fall inside the
# kernel's 4-step blocks and the rebuilt state must carry them.
FLAGSHIP = dict(step_rate=0.2, far_step_cap_rate=0.4, far_boost_radius=20.0)
# (rays' frame, jets, max_steps) of the JAX comparisons: 32 rays.
JAX_CASES = {"midpoint": (False, 64), "jets": (True, 96)}
JAX_SIZE = (8, 4)


def _camera(seed, width, height):
    """A seeded camera and hole: (Camera, spin) drawn with numpy."""
    rng = np.random.default_rng(seed)
    theta = math.pi / 2 - float(rng.uniform(0.15, 0.35))
    r = float(rng.uniform(25.0, 35.0))
    spin = float(rng.uniform(0.6, 0.95))
    return Camera.create(r=r, theta=theta, fov=0.5, width=width,
                         height=height), spin


def _rays(cfg, seed=11, width=12, height=8):
    """Seeded float64 rays at p_t = -1 and their march inputs."""
    cam, spin = _camera(seed, width, height)
    m, a = torch.tensor(1.0, dtype=F64), torch.tensor(spin, dtype=F64)
    return _march_inputs(camera_rays_u(cam, m, a, dtype=F64), m, a, cfg,
                         None)


def _steps(cfg, n_steps):
    """The pre-step states of a march with ``march_step_rows``: for each
    step, (x (11 rows of the live rays), thr, nc, the march's post-step
    rows, crossed), and the scalars."""
    yt, thr, m, a, r_h, r_ph = _rays(cfg)
    n = yt.shape[1]
    y6, pph = tuple(yt[j] for j in (0, 1, 2, 3, 5, 6)), yt[7]
    hit = torch.zeros(n, dtype=torch.int32)
    nc = torch.zeros_like(hit)
    out = []
    for i in range(n_steps):
        live = hit == HIT_NONE
        if not bool(live.any()):
            break
        (y6n, *_), (hit2, nc2, crossed, _) = march_step_rows(
            m, a, r_h, r_ph, thr, cfg, i, y6, pph, hit, nc)
        x = [v[live] for v in y6] + [pph[live]] + [
            v.expand(n)[live] for v in (m, a, r_h, r_ph)]
        out.append((i, x, thr[live], nc[live], [v[live] for v in y6n],
                    crossed[live]))
        y6, hit, nc = y6n, hit2, nc2
    return out


def _cotangents(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=n)) for _ in range(10)]


def _stored_tape(tape):
    """The tape as the kernel reads it back: the stored rows (the
    unclipped u in place of u), u clipped again, beside dlam, mid and the
    decisions."""
    rows = tape_rows(tape)
    y = list(rows)
    y[2] = clip(rows[2], *U_CLIP)
    return {"dlam": tape["dlam"], "mid": tape["mid"], "y": tuple(y),
            "nu_raw": rows[2], "advance": tape["advance"],
            "renorm": tape["renorm"]}


def _same(a, b):
    return torch.equal(a.view(torch.int64), b.view(torch.int64))


@pytest.fixture(scope="module", autouse=True)
def jax_child():
    """The JAX references' child process, started before this file's first
    test so that its compiles overlap the tests before the comparison."""
    from test_torch_render_ad import JaxChild

    child = JaxChild(__file__, *JAX_CASES)
    try:
        yield child
    finally:
        child.close()


@pytest.fixture(scope="module")
def jax_refs(jax_child):
    return jax_child.result()


@pytest.mark.parametrize("iters", [1, 2])
def test_tape_round_trip_and_reverse_are_bit_equal(iters):
    cfg = MarchConfig(max_steps=48, renormalize_every=3,
                      midpoint_iters=iters, **FLAGSHIP)
    seen = {"crossed": 0, "renorm": 0, "rebuilt": 0}
    prev = None
    for i, x, thr, nc, y_next, crossed in _steps(cfg, cfg.max_steps):
        m, a, pph = x[7], x[8], x[6]
        tape = step_tape(cfg, x, thr, i, nc)
        if prev is not None:
            # the state the kernel rebuilds from the previous step's words
            p_rows, p_renorm, p_live = prev
            rebuilt = tape_state(tuple(r[p_live] for r in p_rows),
                                 p_renorm[p_live], m, a, pph)
            for k in range(6):
                assert _same(rebuilt[k], x[k]), (i, k)
            seen["rebuilt"] += 1
        cto = _cotangents(x[0].numel(), i)
        want, fw = march_step_vjp(cfg, x, thr, i, nc, cto)
        got = march_step_vjp_tape(cfg, x, _stored_tape(tape), cto)
        for k in range(11):
            assert _same(got[k], want[k]), (i, k)
        # the tape's post-step state is the march's
        post = fw["s"]
        for k in range(6):
            assert _same(post[k], y_next[k]), (i, k)
        seen["crossed"] += int(crossed.sum())
        seen["renorm"] += int(tape["renorm"].sum())
        prev = (tape_rows(tape), tape["renorm"], tape["hit"] == HIT_NONE)
    assert seen["crossed"] > 0 and seen["renorm"] > 0, seen
    assert seen["rebuilt"] > 20, seen


def test_frozen_step_round_trip():
    """A step frozen by the sanity test (momenta past 1e7, finite): its
    stored rows hold the stepped values, the carry passes, and the reverse
    from the stored tape equals the unsplit VJP."""
    cfg = MarchConfig(max_steps=48, **FLAGSHIP)
    i, x, thr, nc, _, _ = _steps(cfg, 8)[5]
    x = [v[:6].clone() for v in x]
    x[5] = torch.full_like(x[5], 2e7)
    thr, nc = thr[:6], nc[:6]
    tape = step_tape(cfg, x, thr, i, nc)
    assert not bool(tape["advance"].any())
    cto = _cotangents(6, 99)
    want, _ = march_step_vjp(cfg, x, thr, i, nc, cto)
    got = march_step_vjp_tape(cfg, x, _stored_tape(tape), cto)
    for k in range(11):
        assert _same(got[k], want[k]), k


def _autograd(cfg, x, thr, i, nc, cto):
    ins = [v.clone().requires_grad_() for v in x]
    hit = torch.zeros_like(nc)
    (y6, r_c, phi_c, t_c, dmin, _), _ = march_step_rows(
        ins[7], ins[8], ins[9], ins[10], thr, cfg, i, tuple(ins[:6]), ins[6],
        hit, nc)
    return torch.autograd.grad([*y6, r_c, phi_c, t_c, dmin], ins, cto)


def _autograd_cases():
    cfg = MarchConfig(max_steps=48, renormalize_every=3, **FLAGSHIP)
    steps = _steps(cfg, cfg.max_steps)
    cases = {"live": steps[4]}
    cases["crossing"] = max(steps, key=lambda s: int(s[5].sum()))
    cases["renorm"] = next(s for s in steps[10:] if (s[0] + 1) % 3 == 0)
    i, x, thr, nc, _, _ = steps[5]
    x = [v[:6].clone() for v in x]
    x[5] = torch.full_like(x[5], 2e7)
    cases["frozen"] = (i, x, thr[:6], nc[:6], None, None)
    return cfg, cases


@pytest.mark.parametrize("case", ["live", "crossing", "renorm", "frozen"])
def test_tape_reverse_matches_autograd(case):
    cfg, cases = _autograd_cases()
    i, x, thr, nc, _, crossed = cases[case]
    if case == "crossing":
        keep = crossed
        x, thr, nc = [v[keep] for v in x], thr[keep], nc[keep]
    tape = step_tape(cfg, x, thr, i, nc)
    assert {"live": bool(tape["advance"].all()),
            "crossing": bool(tape["crossed"].all()),
            "renorm": bool(tape["renorm"].any()),
            "frozen": not bool(tape["advance"].any())}[case]
    cto = _cotangents(x[0].numel(), 7)
    got = march_step_vjp_tape(cfg, x, _stored_tape(tape), cto)
    want = _autograd(cfg, x, thr, i, nc, cto)
    for k, (g, r) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), k
        np.testing.assert_allclose(
            g.numpy(), r.numpy(), rtol=1e-12,
            atol=1e-12 * float(r.abs().max()), err_msg=f"input {k}")


def _grad_args(jets, max_steps=64, clip=0.0):
    cfg = MarchConfig(max_steps=max_steps, cotangent_clip=clip, **FLAGSHIP)
    jp = JetParams() if jets else None
    yt0, thr, m, a, r_h, r_ph = _rays(cfg, seed=5, width=8, height=4)
    outs = march_u_plain(yt0, thr, m, a, r_h, r_ph, cfg, jp)
    n, k = yt0.shape[1], cfg.max_crossings
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.normal(size=s))
    ct_fin = f(8, n)
    ct_fin[4] = 0.0
    return (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, f(k, n), f(k, n),
            f(k, n), f(n), outs[7], f(3, n) if jets else None, jp)


@pytest.mark.parametrize("jets,clip", [(False, 0.0), (True, 0.05)])
def test_plain_march_grad_is_bit_equal_across_block_lengths(jets, clip):
    args = _grad_args(jets, clip=clip)
    want = march_grad(*args, ckpt=CKPT_F64)
    assert bool(torch.isfinite(want[0]).all())
    for ckpt in (8, 3):
        got = march_grad(*args, ckpt=ckpt)
        for g, w in zip(got, want):
            assert _same(g.reshape(-1), w.reshape(-1)), ckpt
    # the default is the kernel's block length for float64 rays
    for g, w in zip(march_grad(*args), want):
        assert _same(g.reshape(-1), w.reshape(-1))
    assert scratch_words(args[6], F64) == -(-64 // CKPT_F64) * 7 + 1


def _port_loss(rows, jets):
    loss = (rows.state_u[1].mean() + 0.1 * rows.cross_r.mean()
            + 0.05 * rows.cross_phi.mean() + 0.02 * rows.cross_t.mean()
            + 0.01 * torch.exp(-rows.r_min_ph).mean())
    return loss + 0.1 * rows.jet_radiance.mean() if jets else loss


def _port_grads(case):
    jets, steps = JAX_CASES[case]
    cam, spin = _camera(5, *JAX_SIZE)
    cfg = MarchConfig(max_steps=steps, shadow_precull=False, remat_every=0,
                      midpoint_iters=1, **FLAGSHIP)
    m = torch.tensor(1.0, dtype=F64, requires_grad=True)
    a = torch.tensor(spin, dtype=F64, requires_grad=True)
    rows = march_rows(camera_rays_u(cam, m, a, dtype=F64), m, a, cfg,
                      jets=JetParams() if jets else None)
    return [float(g) for g in torch.autograd.grad(_port_loss(rows, jets),
                                                  (a, m))]


def _child_main(cases):
    """The JAX references (run as this file's __main__ in a child without
    fused multiply-adds): {case: [d/d spin, d/d mass]}."""
    import importlib

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from blackhole_simulation_tpu.geometry.metrics import KS, Kerr
    from blackhole_simulation_tpu.render import Camera as JCamera
    from blackhole_simulation_tpu.render import MarchConfig as JMarchConfig
    from blackhole_simulation_tpu.render.camera import camera_rays_u as j_rays
    from blackhole_simulation_tpu.render.shading import JetParams as JJets

    jmarch = importlib.import_module("blackhole_simulation_tpu.render.march")
    out = {}
    for case in cases:
        jets, steps = JAX_CASES[case]
        cam, spin = _camera(5, *JAX_SIZE)
        jcam = JCamera.create(r=cam.r, theta=cam.theta, fov=cam.fov,
                              width=cam.width, height=cam.height)
        cfg = JMarchConfig(max_steps=steps, shadow_precull=False,
                           remat_every=0, midpoint_iters=1, **FLAGSHIP)

        def loss(a, m):
            bh = Kerr(mass=m, spin=a, chart=KS)
            rows = jmarch.march_rows(j_rays(jcam, bh, dtype=jnp.float64), bh,
                                     cfg, jets=JJets() if jets else None)
            v = (jnp.mean(rows.state_u[1]) + 0.1 * jnp.mean(rows.cross_r)
                 + 0.05 * jnp.mean(rows.cross_phi)
                 + 0.02 * jnp.mean(rows.cross_t)
                 + 0.01 * jnp.mean(jnp.exp(-rows.r_min_ph)))
            return v + 0.1 * jnp.mean(rows.jet_radiance) if jets else v

        g = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.float64(spin),
                                                   jnp.float64(1.0))
        out[case] = [float(x) for x in g]
    return out


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_float64_gradient_matches_jax(case, jax_refs):
    got = _port_grads(case)
    for g, r in zip(got, jax_refs[case]):
        assert math.isfinite(g)
        assert g == pytest.approx(r, rel=1e-7, abs=1e-12), (got, jax_refs)


SASS = """
        Function : _Z21march_grad_kernel_f64ILb0EEvPKdS1_
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   DFMA R2, R4, R6, R2 ;
        /*0020*/               @P0 BRA 0x10 ;
        /*0030*/                   STS.64 [R7], R2 ;
        /*0040*/               @P1 BRA 0x30 ;
        /*0050*/                   LDS.64 R8, [R7] ;
        /*0060*/                   DFMA R8, R8, R8, R2 ;
        /*0070*/                   DMUL R8, R8, R4 ;
        /*0080*/               @P2 BRA 0x60 ;
        /*0090*/                   DADD R8, R8, R2 ;
        /*00a0*/               @P3 BRA 0x50 ;
        /*00b0*/                   STG.E.64 [R10.64], R8 ;
        /*00c0*/               @P4 BRA 0x30 ;
        /*00d0*/                   EXIT ;
"""


def test_reverse_loop_is_the_outer_shared_read_loop():
    """Of the loops that read shared memory and store nothing (global,
    shared or atomic), the outermost: not the re-forward that stores the
    tape, not the outer block loop that stores the outputs, not the
    store-free loop nested in the reverse."""
    instrs = sass_census.parse(SASS)["_Z21march_grad_kernel_f64ILb0EEvPKdS1_"]
    lo, hi = sass_census.reverse_loop(instrs)
    assert (instrs[lo][0], instrs[hi][0]) == (0x50, 0xA0)
    out = sass_census.reverse_census(SASS)
    rec = out["march_grad_kernel_f64<0>"]
    assert rec["total"] == 6 and rec["counts"]["double"] == 3
    assert rec["counts"]["memory"] == 1 and rec["counts"]["branch"] == 2
    # the replay's march loop is the first store-free one
    lo, hi = sass_census.march_loop(instrs)
    assert (instrs[lo][0], instrs[hi][0]) == (0x10, 0x20)


def test_block_lane_efficiency():
    steps = torch.tensor([8, 9, 16, 1] + [0] * 28)
    # blocks of 4: 2, 3, 4, 1 and 28 rays of one (born dead: at least 1)
    assert grad_census.block_lane_efficiency(steps, 4) == pytest.approx(
        (2 + 3 + 4 + 1 + 28) / (32 * 4))
    assert grad_census.block_lane_efficiency(torch.full((64,), 12), 4) == 1.0


if __name__ == "__main__":
    print(json.dumps(_child_main(sys.argv[1:])))
