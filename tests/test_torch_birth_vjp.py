"""Ray birth's hand-written VJP (``ops/birth.py::birth_vjp_plain``, the
chain that ``csrc/birth.cu``'s VJP kernels compute) on the CPU.

Against ``torch.autograd.grad`` of the plain ``render/camera.py::
camera_rays_u_plain`` for a seeded (8, N) cotangent: the gradients of
mass, spin, theta (the override or the camera's), r, phi, and of a tensor
fov and roll through the float64 functions the plain chain attaches, at
rel <= 1e-11 in float64 and <= 1e-5 in float32 (sums over the rays in
another order and precision). The cases cover pixel ids and the whole
frame, with and without a jitter; the camera's fields as numbers and as
tensors; positive, negative and zero spin; theta near the poles, below
the clamps and on the tetrad's sin^2 clamp (a tie, whose tangent autograd
passes whole); and mass with and without a gradient. Against ``jax.vjp``
of the JAX package's ``camera_rays_u`` in float64 on a small frame. Also:
the CPU takes the plain chain (the kernels' counters stay 0), and what the
kernels refuse. About 7 s on one worker.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.geometry.metrics import KS, Kerr as JKerr
from blackhole_simulation_tpu.render import Camera as JCamera
from blackhole_simulation_tpu.render.camera import camera_rays_u as j_rays
from birth_cases import (
    CASES,
    DTYPES,
    FIELDS,
    H,
    W,
    leaves_of,
    rel,
    setup,
    twin_grads,
)
from blackhole_simulation_tpu_torch.ops import birth as B
from blackhole_simulation_tpu_torch.render.camera import (
    Camera,
    camera_rays_u,
    camera_rays_u_plain,
)

torch.set_num_threads(1)

@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", list(CASES))
def test_vjp_matches_autograd(name, dtype):
    cam, m, a, th, pix, jitter = setup(name, dtype)
    rows = camera_rays_u_plain(cam, m, a, pix_ids=pix, jitter=jitter,
                               theta=th, dtype=dtype)
    assert torch.isfinite(rows).all()
    g = torch.tensor(np.random.default_rng(1).uniform(-1, 1, rows.shape),
                     dtype=dtype)
    leaves = leaves_of(cam, m, a, th)
    auto = dict(zip(leaves, torch.autograd.grad((rows * g).sum(),
                                                list(leaves.values()))))
    got = twin_grads(cam, m, a, th, pix, jitter, dtype, g)
    bar = 1e-11 if dtype == torch.float64 else 1e-5
    for key, want in auto.items():
        assert math.isfinite(float(got[key])), key
        assert rel(got[key], want) <= bar, (key, float(got[key]), float(want))
    if name == "sin_clamp_tie" and dtype == torch.float32:
        s = torch.sin(th.detach().double()).float()
        assert s * s == torch.tensor(1e-12)


def test_vjp_matches_jax():
    """float64 against jax.vjp of the JAX package's camera_rays_u, on a
    whole jittered frame and on pixel ids."""
    vals = dict(mass=1.0, spin=0.8, **FIELDS)
    names = list(vals)

    def j_birth(pix, jitter):
        def f(*xs):
            v = dict(zip(names, xs))
            cam = JCamera(r=v["r"], theta=v["theta"], phi=v["phi"],
                          fov=v["fov"], roll=v["roll"], width=W, height=H)
            bh = JKerr(mass=v["mass"], spin=v["spin"], chart=KS)
            return j_rays(cam, bh, pix_ids=pix, jitter=jitter,
                          dtype=jnp.float64)
        return f

    for ids, jitter in ((None, (0.3, -0.2)),
                        (np.random.default_rng(2).integers(0, W * H, 33),
                         None)):
        xs = [jnp.float64(vals[k]) for k in names]
        out, vjp = jax.vjp(j_birth(None if ids is None else jnp.asarray(ids),
                                   None if jitter is None
                                   else jnp.asarray(jitter)), *xs)
        g = np.random.default_rng(3).uniform(-1, 1, out.shape)
        want = dict(zip(names, (float(x) for x in vjp(jnp.asarray(g)))))
        t = lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=True)
        cam = Camera.create(width=W, height=H,
                            **{k: t(vals[k]) for k in FIELDS})
        got = twin_grads(cam, t(vals["mass"]), t(vals["spin"]), None,
                         None if ids is None else torch.tensor(ids), jitter,
                         torch.float64, torch.tensor(g))
        got["mass"], got["spin"] = got["m"], got["a"]
        for key in names:
            assert rel(got[key], want[key]) <= 1e-9, (key, float(got[key]),
                                                      want[key])


@pytest.mark.parametrize("grad", [False, True])
def test_the_cpu_takes_the_plain_chain(grad):
    """On the CPU ``camera_rays_u`` is the plain chain, value and graph;
    neither kernel launches."""
    cam, m, a, th, pix, _ = setup("ids", torch.float32)
    before = (B.birth_kernel.launches, B.birth_vjp_kernel.launches)
    with torch.set_grad_enabled(grad):
        rows = camera_rays_u(cam, m, a, pix_ids=pix, theta=th)
        want = camera_rays_u_plain(cam, m, a, pix_ids=pix, theta=th)
    assert torch.equal(rows, want)
    if grad:
        assert rows.grad_fn is not None
        assert "BirthFn" not in type(rows.grad_fn).__name__
        torch.autograd.grad(rows.sum(), [a, th])
    assert (B.birth_kernel.launches, B.birth_vjp_kernel.launches) == before


def test_refusals():
    """What the kernels do not take, said before any device is asked: the
    CPU last, after every other reason."""
    cam, m, a, th, pix, _ = setup("ids", torch.float32)

    def reason(camera=cam, mass=m, spin=a, ids=pix, theta=th,
               dtype=torch.float32):
        return B.refusal(camera, mass, spin, ids, theta, dtype)

    assert "runs on CUDA, not cpu" in reason()
    with pytest.raises(ValueError, match="CUDA"):
        B.birth_rows(cam, m, a, pix, None, th)
    assert "float32 or float64" in reason(dtype=torch.float16)
    assert "CUDA" in reason(mass=1.0)
    assert "theta: a 0-d tensor" in reason(theta=1.3)
    assert "spin" in reason(spin=a.to("meta"))
    assert "spin" in reason(spin=a.half())
    assert "camera.r" in reason(camera=Camera.create(
        r=torch.ones(1), width=W, height=H))
    assert "pix_ids" in reason(ids=pix.double())
    assert "pix_ids" in reason(ids=pix[None])
    assert "pixels" in reason(camera=Camera.create(width=0, height=H))
