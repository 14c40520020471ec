"""The cases of ray birth that the CPU tests (tests/test_torch_birth_vjp.py)
and the card tests (tests/test_torch_birth_kernel.py) share: a small frame,
the camera's fields as numbers or tensors, pixel ids or the whole frame,
jitter, spins, theta near the poles and on the tetrad's sin^2 clamp, and
the plain twin's gradients chained to the fov and roll. Imports neither
JAX nor the JAX package."""

import math

import numpy as np
import torch

from blackhole_simulation_tpu_torch.ops import birth as B
from blackhole_simulation_tpu_torch.render.camera import Camera

W, H = 12, 7
FIELDS = dict(r=30.0, theta=1.3, phi=0.3, fov=0.5, roll=0.2)


def tie_theta() -> float:
    """A float32 theta whose sin^2, rounded to float32, is the clamp's
    1e-12 itself."""
    lo = np.float32(1e-12)
    s = np.float32(math.sqrt(1e-12))
    for _ in range(64):
        if np.float32(s * s) == lo and np.float32(math.sin(float(s))) == s:
            return float(s)
        s = np.nextafter(s, np.float32(1.0))
    raise AssertionError("no float32 theta ties the clamp")


# name -> (ids, jitter, tensor fields, theta override, spin, theta,
#          mass with a gradient)
CASES = {
    "ids": (True, None, False, True, 0.9, 1.3, False),
    "ids_jitter": (True, (0.25, -0.125), False, True, 0.9, 1.3, False),
    "frame": (False, None, False, True, 0.9, 1.3, False),
    "frame_jitter": (False, (0.25, -0.125), False, True, 0.9, 1.3, False),
    "tensor_fields": (True, None, True, False, 0.9, 1.3, False),
    "tensor_fields_frame": (False, (0.4, 0.1), True, False, 0.9, 1.3, False),
    "override_and_fields": (True, None, True, True, 0.9, 1.3, True),
    "negative_spin": (True, None, False, True, -0.7, 1.3, True),
    "zero_spin": (False, None, True, False, 0.0, 1.3, True),
    "near_pole": (True, None, False, True, 0.9, 2e-3, True),
    "south_pole": (False, None, True, False, 0.5, math.pi - 3e-3, False),
    "on_pole": (True, None, False, True, 0.9, 0.0, True),
    "sin_clamp_tie": (True, None, False, True, 0.9, "tie", False),
}
DTYPES = [torch.float32, torch.float64]


def setup(name, dtype, device="cpu"):
    """The camera, mass, spin, theta override and ids of a case on
    ``device``; every tensor a leaf that requires grad (mass where the case
    says)."""
    ids, jitter, tensor_fields, override, spin, theta, mass_grad = CASES[name]
    if theta == "tie":
        theta = tie_theta()
    leaf = lambda v: torch.tensor(v, dtype=dtype, device=device,
                                  requires_grad=True)
    fields = {**FIELDS, "theta": theta}
    if tensor_fields:
        fields = {k: leaf(v) for k, v in fields.items()}
    cam = Camera.create(width=W, height=H, **fields)
    m = leaf(1.0) if mass_grad else torch.tensor(1.0, dtype=dtype,
                                                 device=device)
    a = leaf(spin)
    th = leaf(theta) if override else None
    pix = None
    if ids:
        pix = torch.tensor(np.random.default_rng(0).integers(0, W * H, 40),
                           device=device)
    return cam, m, a, th, pix, jitter


def chain_fov_roll(got, cam):
    """The fov's and roll's gradients from those of tan(fov / 2),
    cos(roll) and sin(roll), through torch in float64."""
    fov, roll = (torch.tensor(float(x.detach()), dtype=torch.float64,
                              requires_grad=True) for x in (cam.fov, cam.roll))
    outs = (torch.tan(fov / 2.0), torch.cos(roll), torch.sin(roll))
    return torch.autograd.grad(outs, (fov, roll), tuple(
        got[k].double().cpu() for k in ("half", "roll_c", "roll_s")))


def leaves_of(cam, m, a, th):
    named = {"m": m, "a": a, "theta": cam.theta if th is None else th,
             "r": cam.r, "phi": cam.phi, "fov": cam.fov, "roll": cam.roll}
    return {k: v for k, v in named.items()
            if torch.is_tensor(v) and v.requires_grad}


def twin_grads(cam, m, a, th, pix, jitter, dtype, g):
    plan, inputs = B.plan_of(cam, m, a, pix, jitter, th, dtype)
    got = B.birth_vjp_plain(plan, inputs, g)
    if torch.is_tensor(cam.fov):
        got["fov"], got["roll"] = chain_fov_roll(got, cam)
    return got


def rel(got, want):
    d = abs(float(got) - float(want))
    return d / abs(float(want)) if float(want) != 0.0 else d
