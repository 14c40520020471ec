"""Geodesic step math: the port against the JAX package, float32.

4096 seeded rays (numpy), including rays at the pole (|u| -> 1, where the
w = 1 - u^2 floor of 1e-6 acts), go through ks_rhs_rows,
ks_symplectic_step_rows, ks_renormalize_pr and diff_step_values on both
sides. The JAX functions run op by op, as the port's plain version does, so
the two round alike; the tolerance is rtol 1e-5 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blackhole_simulation_tpu.ops import ks_kernel as jks
from blackhole_simulation_tpu.ops.pallas_march import (
    diff_step_values as j_diff_step_values,
)
from blackhole_simulation_tpu.render.march import MarchConfig as JMarchConfig
from blackhole_simulation_tpu_torch.ops import ks_kernel as tks
from blackhole_simulation_tpu_torch.ops.march import (
    diff_step_values as t_diff_step_values,
)
from blackhole_simulation_tpu_torch.render.march import MarchConfig

torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-6
SPINS = [0.0, 0.9, 0.999]
CFG = dict(max_steps=256, step_rate=0.2, far_step_cap_rate=0.4,
           far_boost_radius=20.0, midpoint_iters=1)


def _rays(seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(1.6, 60.0, N)
    u = rng.uniform(-0.999, 0.999, N)
    # a quarter of the rays at or next to the pole
    pole = 1.0 - 10.0 ** rng.uniform(-8, -2, N // 4)
    u[: N // 4] = pole * rng.choice([-1.0, 1.0], N // 4)
    rows = dict(
        t=rng.uniform(0.0, 50.0, N), r=r, u=u, ph=rng.uniform(-3, 3, N),
        pr=rng.normal(0.0, 1.0, N), pu=rng.normal(0.0, 2.0, N),
        pph=rng.normal(0.0, 3.0, N), dlam=rng.uniform(0.005, 2.0, N),
    )
    return {k: v.astype(np.float32) for k, v in rows.items()}


def _j(x):
    return jnp.asarray(x, dtype=jnp.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(tv, jv):
    np.testing.assert_allclose(
        tv.numpy(), np.asarray(jv, np.float32), rtol=RTOL, atol=ATOL
    )


def test_w_floor_matches():
    assert tks.w_floor(torch.float32) == jks.w_floor(jnp.float32) == 1e-6
    assert tks.w_floor(torch.float64) == jks.w_floor(jnp.float64) == 1e-12


@pytest.mark.parametrize("spin", SPINS)
def test_ks_rhs_rows(spin):
    x = _rays(1)
    with jax.disable_jit():
        jo = jks.ks_rhs_rows(_j(1.0), _j(spin), _j(x["r"]), _j(x["u"]),
                             _j(-1.0), _j(x["pr"]), _j(x["pu"]), _j(x["pph"]))
    to = tks.ks_rhs_rows(_t(1.0), _t(spin), _t(x["r"]), _t(x["u"]),
                         _t(-1.0), _t(x["pr"]), _t(x["pu"]), _t(x["pph"]))
    for a, b in zip(to, jo):
        _close(a, b)


@pytest.mark.parametrize("spin", SPINS)
def test_ks_symplectic_step_rows(spin):
    x = _rays(2)
    keys = ("t", "r", "u", "ph")
    with jax.disable_jit():
        jo = jks.ks_symplectic_step_rows(
            _j(1.0), _j(spin),
            tuple(_j(x[k]) for k in keys) + (_j(-1.0), _j(x["pr"]),
                                             _j(x["pu"]), _j(x["pph"])),
            _j(x["dlam"]), 1,
        )
    to = tks.ks_symplectic_step_rows(
        _t(1.0), _t(spin),
        tuple(_t(x[k]) for k in keys) + (_t(-1.0), _t(x["pr"]), _t(x["pu"]),
                                         _t(x["pph"])),
        _t(x["dlam"]), 1,
    )
    for a, b in zip(to, jo):
        _close(a, b)


@pytest.mark.parametrize("spin", SPINS)
def test_ks_renormalize_pr(spin):
    x = _rays(3)
    with jax.disable_jit():
        jo = jks.ks_renormalize_pr(_j(1.0), _j(spin), _j(x["r"]), _j(x["u"]),
                                   _j(-1.0), _j(x["pr"]), _j(x["pu"]),
                                   _j(x["pph"]))
    to = tks.ks_renormalize_pr(_t(1.0), _t(spin), _t(x["r"]), _t(x["u"]),
                               _t(-1.0), _t(x["pr"]), _t(x["pu"]),
                               _t(x["pph"]))
    _close(to, jo)


@pytest.mark.parametrize("spin", SPINS)
def test_diff_step_values(spin):
    x = _rays(4)
    r_h = np.float32(1.0 + np.sqrt(max(1.0 - spin * spin, 0.0)))
    r_ph = np.float32(2.0 * (1.0 + np.cos(2.0 / 3.0 * np.arccos(-spin))))
    keys = ("t", "r", "u", "ph", "pr", "pu", "pph")
    with jax.disable_jit():
        jo = j_diff_step_values(_j(1.0), _j(spin), _j(r_h), _j(r_ph),
                                JMarchConfig(**CFG), False,
                                tuple(_j(x[k]) for k in keys))
    to = t_diff_step_values(_t(1.0), _t(spin), _t(r_h), _t(r_ph),
                            MarchConfig(**CFG), tuple(_t(x[k]) for k in keys))
    assert len(to) == len(jo) == 10
    for a, b in zip(to, jo):
        _close(a, b)
    # the step never leaves the chart
    assert float(to[2].abs().max()) <= 1.0 - 1e-7
