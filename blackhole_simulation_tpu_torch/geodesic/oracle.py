"""Oracle march: the float64 adaptive-RKF45 integrator driving a MarchResult.

Counterpart of ``blackhole_simulation_tpu/geodesic/oracle.py``: camera rays
integrate with the per-ray adaptive Fehlberg stepper
(``geodesic/integrator.py``) in float64, record equatorial-plane crossings
and the photon-ring proximity minimum as the fast march does, and return a
MarchResult, so the same shading produces the oracle image. It is plain
PyTorch and runs on the device its inputs are on.

The JAX twin's ``lax.while_loop`` tests ``any(hit == HIT_NONE)`` on every
trial. Here trials run in blocks of ``exit_every`` (on a GPU each test
waits for the device), never past ``max_trials = 2 * max_steps``. A ray
that has finished never changes, and the step size and the trial count are
not returned, so the extra trials of the last block change no output.
On a GPU a block is one captured CUDA graph
(``geodesic/integrate.py::graphed_blocks``): the trial is a
few hundred small elementwise launches, which the host would otherwise
issue one by one.
"""

from __future__ import annotations

import torch

from blackhole_simulation_tpu_torch.geodesic.integrate import graphed_blocks
from blackhole_simulation_tpu_torch.geodesic.integrator import (
    IntegrationOptions,
    rkf45_step,
    step_controller,
)
from blackhole_simulation_tpu_torch.geodesic.invariants import (
    renormalize_null,
)
from blackhole_simulation_tpu_torch.geometry.metrics import KS, KerrMetric
from blackhole_simulation_tpu_torch.render.march import (
    HIT_ESCAPE,
    HIT_HORIZON,
    HIT_NONE,
    MarchConfig,
    MarchResult,
)


def oracle_options(cfg: MarchConfig) -> IntegrationOptions:
    """The oracle's stepper: tolerance 1e-10, 20,000 steps, and the march's
    escape radius and horizon factor."""
    return IntegrationOptions(tolerance=1e-10, max_steps=20_000,
                              escape_radius=cfg.escape_radius,
                              horizon_factor=cfg.horizon_factor)


def _trial(bh, opts, cfg, horizon_r, r_ph, slot_ids, carry):
    """One attempted step of every ray: the carry after it."""
    y, h, hit, steps, cr, cp, ct, nc, rmin = carry
    live = hit == HIT_NONE
    y_trial, err = rkf45_step(bh, y, h)
    accept, h = step_controller(h, err, opts.tolerance, safety=opts.safety,
                                min_step=opts.min_step,
                                max_step=opts.max_step)
    advance = live & accept

    # The crossing record interpolates in u = cos(theta), as the march does.
    u_old = torch.cos(y[:, 2])
    u_new = torch.cos(y_trial[:, 2])
    du = u_old - u_new
    frac = torch.clamp(
        u_old / torch.where(torch.abs(du) < 1e-30, 1e-30, du), 0.0, 1.0)
    r_c = y[:, 1] + frac * (y_trial[:, 1] - y[:, 1])
    phi_c = y[:, 3] + frac * (y_trial[:, 3] - y[:, 3])
    t_c = y[:, 0] + frac * (y_trial[:, 0] - y[:, 0])
    crossed = (advance & ((u_old * u_new) < 0.0) & (r_c > cfg.record_r_min)
               & (r_c < cfg.record_r_max) & (nc < cfg.max_crossings))
    mask_k = crossed[None, :] & (nc[None, :] == slot_ids[:, None])
    cr = torch.where(mask_k, torch.where(crossed, r_c, 0.0)[None, :], cr)
    cp = torch.where(mask_k, torch.where(crossed, phi_c, 0.0)[None, :], cp)
    ct = torch.where(mask_k, torch.where(crossed, t_c, 0.0)[None, :], ct)
    nc = nc + crossed.to(torch.int32)

    y = torch.where(advance[:, None], y_trial, y)
    steps = steps + advance.to(torch.int32)
    rmin = torch.where(advance,
                       torch.minimum(rmin, torch.abs(y[:, 1] - r_ph)), rmin)
    renorm_due = advance & (steps % opts.renormalize_interval == 0)
    y = torch.where(renorm_due[:, None], renormalize_null(y, bh), y)
    hit = torch.where(live & (y[:, 1] < horizon_r), HIT_HORIZON, hit)
    hit = torch.where(live & (y[:, 1] > opts.escape_radius), HIT_ESCAPE, hit)
    return y, h, hit.to(torch.int32), steps, cr, cp, ct, nc, rmin


def oracle_march(y0, mass, spin, cfg: MarchConfig = MarchConfig(),
                 opts: IntegrationOptions | None = None,
                 exit_every: int = 32) -> MarchResult:
    """March (N, 8) theta-form Kerr-Schild rays with the float64 RKF45
    oracle, on y0's device. ``cfg`` gives the termination geometry (horizon
    factor, escape radius, crossing window and slot count), so the oracle
    and the fast march differ only by integration error; ``opts`` tunes the
    stepper (``oracle_options(cfg)`` by default). A ray still live when the
    budget runs out is classed as horizon, as the fast march classes its
    max-step rays."""
    opts = opts or oracle_options(cfg)
    y0 = torch.as_tensor(y0).to(torch.float64)
    dev = y0.device
    bh = KerrMetric.create(mass, spin, chart=KS, device=dev)
    y0 = renormalize_null(y0, bh)
    n = y0.shape[0]
    k = cfg.max_crossings
    r_h = bh.event_horizon()
    r_ph = bh.photon_sphere()
    horizon_r = cfg.horizon_factor * r_h
    slot_ids = torch.arange(k, device=dev)
    zeros_k = torch.zeros((k, n), dtype=torch.float64, device=dev)
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    carry = (
        y0,
        torch.full((n,), opts.initial_step, dtype=torch.float64, device=dev),
        torch.where(y0[:, 1] < horizon_r, HIT_HORIZON, HIT_NONE).to(
            torch.int32),
        zeros_i, zeros_k, zeros_k, zeros_k, zeros_i,
        torch.abs(y0[:, 1] - r_ph),
    )
    max_trials = opts.max_steps * 2

    def trials(c, n):
        for _ in range(n):
            c = _trial(bh, opts, cfg, horizon_r, r_ph, slot_ids, c)
        return c

    done = 0
    if dev.type == "cuda":
        carry, done = graphed_blocks(trials, carry, exit_every, max_trials,
                                     lambda c: c[2] == HIT_NONE)
    while done < max_trials and bool((carry[2] == HIT_NONE).any()):
        block = min(exit_every, max_trials - done)
        carry = trials(carry, block)
        done += block
    y, _, hit, steps, cr, cp, ct, nc, rmin = carry
    hit = torch.where(hit == HIT_NONE, HIT_HORIZON, hit).to(torch.int32)
    return MarchResult(
        state=y, hit=hit, steps=steps, cross_r=cr.T, cross_phi=cp.T,
        cross_t=ct.T, n_crossings=nc,
        jet_radiance=torch.zeros((n, 3), dtype=torch.float64, device=dev),
        r_min_ph=rmin,
    )
