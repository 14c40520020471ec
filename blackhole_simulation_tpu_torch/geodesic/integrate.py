"""Batched adaptive integration to termination.

Counterpart of ``blackhole_simulation_tpu/geodesic/integrate.py``: all rays
integrate together, each with its own step size, step count, termination
code and max |H| drift; finished rays freeze. Every trip of the loop is one
attempted step, accepted per ray by the step controller, within a budget of
``max_trials`` attempts. The JAX twin tests ``any(live)`` on every trip of
its ``lax.while_loop``; here the loop runs in blocks of ``exit_every`` trips
and tests between blocks (on a GPU each test waits for the device, and each
block is one captured CUDA graph, ``graphed_blocks``, which the oracle
march shares). A finished ray never changes, so the trips a block adds
after the last ray ends leave every output as the per-trip test would.

Termination codes: 0 NONE / 1 HORIZON / 2 ESCAPE / 3 MAX_STEPS /
4 DISK_CROSSING.
"""

from __future__ import annotations

import dataclasses

import torch

from blackhole_simulation_tpu_torch.geodesic.integrator import (
    IntegrationMethod,
    IntegrationOptions,
    rk4_step,
    rkf45_step,
    step_controller,
    symplectic_step,
)
from blackhole_simulation_tpu_torch.geodesic.invariants import (
    hamiltonian,
    renormalize_null,
)

TERM_NONE = 0
TERM_HORIZON = 1
TERM_ESCAPE = 2
TERM_MAX_STEPS = 3
TERM_DISK = 4

TERMINATION_NAMES = ("none", "horizon", "escape", "max_steps", "disk_crossing")


@dataclasses.dataclass(frozen=True)
class Trajectory:
    """Result bundle, batched over leading ray axes."""

    final_state: torch.Tensor            # (..., 8)
    termination: torch.Tensor            # (...) int32 TERM_* code
    steps_taken: torch.Tensor            # (...) int32 accepted steps
    max_hamiltonian_drift: torch.Tensor  # (...)
    path: torch.Tensor | None = None     # (n_steps + 1, ..., 8) when recorded


def _classify_termination(y, term, steps, horizon, opts: IntegrationOptions):
    r = y[..., 1]
    live = term == TERM_NONE
    term = torch.where(live & (r < horizon), TERM_HORIZON, term)
    term = torch.where(live & (r > opts.escape_radius), TERM_ESCAPE, term)
    term = torch.where((term == TERM_NONE) & (steps >= opts.max_steps),
                       TERM_MAX_STEPS, term)
    return term.to(torch.int32)


def _horizon(metric, opts, like):
    return (opts.horizon_factor
            * torch.as_tensor(metric.event_horizon()).to(like))


def graphed_blocks(trials, carry, k, max_trials, live):
    """Run whole blocks of k trials as one captured CUDA graph, replayed
    while ``live(carry)`` holds for some ray and a whole block fits the
    budget; returns the carry and the trials run (the caller runs any
    remainder eagerly). The shapes are fixed, so one capture serves every
    block; the graph runs the same kernels on the same inputs as the eager
    loop."""
    static = tuple(t.clone() for t in carry)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trials(tuple(t.clone() for t in static), k)   # warm-up, discarded
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = trials(static, k)
        for dst, src in zip(static, out):
            dst.copy_(src)
    done = 0
    while done + k <= max_trials and bool(live(static).any()):
        graph.replay()
        done += k
    return static, done


def integrate(y0, metric, opts: IntegrationOptions = IntegrationOptions(),
              exit_every: int = 32) -> Trajectory:
    """Integrate a batch of null rays to termination. y0: (..., 8), in the
    metric's dtype (float64 for the oracle). On a GPU each block of
    ``exit_every`` trials is one captured CUDA graph (``graphed_blocks``):
    a trial is about a thousand small launches, which the host would
    otherwise issue one by one."""
    y0 = renormalize_null(torch.as_tensor(y0), metric)
    batch_shape = y0.shape[:-1]
    dev = y0.device
    h = torch.full(batch_shape, opts.initial_step, dtype=y0.dtype, device=dev)
    term = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    steps = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    drift = torch.zeros(batch_shape, dtype=y0.dtype, device=dev)
    horizon = _horizon(metric, opts, y0)
    term = _classify_termination(y0, term, steps, horizon, opts)

    adaptive = opts.method is IntegrationMethod.RKF45
    max_trials = opts.max_steps * (2 if adaptive else 1)
    step = rk4_step if opts.method is IntegrationMethod.RK4 else symplectic_step

    def trials(carry, n):
        y, h, term, steps, drift = carry
        for _ in range(n):
            live = term == TERM_NONE
            if adaptive:
                y_trial, err = rkf45_step(metric, y, h)
                accept, h = step_controller(
                    h, err, opts.tolerance, safety=opts.safety,
                    min_step=opts.min_step, max_step=opts.max_step)
            else:
                y_trial = step(metric, y, h)
                accept = torch.ones_like(live)
            advance = live & accept
            y = torch.where(advance[..., None], y_trial, y)
            steps = steps + advance.to(torch.int32)
            renorm_due = advance & (steps % opts.renormalize_interval == 0)
            y = torch.where(renorm_due[..., None], renormalize_null(y, metric),
                            y)
            h_now = torch.abs(hamiltonian(y, metric))
            drift = torch.where(advance, torch.maximum(drift, h_now), drift)
            term = _classify_termination(y, term, steps, horizon, opts)
        return y, h, term, steps, drift

    carry = (y0, h, term, steps, drift)
    live = lambda c: c[2] == TERM_NONE
    done = 0
    if dev.type == "cuda":
        carry, done = graphed_blocks(trials, carry, exit_every, max_trials,
                                     live)
    while done < max_trials and bool(live(carry).any()):
        block = min(exit_every, max_trials - done)
        carry = trials(carry, block)
        done += block
    y, _, term, steps, drift = carry
    term = torch.where(term == TERM_NONE, TERM_MAX_STEPS, term)
    integrate.trials = done
    return Trajectory(final_state=y, termination=term.to(torch.int32),
                      steps_taken=steps, max_hamiltonian_drift=drift)


# The attempted steps (loop trips) of the last call, blocks included.
integrate.trials = 0


def integrate_path(y0, metric, n_steps: int = 1000, step_size: float = 1e-2,
                   method: IntegrationMethod = IntegrationMethod.RK4,
                   opts: IntegrationOptions = IntegrationOptions()
                   ) -> Trajectory:
    """Fixed-step integration recording the path: ``n_steps`` steps of
    ``method``; rays freeze once terminated; ``path`` is
    (n_steps + 1, ..., 8)."""
    y0 = renormalize_null(torch.as_tensor(y0), metric)
    batch_shape = y0.shape[:-1]
    dev = y0.device
    h = torch.full(batch_shape, step_size, dtype=y0.dtype, device=dev)
    term = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    steps = torch.zeros(batch_shape, dtype=torch.int32, device=dev)
    drift = torch.zeros(batch_shape, dtype=y0.dtype, device=dev)
    step = rk4_step if method is IntegrationMethod.RK4 else symplectic_step
    run_opts = dataclasses.replace(opts, max_steps=n_steps)
    horizon = _horizon(metric, opts, y0)
    y = y0
    path = [y0]
    for _ in range(n_steps):
        live = term == TERM_NONE
        y = torch.where(live[..., None], step(metric, y, h), y)
        steps = steps + live.to(torch.int32)
        renorm_due = live & (steps % opts.renormalize_interval == 0)
        y = torch.where(renorm_due[..., None], renormalize_null(y, metric), y)
        drift = torch.where(
            live, torch.maximum(drift, torch.abs(hamiltonian(y, metric))),
            drift)
        term = _classify_termination(y, term, steps, horizon, run_opts)
        path.append(y)
    term = torch.where(term == TERM_NONE, TERM_MAX_STEPS, term)
    return Trajectory(final_state=y, termination=term.to(torch.int32),
                      steps_taken=steps, max_hamiltonian_drift=drift,
                      path=torch.stack(path))
