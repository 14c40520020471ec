"""March configuration, termination codes, and the row-native march.

Counterpart of ``blackhole_simulation_tpu/render/march.py``: the same
``MarchConfig`` fields and defaults (:48-189; a test holds them equal), so a
JAX scene's config carries over field by field; ``refinement_config``
(:167-183); ``clip_cotangent``
(:192-214), ``MarchRows`` (:249), ``precull_threshold`` (:286),
``march_rows`` (:427) and the differentiable ``march_rows_ad`` (:381) with
its custom VJP ``_march_kernel_diff`` (:338-378), here a
``torch.autograd.Function``; ``MarchResult`` (:226), ``adaptive_dlam``
(:269) and ``march`` (:307), the (N, 8) theta-form packing wrapper over
``march_rows`` that the oracle comparisons read.

Both march entry points run the march kernel (``csrc/march.cu`` through
``ops/pallas_march.march_u``) for CUDA rays and its plain version for CPU
rays. ``march_rows`` also takes the jets (the kernel's jets instantiation,
with exact divides and the midpoint march, as the JAX package's jnp march
runs them) and applies ``start_jitter``. Both are differentiable: their
backward runs the gradient kernel (``csrc/march_grad.cu`` through
``ops/march_grad.march_grad_kernel``; with the jets its jets
instantiation) or its plain version likewise. ``march_rows`` under
autograd is the JAX package's jnp march under ``jax.grad``: the exact
midpoint march (``_kernel_cfg``), the start offset applied to the rows in
PyTorch before the kernel (autograd differentiates it, the hash's floors
included), and a refusal where the JAX package would run its Pallas
kernel, which has no VJP. ``march_rows_ad`` is the JAX package's twin: no
jets, no start offset. ``approx_recip`` applies in the kernels when
``use_pallas`` is set, as the JAX package applies it in its Pallas kernels
only.

The march runs in the rays' dtype, float32 or float64 (mass, spin and the
radii cast to it, no float32 rounding on the way): float64 rays take the
kernels' float64 instantiations on the card. Where the JAX package would
run its Pallas march on float64 rays (``use_pallas`` without jets, and
``march_rows_ad``), its trace fails with a TypeError ("while_loop body
function carry input and carry output must have equal types"); the port
raises TypeError there too.
"""

from __future__ import annotations

import dataclasses

import torch

HIT_NONE = 0
HIT_HORIZON = 1
HIT_ESCAPE = 2


@dataclasses.dataclass(frozen=True)
class MarchConfig:
    """Static march parameters. See the JAX twin for what each field does.

    ``approx_recip`` applies in the CUDA kernels and never in the plain
    versions, as the JAX package applies it on the TPU and never in
    interpret mode: the kernels' approximate reciprocal, their step's
    multiply-adds contracted into fused ones (one rounding each, as XLA
    contracts them on a GPU) and the jets' exp and pow in float; held to
    statistical bars against the plain versions. Without it the kernels
    are bit-equal to the plain versions. ``multistep`` (the AB3 march) applies with
    ``use_pallas`` only, as in the JAX package, whose jnp march ignores it.
    ``exit_check_every`` sets the AB3 march's renormalization cadence (a
    live ray is renormalized at the multiples of it that are multiples of
    ``renormalize_every``, and never when ``renormalize_every`` is not a
    multiple of it); the kernels exit per thread, so it has no other
    effect. ``remat_every`` has none: the differentiable march checkpoints
    every ``ops/march_grad.CKPT`` (8) steps in its gradient kernel.
    """

    max_steps: int = 256
    step_rate: float = 0.12
    min_step: float = 5e-3
    max_step: float = 4.0
    far_step_cap_rate: float = 0.0
    far_boost_radius: float = 30.0
    escape_radius: float = 120.0
    horizon_factor: float = 1.01
    renormalize_every: int = 16
    exit_check_every: int = 8
    remat_every: int = 32
    max_crossings: int = 4
    record_r_min: float = 1.0
    record_r_max: float = 30.0
    midpoint_iters: int = 2
    approx_recip: bool = False
    shadow_precull: bool = False
    precull_keep_disk: bool = True
    cotangent_clip: float = 0.0
    use_pallas: bool = False
    fused: bool = False
    multistep: bool = False
    start_jitter: float = 0.0
    refine_band: float = 0.0
    refine_budget: int = 16384
    refine_step_rate: float = 0.03
    refine_max_steps: int = 4096
    refine_max_step: float = 1.0
    refine_pole_w: float = 0.0


class _ClipCotangent(torch.autograd.Function):
    """Identity forward; the backward rescales each ray's cotangent over the
    6 stacked evolving rows to norm <= limit."""

    @staticmethod
    def forward(ctx, x, limit):
        ctx.limit = limit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return clip_rows(g, ctx.limit), None


def clip_rows(g: torch.Tensor, limit: float) -> torch.Tensor:
    """Scale each column of ``g`` (rows x N) to norm <= limit."""
    norm = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True))
    scale = torch.clamp(torch.full_like(norm, limit)
                        / torch.clamp(norm, min=1e-30), max=1.0)
    return g * scale


def clip_cotangent(x: torch.Tensor, limit: float) -> torch.Tensor:
    """``x``: (6, N) stacked evolving state rows; identity forward, per-ray
    cotangent-norm clip backward (see MarchConfig.cotangent_clip in the JAX
    package)."""
    return _ClipCotangent.apply(x, limit)


@dataclasses.dataclass
class MarchRows:
    """Row-native march result."""

    state_u: torch.Tensor      # (8, N) final u-chart rows
    hit: torch.Tensor          # (N,) int32
    steps: torch.Tensor        # (N,) int32
    cross_r: torch.Tensor      # (K, N)
    cross_phi: torch.Tensor    # (K, N)
    cross_t: torch.Tensor      # (K, N)
    n_crossings: torch.Tensor  # (N,) int32
    r_min_ph: torch.Tensor     # (N,)
    jet_radiance: torch.Tensor  # (3, N), zeros without jets


@dataclasses.dataclass
class MarchResult:
    """Packed march result, the layout the oracle (``geodesic/oracle.py``)
    shares with ``march``."""

    state: torch.Tensor         # (N, 8) final theta-form state
    hit: torch.Tensor           # (N,) int32 HIT_* code
    steps: torch.Tensor         # (N,) int32 steps taken while live
    cross_r: torch.Tensor       # (N, K) crossing radii (0 = empty)
    cross_phi: torch.Tensor     # (N, K)
    cross_t: torch.Tensor       # (N, K)
    n_crossings: torch.Tensor   # (N,) int32
    jet_radiance: torch.Tensor  # (N, 3)
    r_min_ph: torch.Tensor      # (N,) min |r - r_ph| along the march


def adaptive_dlam(r, r_h, r_ph, cfg: MarchConfig):
    """The curvature-adaptive affine step: (r - r_h) step_rate, boosted in
    the far field, clamped down near the photon sphere, clipped to
    [min_step, cap] (cap = max(max_step, far_step_cap_rate r) when that
    rate is on). In r's dtype; ``r_ph`` enters as one reciprocal, then a
    multiply, as in the kernels."""
    from blackhole_simulation_tpu_torch._elementwise import (
        clip,
        div_c,
        maximum,
    )

    inv_rph = 1.0 / maximum(r_ph, 1e-3)
    base = (r - r_h) * cfg.step_rate
    far = maximum(div_c(r, cfg.far_boost_radius), 1.0)
    prox = clip(torch.abs(r - r_ph) * inv_rph, 0.25, 1.0)
    if cfg.far_step_cap_rate > 0.0:
        cap = maximum(cfg.far_step_cap_rate * r, cfg.max_step)
    else:
        cap = cfg.max_step
    return clip(base * far * prox, cfg.min_step, cap)


def refinement_config(cfg: MarchConfig) -> MarchConfig:
    """The march configuration of the critical-band refinement pass: the
    validation-grade reference march (exact divides, the refine_* step
    rate, budget and cap, no precull, midpoint steps)."""
    return dataclasses.replace(
        cfg,
        step_rate=cfg.refine_step_rate,
        max_steps=cfg.refine_max_steps,
        max_step=cfg.refine_max_step,
        approx_recip=False,
        refine_band=0.0,
        fused=False,
        multistep=False,
        shadow_precull=False,
    )


def _kernel_cfg(cfg: MarchConfig, jets=None) -> MarchConfig:
    """The approximate reciprocal and the AB3 march belong to the kernel
    path (use_pallas without jets); otherwise the march is the midpoint one
    with exact divides, as the JAX package's jnp march is (it takes every
    march with jets, render/march.py:482)."""
    if (cfg.approx_recip or cfg.multistep) and (
            not cfg.use_pallas or jets is not None):
        return dataclasses.replace(cfg, approx_recip=False, multistep=False)
    return cfg


def precull_threshold(yt0: torch.Tensor, m, a, cfg: MarchConfig):
    """(N,) per-ray termination radius from the u-chart rows, in their
    dtype: the horizon radius, or for pre-culled rays the ISCO (disk kept)
    or 1e9 (instant death). ``m``, ``a``: 0-d tensors of the rows' dtype.
    Not differentiable."""
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        event_horizon_t,
        isco_t,
    )
    from blackhole_simulation_tpu_torch.render.precull import capture_mask_u

    with torch.no_grad():
        horizon_r = cfg.horizon_factor * event_horizon_t(m, a).to(yt0.dtype)
        n = yt0.shape[1]
        if not cfg.shadow_precull:
            return horizon_r.expand(n).clone()
        dead = capture_mask_u(m, a, yt0)
        if cfg.precull_keep_disk:
            stop_r = torch.maximum(
                torch.clamp(isco_t(m, a).to(yt0.dtype), min=cfg.record_r_min),
                horizon_r,
            )
        else:
            stop_r = torch.full((), 1e9, dtype=yt0.dtype, device=yt0.device)
        return torch.where(dead, stop_r, horizon_r)


def _refuse_pallas_f64(yt0, where: str) -> None:
    """TypeError for float64 rays on the JAX package's Pallas march route,
    whose trace fails there."""
    if yt0.dtype == torch.float64:
        raise TypeError(
            f"{where}: float64 rays on the Pallas march route, where the JAX "
            "package's pallas_march_u fails to trace (TypeError: while_loop "
            "body function carry input and carry output must have equal "
            "types); a float64 march takes use_pallas=False, or jets")


def _march_inputs(yt0, mass, spin, cfg, thr):
    """Radii, termination radii and the normalized, null-renormalized rows
    (their derivatives by autograd), in the rows' dtype: a number's mass
    or spin rounded once to it."""
    from blackhole_simulation_tpu_torch._elementwise import leaf
    from blackhole_simulation_tpu_torch.geometry.metrics import (
        event_horizon_t,
        photon_sphere_t,
    )
    from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_renormalize_u
    from blackhole_simulation_tpu_torch.ops.pallas_march import normalize_pt

    dtype = yt0.dtype
    m = leaf(mass, dtype, yt0.device)
    a = leaf(spin, dtype, yt0.device)
    r_h = event_horizon_t(m, a).to(dtype)
    r_ph = photon_sphere_t(m, a).to(dtype)
    if thr is None:
        thr = precull_threshold(yt0, m, a, cfg)
    yt0 = ks_renormalize_u(m, a, normalize_pt(yt0))
    return yt0, thr.detach(), m, a, r_h, r_ph


def march_rows(yt0: torch.Tensor, mass, spin, cfg: MarchConfig = MarchConfig(),
               thr: torch.Tensor | None = None, jets=None) -> MarchRows:
    """Row-native march: (8, N) u-chart rows in (renormalized here),
    MarchRows out. ``mass``, ``spin``: 0-d tensors or numbers; ``thr``
    overrides the per-ray termination radius; ``jets`` (a ``JetParams``)
    accumulates the jets' emission per step. With ``cfg.start_jitter`` > 0
    each ray first advances by its hashed start offset
    (``ops/march.py::start_offset_rows``, exact divides), after the null
    projection, as the JAX package's march_rows does (:469-480).

    Differentiable where autograd wants a derivative of the rows, mass or
    spin: the march kernel forward and the gradient kernel backward
    (``_MarchKernelDiff``, with the jets' emission when ``jets``), on the
    exact midpoint march, the start offset differentiated by autograd.
    ``thr`` is detached (it enters comparisons only). Raises
    NotImplementedError there for ``cfg.use_pallas`` without jets, where
    the JAX package marches on its Pallas kernel, which has no VJP
    (``jax.grad`` raises). Float64 rays with ``cfg.use_pallas`` and no jets
    raise TypeError, as the JAX package's Pallas march does."""
    from blackhole_simulation_tpu_torch._elementwise import grad_wanted
    from blackhole_simulation_tpu_torch.ops.march import start_offset_rows
    from blackhole_simulation_tpu_torch.ops.pallas_march import march_u

    if cfg.use_pallas and jets is None:
        _refuse_pallas_f64(yt0, "march_rows")
    differentiable = grad_wanted(yt0, mass, spin)
    if differentiable and cfg.use_pallas and jets is None:
        raise NotImplementedError(
            "march_rows: use_pallas marches on the Pallas kernel in the JAX "
            "package, which has no VJP (jax.grad raises 'Linearization "
            "failed'); a differentiable march takes use_pallas=False")
    yt0, thr, m, a, r_h, r_ph = _march_inputs(yt0, mass, spin, cfg, thr)
    if cfg.start_jitter > 0.0:
        ot, orr, ou, oph, opr, opu, _ = start_offset_rows(
            m, a, r_h, r_ph, cfg,
            tuple(yt0[i] for i in (0, 1, 2, 3, 5, 6, 7)))
        yt0 = torch.stack([ot, orr, ou, oph, yt0[4], opr, opu, yt0[7]])
    args = (yt0, thr, m, a, r_h, r_ph, _kernel_cfg(cfg, jets), jets)
    if differentiable:
        return MarchRows(*_MarchKernelDiff.apply(*args))
    return MarchRows(*march_u(*args))


class _MarchKernelDiff(torch.autograd.Function):
    """The march with its gradient kernel as the backward; differentiable in
    the rows and (m, a, r_h, r_ph), not in thr. With ``jets`` the march
    sums the jets' emission (the ninth output, differentiable too); without
    them the ninth output is zeros."""

    @staticmethod
    def forward(ctx, yt0, thr, m, a, r_h, r_ph, cfg, jets=None):
        from blackhole_simulation_tpu_torch.ops.pallas_march import march_u

        outs = march_u(yt0, thr, m, a, r_h, r_ph, cfg, jets)
        ctx.cfg, ctx.jets = cfg, jets
        ctx.save_for_backward(yt0, thr, m, a, r_h, r_ph, outs[7])
        ctx.mark_non_differentiable(outs[1], outs[2], outs[6])
        if jets is None:
            ctx.mark_non_differentiable(outs[8])
        return outs

    @staticmethod
    def backward(ctx, ct_yt, _ct_hit, _ct_steps, ct_cr, ct_cp, ct_ct,
                 _ct_nc, ct_rmin, ct_jet):
        from blackhole_simulation_tpu_torch.ops.march_grad import (
            march_grad_kernel,
        )

        yt0, thr, m, a, r_h, r_ph, rmin = ctx.saved_tensors
        k = ctx.cfg.max_crossings
        n = yt0.shape[1]
        z = lambda g, shape: (g if g is not None else
                              torch.zeros(shape, dtype=yt0.dtype,
                                          device=yt0.device))
        jets = ctx.jets
        ct_yt0, ct_m, ct_a, ct_rh, ct_rph = march_grad_kernel(
            yt0, thr, m, a, r_h, r_ph, ctx.cfg, z(ct_yt, (8, n)),
            z(ct_cr, (k, n)), z(ct_cp, (k, n)), z(ct_ct, (k, n)),
            z(ct_rmin, (n,)), rmin,
            None if jets is None else z(ct_jet, (3, n)), jets,
        )
        return (ct_yt0, None, ct_m.to(m.dtype), ct_a.to(a.dtype),
                ct_rh.to(r_h.dtype), ct_rph.to(r_ph.dtype), None, None)


def march_rows_ad(yt0: torch.Tensor, mass, spin,
                  cfg: MarchConfig = MarchConfig(),
                  thr: torch.Tensor | None = None) -> MarchRows:
    """march_rows with a gradient: the march kernel forward, the gradient
    kernel backward (checkpoint and replay). Gradients flow to the rows and,
    through the radii, to mass and spin; the termination radii are
    detached, as the JAX package's stop_gradient does. Like the JAX
    package's, it has no jets and ignores ``start_jitter``; its
    ``jet_radiance`` is zeros.

    The AB3 march (``multistep`` with ``use_pallas``) is refused: the
    gradient kernel replays the midpoint march, so its gradient would be of
    another march than the forward's. Float64 rays raise TypeError: the
    JAX twin marches them on its Pallas kernel, which fails to trace
    there."""
    _refuse_pallas_f64(yt0, "march_rows_ad")
    cfg = _kernel_cfg(cfg)
    if cfg.multistep:
        raise NotImplementedError(
            "march_rows_ad: the AB3 march (multistep) has no gradient path")
    yt0, thr, m, a, r_h, r_ph = _march_inputs(yt0, mass, spin, cfg, thr)
    outs = _MarchKernelDiff.apply(yt0, thr, m, a, r_h, r_ph, cfg)
    return MarchRows(*outs)


def march(y0: torch.Tensor, mass, spin, cfg: MarchConfig = MarchConfig(),
          jets=None) -> MarchResult:
    """``march_rows`` on (N, 8) theta-form states (t, r, theta, phi, p_t,
    p_r, p_theta, p_phi), packed back into a MarchResult whose state is in
    theta form. Runs the march kernel for CUDA rays."""
    from blackhole_simulation_tpu_torch.ops.ks_kernel import (
        theta_state_to_u,
        u_state_to_theta,
    )

    rows = march_rows(theta_state_to_u(y0.T), mass, spin, cfg, jets=jets)
    return MarchResult(
        state=u_state_to_theta(rows.state_u).T,
        hit=rows.hit,
        steps=rows.steps,
        cross_r=rows.cross_r.T,
        cross_phi=rows.cross_phi.T,
        cross_t=rows.cross_t.T,
        n_crossings=rows.n_crossings,
        jet_radiance=rows.jet_radiance.T,
        r_min_ph=rows.r_min_ph,
    )
