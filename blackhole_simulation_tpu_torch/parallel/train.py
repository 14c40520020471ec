"""Inverse rendering, on one device or sharded over the mesh: recover spin,
camera inclination and disk parameters from a target image by pixel
gradients through the march.

Counterpart of ``blackhole_simulation_tpu/parallel/train.py``:
``InverseParams`` (:33), ``_forward`` (:52), ``init_opt_state`` (:86),
``make_inverse_step`` (:92-237), the central-difference path (:236-385:
``_FD_FIELDS``, ``_FD_H``, ``_params_to_vec``, ``_vec_to_params``,
``fd_state_init``, ``fd_state_params``, ``make_fd_inverse_step``,
``fd_inverse_render``), ``make_ad_inverse_step`` (:388-470),
``_adam_update`` (:473), ``ad_inverse_render`` (:500) and
``inverse_render`` (:527, methods ``"ad"``, ``"fd"`` and ``"ad-step"``).

The forward renders the parameterized scene through ``march_rows_ad`` with
``use_pallas`` and ``march_rows`` without, as the JAX twin's takes its
Pallas kernels or its jnp march: in both the march kernel
(``csrc/march.cu``) forward and the gradient kernel
(``csrc/march_grad.cu``) backward, with camera ray birth (on the card
``csrc/birth.cu``'s kernel and its VJP), the null renormalization and the
shading (on the card ``csrc/composite.cu``'s) differentiated around them;
a spectral disk's tables are built in the graph from the spin being
optimized (``render/shading.py::build_disk_luts_t``), as the JAX twin
builds them in its.
The central-difference step evaluates the loss at the centre and at +-h
on each of the four parameters: nine forward passes under ``no_grad``,
each one launch of the march kernel (the JAX twin vmaps the nine into one
program; each variant here has its own spin, and the kernel takes its
scalars per launch). The steps run on ``cuda`` unless the caller passes
``device="cpu"`` (the kernels' plain versions); with no CUDA device and no
explicit CPU request they raise.

With a mesh (``parallel/mesh.py``; every rank builds the same step and
calls it with the same state and target) each rank takes its contiguous
slice of the row-major pixel ids and of the target (the AD curriculum's, a
slab of whole rows), computes its loss sum, or the FD step's (9,) loss
vector, with its gradient, and all-reduces what the JAX twin psums; Adam
then runs the same on every rank, on ``mesh.device``. The mesh path uses
row-major pixels even with ``use_pallas``, and divides by the frame's
pixel count, as the JAX twin's does.

Every entry takes ``dtype`` (``torch.float32`` by default, or
``torch.float64``), as the JAX twin's: the forward renders in it (rays,
march, shading; with float64 on the march and gradient kernels' float64
instantiations), the parameters of ``InverseParams.init`` and the AD
steps' Adam moments are of it, and on a mesh the losses and gradients are
all-reduced in it. The central-difference state stays the JAX twin's
float32 vector, which its float64 gradient promotes after the first step,
as the JAX twin's does. With ``use_pallas`` the float64 forward raises
TypeError, as the JAX twin's Pallas march (``march_rows_ad``) fails to
trace on float64 rays.

Under a profiler session each call of an AD step (``make_inverse_step``,
``make_ad_inverse_step``) is recorded as the span ``inverse_step`` with
``inverse_forward``, ``inverse_backward`` and ``adam`` inside it, and its
host waits as ``stream_syncs`` (``perf/spans.py``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from blackhole_simulation_tpu_torch._elementwise import const, div_c, host
from blackhole_simulation_tpu_torch.perf import spans

_AD_STAGES = ((64, 8), (96, 4), (128, 2))  # (march steps, pool k) per stage
_FIELDS = ("spin", "theta_cam", "log_density", "log_t_peak")


@dataclasses.dataclass(frozen=True)
class InverseParams:
    """The recoverable scene parameters: four 0-dim tensors (float32, or
    float64 for a float64 inverse)."""

    spin: torch.Tensor
    theta_cam: torch.Tensor
    log_density: torch.Tensor
    log_t_peak: torch.Tensor

    @classmethod
    def init(cls, spin=0.5, theta_cam=1.3, density=0.7, t_peak=9000.0,
             device="cpu", dtype=torch.float32):
        f = lambda v: torch.tensor(v, dtype=dtype, device=device)
        return cls(spin=f(spin), theta_cam=f(theta_cam),
                   log_density=torch.log(f(density)),
                   log_t_peak=torch.log(f(t_peak)))

    def leaves(self):
        return [getattr(self, k) for k in _FIELDS]

    @classmethod
    def from_leaves(cls, leaves):
        return cls(**dict(zip(_FIELDS, leaves)))

    def to(self, device):
        return InverseParams.from_leaves([v.to(device) for v in self.leaves()])


def inverse_params_from_numpy(spin, theta_cam, log_density, log_t_peak,
                              device="cpu",
                              dtype=torch.float32) -> InverseParams:
    """InverseParams from plain numbers (a JAX InverseParams' leaves), so
    both packages can step from the same state, as ``dtype`` tensors."""
    return InverseParams.from_leaves([
        torch.tensor(float(v), dtype=dtype, device=device)
        for v in (spin, theta_cam, log_density, log_t_peak)
    ])


def init_opt_state(params: InverseParams):
    """Adam moments (m, v, step count) for the inverse optimizer."""
    zeros = InverseParams.from_leaves(
        [torch.zeros_like(v) for v in params.leaves()])
    return (zeros, zeros, torch.zeros((), dtype=torch.int32,
                                      device=params.spin.device))


def _forward(params: InverseParams, scene, pix_ids, dtype=torch.float32):
    """Radiance (len(pix_ids), 3) of the parameterized scene in ``dtype``:
    rays for the given row-major pixel ids, the differentiable march
    (``march_rows_ad`` with ``use_pallas``, ``march_rows`` without, the
    start offset included), the composite with the density and
    peak-temperature scales."""
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import (
        march_rows,
        march_rows_ad,
    )
    from blackhole_simulation_tpu_torch.render.pipeline import (
        conserved_lam,
        shade_march_rows,
    )

    dev = params.spin.device
    m = torch.tensor(host(scene.bh.mass), dtype=dtype, device=dev)
    if spans.on and m.is_cuda:
        spans.count("stream_syncs")          # the mass's blocking upload
    a = params.spin.to(dtype)
    # Density and peak temperature enter as multiplicative scales on the
    # static DiskParams.
    dens_scale = div_c(torch.exp(params.log_density).to(dtype),
                       scene.disk.density)
    int_scale = torch.exp(params.log_t_peak
                          - math.log(scene.disk.t_peak)).to(dtype)
    rays = camera_rays_u(scene.camera, m, a, pix_ids=pix_ids,
                         theta=params.theta_cam, dtype=dtype)
    cfg = scene.march_cfg
    rows = (march_rows_ad if cfg.use_pallas else march_rows)(rays, m, a, cfg)
    rgb = shade_march_rows(rows, m, a, scene, conserved_lam(rays),
                           density_scale=dens_scale,
                           intensity_scale=int_scale)
    return torch.stack(rgb, dim=-1)


@spans.span("adam")
def _adam_update(params: InverseParams, opt_state, grads, n_norm, lr,
                 total_steps, b1=0.9, b2=0.999, eps=1e-8):
    """Adam with a global-norm clip of 10 and the spin clamp to
    [-0.998, 0.998], as the JAX twin (its formula, not torch.optim's)."""
    g = [v / n_norm for v in grads]
    gnorm = torch.sqrt(sum(torch.sum(v * v) for v in g))
    scale = torch.clamp(const(gnorm, 10.0) / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    g = [v * scale for v in g]
    m, v, t = opt_state
    t = t + 1
    tf = t.to(torch.float32)
    if total_steps is not None:
        frac = torch.clamp(tf / total_steps, max=1.0)
        lr_t = lr * (0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac)))
    else:
        lr_t = lr
    m = [b1 * mm + (1 - b1) * gg for mm, gg in zip(m.leaves(), g)]
    v = [b2 * vv + (1 - b2) * gg * gg for vv, gg in zip(v.leaves(), g)]
    mhat = [mm / (1 - torch.pow(b1, tf)) for mm in m]
    vhat = [vv / (1 - torch.pow(b2, tf)) for vv in v]
    upd = [p - lr_t * mm / (torch.sqrt(vv) + eps)
           for p, mm, vv in zip(params.leaves(), mhat, vhat)]
    upd[0] = torch.clamp(upd[0], -0.998, 0.998)
    return InverseParams.from_leaves(upd), (
        InverseParams.from_leaves(m), InverseParams.from_leaves(v), t)


def _unpack(state, device):
    if isinstance(state, InverseParams):
        params = state.to(device)
        return params, init_opt_state(params)
    return state


@spans.span("inverse_forward")
def _loss_of(loss_fn, leaves):
    return loss_fn(InverseParams.from_leaves(leaves))


@spans.span("inverse_backward")
def _grads_of(loss, leaves):
    return torch.autograd.grad(loss, leaves)


def _value_and_grad(loss_fn, params: InverseParams):
    """The loss at ``params`` and its gradient in the four leaves; in a
    recorded step (``perf/spans.py``) the spans ``inverse_forward`` and
    ``inverse_backward``."""
    leaves = [v.detach().clone().requires_grad_() for v in params.leaves()]
    loss = _loss_of(loss_fn, leaves)
    grads = _grads_of(loss, leaves)
    return loss.detach(), grads


def _step_device(mesh, device) -> torch.device:
    """The step's device: ``mesh.device`` with a mesh (``device``, if given,
    must agree), else ``resolve_device(device)``. Raises TypeError for a
    mesh that is not a port ``Mesh``."""
    from blackhole_simulation_tpu_torch.parallel.mesh import Mesh
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a blackhole_simulation_tpu_torch "
                        f"parallel Mesh (make_mesh), not {type(mesh).__name__}")
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.device.type or d.index not in (None,
                                                         mesh.device.index):
            raise ValueError(f"device {d} is not the mesh's {mesh.device}")
    return mesh.device


def _mesh_pixels(mesh, n_pix, device):
    """This rank's contiguous slice of the row-major pixel ids, and the
    sharding that cuts the target the same way."""
    from blackhole_simulation_tpu_torch.parallel.render import shard_rays_spec

    spec = shard_rays_spec(mesh)
    return spec.shard(torch.arange(n_pix, device=device), 0), spec


def _psum(mesh, loss, grads):
    """(loss, grads) summed over the mesh, in one all-reduce."""
    from blackhole_simulation_tpu_torch.parallel.mesh import all_reduce_sum

    total = all_reduce_sum(mesh, torch.stack([loss, *grads]))
    return total[0], tuple(total[1:])


def make_inverse_step(scene, mesh=None, lr=2e-2, b1=0.9, b2=0.999, eps=1e-8,
                      total_steps: int | None = None, device=None,
                      dtype=torch.float32):
    """One Adam step on the per-pixel MSE at the scene's own march config,
    rendered in ``dtype``:
    ((params, opt_state), target) -> ((params', opt_state'), loss). Bare
    InverseParams start a fresh optimizer state. Without a mesh and with
    ``use_pallas`` the pixels are in block order (``to_block_order``): the
    edge-padded frame, with the loss divided by the padded pixel count, as
    the JAX twin. With a mesh the pixel count must divide the mesh size."""
    from blackhole_simulation_tpu_torch.ops.pallas_march import to_block_order

    device = _step_device(mesh, device)
    h, w = scene.camera.height, scene.camera.width
    ids = torch.arange(h * w, device=device)
    if mesh is not None:
        if (h * w) % mesh.size:
            raise ValueError(
                f"pixel count {h * w} must divide the mesh size {mesh.size} "
                "for the sharded inverse step")
        pix_order, spec = _mesh_pixels(mesh, h * w, device)
        n_eff = h * w
    else:
        pix_order = (to_block_order(ids, h, w) if scene.march_cfg.use_pallas
                     else ids)
        n_eff = int(pix_order.shape[0])

    @spans.root("inverse_step")
    def step(state, target):
        params, opt_state = _unpack(state, device)
        target_flat = torch.as_tensor(target, device=device).reshape(-1, 3)
        target_flat = target_flat.to(dtype)
        target_flat = (spec.shard(target_flat, 0) if mesh is not None
                       else target_flat[pix_order])

        def loss_fn(p):
            rgb = _forward(p, scene, pix_order, dtype)
            return torch.sum((rgb - target_flat) ** 2)

        loss, grads = _value_and_grad(loss_fn, params)
        if mesh is not None:
            loss, grads = _psum(mesh, loss, grads)
        params, opt_state = _adam_update(params, opt_state, grads, n_eff, lr,
                                         total_steps, b1, b2, eps)
        return (params, opt_state), loss / n_eff

    return step


# The central-difference driver. Reverse-mode AD through a long chaotic
# march returns gradients of random sign on near-critical rays (the JAX
# twin's rationale, train.py:222-236), while the loss itself is a smooth
# basin: central differences of the loss value at h ~ the basin scale
# converge. The state vector and Adam moments are float32 (the moments
# take a float64 gradient's dtype from the first step on).

_FD_FIELDS = _FIELDS
_FD_H = (0.008, 0.008, 0.05, 0.05)


def _params_to_vec(p: InverseParams) -> torch.Tensor:
    return torch.stack([getattr(p, f) for f in _FD_FIELDS])


def _vec_to_params(v: torch.Tensor) -> InverseParams:
    return InverseParams(**{f: v[i] for i, f in enumerate(_FD_FIELDS)})


def fd_state_init(params: InverseParams):
    """The central-difference driver's checkpointable state:
    (vec (4,), (m, v, step count))."""
    vec = _params_to_vec(params).to(torch.float32)
    zeros = torch.zeros(4, dtype=torch.float32, device=vec.device)
    return (vec, (zeros, zeros,
                  torch.zeros((), dtype=torch.int32, device=vec.device)))


def fd_state_params(state) -> InverseParams:
    """InverseParams of a central-difference driver state."""
    return _vec_to_params(state[0])


def make_fd_inverse_step(scene, mesh=None, lr=3e-2, b1=0.9, b2=0.999,
                         eps=1e-8, total_steps: int | None = None, h=_FD_H,
                         device=None, dtype=torch.float32):
    """One central-difference Adam step:
    ((vec, opt_state), target) -> ((vec', opt_state'), loss). The loss is
    the per-pixel MSE over the row-major frame, rendered and summed in
    ``dtype`` (its (9,) vector all-reduced in it), divided by the pixel count,
    at the centre and at +-h along each parameter (nine forward passes);
    the gradient is the central difference; Adam with the cosine lr
    schedule when ``total_steps`` is set, and spin clipped to +-0.998. With
    a mesh each rank sums its pixels' nine losses and the (9,) vector is
    all-reduced; the pixel count must divide the mesh size."""
    device = _step_device(mesh, device)
    n_pix = scene.camera.width * scene.camera.height
    h_vec = torch.tensor(h, dtype=torch.float32, device=device)
    offsets = torch.cat([torch.zeros((1, 4), dtype=torch.float32,
                                     device=device),
                         torch.diag(h_vec), -torch.diag(h_vec)])
    if mesh is not None:
        if n_pix % mesh.size:
            raise ValueError(
                f"pixel count {n_pix} must divide the mesh size {mesh.size}")
        pix_ids, spec = _mesh_pixels(mesh, n_pix, device)
    else:
        pix_ids = torch.arange(n_pix, device=device)

    def step(state, target):
        from blackhole_simulation_tpu_torch.parallel.mesh import (
            all_reduce_sum,
        )

        vec, (m_t, v_t, t) = state
        target_flat = torch.as_tensor(target, device=device).reshape(-1, 3)
        target_flat = target_flat.to(dtype)
        if mesh is not None:
            target_flat = spec.shard(target_flat, 0)
        with torch.no_grad():
            ls = torch.stack([
                torch.sum((_forward(_vec_to_params(v), scene, pix_ids, dtype)
                           - target_flat) ** 2)
                for v in vec[None, :] + offsets
            ])
            if mesh is not None:
                ls = all_reduce_sum(mesh, ls)
            ls = ls / n_pix
        g = (ls[1:5] - ls[5:9]) / (2.0 * h_vec)
        t = t + 1
        tf = t.to(torch.float32)
        if total_steps is not None:
            frac = torch.clamp(tf / total_steps, max=1.0)
            lr_t = lr * (0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac)))
        else:
            lr_t = lr
        m_t = b1 * m_t + (1 - b1) * g
        v_t = b2 * v_t + (1 - b2) * g * g
        mhat = m_t / (1 - torch.pow(b1, tf))
        vhat = v_t / (1 - torch.pow(b2, tf))
        vec = vec - lr_t * mhat / (torch.sqrt(vhat) + eps)
        vec = torch.cat([torch.clamp(vec[:1], -0.998, 0.998), vec[1:]])
        return (vec, (m_t, v_t, t)), ls[0]

    return step


def fd_inverse_render(scene, target, n_steps=40, mesh=None, lr=3e-2,
                      init: InverseParams | None = None, device=None,
                      dtype=torch.float32):
    """Central-difference inverse rendering: ``n_steps`` of
    ``make_fd_inverse_step`` with the cosine schedule over them, rendered
    in ``dtype``. Returns (params, loss_history)."""
    device = _step_device(mesh, device)
    params = (init or InverseParams.init(dtype=dtype)).to(device)
    step = make_fd_inverse_step(scene, mesh, lr, total_steps=n_steps,
                                device=device, dtype=dtype)
    state = fd_state_init(params)
    target = torch.as_tensor(target, device=device)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, target)
        losses.append(float(loss))
    return fd_state_params(state), losses


def make_ad_inverse_step(scene, mesh=None, lr=2e-2, pool: int = 4,
                         march_steps: int = 64, clip: float = 0.03,
                         total_steps: int | None = None, device=None,
                         dtype=torch.float32):
    """One curriculum stage's Adam step on the pooled pixel loss, marched
    at ``march_steps`` with the per-step cotangent clip ``clip``, rendered
    in ``dtype``:
    ((params, opt_state), target) -> ((params', opt_state'), loss). With a
    mesh each rank renders and pools its own slab of height / n_dev rows;
    (height // pool) must divide the mesh size."""
    device = _step_device(mesh, device)
    h, w = scene.camera.height, scene.camera.width
    while pool > 1 and (h % pool or w % pool):
        pool //= 2
    pool = max(pool, 1)
    cfg = dataclasses.replace(
        scene.march_cfg, max_steps=march_steps, cotangent_clip=clip,
        fused=False, refine_band=0.0, start_jitter=0.0,
    )
    stage_scene = dataclasses.replace(scene, march_cfg=cfg)
    n_pool = (h // pool) * (w // pool)
    if mesh is not None:
        if (h // pool) % mesh.size:
            raise ValueError(
                f"{h // pool} rows of {pool}x{pool} pooled blocks must divide "
                f"the mesh size {mesh.size}")
        rows = h // mesh.size
        pix, spec = _mesh_pixels(mesh, h * w, device)
    else:
        rows = h
        pix = torch.arange(h * w, device=device)

    def pooled(x):
        return x.reshape(rows // pool, pool, w // pool, pool, 3).mean(
            dim=(1, 3))

    @spans.root("inverse_step")
    def step(state, target):
        params, opt_state = _unpack(state, device)
        target_flat = torch.as_tensor(target, device=device).reshape(-1, 3)
        target_flat = target_flat.to(dtype)
        if mesh is not None:
            target_flat = spec.shard(target_flat, 0)
        target_p = pooled(target_flat)

        def loss_fn(p):
            return torch.sum((pooled(_forward(p, stage_scene, pix, dtype))
                              - target_p) ** 2)

        loss, grads = _value_and_grad(loss_fn, params)
        if mesh is not None:
            loss, grads = _psum(mesh, loss, grads)
        params, opt_state = _adam_update(params, opt_state, grads, n_pool, lr,
                                         total_steps)
        return (params, opt_state), loss / n_pool

    return step


def ad_inverse_render(scene, target, n_steps=90, mesh=None, lr=None,
                      init: InverseParams | None = None, stages=_AD_STAGES,
                      device=None, dtype=torch.float32):
    """The short-horizon pooled-gradient curriculum: ``n_steps`` split over
    the (march steps, pool) stages, fresh Adam moments per stage, rendered
    in ``dtype``. Returns (params, loss_history)."""
    device = _step_device(mesh, device)
    params = (init or InverseParams.init(dtype=dtype)).to(device)
    target = torch.as_tensor(target, device=device)
    per = max(n_steps // len(stages), 1)
    lrs = [3e-2, 1.2e-2, 6e-3] if lr is None else [lr] * len(stages)
    losses = []
    for (march_steps, pool), lr_s in zip(stages, lrs):
        step = make_ad_inverse_step(scene, mesh, lr_s, pool=pool,
                                    march_steps=march_steps,
                                    total_steps=per, device=device,
                                    dtype=dtype)
        state = (params, init_opt_state(params))
        for _ in range(per):
            state, loss = step(state, target)
            losses.append(float(loss))
        params = state[0]
    return params, losses


def inverse_render(scene, target, n_steps=90, mesh=None, lr=None,
                   init: InverseParams | None = None, method: str = "ad",
                   ad_stages=_AD_STAGES, device=None, dtype=torch.float32):
    """Run the inverse optimization in ``dtype``; returns (params,
    loss_history). ``method``: "ad" (the curriculum, ad_inverse_render),
    "fd" (central differences, fd_inverse_render, lr 3e-2 by default) or
    "ad-step" (the raw step at the scene's own config). ``mesh`` shards
    each step over the mesh."""
    if method == "fd":
        return fd_inverse_render(scene, target, n_steps, mesh,
                                 3e-2 if lr is None else lr, init,
                                 device=device, dtype=dtype)
    if method == "ad":
        return ad_inverse_render(scene, target, n_steps, mesh, lr, init,
                                 stages=ad_stages, device=device, dtype=dtype)
    if method != "ad-step":
        raise ValueError(f"unknown method {method!r}")
    device = _step_device(mesh, device)
    step = make_inverse_step(scene, mesh, 2e-2 if lr is None else lr,
                             total_steps=n_steps, device=device, dtype=dtype)
    params = (init or InverseParams.init(dtype=dtype)).to(device)
    state = (params, init_opt_state(params))
    target = torch.as_tensor(target, device=device)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, target)
        losses.append(float(loss))
    return state[0], losses
