"""The march kernel's host side: pixel-block ray order, the static
parameters, and the wrapper that launches the kernel.

Counterpart of ``blackhole_simulation_tpu/ops/pallas_march.py``:
``_block_dims`` / ``_padded_dims`` / ``to_block_order`` /
``from_block_order`` (:56-115) and the ``pallas_march_u`` wrapper (:677-775)
around ``_march_kernel`` (:646), whose body is ``march_tile`` or, with
``MarchConfig.multistep``, ``march_tile_ab3`` (:660); and the jnp march's
jets (render/march.py:555-569), which the port runs in the same kernel
(``march_tile``'s jet term, pallas_march.py:290-325). The kernel is
``csrc/march.cu``; its plain version is ``ops/march.py::march_tile`` /
``march_tile_ab3``. ``march_u`` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; nothing else picks between them.

The march runs in the rays' dtype: float32 rays launch the kernel's float
instantiations, float64 rays its double ones (``march_kernel_f64``, the
exact route only, as the JAX package marches float64 in jnp with exact
divides), and any other dtype raises. The plain version runs in either.

The CUDA kernel needs no tiles: a resident grid of persistent warps takes
rays from a pool (``ray_pool``) until none is left, so nothing is padded
in memory (the Pallas wrapper pads to whole tiles with rays born dead).
The block order is kept because the training loss is defined over the
block-ordered, edge-padded pixel ids, and because a warp's first rays are
then a compact strip of one pixel block.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blackhole_simulation_tpu_torch._elementwise import const
from blackhole_simulation_tpu_torch.ops.build import KMAX_DEFAULT, kmax_for
from blackhole_simulation_tpu_torch.ops.march import (
    ab3_renorm_plan,
    march_tile,
    march_tile_ab3,
)

# The Pallas kernel's tile: SUB x LANE rays (its BH_PALLAS_SUB override, a
# TPU tuning knob, is not ported).
SUB = 32
LANE = 128
TILE = SUB * LANE


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _block_dims(height: int, width: int):
    """The BLOCK_H x BLOCK_W = TILE pixel block that pads this frame least;
    ties prefer the squarest block."""
    best = None
    bh = 8
    while bh * 8 <= TILE:
        bw = TILE // bh
        area = _cdiv(height, bh) * bh * _cdiv(width, bw) * bw
        squareness = abs(bh - bw)
        if best is None or (area, squareness) < best[:2]:
            best = (area, squareness, bh, bw)
        bh *= 2
    return best[2], best[3]


def _padded_dims(height: int, width: int):
    bh, bw = _block_dims(height, width)
    return _cdiv(height, bh) * bh, _cdiv(width, bw) * bw


def to_block_order(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Row-major (H*W, ...) -> pixel-block-major (Hp*Wp, ...): the frame is
    padded to whole blocks with edge-replicated entries, then regrouped so
    each BLOCK_H x BLOCK_W block is contiguous."""
    bh, bw = _block_dims(height, width)
    hp, wp = _padded_dims(height, width)
    tail = x.shape[1:]
    x = x.reshape(height, width, *tail)
    rows = torch.clamp(torch.arange(hp, device=x.device), max=height - 1)
    cols = torch.clamp(torch.arange(wp, device=x.device), max=width - 1)
    x = x[rows][:, cols]
    x = x.reshape(hp // bh, bh, wp // bw, bw, *tail).transpose(1, 2)
    return x.reshape(hp * wp, *tail)


def from_block_order(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Inverse of to_block_order: (Hp*Wp, ...) -> row-major (H*W, ...)."""
    bh, bw = _block_dims(height, width)
    hp, wp = _padded_dims(height, width)
    tail = x.shape[1:]
    x = x.reshape(hp // bh, wp // bw, bh, bw, *tail).transpose(1, 2)
    x = x.reshape(hp, wp, *tail)
    return x[:height, :width].reshape(height * width, *tail)


def lane_efficiency(steps: torch.Tensor) -> float:
    """The share of a one-ray-per-lane launch's lane-steps that march a
    ray: sum(steps) / sum over warps of 32 x the warp's largest count, with
    the 1-D ``steps`` grouped into warps of 32 consecutive entries in launch
    order (the tail filled with zeros). A warp steps until its slowest ray
    ends; 1.0 means no lane ever waits."""
    steps = steps.reshape(-1).long()
    pad = (-steps.numel()) % 32
    warps = torch.cat([steps, steps.new_zeros(pad)]).reshape(-1, 32)
    lane_steps = 32 * int(warps.amax(dim=1).sum())
    return int(steps.sum()) / lane_steps if lane_steps else 1.0


_MARCH_INTS = (
    "max_steps", "renormalize_every", "max_crossings", "midpoint_iters",
    "approx_recip", "far_cap_on", "multistep", "ab3_renorm_every",
    "ab3_tail_renorm",
)
_MARCH_LENGTHS = (
    "step_rate", "min_step", "max_step", "far_step_cap_rate",
    "far_boost_radius", "escape_radius", "escape_sanity_r", "record_r_min",
    "record_r_max",
)
_JET_FIELDS = (
    "core_radius", "opening_slope", "z_min", "z_max", "density",
    "turbulence", "one_minus_turb", "gamma", "beta", "beaming_exponent",
)


class _CMarchParams(ctypes.Structure):
    """``MarchParams`` (``MarchParamsT<float>``) as ``csrc/march_step.cuh``
    declares it."""

    _fields_ = ([(name, ctypes.c_int) for name in _MARCH_INTS]
                + [(name, ctypes.c_float) for name in _MARCH_LENGTHS])


class _CMarchParams64(ctypes.Structure):
    """``MarchParamsT<double>``, the float64 kernels' configuration."""

    _fields_ = ([(name, ctypes.c_int) for name in _MARCH_INTS]
                + [(name, ctypes.c_double) for name in _MARCH_LENGTHS])


class _CJetParams(ctypes.Structure):
    """``JetParams`` as ``csrc/march_step.cuh`` declares it: the jets'
    static configuration, each field rounded to float32 (``gamma`` and
    ``one_minus_turb`` from float64, as the JAX twin rounds them)."""

    _fields_ = [(name, ctypes.c_float) for name in _JET_FIELDS]


class _CJetParams64(ctypes.Structure):
    """``JetParamsT<double>``: the jets' configuration in float64, as the
    JAX twin's Python numbers meet float64 rows."""

    _fields_ = [(name, ctypes.c_double) for name in _JET_FIELDS]


def _f64(dtype) -> bool:
    return dtype == torch.float64


def c_jet_params(jets, dtype=torch.float32):
    """The kernels' jet configuration from a JetParams (zeros for None), in
    ``dtype`` (float32 or float64)."""
    cls = _CJetParams64 if _f64(dtype) else _CJetParams
    if jets is None:
        return cls()
    return cls(
        core_radius=jets.core_radius, opening_slope=jets.opening_slope,
        z_min=jets.z_min, z_max=jets.z_max, density=jets.density,
        turbulence=jets.turbulence, one_minus_turb=1.0 - jets.turbulence,
        gamma=jets.gamma, beta=jets.beta,
        beaming_exponent=jets.beaming_exponent,
    )


def c_march_params(cfg, dtype=torch.float32):
    """The kernels' static march configuration from a MarchConfig, its
    lengths in ``dtype`` (float32 or float64)."""
    ab3_every, ab3_tail = ab3_renorm_plan(cfg)
    cls = _CMarchParams64 if _f64(dtype) else _CMarchParams
    return cls(
        max_steps=cfg.max_steps, renormalize_every=cfg.renormalize_every,
        max_crossings=cfg.max_crossings, midpoint_iters=cfg.midpoint_iters,
        approx_recip=int(cfg.approx_recip),
        far_cap_on=int(cfg.far_step_cap_rate > 0.0),
        multistep=int(cfg.multistep), ab3_renorm_every=ab3_every,
        ab3_tail_renorm=int(ab3_tail),
        step_rate=cfg.step_rate, min_step=cfg.min_step,
        max_step=cfg.max_step, far_step_cap_rate=cfg.far_step_cap_rate,
        far_boost_radius=cfg.far_boost_radius,
        escape_radius=cfg.escape_radius,
        escape_sanity_r=8.0 * cfg.escape_radius,
        record_r_min=cfg.record_r_min, record_r_max=cfg.record_r_max,
    )


def normalize_pt(yt0: torch.Tensor) -> torch.Tensor:
    """Affine-normalize (8, N) rows to p_t = -1 (an exact multiply by one
    for camera rays, which are born normalized)."""
    pt = yt0[4]
    inv_e = const(pt, -1.0) / torch.where(torch.abs(pt) < 1e-12, -1.0, pt)
    return torch.cat([yt0[:4], -torch.ones_like(yt0[4:5]),
                      yt0[5:8] * inv_e[None, :]], dim=0)


def scalar_params(m, a, r_h, r_ph, device,
                  dtype=torch.float32) -> torch.Tensor:
    """The kernels' (4,) [m, a, r_h, r_ph] in ``dtype`` on the device."""
    return torch.stack([torch.as_tensor(x).detach().to(device, dtype)
                        for x in (m, a, r_h, r_ph)]).contiguous()


def check_dtype(x: torch.Tensor, cfg, what: str = "rays"):
    """The march's dtype rule: float32, or float64 on the exact route (the
    JAX package's float64 march is its jnp march, which divides exactly;
    the float64 kernels have no approx_recip instantiation). Raises
    ValueError otherwise."""
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what} must be float32 or float64, got {x.dtype}")
    if _f64(x.dtype) and cfg.approx_recip:
        raise ValueError("the float64 march divides exactly: take "
                         "approx_recip=False")


def _check_rows(yt0, thr, cfg):
    check_dtype(yt0, cfg)
    if yt0.dim() != 2 or yt0.shape[0] != 8:
        raise ValueError(f"rays must be (8, N), got {tuple(yt0.shape)}")
    if thr.shape != (yt0.shape[1],) or thr.device != yt0.device:
        raise ValueError("thr must be (N,) on the rays' device")
    if cfg.max_crossings < 1:
        raise ValueError("max_crossings must be at least 1")


def march_u_plain(yt0: torch.Tensor, thr: torch.Tensor, m, a, r_h, r_ph, cfg,
                  jets=None):
    """The plain version of ``march_u`` on any device (``march_tile``, or
    ``march_tile_ab3`` with ``cfg.multistep`` and no jets; exact divides):
    the same outputs, differentiable by autograd (the midpoint march)."""
    _check_rows(yt0, thr, cfg)
    yt0 = normalize_pt(yt0)
    tile = march_tile_ab3 if cfg.multistep and jets is None else march_tile
    kw = {} if jets is None else {"jets": jets}
    t, r, u, ph, pr, pu, hit, steps, cr, cp, ct, nc, rmin, jet = tile(
        m, a, r_h, r_ph, thr,
        (yt0[0], yt0[1], yt0[2], yt0[3], yt0[5], yt0[6], yt0[7]), cfg, **kw,
    )
    yt = torch.stack([t, r, u, ph, yt0[4], pr, pu, yt0[7]])
    if jet is None:
        jet = torch.zeros((3,) + r.shape, dtype=r.dtype, device=r.device)
    return yt, hit, steps, cr, cp, ct, nc, rmin, jet


def march_u(yt0: torch.Tensor, thr: torch.Tensor, m, a, r_h, r_ph, cfg,
            jets=None, out=None):
    """March (8, N) u-chart rays (p_t normalized here) with per-ray
    termination radii ``thr``. Returns (yt (8, N), hit, steps, cross_r,
    cross_phi, cross_t (K, N), n_crossings, r_min_ph, jet (3, N)), as the
    JAX package's ``pallas_march_u`` plus the jet radiance of its jnp
    march (zeros without ``jets``, a ``JetParams``); the integer outputs
    are int32, the others in the rays' dtype. ``cfg.multistep`` selects the
    AB3 march, which has no jets: with jets the march is the midpoint one.

    CUDA tensors launch the march kernel (``csrc/march.cu``; float64 rays
    its float64 instantiation, which takes no approx_recip) on the current
    stream and count the launch in ``march_u.launches``; CPU tensors run the
    plain version (``march_u_plain``). More than 4 crossings
    (``cfg.max_crossings``, up to ``ops/build.KMAX_LIMIT`` on the card) run
    on a build with more slots (``ops/build.kmax_for``). The kernel applies
    ``cfg.approx_recip``; the plain version always divides exactly. While
    ``march_u.record`` is a list, each call appends its arguments to it, so
    a caller can replay the kernel on a real step's own inputs. ``out``, a
    CUDA call's tuple of the nine outputs as this returns them, receives the
    results in place of new tensors.
    """
    if march_u.record is not None:
        march_u.record.append((yt0, thr, m, a, r_h, r_ph, cfg, jets))
    if yt0.device.type == "cpu":
        return march_u_plain(yt0, thr, m, a, r_h, r_ph, cfg, jets)
    _check_rows(yt0, thr, cfg)
    yt0 = normalize_pt(yt0)
    n = yt0.shape[1]
    k_slots = cfg.max_crossings
    if yt0.device.type != "cuda":
        raise ValueError(f"no march path for device {yt0.device}")
    lib = _march_library(kmax_for(k_slots))
    dev = yt0.device
    dtype = yt0.dtype
    y = yt0.detach().contiguous()
    thr = thr.detach().to(dtype).contiguous()
    params = scalar_params(m, a, r_h, r_ph, dev, dtype)
    fl = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    k = k_slots
    shapes = [(8, n), (n,), (n,), (k, n), (k, n), (k, n), (n,), (n,), (3, n)]
    dtypes = [fl, i32, i32, fl, fl, fl, i32, fl, fl]
    if out is None:
        out = [torch.empty(sh, **dt) for sh, dt in zip(shapes, dtypes)]
    elif len(out) != 9 or any(
            x.shape != sh or x.dtype != dt["dtype"] or x.device != dev
            or not x.is_contiguous()
            for x, sh, dt in zip(out, shapes, dtypes)):
        raise ValueError("out must hold the nine outputs as contiguous "
                         "tensors, shaped and typed as march_u returns them")
    yo, hit, steps, cr, cp, ct, nc, rmin, jet = out
    if jets is None:
        jet.zero_()
    c_mp = c_march_params(cfg, dtype)
    c_jets = c_jet_params(jets, dtype)
    launch = lib.bh_march_launch64 if _f64(dtype) else lib.bh_march_launch
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with torch.cuda.device(dev):
        pool = ray_pool(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(
            ptr(params), ptr(y), ptr(thr), ptr(yo), ptr(hit), ptr(steps),
            ptr(cr), ptr(cp), ptr(ct), ptr(nc), ptr(rmin),
            ctypes.c_void_p(None if jets is None else jet.data_ptr()),
            ctypes.c_int(n), ptr(pool), ctypes.byref(c_mp),
            None if jets is None else ctypes.byref(c_jets),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(
            f"march kernel launch failed: {lib.bh_error_string(err).decode()}")
    march_u.launches += 1
    return yo, hit, steps, cr, cp, ct, nc, rmin, jet


march_u.launches = 0
march_u.record = None

_POOLS: dict = {}


def ray_pool(device) -> torch.Tensor:
    """The ray pool of the render and march kernels on ``device``'s current
    stream: two int32 words, [next ray, retired blocks]. A launch takes its
    rays from it and its last block to retire sets both back to zero, so a
    launch needs no reset of its own; launches on one stream run in order
    and share it. Allocated zeroed at the stream's first launch."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    stream = torch.cuda.current_stream(device)
    key = (device.index, stream.cuda_stream)
    pool = _POOLS.get(key)
    if pool is None:
        pool = _POOLS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return pool


def march_kernel_shape(cfg, jets=None, dtype=torch.float32) -> dict:
    """The launch shape of the march kernel's instantiation for ``cfg``,
    ``jets`` and ``dtype``, from the built library on the current device:
    threads per block, resident blocks and warps per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the SM count (the
    resident grid is their product) and the static shared memory per
    block."""
    lib = _march_library(kmax_for(cfg.max_crossings))
    out = (ctypes.c_int * 4)()
    c_mp, c_jets = c_march_params(cfg, dtype), c_jet_params(jets, dtype)
    shape = lib.bh_march_shape64 if _f64(dtype) else lib.bh_march_shape
    err = shape(ctypes.byref(c_mp), None if jets is None
                else ctypes.byref(c_jets), out)
    if err != 0:
        raise RuntimeError("march kernel shape query failed: "
                           f"{lib.bh_error_string(err).decode()}")
    threads, blocks, sms, smem = out
    return {"threads": threads, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "sms": sms,
            "smem_bytes": smem}


def load_library(source: str, params_size_fn: str,
                 kmax: int = KMAX_DEFAULT) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>`` with ``kmax``
    crossing slots; check that its MarchParams (and, where it has them, its
    JetParams and their float64 forms) match ``_CMarchParams`` and the
    others."""
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build(source, kmax)))
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    checks = [(params_size_fn, _CMarchParams, "MarchParams"),
              ("bh_jet_params_size", _CJetParams, "JetParams"),
              ("bh_march_params64_size", _CMarchParams64,
               "MarchParamsT<double>"),
              ("bh_jet_params64_size", _CJetParams64, "JetParamsT<double>")]
    for fn, cls, name in checks:
        size = getattr(lib, fn, None)
        if size is None and fn != params_size_fn:
            continue
        size.restype = ctypes.c_int
        if size() != ctypes.sizeof(cls):
            raise RuntimeError(f"{name} differs between csrc/{source} and "
                               "ops/pallas_march.py")
    return lib


@functools.cache
def _march_library(kmax: int = KMAX_DEFAULT) -> ctypes.CDLL:
    lib = load_library("march.cu", "bh_march_params_size", kmax)
    for launch in (lib.bh_march_launch, lib.bh_march_launch64):
        launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
        launch.restype = ctypes.c_int
    for shape in (lib.bh_march_shape, lib.bh_march_shape64):
        shape.argtypes = [ctypes.c_void_p] * 3
        shape.restype = ctypes.c_int
    return lib
