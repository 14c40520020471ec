"""Ray birth as one CUDA kernel and its VJP as another: ``csrc/birth.cu``
built and bound with ctypes, and the ``torch.autograd.Function`` that
``render/camera.py::camera_rays_u`` takes for rays on a CUDA device.

The forward kernel computes ``camera_rays_u``'s (8, N) u-chart rows, bit
for bit as the plain chain (``camera_rays_u_plain``) computes them on the
card: the camera's tetrad (``camera_scalars``' ``_zamo_tetrad_t`` and
``_lower_to_ks``, in the dtype of the tensors among mass, spin and theta)
once a block, then each ray's NDC coordinates (the pixel ids' or the whole
frame's, with the jitter), momenta and normalization. The fov's and roll's
functions (tan, cos, sin in float64, rounded once) and the aspect ratio
come as launch arguments, as the plain chain computes them on the host, so
no number is copied to the card: the plain chain's ~400 launches (~330 of
them 0-d) and its five blocking copies become one launch. The VJP kernel
recomputes each ray, sweeps it back to the cotangents of the camera's
scalars and sums them in float64 in a fixed order; its one-block reduction
takes the tetrad back to mass, spin, r and theta by forward duals: two
launches in place of autograd's ~600. The kernels replace no TPU kernel:
the JAX package's ray birth is plain ``jnp``.

The derivative chain: each ray in reverse with autograd's local
derivatives (a quotient's, a reciprocal's ``-grad * r * r``, sqrt's
``0.5 / sqrt(x)`` formed in float64); the sums rounded to the rays' dtype,
then to the tetrad's, as autograd's cotangents of the 0-d scalars are; the
tetrad along (mass, spin, r, theta) and theta's rows u0 and s0 along theta
by forward duals, with ``torch.clamp``'s rule at the clamps (the tangent
passes where x >= the bound, a tie included). ``birth_vjp_plain`` is that
chain in plain PyTorch: the twin that the CPU tests hold to autograd.

The gradients reach the camera's tensors: mass, spin, theta (the override
or the camera's), r and phi directly; a tensor fov or roll through the
float64 function of it that the plain chain attaches (``_field_fn``),
which ``BirthFn`` takes as an input of its own.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import numbers

import torch

from blackhole_simulation_tpu_torch._elementwise import (
    const,
    grad_wanted,
    host,
    leaf,
)
from blackhole_simulation_tpu_torch.ops import composite as C

# The Function's tensor inputs and the VJP's gradients, in order
# (csrc/birth.cu::Grads): the fields (None where a number), then the
# float64 functions of a tensor fov and roll.
GRADS = ("m", "a", "theta", "r", "phi", "half", "roll_c", "roll_s")
_FIELDS = 5
# csrc/birth.cu's sums: c0, c_r, c_th, c_ph (4 each), then these.
_K1, _K2, _RC, _RS, _S0, _R, _U0, _PHI = range(16, 24)


@dataclasses.dataclass(frozen=True)
class BirthPlan:
    """A launch's host side: the frame, the ids (None for the whole
    frame), the jitter (rounded to ``dtype``; zeros without one), the host
    values of tan(fov / 2), cos(roll), sin(roll) and the aspect ratio, the
    fields that are numbers (mass, spin, theta, r, phi; 0.0 where a tensor)
    and three dtypes: the rays', the tetrad's and that of theta's rows u0
    and s0 (theta's own where it overrides the camera's, else float64)."""

    width: int
    height: int
    ids: torch.Tensor | None
    jitter: tuple[float, float]
    half: float
    roll_c: float
    roll_s: float
    aspect: float
    numbers: tuple[float, ...]
    dtype: torch.dtype
    tetrad_dtype: torch.dtype
    theta_dtype: torch.dtype

    @property
    def n(self) -> int:
        if self.ids is None:
            return self.width * self.height
        return self.ids.shape[0]


def plan_of(camera, mass, spin, pix_ids=None, jitter=None, theta=None,
            dtype=torch.float32):
    """``camera_rays_u``'s arguments as a (BirthPlan, inputs): ``inputs``
    are the 0-d tensors among mass, spin, theta (the override, else the
    camera's), r and phi, None where a field is a number; ``pix_ids`` a
    contiguous tensor or None. A tensor fov or roll is read on the host,
    as the plain chain reads it."""
    from blackhole_simulation_tpu_torch.render.camera import _jitter_values

    th = camera.theta if theta is None else theta
    fields = (mass, spin, th, camera.r, camera.phi)
    tensors = [x for x in (mass, spin, theta) if torch.is_tensor(x)]
    ct = torch.float64
    if tensors:
        ct = tensors[0].dtype
        for x in tensors[1:]:
            ct = torch.promote_types(ct, x.dtype)
    roll = host(camera.roll)
    plan = BirthPlan(
        width=camera.width, height=camera.height, ids=pix_ids,
        jitter=_jitter_values(jitter, dtype),
        half=math.tan(host(camera.fov) / 2.0), roll_c=math.cos(roll),
        roll_s=math.sin(roll), aspect=camera.width / camera.height,
        numbers=tuple(0.0 if torch.is_tensor(x) else float(x)
                      for x in fields),
        dtype=dtype, tetrad_dtype=ct,
        theta_dtype=torch.float64 if theta is None else theta.dtype)
    return plan, tuple(x if torch.is_tensor(x) else None for x in fields)


def refusal(camera, mass, spin, pix_ids, theta, dtype) -> str | None:
    """Why the kernels refuse these arguments of ``camera_rays_u``, or
    None. ``pix_ids`` a tensor or None."""
    floats = (torch.float32, torch.float64)
    if dtype not in floats:
        return f"the kernel takes float32 or float64 rays, not {dtype}"
    if not torch.is_tensor(mass):
        return "the kernel runs on CUDA, not on a number's host"
    if theta is not None and not torch.is_tensor(theta):
        return "theta: a 0-d tensor, not a number"
    named = {"mass": mass, "spin": spin, "theta": theta,
             **{f"camera.{k}": getattr(camera, k)
                for k in ("r", "theta", "phi", "fov", "roll")}}
    for name, x in named.items():
        if torch.is_tensor(x):
            if (x.dim() != 0 or x.dtype not in floats
                    or x.device != mass.device):
                return (f"{name}: a 0-d float32 or float64 tensor on "
                        f"{mass.device}, not {tuple(x.shape)} {x.dtype} on "
                        f"{x.device}")
        elif x is not None and not isinstance(x, numbers.Real):
            return f"{name}: a number or a 0-d tensor, not {type(x)}"
    if pix_ids is not None and (
            pix_ids.dtype not in (torch.int32, torch.int64)
            or pix_ids.dim() != 1 or pix_ids.device != mass.device):
        return (f"pix_ids: a 1-d int32 or int64 tensor on {mass.device}, not "
                f"{tuple(pix_ids.shape)} {pix_ids.dtype} on {pix_ids.device}")
    if camera.width < 1 or camera.height < 1:
        return f"a frame of {camera.width}x{camera.height} pixels"
    if mass.device.type != "cuda":
        return f"the kernel runs on CUDA, not {mass.device}"
    return None


# ---------------------------------------------------------------------------
# The plain twin of the VJP
# ---------------------------------------------------------------------------

def _clamp_min(x, lo):
    """torch.clamp(x, min=lo) of a Dual, with autograd's tangent: passed
    where x >= lo, a tie included."""
    d = None if x.d is None else torch.where(x.v >= lo, x.d, 0.0)
    return C.Dual(torch.clamp(x.v, min=lo), d)


def _tetrad(m, a, r, th):
    """csrc/birth.cu::tetrad on Duals: coef[leg][j], legs (u, e_r, e_th,
    e_ph), of ``_zamo_tetrad_t`` lowered by ``_lower_to_ks``."""
    s = C.sin(th)
    s2c = _clamp_min(s * s, 1e-12)
    c = C.cos(th)
    sig = r * r + a * a * c * c
    delta = r * r - 2.0 * m * r + a * a
    r2a2 = r * r + a * a
    big_a = r2a2 * r2a2 - a * a * delta * s2c
    alpha = C.sqrt(_clamp_min(delta * sig / big_a, 1e-30))
    omega = 2.0 * m * a * r / big_a
    zero = C.Dual(torch.zeros_like(m.v))
    legs = ((1.0 / alpha, zero, zero, omega / alpha),
            (zero, C.sqrt(_clamp_min(delta / sig, 1e-30)), zero, zero),
            (zero, zero, 1.0 / C.sqrt(sig), zero),
            (zero, zero, zero,
             C.sqrt(_clamp_min(sig / big_a, 1e-30)) / C.sqrt(s2c)))
    s2 = s * s
    two_mr = 2.0 * m * r
    g_tt = -(1.0 - two_mr / sig)
    g_tph = -two_mr * a * s2 / sig
    g_rr = sig / delta
    g_phph = (r * r + a * a + two_mr * a * a * s2 / sig) * s2
    shift_t, shift_ph = -(2.0 * m * r / delta), a / delta
    coef = []
    for v in legs:
        p0 = g_tt * v[0] + g_tph * v[3]
        p3 = g_tph * v[0] + g_phph * v[3]
        coef.append((p0, g_rr * v[1] + (shift_t * p0 - shift_ph * p3),
                     sig * v[2], p3))
    return coef


def _theta_rows(th):
    """camera_rays_u's u0 = cos(theta), s0 = sqrt(max(1 - u0^2, 1e-12))."""
    u0 = C.cos(th)
    return u0, C.sqrt(_clamp_min(1.0 - u0 * u0, 1e-12))


def _field_values(plan, inputs, device):
    """(m, a, theta, r, phi) as float64 0-d tensors: a tensor's value, or
    the plan's number."""
    return [torch.tensor(n, dtype=torch.float64, device=device) if x is None
            else x.detach().to(device=device, dtype=torch.float64)
            for x, n in zip(inputs, plan.numbers)]


def _ndc(plan, device):
    """csrc/birth.cu::ndc of every ray."""
    t = plan.dtype
    w, h = (torch.tensor(float(v), dtype=t, device=device)
            for v in (plan.width, plan.height))
    jx, jy = plan.jitter
    if plan.ids is not None:
        iy = torch.div(plan.ids, plan.width, rounding_mode="floor")
        ix = (plan.ids - iy * plan.width).to(t)
        return (((ix + 0.5) + jx) / w * 2.0 - 1.0,
                1.0 - ((iy.to(t) + 0.5) + jy) / h * 2.0)
    i = torch.arange(plan.n, device=device)
    iy = i // plan.width
    xs = ((i - iy * plan.width).to(t) + 0.5) / w + const(w, jx) / w
    ys = (iy.to(t) + 0.5) / h + const(h, jy) / h
    return xs * 2.0 - 1.0, 1.0 - ys * 2.0


def birth_vjp_plain(plan: BirthPlan, inputs, g) -> dict:
    """The VJP kernels' derivative chain in plain PyTorch: the gradients of
    ``GRADS`` for the (8, N) cotangent ``g`` of the rows, as a dict of 0-d
    tensors, each of its input's dtype (float64 where the field is a
    number; ``half``, ``roll_c``, ``roll_s`` of the rays' dtype)."""
    with torch.no_grad():
        t, ct, dev = plan.dtype, plan.tetrad_dtype, g.device
        m, a, th, r, phi = _field_values(plan, inputs, dev)
        coef = _tetrad(*(C._seed(x.to(ct), i, 4)
                         for i, x in enumerate((m, a, r, th))))
        k = [[c.v.to(t) for c in leg] for leg in coef]
        u0, s0 = (x.v.to(t) for x in _theta_rows(C.Dual(th.to(
            plan.theta_dtype))))
        half, aspect, rc, rs = (
            torch.tensor(v, dtype=torch.float64, device=dev).to(t)
            for v in (plan.half, plan.aspect, plan.roll_c, plan.roll_s))
        k1 = half * aspect
        # each ray's forward
        nx, ny = _ndc(plan, dev)
        cx0, cy0 = nx * k1, ny * half
        cx = cx0 * rc - cy0 * rs
        cy = cx0 * rs + cy0 * rc
        q = (1.0 + cx * cx) + cy * cy
        rq = torch.reciprocal(torch.sqrt(q.double()).to(t))
        inv_norm = rq * 1.0
        n_r, n_th, n_ph = -inv_norm, -cy * inv_norm, -cx * inv_norm
        p = [k[0][j] + n_r * k[1][j] + n_th * k[2][j] + n_ph * k[3][j]
             for j in range(4)]
        rp = torch.reciprocal(-p[0])
        inv = rp * 1.0
        out6 = -(p[2] * inv) / s0
        # and back
        g_t2 = -(g[6] / s0)
        gp = [(g[5] * p[1] + g[7] * p[3] + g_t2 * p[2]) * (rp * rp),
              g[5] * inv, g_t2 * inv, g[7] * inv]
        sums = [gp[j] for j in range(4)]
        for n_leg in (n_r, n_th, n_ph):
            sums += [gp[j] * n_leg for j in range(4)]
        g_n = [sum(gp[j] * k[leg][j] for j in range(4)) for leg in (1, 2, 3)]
        g_invn = (g_n[1] * -cy - g_n[0]) + g_n[2] * -cx
        g_cy, g_cx = -(g_n[1] * inv_norm), -(g_n[2] * inv_norm)
        g_sq = -(g_invn * (rq * rq))
        g_q = g_sq * (0.5 / torch.sqrt(q.double())).to(t)
        g_cx = g_cx + (g_q * cx + g_q * cx)
        g_cy = g_cy + (g_q * cy + g_q * cy)
        g_cx0 = g_cx * rc + g_cy * rs
        g_cy0 = g_cy * rc - g_cx * rs
        sums += [g_cx0 * nx, g_cy0 * ny, g_cx * cx0 + g_cy * cy0,
                 g_cy * cx0 - g_cx * cy0, -(g[6] * (out6 / s0)), g[1], g[2],
                 g[3]]
        s = [x.double().sum().to(t) for x in sums]
        # the tetrad along (m, a, r, theta); theta's rows along theta
        gt = [torch.zeros((), dtype=ct, device=dev)] * 4
        for leg in range(4):
            for j in range(4):
                d = coef[leg][j].d
                if d is not None:
                    gc = s[4 * leg + j].to(ct)
                    gt = [gt[i] + gc * d[i, 0] for i in range(4)]
        u0, s0 = _theta_rows(C._seed(th.to(plan.theta_dtype), 0, 1))
        ut = plan.theta_dtype
        g_th = s[_U0].to(ut) * u0.d[0, 0] + s[_S0].to(ut) * s0.d[0, 0]
        out = (gt[0], gt[1], gt[3].double() + g_th.double(),
               gt[2].double() + s[_R].double(), s[_PHI],
               s[_K1] * aspect + s[_K2], s[_RC], s[_RS])
        dtypes = [torch.float64 if x is None else x.dtype for x in inputs]
        return {name: torch.as_tensor(v).to(dt) for name, v, dt in
                zip(GRADS, out, dtypes + [t] * 3)}


# ---------------------------------------------------------------------------
# The kernels' wrapper
# ---------------------------------------------------------------------------

class _BArgs(ctypes.Structure):
    """``csrc/birth.cu::BirthArgs``."""
    _fields_ = [
        ("n", ctypes.c_longlong), ("width", ctypes.c_int),
        ("height", ctypes.c_int), ("ids", ctypes.c_int), ("t64", ctypes.c_int),
        ("c64", ctypes.c_int), ("th64", ctypes.c_int), ("f64", ctypes.c_int),
        ("grad64", ctypes.c_int),
        *((k, ctypes.c_double) for k in (
            "jx", "jy", "half", "roll_c", "roll_s", "aspect", "m", "a", "th",
            "r", "phi")),
    ]


def _bits(xs) -> int:
    """Bit i set where ``xs[i]`` is a float64 tensor."""
    return sum(1 << i for i, x in enumerate(xs)
               if x is not None and x.dtype == torch.float64)


def _c_args(plan: BirthPlan, inputs, grads=()) -> _BArgs:
    f64 = torch.float64
    args = _BArgs(n=plan.n, width=plan.width, height=plan.height,
                  t64=plan.dtype == f64, c64=plan.tetrad_dtype == f64,
                  th64=plan.theta_dtype == f64, f64=_bits(inputs),
                  grad64=_bits(grads), half=plan.half, roll_c=plan.roll_c,
                  roll_s=plan.roll_s, aspect=plan.aspect)
    if plan.ids is not None:
        args.ids = 2 if plan.ids.dtype == torch.int64 else 1
    args.jx, args.jy = plan.jitter
    args.m, args.a, args.th, args.r, args.phi = plan.numbers
    return args


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/birth.cu."""
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build("birth.cu")))
    p = ctypes.c_void_p
    lib.bh_birth_forward.argtypes = [p] * 9
    lib.bh_birth_forward.restype = ctypes.c_int
    lib.bh_birth_vjp.argtypes = [p] * 11
    lib.bh_birth_vjp.restype = ctypes.c_int
    lib.bh_birth_blocks.argtypes = [ctypes.c_longlong]
    lib.bh_birth_blocks.restype = ctypes.c_longlong
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    if lib.bh_birth_args_size() != ctypes.sizeof(_BArgs):
        raise RuntimeError("BirthArgs differs between csrc/birth.cu and "
                           "ops/birth.py")
    return lib


def _ptr(x):
    return ctypes.c_void_p(None if x is None else x.data_ptr())


def _check(err, lib, what):
    if err != 0:
        raise RuntimeError(f"birth {what} kernel launch failed: "
                           f"{lib.bh_error_string(err).decode()}")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def birth_kernel(plan: BirthPlan, inputs) -> torch.Tensor:
    """The (8, N) rows by the forward kernel: a new tensor of the rays'
    dtype on mass's device, on the current stream, with no
    synchronisation. One launch; none for no rays. Raises RuntimeError if
    the launch fails. Counts each launch in ``birth_kernel.launches``."""
    dev = inputs[0].device
    out = torch.empty((8, plan.n), dtype=plan.dtype, device=dev)
    if plan.n == 0:
        return out
    lib = _library()
    args = _c_args(plan, inputs)
    with torch.cuda.device(dev):
        err = lib.bh_birth_forward(ctypes.byref(args), *map(_ptr, inputs),
                                   _ptr(plan.ids), _ptr(out), _stream(dev))
    _check(err, lib, "forward")
    birth_kernel.launches += 1
    return out


birth_kernel.launches = 0


def birth_vjp_kernel(plan: BirthPlan, inputs, g, wanted) -> tuple:
    """The gradients of ``GRADS`` for the (8, N) cotangent ``g`` by the VJP
    kernel and its reduction, on the current stream: a tuple of 0-d
    tensors, each of its input's dtype (``half``, ``roll_c``, ``roll_s`` of
    the rays'), None where ``wanted`` is false. Two launches; none for no
    rays (zeros). Counts each call that launches in
    ``birth_vjp_kernel.launches``."""
    dev = inputs[0].device
    if tuple(g.shape) != (8, plan.n) or g.dtype != plan.dtype:
        raise ValueError(f"birth VJP kernel: the cotangent is an (8, "
                         f"{plan.n}) tensor of {plan.dtype}, not "
                         f"{tuple(g.shape)} {g.dtype}")
    dtypes = [plan.dtype if x is None else x.dtype for x in inputs]
    dtypes += [plan.dtype] * 3
    grads = tuple(torch.empty((), dtype=dt, device=dev) if w else None
                  for w, dt in zip(wanted, dtypes))
    if plan.n == 0:
        return tuple(None if x is None else x.zero_() for x in grads)
    lib = _library()
    args = _c_args(plan, inputs, grads)
    partials = torch.empty((lib.bh_birth_blocks(plan.n), lib.bh_birth_sums()),
                           dtype=torch.float64, device=dev)
    ptrs = (ctypes.c_void_p * len(GRADS))(
        *(None if x is None else x.data_ptr() for x in grads))
    with torch.cuda.device(dev):
        err = lib.bh_birth_vjp(ctypes.byref(args), *map(_ptr, inputs),
                               _ptr(plan.ids), _ptr(g.contiguous()),
                               _ptr(partials), ptrs, _stream(dev))
    _check(err, lib, "VJP")
    birth_vjp_kernel.launches += 1
    return grads


birth_vjp_kernel.launches = 0


class BirthFn(torch.autograd.Function):
    """The forward kernel, the VJP kernels backward. ``apply(plan,
    *inputs)`` with the tensors of ``GRADS``: the fields of ``plan_of``,
    then the float64 functions of a tensor fov and roll as ``_field_fn``
    attaches them (None without a graph: their values are the plan's,
    these only carry the gradient back to the field); returns the (8, N)
    rows."""

    @staticmethod
    def forward(ctx, plan, *inputs):
        ctx.plan = plan
        ctx.save_for_backward(*inputs[:_FIELDS])
        return birth_kernel(plan, inputs[:_FIELDS])

    @staticmethod
    def backward(ctx, g):
        grads = birth_vjp_kernel(ctx.plan, ctx.saved_tensors, g.contiguous(),
                                 ctx.needs_input_grad[1:])
        return (None, *grads)


def _twins(camera, dtype, device):
    """The float64 tan(fov / 2), cos(roll) and sin(roll) of a tensor fov
    or roll that autograd differentiates, in ``dtype`` (``_field_fn``'s);
    None for a number or a tensor without a graph."""
    def twin(x, fn):
        if not grad_wanted(x):
            return None
        return fn(leaf(x, torch.float64, device)).to(dtype)

    return (twin(camera.fov, lambda v: torch.tan(v / 2.0)),
            twin(camera.roll, torch.cos), twin(camera.roll, torch.sin))


def birth_rows(camera, mass, spin, pix_ids=None, jitter=None, theta=None,
               dtype=torch.float32) -> torch.Tensor:
    """``render/camera.py::camera_rays_u`` on the kernels, for a CUDA
    ``mass``: the forward kernel, under ``BirthFn`` where autograd wants a
    derivative of any of the camera's tensors. Raises ValueError where
    ``refusal`` finds a reason; there is no plain fallback."""
    if pix_ids is not None and torch.is_tensor(mass):
        pix_ids = torch.as_tensor(pix_ids, device=mass.device).contiguous()
    reason = refusal(camera, mass, spin, pix_ids, theta, dtype)
    if reason is not None:
        raise ValueError(f"birth kernel: {reason}")
    plan, inputs = plan_of(camera, mass, spin, pix_ids, jitter, theta, dtype)
    twins = _twins(camera, dtype, mass.device)
    if grad_wanted(*inputs, *twins):
        return BirthFn.apply(plan, *inputs, *twins)
    return birth_kernel(plan, inputs)
