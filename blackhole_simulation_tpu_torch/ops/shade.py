"""The host side of ``csrc/shade.cuh``, the shading that the render kernel
and the composite kernels share: its ``DiskArgs`` and ``StarArgs`` as
ctypes structures, and ``shade_args``, the one function that forms them
from a scene's disk and stars for both (``ops/render.py::_c_static``,
``ops/composite.py::_c_args``)."""

from __future__ import annotations

import ctypes

from blackhole_simulation_tpu_torch.ops.tonemap import (
    CUBE,
    INV_SQUARE,
    POW,
    RECIPROCAL,
    SQUARE,
    pow_route,
)
from blackhole_simulation_tpu_torch.render.shading import NT_PEAK, _powi_plan

_ROUTES = (POW, RECIPROCAL, SQUARE, CUBE, INV_SQUARE)


def _disk_fields(real) -> list:
    return [
        ("dens", real), ("outer_radius", real), ("t_peak", real),
        ("beam_p", real), ("outer_p", real), ("turbulence", real),
        ("softness", real), ("one_minus_turb", real), ("edge_width", real),
        ("nt_peak", real), ("artistic_rgb", real * 3),
        ("artistic", ctypes.c_int), ("beam_plan", ctypes.c_int * 3),
        ("outer_plan", ctypes.c_int * 3), ("beam_route", ctypes.c_int * 2),
        ("outer_route", ctypes.c_int * 2),
    ]


def _star_fields(real) -> list:
    return [("cells", real * 2), ("thr", real * 2), ("brightness", real),
            ("nebula", real)]


class DiskArgs(ctypes.Structure):
    """``csrc/shade.cuh::DiskArgsT<double>``: the composite's."""
    _fields_ = _disk_fields(ctypes.c_double)


class StarArgs(ctypes.Structure):
    """``csrc/shade.cuh::StarArgsT<double>``: the composite's."""
    _fields_ = _star_fields(ctypes.c_double)


class DiskArgs32(ctypes.Structure):
    """``csrc/shade.cuh::DiskArgsT<float>``: the render kernel's, each
    number rounded to float32 here as the card would round it."""
    _fields_ = _disk_fields(ctypes.c_float)


class StarArgs32(ctypes.Structure):
    """``csrc/shade.cuh::StarArgsT<float>``: the render kernel's."""
    _fields_ = _star_fields(ctypes.c_float)


def plan_fields(p: float, dtype):
    """(plan (k, n, negative) or (-1, 0, 0), routes of p and p - 1) of an
    exponent that ``_powi`` raises to: a plan, or a plain pow whose routes
    the kernels take."""
    plan = _powi_plan(p)
    if plan is not None:
        return (plan[0], plan[1], int(plan[2])), (POW, POW)
    routes = (pow_route(p, dtype), pow_route(p - 1.0, dtype))
    if any(r not in _ROUTES for r in routes):
        raise ValueError(f"shading kernels: no route for the exponent {p}")
    return (-1, 0, 0), routes


def shade_args(disk, stars, dtype, density_scale=1.0,
               types=(DiskArgs, StarArgs)):
    """The kernels' numbers of ``disk`` and ``stars`` (either None: left
    zero) for rows of ``dtype``, in the structures ``types`` (the render
    kernel's ``(DiskArgs32, StarArgs32)``): the Python floats as the plain
    shading forms them, the density times ``density_scale`` in float64,
    the ``_powi`` plans and ``torch.pow``'s routes of the disk's
    exponents."""
    kd, ks = types[0](), types[1]()
    if disk is not None:
        kd.dens = float(disk.density * density_scale)
        kd.outer_radius, kd.t_peak = disk.outer_radius, disk.t_peak
        kd.turbulence = disk.turbulence
        kd.one_minus_turb = 1.0 - disk.turbulence
        kd.softness = disk.inner_edge_softness
        kd.edge_width = 0.15 * disk.outer_radius
        kd.nt_peak = NT_PEAK
        kd.beam_p = disk.beaming_exponent
        kd.outer_p = -disk.outer_falloff * 0.5
        for name, p in (("beam", kd.beam_p), ("outer", kd.outer_p)):
            plan, routes = plan_fields(p, dtype)
            getattr(kd, f"{name}_plan")[:] = plan
            getattr(kd, f"{name}_route")[:] = routes
        kd.artistic = int(disk.artistic_rgb is not None)
        if kd.artistic:
            kd.artistic_rgb[:] = [float(v) for v in disk.artistic_rgb]
    if stars is not None:
        ks.cells[:] = [stars.cells, stars.cells * 0.35]
        ks.thr[:] = [stars.density * 1.0 * 300.0, stars.density * 2.2 * 300.0]
        ks.brightness, ks.nebula = stars.brightness, stars.nebula
    return kd, ks
