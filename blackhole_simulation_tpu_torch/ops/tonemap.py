"""The tone-map kernel's wrapper: ``csrc/tonemap.cu`` built and bound with
ctypes, launched by ``render/post.py::tonemap`` for every CUDA image that
autograd does not differentiate.

The kernel computes ``render/post.py::tonemap_plain`` (exposure, bloom,
ACES, gamma), bit for bit as that plain version computes it on the card,
for any parameters that it takes; it replaces no TPU kernel (the JAX
package's tone map is plain jnp). Its plain version runs on the CPU and
under autograd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from blackhole_simulation_tpu_torch.render.post import (
    _ACES,
    _GAUSS9,
    _LUMA,
    PostParams,
)

# csrc/tonemap.cu::PowRoute
(POW, FILL_ONE, COPY, SQRT, RSQRT, RECIPROCAL, SQUARE, CUBE,
 INV_SQUARE) = range(9)
# csrc/tonemap.cu::FUSED_PASSES: more bloom passes run as a chain of
# launches through two scratch images.
FUSED_PASSES = 2


class _CArgs(ctypes.Structure):
    """``csrc/tonemap.cu::TonemapArgs``."""
    _fields_ = [
        ("exposure", ctypes.c_double), ("threshold", ctypes.c_double),
        ("strength", ctypes.c_double), ("inv_gamma", ctypes.c_double),
        ("gauss", ctypes.c_double * 5), ("luma", ctypes.c_double * 3),
        ("aces", ctypes.c_double * 5), ("bloom", ctypes.c_int),
        ("passes", ctypes.c_int), ("aces_on", ctypes.c_int),
        ("pow_route", ctypes.c_int), ("f64", ctypes.c_int),
    ]


def pow_route(p: float, dtype: torch.dtype) -> int:
    """The route by which ``torch.pow`` raises a ``dtype`` tensor on the
    card to the Python number ``p`` (``csrc/tonemap.cu::PowRoute``): ``p``
    itself against 0, 1, 0.5, -0.5 and -1, then ``p`` rounded to ``dtype``
    against 2, 3 and -2, else ``pow``."""
    for route, q in ((FILL_ONE, 0.0), (COPY, 1.0), (SQRT, 0.5),
                     (RSQRT, -0.5), (RECIPROCAL, -1.0)):
        if p == q:
            return route
    rounded = float(torch.tensor(p, dtype=dtype))
    return {2.0: SQUARE, 3.0: CUBE, -2.0: INV_SQUARE}.get(rounded, POW)


@functools.lru_cache(maxsize=64)
def _c_args(params: PostParams, dtype: torch.dtype) -> _CArgs:
    """The kernel's numbers for ``params`` and ``dtype``, once per pair.
    The blur passes the centre weight and the weights at distance 1..4: the
    kernel forms each product once for the two taps at one distance, which
    the plain version's symmetric weights allow. Negative bloom passes blur
    nothing, as ``range`` runs none."""
    if _GAUSS9 != _GAUSS9[::-1]:
        raise ValueError("the tone-map kernel takes symmetric blur weights")
    bloom = bool(params.bloom_enabled)
    inv_gamma = 1.0 / float(params.gamma)
    return _CArgs(
        float(params.exposure), float(params.bloom_threshold),
        float(params.bloom_strength), inv_gamma,
        (ctypes.c_double * 5)(*_GAUSS9[4:]), (ctypes.c_double * 3)(*_LUMA),
        (ctypes.c_double * 5)(*_ACES), int(bloom),
        max(int(params.bloom_passes), 0) if bloom else 0,
        int(bool(params.tonemap)), pow_route(inv_gamma, dtype),
        int(dtype == torch.float64),
    )


def refusal(img: torch.Tensor, params: PostParams) -> str | None:
    """Why ``tonemap_kernel`` refuses ``img`` and ``params``, or None. The
    parameters and autograd are judged before the device, so that each
    reason shows on the CPU too."""
    numbers = (params.exposure, params.bloom_threshold,
               params.bloom_strength, params.gamma)
    if not all(isinstance(v, (int, float)) for v in numbers):
        return "the kernel takes Python numbers for the parameters"
    if params.bloom_enabled and not isinstance(params.bloom_passes, int):
        return ("the kernel takes a whole number of bloom passes, not "
                f"{params.bloom_passes!r}")
    if torch.is_grad_enabled() and img.requires_grad:
        return "autograd: the kernel has no derivative"
    if img.dtype not in (torch.float32, torch.float64):
        return f"the kernel takes float32 or float64, not {img.dtype}"
    if (img.dim() != 3 or img.shape[2] != 3
            or max(img.shape[:2]) >= 2 ** 31):
        return ("the kernel takes an (H, W, 3) image with H, W < 2**31, "
                f"not {tuple(img.shape)}")
    if img.device.type != "cuda":
        return f"the kernel runs on CUDA, not {img.device}"
    return None


def tonemap_kernel(img: torch.Tensor,
                   params: PostParams = PostParams()) -> torch.Tensor:
    """``tonemap_plain(img, params)`` by the tone-map kernel: a new
    contiguous (H, W, 3) tensor of ``img``'s dtype, on the current stream,
    with no synchronisation. One launch, or ``bloom_passes`` launches where
    the bloom runs more than ``FUSED_PASSES`` passes; none for an empty
    image. ``img`` is read through its strides (the render's planar ``(3,
    H, W).permute(1, 2, 0)`` view as it is). Raises ValueError where
    ``refusal`` finds a reason, and RuntimeError if a launch fails. Counts
    each call that launches in ``tonemap_kernel.launches``."""
    reason = refusal(img, params)
    if reason is not None:
        raise ValueError(f"tone-map kernel: {reason}")
    h, w, _ = img.shape
    out = torch.empty((h, w, 3), dtype=img.dtype, device=img.device)
    if out.numel() == 0:
        return out
    args = _c_args(params, img.dtype)
    scratch = (torch.empty((2, h, w, 3), dtype=img.dtype, device=img.device)
               if args.passes > FUSED_PASSES else None)
    lib = _library()
    strides = (ctypes.c_longlong * 3)(*img.stride())
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.bh_tonemap_launch(
            ctypes.c_void_p(img.data_ptr()), strides, h, w,
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
            ctypes.byref(args), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError("tone-map kernel launch failed: "
                           f"{lib.bh_error_string(err).decode()}")
    tonemap_kernel.launches += 1
    return out


tonemap_kernel.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    """Build (at first use) and load csrc/tonemap.cu."""
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build("tonemap.cu")))
    lib.bh_tonemap_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.bh_tonemap_launch.restype = ctypes.c_int
    lib.bh_tonemap_shape.argtypes = [ctypes.c_void_p] * 2
    lib.bh_tonemap_shape.restype = ctypes.c_int
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    if (lib.bh_tonemap_args_size() != ctypes.sizeof(_CArgs)
            or lib.bh_tonemap_fused_passes() != FUSED_PASSES):
        raise RuntimeError("TonemapArgs or FUSED_PASSES differs between "
                           "csrc/tonemap.cu and ops/tonemap.py")
    return lib


def tonemap_kernel_shape(params: PostParams = PostParams(),
                         dtype: torch.dtype = torch.float32) -> dict:
    """The launch shape of the first launch for ``params`` and ``dtype`` on
    the current device: threads per block, the tile, dynamic shared bytes
    per block, resident blocks and warps per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the SM count."""
    lib = _library()
    out = (ctypes.c_int * 6)()
    err = lib.bh_tonemap_shape(ctypes.byref(_c_args(params, dtype)), out)
    if err != 0:
        raise RuntimeError("tone-map kernel shape query failed: "
                           f"{lib.bh_error_string(err).decode()}")
    threads, tile_w, tile_h, smem, blocks, sms = out
    return {"threads": threads, "tile": [tile_w, tile_h],
            "smem_bytes": smem, "blocks_per_sm": blocks,
            "warps_per_sm": blocks * threads // 32, "sms": sms}
