"""Post-processing: bloom, ACES tone mapping, gamma.

Counterpart of ``blackhole_simulation_tpu/render/post.py``: plain tensor
operations on an (H, W, 3) image, on whatever device the image is
(``tonemap_plain``). The blur wraps around the frame edges (``torch.roll``),
as the JAX twin's ``jnp.roll`` does. Differentiable by autograd, with
``jnp.clip``'s derivative (``_elementwise.clip``, ``maximum``: half at a
tie).

``tonemap`` launches the tone-map kernel (``ops/tonemap.py``,
``csrc/tonemap.cu``: the whole chain in one tiled pass, bit for bit what
``tonemap_plain`` computes on the card) for every CUDA image that autograd
will not differentiate; the kernel raises on what it does not take. The
CPU and autograd take ``tonemap_plain``.
"""

from __future__ import annotations

import dataclasses

import torch

from blackhole_simulation_tpu_torch._elementwise import clip, maximum


@dataclasses.dataclass(frozen=True)
class PostParams:
    exposure: float = 1.0
    bloom_enabled: bool = True
    bloom_threshold: float = 0.85
    bloom_strength: float = 0.55
    bloom_passes: int = 2
    tonemap: bool = True
    gamma: float = 2.2


# 9-tap Gaussian weights.
_GAUSS9 = (0.0162162162, 0.0540540541, 0.1216216216, 0.1945945946,
           0.2270270270, 0.1945945946, 0.1216216216, 0.0540540541,
           0.0162162162)
_LUMA = (0.2126, 0.7152, 0.0722)
# ACES (Narkowicz fit): x (a x + b) / (x (c x + d) + e).
_ACES = (2.51, 0.03, 2.43, 0.59, 0.14)


def _blur_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
    """Separable 9-tap Gaussian along one spatial axis (wrapping)."""
    g = _GAUSS9
    out = g[4] * img
    for k in range(1, 5):
        up = torch.roll(img, k, dims=axis)
        dn = torch.roll(img, -k, dims=axis)
        out = out + g[4 - k] * up + g[4 + k] * dn
    return out


def bloom(img: torch.Tensor, params: PostParams) -> torch.Tensor:
    """Bright-pass -> ``bloom_passes`` separable blurs -> additive combine."""
    luma = img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] + img[..., 2] * _LUMA[2]
    bright = img * maximum(luma - params.bloom_threshold, 0.0)[..., None]
    blurred = bright
    for _ in range(params.bloom_passes):
        blurred = _blur_axis(_blur_axis(blurred, 0), 1)
    return img + params.bloom_strength * blurred


def aces(x: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (Narkowicz fit)."""
    a, b, c, d, e = _ACES
    return clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _differentiated(img: torch.Tensor, params: PostParams) -> bool:
    """Whether autograd will ask for a derivative through the tone map of
    ``img`` with ``params``."""
    if not torch.is_grad_enabled():
        return False
    numbers = (params.exposure, params.bloom_threshold,
               params.bloom_strength, params.gamma)
    return img.requires_grad or any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in numbers)


def tonemap(img: torch.Tensor, params: PostParams = PostParams()) -> torch.Tensor:
    """exposure -> bloom -> ACES -> gamma: the tone-map kernel
    (``ops/tonemap.py::tonemap_kernel``) for a CUDA image that autograd
    will not differentiate, else ``tonemap_plain``; the two give the same
    bits on the card."""
    if img.device.type == "cuda" and not _differentiated(img, params):
        from blackhole_simulation_tpu_torch.ops.tonemap import tonemap_kernel

        return tonemap_kernel(img, params)
    return tonemap_plain(img, params)


def tonemap_plain(img: torch.Tensor,
                  params: PostParams = PostParams()) -> torch.Tensor:
    """exposure -> bloom -> ACES -> gamma, in plain tensor operations."""
    img = img * params.exposure
    if params.bloom_enabled:
        img = bloom(img, params)
    if params.tonemap:
        img = aces(img)
    return torch.pow(clip(img, 0.0, 1.0), 1.0 / params.gamma)
