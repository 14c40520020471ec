"""Post-processing: bloom, ACES tone mapping, gamma.

Counterpart of ``blackhole_simulation_tpu/render/post.py``: plain tensor
operations on an (H, W, 3) float32 image, on whatever device the image is.
The blur wraps around the frame edges (``torch.roll``), as the JAX twin's
``jnp.roll`` does. Differentiable by autograd, with ``jnp.clip``'s
derivative (``_elementwise.clip``, ``maximum``: half at a tie).
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
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap(img: torch.Tensor, params: PostParams = PostParams()) -> torch.Tensor:
    """exposure -> bloom -> ACES -> gamma."""
    img = img * params.exposure
    if params.bloom_enabled:
        img = bloom(img, params)
    if params.tonemap:
        img = aces(img)
    return torch.pow(clip(img, 0.0, 1.0), 1.0 / params.gamma)
