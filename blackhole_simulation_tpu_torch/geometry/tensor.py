"""Batched 4x4 metric-tensor algebra.

Counterpart of ``blackhole_simulation_tpu/geometry/tensor.py``: tensors are
``(..., 4, 4)`` batched over leading axes; the Christoffel symbols come from
exact forward-mode derivatives of the metric (``torch.func.jacfwd``, as the
JAX twin uses ``jax.jacfwd``).
"""

from __future__ import annotations

import torch


def contract(g: torch.Tensor, p: torch.Tensor,
             q: torch.Tensor | None = None) -> torch.Tensor:
    """g^{mu nu} p_mu q_nu (or p twice). g: (..., 4, 4), p/q: (..., 4)."""
    if q is None:
        q = p
    return torch.einsum("...ij,...i,...j->...", g, p, q)


def raise_index(g_inv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """p^mu = g^{mu nu} p_nu."""
    return torch.einsum("...ij,...j->...i", g_inv, p)


def lower_index(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v_mu = g_{mu nu} v^nu."""
    return torch.einsum("...ij,...j->...i", g, v)


def determinant(g: torch.Tensor) -> torch.Tensor:
    """det of a batched 4x4 tensor."""
    return torch.linalg.det(g)


def christoffel(metric, r, theta) -> torch.Tensor:
    """Christoffel symbols Gamma^alpha_{mu nu} at (r, theta), (..., 4, 4, 4).

    Stationary axisymmetric metrics depend on r and theta only, so only
    d/dr and d/dtheta of g are nonzero."""
    r = torch.as_tensor(r)
    theta = torch.as_tensor(theta, dtype=r.dtype, device=r.device)
    rt = torch.stack(torch.broadcast_tensors(r, theta), dim=-1)

    def cov(rt_single):
        return metric.covariant(rt_single[0], rt_single[1])

    def gamma_at(rt_single):
        g = cov(rt_single)
        dg_drt = torch.func.jacfwd(cov)(rt_single)          # (4, 4, 2)
        zeros = torch.zeros_like(g)
        dg = torch.stack([zeros, dg_drt[..., 0], dg_drt[..., 1], zeros])
        g_inv = torch.linalg.inv(g)
        term = (torch.einsum("mbn->bmn", dg) + torch.einsum("nbm->bmn", dg)
                - dg)
        return 0.5 * torch.einsum("ab,bmn->amn", g_inv, term)

    flat = rt.reshape(-1, 2)
    gammas = torch.func.vmap(gamma_at)(flat)
    return gammas.reshape(rt.shape[:-1] + (4, 4, 4))
