"""The hot path: the geodesic step math, the plain batched march, and the
fused render kernel with its wrapper. Exports the packed theta-form step
math, as the JAX package's ``ops`` does."""

from blackhole_simulation_tpu_torch.ops.ks_kernel import (
    ks_hamiltonian,
    ks_renormalize,
    ks_rhs,
    ks_symplectic_step,
)

__all__ = ["ks_hamiltonian", "ks_renormalize", "ks_rhs",
           "ks_symplectic_step"]
