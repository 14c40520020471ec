"""Learned models: the Neural Radiance Surrogate (NRS) of the far-field
skip, its labels and its training (``models/nrs.py``), with the JAX
package's ``models`` exports."""

from blackhole_simulation_tpu_torch.models.nrs import (
    NRS_HIDDEN,
    NRS_LAYERS,
    generate_training_data,
    nrs_apply,
    nrs_flat_weights,
    nrs_from_flat,
    nrs_init,
    train_nrs,
)

__all__ = ["NRS_HIDDEN", "NRS_LAYERS", "generate_training_data", "nrs_apply",
           "nrs_flat_weights", "nrs_from_flat", "nrs_init", "train_nrs"]
