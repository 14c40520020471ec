"""Learned models: the Neural Radiance Surrogate of the far-field skip."""
