"""The hot path: the geodesic step math, the plain batched march, and the
fused render kernel with its wrapper."""
