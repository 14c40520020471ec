"""The plain PyTorch reference that decides ``correct``: a frozen copy of
the port's plain code paths (the midpoint Kerr-Schild march, the disk,
starfield and glow composite, the spectral disk's Chebyshev tables, the
tone map), cut to what the cells run and written in any floating dtype,
so that the same code in bfloat16 is the control. It imports neither JAX
nor the port, and takes only what the benchmark makes: the
configuration, the camera poses and the jitters."""
