"""Host float64 physics for the spectral disk tables."""
