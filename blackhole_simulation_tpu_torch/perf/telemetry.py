"""March telemetry: step histograms, Hamiltonian drift, hit fractions.

Counterpart of ``blackhole_simulation_tpu/perf/telemetry.py``: a march
(``render/march.py::MarchResult``) summarized after the fact, its tensors
read back to the host.
"""

from __future__ import annotations

import numpy as np

from blackhole_simulation_tpu_torch.ops.ks_kernel import ks_hamiltonian
from blackhole_simulation_tpu_torch.render.march import (
    HIT_ESCAPE,
    HIT_HORIZON,
    MarchResult,
)


def march_telemetry(result: MarchResult, bh) -> dict:
    """Summarize a MarchResult into a JSON-friendly dict. ``bh``: the
    scene's ``Kerr`` (its ``mass`` and ``spin``)."""
    hit = result.hit.cpu().numpy()
    steps = result.steps.cpu().numpy()
    # |H| of final states: escaped and captured rays should still sit near
    # the null surface (the float32-regression canary).
    h_final = np.abs(ks_hamiltonian(bh.mass, bh.spin, result.state)
                     .cpu().numpy())
    hist, edges = np.histogram(steps, bins=8)
    return {
        "n_rays": int(hit.size),
        "frac_escape": float((hit == HIT_ESCAPE).mean()),
        "frac_horizon": float((hit == HIT_HORIZON).mean()),
        "steps_p50": float(np.median(steps)),
        "steps_p99": float(np.percentile(steps, 99)),
        "steps_hist": {"counts": hist.tolist(), "edges": edges.tolist()},
        "h_drift_median": float(np.median(h_final)),
        "h_drift_p99": float(np.percentile(h_final, 99)),
        "disk_crossings_mean": float(result.n_crossings.cpu().numpy().mean()),
    }
