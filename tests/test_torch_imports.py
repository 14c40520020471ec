"""The port and chip_smoke.py import neither JAX nor the JAX package.

Checked in a fresh interpreter (this test process has both loaded), and
statically over the port's sources.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "blackhole_simulation_tpu_torch"
MODULES = [
    "blackhole_simulation_tpu_torch",
    "blackhole_simulation_tpu_torch.render.pipeline",
    "blackhole_simulation_tpu_torch.ops.render",
    "blackhole_simulation_tpu_torch.ops.build",
    "blackhole_simulation_tpu_torch.ops.pallas_march",
    "blackhole_simulation_tpu_torch.ops.march_grad",
    "blackhole_simulation_tpu_torch.ops.march_adjoint",
    "blackhole_simulation_tpu_torch.render.march",
    "blackhole_simulation_tpu_torch.render.camera",
    "blackhole_simulation_tpu_torch.render.precull",
    "blackhole_simulation_tpu_torch.parallel",
    "blackhole_simulation_tpu_torch.parallel.train",
    "blackhole_simulation_tpu_torch.geometry",
    "blackhole_simulation_tpu_torch.geometry.metrics",
    "blackhole_simulation_tpu_torch.geometry.radii",
    "blackhole_simulation_tpu_torch.geometry.tensor",
    "blackhole_simulation_tpu_torch.geodesic",
    "blackhole_simulation_tpu_torch.geodesic.hamiltonian",
    "blackhole_simulation_tpu_torch.geodesic.integrate",
    "blackhole_simulation_tpu_torch.geodesic.integrator",
    "blackhole_simulation_tpu_torch.geodesic.invariants",
    "blackhole_simulation_tpu_torch.geodesic.oracle",
    "blackhole_simulation_tpu_torch.geodesic.state",
    "blackhole_simulation_tpu_torch.constants",
    "blackhole_simulation_tpu_torch.physics",
    "blackhole_simulation_tpu_torch.physics.disk",
    "blackhole_simulation_tpu_torch.physics.hawking",
    "blackhole_simulation_tpu_torch.physics.matter",
    "blackhole_simulation_tpu_torch.physics.redshift",
    "blackhole_simulation_tpu_torch.physics.spectrum",
    "blackhole_simulation_tpu_torch.physics.shadow",
    "blackhole_simulation_tpu_torch.render.overlay",
    "blackhole_simulation_tpu_torch.render.accumulate",
    "blackhole_simulation_tpu_torch.render.tiles",
    "blackhole_simulation_tpu_torch.render.shading",
    "blackhole_simulation_tpu_torch.spacetime",
    "blackhole_simulation_tpu_torch.spacetime.curvature",
    "blackhole_simulation_tpu_torch.spacetime.embedding",
    "blackhole_simulation_tpu_torch.spacetime.frame_drag",
    "blackhole_simulation_tpu_torch.spacetime.lightcone",
    "blackhole_simulation_tpu_torch.engine",
    "blackhole_simulation_tpu_torch.engine.facade",
    "blackhole_simulation_tpu_torch.engine.native",
    "blackhole_simulation_tpu_torch.models",
    "blackhole_simulation_tpu_torch.models.nrs",
    "blackhole_simulation_tpu_torch.models.threefry",
    "blackhole_simulation_tpu_torch.configs",
    "blackhole_simulation_tpu_torch.configs.simulation",
    "blackhole_simulation_tpu_torch.configs.performance",
    "blackhole_simulation_tpu_torch.configs.physics",
    "blackhole_simulation_tpu_torch.utils",
    "blackhole_simulation_tpu_torch.utils.cache",
    "blackhole_simulation_tpu_torch.utils.device",
    "blackhole_simulation_tpu_torch.utils.errors",
    "blackhole_simulation_tpu_torch.utils.validate",
    "blackhole_simulation_tpu_torch.engine.cinema",
    "blackhole_simulation_tpu_torch.perf",
    "blackhole_simulation_tpu_torch.perf.adaptive_resolution",
    "blackhole_simulation_tpu_torch.perf.benchmark",
    "blackhole_simulation_tpu_torch.perf.monitor",
    "blackhole_simulation_tpu_torch.perf.telemetry",
    "blackhole_simulation_tpu_torch.perf.timer",
    "blackhole_simulation_tpu_torch.perf.validator",
    "blackhole_simulation_tpu_torch.app",
    "blackhole_simulation_tpu_torch.app.animate",
    "blackhole_simulation_tpu_torch.app.cli",
    "blackhole_simulation_tpu_torch.app.live",
    "blackhole_simulation_tpu_torch.app.screenshot",
    "blackhole_simulation_tpu_torch.app.state",
    "blackhole_simulation_tpu_torch.__main__",
    "blackhole_simulation_tpu_torch.parallel.checkpoint",
    "blackhole_simulation_tpu_torch.tools.vpu_peak",
    "blackhole_simulation_tpu_torch.tools.train_probe",
    "chip_smoke",
]

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "blackhole_simulation_tpu")
    or m.startswith(("jax.", "jaxlib.", "blackhole_simulation_tpu."))
)
print(json.dumps(bad))
"""


def test_no_jax_in_fresh_interpreter():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_source_imports_no_jax(path):
    text = (ROOT / path).read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert mod.split(".")[0] not in ("jax", "jaxlib"), line
            assert mod != "blackhole_simulation_tpu" and not mod.startswith(
                "blackhole_simulation_tpu."
            ), line
