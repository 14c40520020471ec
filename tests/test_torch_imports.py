"""The port and chip_smoke.py import neither JAX nor the JAX package, and
the port has a twin of every public name of the JAX package.

The imports are checked in a fresh interpreter (this test process has both
loaded), and statically over the port's sources. The names are read from
each JAX module's top level with ``ast`` (no JAX import): every one must be
an attribute of the port's module of the same path, or have its twin under
another name listed in ``TWINS`` (checked to exist), or stand in
``ABSENT`` with the reason it has none.
"""

import ast
import importlib
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
    "blackhole_simulation_tpu_torch.perf.spans",
    "blackhole_simulation_tpu_torch.perf.telemetry",
    "blackhole_simulation_tpu_torch.perf.validator",
    "blackhole_simulation_tpu_torch.app",
    "blackhole_simulation_tpu_torch.app.animate",
    "blackhole_simulation_tpu_torch.app.cli",
    "blackhole_simulation_tpu_torch.app.live",
    "blackhole_simulation_tpu_torch.app.screenshot",
    "blackhole_simulation_tpu_torch.app.state",
    "blackhole_simulation_tpu_torch.__main__",
    "blackhole_simulation_tpu_torch.parallel.checkpoint",
    "blackhole_simulation_tpu_torch.parallel.mesh",
    "blackhole_simulation_tpu_torch.parallel.render",
    "blackhole_simulation_tpu_torch.ops",
    "blackhole_simulation_tpu_torch.ops.ks_kernel",
    "blackhole_simulation_tpu_torch.tools.vpu_peak",
    "blackhole_simulation_tpu_torch.tools.train_probe",
    "blackhole_simulation_tpu_torch.tools.mesh_check",
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


JAX = ROOT / "blackhole_simulation_tpu"

# JAX name (module path relative to the package, name) -> its port twin
# under another name or in another module ("module.path:name").
TWINS = {
    ("ops/pallas_march.py", "pallas_march_u"): "ops.pallas_march:march_u",
    ("ops/pallas_march.py", "diff_step_values"): "ops.march:diff_step_values",
    ("ops/pallas_march.py", "start_offset_rows"):
        "ops.march:start_offset_rows",
    ("ops/pallas_march.py", "HIT_NONE"): "render.march:HIT_NONE",
    ("ops/pallas_march.py", "HIT_HORIZON"): "render.march:HIT_HORIZON",
    ("ops/pallas_march.py", "HIT_ESCAPE"): "render.march:HIT_ESCAPE",
    ("ops/pallas_grad.py", "CKPT"): "ops.march_grad:CKPT",
    ("ops/pallas_grad.py", "pallas_march_grad"):
        "ops.march_grad:march_grad_kernel",
    ("ops/pallas_grad.py", "make_composite"): "ops.march:march_step_rows",
    ("ops/pallas_render.py", "pallas_render_sample"):
        "ops.render:render_planes_kernel",
}

_NO_TIMER = ("device time is read from the profiler trace and `perf.spans`; "
             "nothing in the port used it")

# JAX names with no port twin, and why.
ABSENT = {
    ("ops/pallas_march.py", "recip_approx"):
        "the TPU approximate reciprocal with its VJP: the CUDA kernels' "
        "approx_recip route (csrc/march_step.cuh) and the gradient kernel's "
        "replay of it take its place; the plain versions divide exactly",
    ("ops/pallas_march.py", "make_div_recip"):
        "picks (div, recip) for the Pallas kernel body; the CUDA kernels pick "
        "the route by template instantiation at launch",
    ("perf/timer.py", "DeviceTimer"): _NO_TIMER,
    ("perf/timer.py", "time_jitted"): _NO_TIMER,
    ("perf/__init__.py", "DeviceTimer"): _NO_TIMER,
}


def _public_names(path):
    """The public top-level names of a module: its functions, classes and
    assigned names; a package's __init__ adds the names it imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


def _port_module(rel):
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["blackhole_simulation_tpu_torch", *parts])


def _resolve(spec):
    mod, name = spec.split(":")
    return getattr(importlib.import_module(
        f"blackhole_simulation_tpu_torch.{mod}"), name)


@pytest.mark.parametrize(
    "rel", sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")))
def test_every_public_name_has_a_twin(rel):
    missing = []
    try:
        module = importlib.import_module(_port_module(rel))
    except ModuleNotFoundError:
        module = None
    for name in _public_names(JAX / rel):
        key = (rel, name)
        if key in TWINS:
            _resolve(TWINS[key])
        elif key not in ABSENT and not hasattr(module, name):
            missing.append(name)
    assert not missing, f"{rel}: no port twin for {missing}"


def test_twin_and_absence_lists_are_current():
    """Every listed name is still public in the JAX package, and a listed
    absence is not quietly present in the port."""
    for rel, name in [*TWINS, *ABSENT]:
        assert name in _public_names(JAX / rel), (rel, name)
    for rel, name in ABSENT:
        try:
            module = importlib.import_module(_port_module(rel))
        except ModuleNotFoundError:
            continue
        assert not hasattr(module, name), (rel, name)
