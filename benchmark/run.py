#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card(s):

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port
(``blackhole_simulation_tpu_torch``). The cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``),
whose ``driver`` names the loop in ``drivers/``; the cell's limits are in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``. Set-up (imports, the card, kernel builds, the
scene and warm-up) is timed as ``setup_s``; then the window runs for
``--seconds``; then the program's state is freed and its outputs are
checked against the plain reference (``reference/``). With ``--trace 1``
the window runs under ``torch.profiler`` and the per-layer metrics are
read from its trace. The last line of standard output is one JSON object;
the numbers compared, each beside its limit, end standard error. Refuses
to run (exit 2, no result) without as many CUDA cards as the cell asks
for, and exits 3 with no result if JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# One host thread for the framework's and the math libraries' CPU work:
# the loops are one process driving the card, and idle worker threads
# only add jitter.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "blackhole_simulation_tpu")
# Run as a script, Python puts this directory first on the path, where
# its modules would shadow any standard module of the same name.
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path.pop(0)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in the file ``path`` (a name may hold dots, which an
    import statement could not take), registered as ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: the port's begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_spec(name: str) -> types.SimpleNamespace:
    """The cell's entry, configuration, traffic, limits and metrics."""
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    applies = lambda m: name in m.get("workloads", [name])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return types.SimpleNamespace(
        cell=cell, traffic=traffic,
        config=load_json(HERE / "configs" / f"{cell['config']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        driver=importlib.import_module(f"benchmark.drivers.{traffic['driver']}"))


def read_layer_metrics(spec, ctx: dict) -> dict:
    """Each per-layer metric's reader on the traced window; a reader that
    finds nothing returns None and its metric is left out."""
    out = {}
    for m in spec.per_layer:
        reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def power_limit() -> str | None:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)

    import torch

    torch.set_num_threads(1)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    # Build and kernel caches inside the checkout, at fixed paths (the
    # port's own nvcc builds go to <checkout>/build/kernels).
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    spec.seed, spec.seconds, spec.trace = args.seed, args.seconds, args.trace
    spec.device, spec.t_start = "cuda", T_START
    out = spec.driver.run(spec)

    found = forbidden_modules()
    if found:
        print(f"loaded in the measuring process: {found}", file=sys.stderr)
        return 3
    checks = out["checks"]
    correct = bool(out["correct"])
    metrics = {}
    if args.trace:
        metrics = read_layer_metrics(spec, out["layer"])
    else:
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": out["metrics"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
