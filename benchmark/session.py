"""One run of a one-process cell: set-up, the window (traced or not), the
memory peak, the program's state freed, then the checks against the
reference. A driver's object gives ``setup()``, ``window(seconds)``,
``release()``, ``checks()`` and, for a traced run, ``spans()`` (the
program's functions to record as spans) and ``work(seed)``."""

from __future__ import annotations

import time

import torch

from benchmark import trace as tracing


def run(spec, obj) -> dict:
    obj.setup()
    setup_s = time.perf_counter() - spec.t_start
    if spec.trace:
        prof, marks = tracing.Profiler(), []
        with prof, tracing.spans(obj.spans(), marks):
            w = obj.window(spec.seconds)
    else:
        w = obj.window(spec.seconds)
    peak = torch.cuda.max_memory_allocated() if spec.device == "cuda" else 0
    out = {"attempted": w["attempted"], "failed": w["failed"],
           "metrics": dict(w["metrics"], setup_s=setup_s),
           "memory_peak_bytes": peak, "window_s": w["window_s"]}
    if spec.trace:
        tr = tracing.read(prof, marks)
        del prof
        out.update(busy_s=tr.busy(), breakdown=tr.breakdown())
        out["layer"] = dict(obj.work(spec.seed + 1), trace=tr,
                            window_s=w["window_s"])
    obj.release()
    if spec.device == "cuda":
        torch.cuda.empty_cache()
    numbers = obj.checks()
    out["checks"] = {k: {"value": v, "limit": spec.limits[k]}
                     for k, v in numbers.items()}
    out["correct"] = (w["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in out["checks"].values()))
    return out
