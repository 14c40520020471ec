"""Device timing: host dispatch against device execution.

Counterpart of ``blackhole_simulation_tpu/perf/timer.py``: ``DeviceTimer``
and ``time_jitted`` keep their names and signatures, with
``torch.cuda.synchronize`` of the devices the result's tensors are on in
place of ``jax.block_until_ready``. Tensors on the CPU are ready when they
are returned, so there is nothing to wait on. As in the JAX twin,
``device_ms`` is the total minus the dispatch time.
"""

from __future__ import annotations

import time

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _block_until_ready(tree):
    """Wait for the work behind every CUDA tensor in ``tree`` (a tensor or
    nested lists, tuples and dicts of them); returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


class DeviceTimer:
    """Measure device execution by bracketing a wait for the result.

    begin() -> token; end(token, arrays) waits for the arrays and returns
    (total_ms, device_ms): device_ms is the total less the host-side
    dispatch time, when one was marked.
    """

    def __init__(self):
        self.last_total_ms = 0.0
        self.last_device_ms = 0.0

    def begin(self) -> float:
        return time.perf_counter()

    def mark_dispatched(self, t0: float) -> float:
        return time.perf_counter() - t0

    def end(self, t0: float, arrays, dispatch_s: float | None = None):
        _block_until_ready(arrays)
        total = time.perf_counter() - t0
        self.last_total_ms = total * 1e3
        if dispatch_s is not None:
            self.last_device_ms = max(total - dispatch_s, 0.0) * 1e3
        else:
            self.last_device_ms = self.last_total_ms
        return self.last_total_ms, self.last_device_ms


def time_jitted(fn, *args, iters: int = 5, warmup: int = 1):
    """min/mean wall time of a call after ``warmup`` calls (which take any
    first-call build). Returns a dict."""
    for _ in range(warmup):
        _block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return {
        "best_s": min(times),
        "mean_s": sum(times) / len(times),
        "iters": iters,
    }
