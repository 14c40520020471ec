"""Measured FP32 peak of the card: a synthetic pure-FMA CUDA kernel.

Counterpart of ``tools/vpu_peak.py`` (its Pallas kernel, :65, lives inside
its ``main()``): ``chains`` independent float32 chains x <- x * k + b per
thread (k = 1.0000001, b = 1e-7), ``unroll`` steps per loop iteration,
``iters`` iterations, enough independent work to be bound by the FP32 pipes
alone; the kernel is ``csrc/vpu_peak.cu``. Its measured rate of lane FMA
instructions, ``lane_fma_per_s``, is the rate at which the port's kernels
(built with ``--fmad=false``, so every counted add or multiply is one lane
instruction) can retire their hand-counted operations: ``chip_smoke.py``
divides by the larger of it and the published rate. ``flop_per_s`` counts an FMA as two operations, the
convention of the published float32 peak.

    python -m blackhole_simulation_tpu_torch.tools.vpu_peak [--iters 4096]
        [--grid BLOCKS] [--chains 8] [--unroll 8] [--reps 30]

prints one JSON line. It needs a CUDA device and raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json

import torch

K_MUL = 1.0000001
B_ADD = 1e-7
# The kernel's choices of chains and unroll (compile-time in csrc/vpu_peak.cu).
SIZES = (1, 2, 4, 8, 16)


def fma_chains_plain(x: torch.Tensor, iters: int, unroll: int) -> torch.Tensor:
    """The plain version: (chains, n) float32 starts -> (n,) float32 sums of
    the chains after iters * unroll steps of x * k + b, each step rounded
    once to float32 as ``__fmaf_rn`` rounds it, then the chains added in
    order in float32. A step runs in float64, where it is exact: x * k of
    two float32 values has at most 48 significant bits, and for x in
    [0.5, 4) it and b are multiples of 2^-47, so their sum fits in 53."""
    k = float(torch.tensor(K_MUL, dtype=torch.float32))
    b = float(torch.tensor(B_ADD, dtype=torch.float32))
    for _ in range(iters * unroll):
        x = (x.double() * k + b).float()
    acc = x[0]
    for c in range(1, x.shape[0]):
        acc = acc + x[c]
    return acc


def fma_chains(x: torch.Tensor, iters: int, unroll: int) -> torch.Tensor:
    """(chains, n) float32 starts -> (n,) chain sums. A CUDA tensor
    launches the probe kernel on the current stream and counts the launch
    in ``fma_chains.launches``; a CPU tensor runs ``fma_chains_plain``."""
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be float32 (chains, n), got {x.dtype} "
                         f"{tuple(x.shape)}")
    chains, n = x.shape
    if chains not in SIZES or unroll not in SIZES:
        raise ValueError(f"chains and unroll take {SIZES}")
    if x.device.type == "cpu":
        return fma_chains_plain(x, iters, unroll)
    if x.device.type != "cuda":
        raise ValueError(f"no probe for device {x.device}")
    lib = _library()
    x = x.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bh_fma_chains_launch(
            ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            n, iters, chains, unroll, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"probe launch failed: {lib.bh_error_string(err).decode()}")
    fma_chains.launches += 1
    return out


fma_chains.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    from blackhole_simulation_tpu_torch.ops.build import build

    lib = ctypes.CDLL(str(build("vpu_peak.cu")))
    lib.bh_fma_chains_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bh_fma_chains_launch.restype = ctypes.c_int
    lib.bh_error_string.argtypes = [ctypes.c_int]
    lib.bh_error_string.restype = ctypes.c_char_p
    lib.bh_threads_per_block.restype = ctypes.c_int
    return lib


def starts(chains: int, n: int, device, seed: int = 0) -> torch.Tensor:
    """The probe's (chains, n) float32 starts, uniform in [1, 2) from
    ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return 1.0 + torch.rand((chains, n), generator=g, device=device)


def measure(iters: int = 4096, grid: int | None = None, chains: int = 8,
            unroll: int = 8, reps: int = 30, seed: int = 0):
    """Time the probe on the current CUDA device: ``grid`` blocks (default
    16 per SM) of the kernel's threads, each running ``chains`` chains of
    ``iters * unroll`` FMAs from ``starts(chains, grid * threads, "cuda",
    seed)``; one warm-up call, then the mean over ``reps`` calls between
    CUDA events. Returns the tool's keys, unrounded, rates in operations
    per second, and the warm-up call's (n,) output, for holding against
    ``fma_chains_plain`` on the same starts."""
    if not torch.cuda.is_available():
        raise RuntimeError("the FP32 peak probe needs a CUDA device")
    dev = torch.device("cuda")
    threads = _library().bh_threads_per_block()
    if grid is None:
        grid = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    n = grid * threads
    x = starts(chains, n, dev, seed)
    out = fma_chains(x, iters, unroll)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fma_chains(x, iters, unroll)
    end.record()
    end.synchronize()
    per = start.elapsed_time(end) / 1e3 / reps
    fmas = n * chains * iters * unroll
    return {
        "grid": grid, "threads": threads, "chains": chains, "iters": iters,
        "unroll": unroll, "seconds_per_call": per,
        "lane_fma_per_s": fmas / per, "flop_per_s": 2 * fmas / per,
        "device": torch.cuda.get_device_name(dev),
    }, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--grid", type=int, default=None,
                    help="blocks (default: 16 per SM)")
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--unroll", type=int, default=8)
    ap.add_argument("--reps", type=int, default=30)
    a = ap.parse_args()
    out, _ = measure(a.iters, a.grid, a.chains, a.unroll, a.reps)
    out.update(
        lane_fma_per_s=out["lane_fma_per_s"] / 1e12,
        flop_per_s=out["flop_per_s"] / 1e12, unit="T/s",
        note="lane_fma_per_s is the measured ceiling for the hand-counted "
             "operations of kernels built with --fmad=false (1 FMA = 1 lane "
             "instruction = 2 FLOPs)")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
