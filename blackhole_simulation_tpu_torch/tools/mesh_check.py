"""Check and time the multi-device layer over every process of a
``torchrun`` world: one process per card on NCCL, or ``--device cpu`` on
gloo.

    torchrun --nproc_per_node 4 -m blackhole_simulation_tpu_torch.tools.mesh_check
    torchrun --nproc_per_node 4 -m blackhole_simulation_tpu_torch.tools.mesh_check \\
        --device cpu --width 64 --height 32

Every rank renders the flagship frame (bench.py's: Kerr a = 0.999,
spectral disk, 256 steps, the kernel path) with ``render_sharded`` over the
whole world, and takes one sharded AD step (``make_inverse_step``) and one
sharded FD step on the training scene (``tools/train_probe.py``) from spin
0.9 against a zero target. Rank 0 then holds them against itself alone: the
image bit for bit against ``render()`` of ``single_device_twin`` on its own
device, and the steps against the same steps on a mesh of one device
(``make_mesh(1)``) at tests/test_parallel.py's bars (loss rel < 1e-4, spin
|d| < 5e-5; FD loss rel < 1e-4, state vector |d| < 5e-4). Times: the
sharded frame and steps at the world's size (median of ``--reps`` calls,
CUDA events on rank 0, each call ending in the all-gather or all-reduce
that waits for every rank) beside rank 0's one-device times, and each
rank's march-kernel launches. Rank 0 prints one JSON line (with the card's
name and the world size); the exit code is 1 if a check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from blackhole_simulation_tpu_torch.ops.march_grad import march_grad_kernel
from blackhole_simulation_tpu_torch.ops.pallas_march import march_u
from blackhole_simulation_tpu_torch.parallel import (
    InverseParams,
    fd_state_init,
    initialize_multihost,
    make_fd_inverse_step,
    make_inverse_step,
    make_mesh,
    render_sharded,
)
from blackhole_simulation_tpu_torch.parallel.render import single_device_twin
from blackhole_simulation_tpu_torch.render import render
from blackhole_simulation_tpu_torch.tools.train_probe import (
    flagship_scene,
    train_scene,
)


def _timed(fn, reps, device):
    """(median ms, the last result) of ``reps`` calls of ``fn``: CUDA
    events on a card, the host clock after each call on the CPU."""
    times, out = [], None
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def _steps(scene, mesh, device, reps):
    """(AD loss, parameters, ms; FD loss, state vector, ms) of one step
    each on ``mesh`` from spin 0.9, zero target."""
    h, w = scene.camera.height, scene.camera.width
    params = InverseParams.init(spin=0.9, theta_cam=float(scene.camera.theta),
                                device=device)
    target = torch.zeros((h, w, 3), device=device)
    step = make_inverse_step(scene, mesh)
    ad_ms, ((p1, _), loss) = _timed(lambda: step(params, target), reps,
                                    device)
    fd = make_fd_inverse_step(scene, mesh)
    state = fd_state_init(params)
    fd_ms, ((vec, _), fd_loss) = _timed(lambda: fd(state, target), reps,
                                        device)
    return {"ad_loss": float(loss), "ad_params": [float(x) for x in
                                                  p1.leaves()],
            "ad_ms": ad_ms, "fd_loss": float(fd_loss),
            "fd_vec": vec.tolist(), "fd_ms": fd_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    initialize_multihost(num_processes=world, device=args.device)
    try:
        mesh = make_mesh(device=args.device)
        dev = mesh.device
        lead = mesh.rank == 0
        scene = flagship_scene(args.width, args.height)
        march_u.launches = march_grad_kernel.launches = 0
        img = render_sharded(scene, mesh)
        launches = {"render_march": march_u.launches}
        frame_ms, _ = _timed(lambda: render_sharded(scene, mesh), args.reps,
                             dev)
        tscene = train_scene(args.width, args.height)
        march_u.launches = march_grad_kernel.launches = 0
        sharded = _steps(tscene, mesh, dev, 1)
        launches.update(step_march=march_u.launches,
                        step_march_grad=march_grad_kernel.launches)
        sharded_t = _steps(tscene, mesh, dev, args.reps)
        sharded.update(ad_ms=sharded_t["ad_ms"], fd_ms=sharded_t["fd_ms"])
        all_launches = [None] * mesh.size
        if mesh.group is not None:
            dist.all_gather_object(all_launches, launches, group=mesh.group)
        else:
            all_launches = [launches]
        if not lead:
            if mesh.group is not None:
                dist.barrier(group=mesh.group)
            return 0
        twin = single_device_twin(scene)
        ref = render(twin, device=dev)
        single_ms, _ = _timed(lambda: render(twin, device=dev), args.reps,
                              dev)
        one = _steps(tscene, make_mesh(1, device=args.device), dev,
                     args.reps)
        checks = {
            "image_bit_equal": bool(torch.equal(img, ref)),
            "ad_loss_rel": abs(sharded["ad_loss"] / one["ad_loss"] - 1),
            "ad_spin_abs": abs(sharded["ad_params"][0]
                               - one["ad_params"][0]),
            "fd_loss_rel": abs(sharded["fd_loss"] / one["fd_loss"] - 1),
            "fd_vec_abs": max(abs(x - y) for x, y in zip(sharded["fd_vec"],
                                                         one["fd_vec"])),
        }
        # the rendering launch is timed five times after the counted one,
        # the steps once before the timed ones
        ok = (checks["image_bit_equal"] and checks["ad_loss_rel"] < 1e-4
              and checks["ad_spin_abs"] < 5e-5
              and checks["fd_loss_rel"] < 1e-4 and checks["fd_vec_abs"] < 5e-4
              and all(x["render_march"] == 1 and x["step_march"] == 10
                      and x["step_march_grad"] == 1 for x in all_launches))
        print(json.dumps({
            "ok": ok, "world": mesh.size, "backend": mesh.backend,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "frame": [args.width, args.height], "checks": checks,
            "frame_ms": {"world": frame_ms, "one_device": single_ms},
            "ad_step_ms": {"world": sharded["ad_ms"], "one_device":
                           one["ad_ms"]},
            "fd_step_ms": {"world": sharded["fd_ms"], "one_device":
                           one["fd_ms"]},
            "launches_per_rank": all_launches}))
        if mesh.group is not None:
            dist.barrier(group=mesh.group)
        return 0 if ok else 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
