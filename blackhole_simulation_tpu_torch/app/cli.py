"""Command-line front-end.

Counterpart of ``blackhole_simulation_tpu/app/cli.py``, with its
subcommands and their arguments:
  info       -- derived physics readout (JSON)
  render     -- still frame -> PNG
  animate    -- cinematic director sequence -> PNGs
  sweep      -- mesh-sharded batched camera sweep -> npz volume
  bench      -- preset sweep benchmark
  validate   -- per-feature cost measurement -> JSON
  fields     -- spacetime analytics fields -> .npz
  inverse    -- inverse rendering: recover spin from a target image
  live       -- interactive session (``app/live.py``)
  state      -- print the shareable state string

Run as ``python -m blackhole_simulation_tpu_torch [--device D] <subcommand>
...``. ``--device`` is the one option the JAX CLI does not have: the port's
entry points take ``device=``, where the JAX package reads
``JAX_PLATFORMS``. Unset, it resolves to ``cuda``
(``render/pipeline.resolve_device``) and raises where there is no CUDA
device; ``--device cpu`` runs the kernels' plain PyTorch versions. Every
subcommand passes it down.

``sweep`` runs on the device mesh (``parallel/mesh.py``). Under
``torchrun`` (WORLD_SIZE > 1) it starts ``torch.distributed`` from the
environment (NCCL with one rank per card; gloo with ``--device cpu``), and
every rank renders its shard of each frame; alone, it runs a one-device
mesh on ``--device``. Rank 0 writes the npz and prints the JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _add_param_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=["minimal", "balanced", "quality", "cinematic"])
    p.add_argument("--state", help="shareable #k=v&... state string")
    p.add_argument("--settings", help="settings JSON file to load/save")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a SimulationParams field")


def _params_from_args(args):
    from blackhole_simulation_tpu_torch.app.state import (
        SettingsStorage,
        decode_state,
    )
    from blackhole_simulation_tpu_torch.configs.simulation import (
        SimulationParams,
        apply_preset,
        clamp_params,
    )

    params = SimulationParams()
    if args.settings and os.path.exists(args.settings):
        params, _ = SettingsStorage(args.settings).load()
    if args.state:
        params = decode_state(args.state)
    if args.preset:
        params = apply_preset(params, args.preset)
    updates = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        field_types = {f.name: f.type for f in dataclasses.fields(SimulationParams)}
        if k not in field_types:
            raise SystemExit(f"unknown param {k!r}")
        t = field_types[k]
        updates[k] = (v in ("1", "true", "True")) if t == "bool" else (
            v if t == "str" else float(v)
        )
    if updates:
        params = clamp_params(dataclasses.replace(params, **updates))
    if args.settings:
        SettingsStorage(args.settings).save(params, args.preset)
    return params


def cmd_info(args) -> int:
    from blackhole_simulation_tpu_torch.engine import PhysicsEngine

    params = _params_from_args(args)
    eng = PhysicsEngine(mass=params.mass, spin=params.spin, device=args.device)
    out = {
        "mass": params.mass,
        "spin": params.spin,
        "event_horizon": eng.compute_horizon(),
        "isco_prograde": eng.compute_isco(True),
        "isco_retrograde": eng.compute_isco(False),
        "photon_sphere": eng.compute_photon_sphere(),
        "shadow_radius": eng.compute_shadow_radius(),
        "time_dilation_at_isco": eng.compute_dilation(eng.compute_isco(True)),
        "hawking_temperature_K(M_sun)": eng.compute_hawking_temperature(1.0),
    }
    eng.close()
    print(json.dumps(out, indent=1))
    return 0


def _save_frame(img, path: str) -> str:
    """Clamp the (H, W, 3) image to [0, 1] on its device, copy it to the
    host once and write the PNG."""
    from blackhole_simulation_tpu_torch.app.screenshot import save_png

    return save_png(img.clamp(0.0, 1.0).cpu().numpy(), path)


def cmd_render(args) -> int:
    from blackhole_simulation_tpu_torch.configs.simulation import (
        scene_from_params,
    )
    from blackhole_simulation_tpu_torch.render import render

    params = _params_from_args(args)
    scene = scene_from_params(params, width=args.width, height=args.height,
                              device=args.device)
    if args.certified:
        scene = dataclasses.replace(
            scene,
            march_cfg=dataclasses.replace(scene.march_cfg, refine_band=0.6,
                                          refine_budget=16384),
        )
    img = render(scene, n_samples=args.samples, device=args.device)
    path = _save_frame(img, args.out)
    print(f"wrote {path} ({args.width}x{args.height}, {args.samples} spp)")
    return 0


def cmd_animate(args) -> int:
    from blackhole_simulation_tpu_torch.configs.simulation import (
        scene_from_params,
    )
    from blackhole_simulation_tpu_torch.engine.cinema import DIRECTORS
    from blackhole_simulation_tpu_torch.render import Camera, render

    params = _params_from_args(args)
    director = DIRECTORS[args.director]
    os.makedirs(args.outdir, exist_ok=True)
    scene0 = scene_from_params(params, width=args.width, height=args.height,
                               device=args.device)
    for i in range(args.frames):
        r, theta, phi = director(i / args.fps)
        cam = Camera.create(
            r=r, theta=theta, phi=phi, fov=params.fov,
            width=scene0.camera.width, height=scene0.camera.height,
        )
        scene = dataclasses.replace(scene0, camera=cam)
        img = render(scene, n_samples=args.samples, device=args.device)
        _save_frame(img, os.path.join(args.outdir, f"frame_{i:05d}.png"))
        print(f"frame {i + 1}/{args.frames} r={r:.1f}", file=sys.stderr)
    print(f"wrote {args.frames} frames to {args.outdir}")
    return 0


def cmd_sweep(args) -> int:
    """The mesh-sharded batched camera sweep: each frame's rays shard over
    the mesh (``render_sharded``), the whole image is on every rank
    (``gather_image``), and rank 0 stacks the frames into one npz volume
    and prints {frames, shape, devices, mrays_per_s, out}."""
    import time

    import numpy as np
    import torch.distributed as dist

    from blackhole_simulation_tpu_torch.configs.simulation import (
        scene_from_params,
    )
    from blackhole_simulation_tpu_torch.engine.cinema import DIRECTORS
    from blackhole_simulation_tpu_torch.parallel import (
        gather_image,
        initialize_multihost,
        make_mesh,
        render_sharded,
    )
    from blackhole_simulation_tpu_torch.render import Camera

    started = False
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1 and not dist.is_initialized():
        initialize_multihost(num_processes=world, device=args.device)
        started = True
    try:
        params = _params_from_args(args)
        director = DIRECTORS[args.director]
        mesh = make_mesh(args.devices if args.devices > 0 else None,
                         device=args.device)
        lead = not dist.is_initialized() or dist.get_rank() == 0
        scene0 = scene_from_params(params, width=args.width,
                                   height=args.height, device=mesh.device)

        frames = []
        t0 = time.perf_counter()
        for i in range(args.frames):
            r, theta, phi = director(i * args.dt)
            cam = Camera.create(
                r=r, theta=theta, phi=phi, fov=params.fov,
                width=scene0.camera.width, height=scene0.camera.height,
            )
            scene = dataclasses.replace(scene0, camera=cam)
            img = gather_image(render_sharded(scene, mesh,
                                              n_samples=args.samples))
            frames.append(img.cpu().numpy())
            if lead:
                print(f"frame {i + 1}/{args.frames} r={r:.1f}",
                      file=sys.stderr)
        elapsed = time.perf_counter() - t0
        if lead:
            vol = np.stack(frames)
            np.savez(args.out, frames=vol)
            n_rays = args.frames * args.samples * vol.shape[1] * vol.shape[2]
            print(json.dumps({
                "frames": args.frames,
                "shape": list(vol.shape),
                "devices": mesh.size,
                "mrays_per_s": round(n_rays / elapsed / 1e6, 3),
                "out": args.out,
            }))
    finally:
        if started:
            dist.destroy_process_group()
    return 0


def _frame_sum(args):
    """render_frame(params) for the benchmark and the validator: one frame
    at the command's size, reduced to a host float (a wait per frame)."""
    import torch

    from blackhole_simulation_tpu_torch.configs.simulation import (
        scene_from_params,
    )
    from blackhole_simulation_tpu_torch.render import render

    def render_frame(params):
        scene = scene_from_params(params, width=args.width,
                                  height=args.height, device=args.device)
        return float(torch.sum(render(scene, n_samples=1,
                                      device=args.device)))

    return render_frame


def cmd_bench(args) -> int:
    from blackhole_simulation_tpu_torch.perf.benchmark import (
        BenchmarkController,
    )

    ctl = BenchmarkController(_frame_sum(args), seconds_per_preset=args.seconds)
    results = ctl.run()
    for r in results:
        print(json.dumps(dataclasses.asdict(r)))
    print(f"recommended preset: {BenchmarkController.recommend(results)}")
    return 0


def cmd_validate(args) -> int:
    from blackhole_simulation_tpu_torch.perf.validator import (
        PerformanceValidator,
    )

    validator = PerformanceValidator(_frame_sum(args), measure_s=args.seconds)
    report = validator.run()
    if args.out:
        PerformanceValidator.export_json(report, args.out)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(report, indent=1))
    return 0


def cmd_fields(args) -> int:
    import numpy as np

    from blackhole_simulation_tpu_torch.engine import PhysicsEngine

    params = _params_from_args(args)
    eng = PhysicsEngine(mass=params.mass, spin=params.spin, device=args.device)
    r = np.linspace(args.r_min, args.r_max, args.n_r)
    th = np.linspace(0.05, np.pi - 0.05, args.n_theta)
    out = {
        "r": r,
        "theta": th,
        "kretschmann": np.asarray(eng.compute_kretschmann_field(r, th)),
        "frame_drag": np.asarray(eng.compute_frame_drag_field(r, th)),
        "light_cone_tilt": np.asarray(eng.compute_light_cone_field(r, th)),
    }
    out["embedding_mesh"] = np.asarray(eng.generate_embedding_mesh())
    eng.close()
    np.savez(args.out, **out)
    print(f"wrote {args.out} ({', '.join(out)})")
    return 0


def cmd_inverse(args) -> int:
    from blackhole_simulation_tpu_torch.configs.simulation import (
        scene_from_params,
    )
    from blackhole_simulation_tpu_torch.parallel.checkpoint import (
        CheckpointManager,
    )
    from blackhole_simulation_tpu_torch.parallel.train import (
        InverseParams,
        fd_state_init,
        fd_state_params,
        inverse_render,
        make_fd_inverse_step,
    )
    from blackhole_simulation_tpu_torch.render import render_radiance

    device = args.device
    params = _params_from_args(args)
    scene = scene_from_params(params, width=args.width, height=args.height,
                              device=device)
    target = render_radiance(scene, device=device)
    print(f"target rendered at true spin {params.spin}")

    if args.checkpoint_dir:
        # Checkpoint the FD driver (the production optimizer: reverse-mode
        # gradients through a long march are chaos-corrupted).
        mgr = CheckpointManager(args.checkpoint_dir)
        step_fn = make_fd_inverse_step(scene, total_steps=args.steps,
                                       device=device)
        state = fd_state_init(InverseParams.init(spin=args.init_spin,
                                                 device=device))
        start, restored = mgr.restore_latest(state)
        if restored is not None:
            state = restored
            print(f"resumed from step {start}")
        else:
            start = 0
        for i in range(start, args.steps):
            state, loss = step_fn(state, target)
            if (i + 1) % max(args.steps // 5, 1) == 0:
                mgr.save(i + 1, state)
                print(f"step {i + 1}: loss {float(loss):.3e} "
                      f"spin {float(fd_state_params(state).spin):+.4f}")
        final = fd_state_params(state)
    else:
        final, losses = inverse_render(
            scene, target, n_steps=args.steps,
            init=InverseParams.init(spin=args.init_spin), device=device,
        )
        print(f"loss {losses[0]:.3e} -> {losses[-1]:.3e}")
    print(json.dumps({
        "true_spin": params.spin,
        "recovered_spin": float(final.spin),
        "error": abs(float(final.spin) - params.spin),
    }))
    return 0


def cmd_live(args) -> int:
    import numpy as np

    from blackhole_simulation_tpu_torch.app.live import run_live

    stats = run_live(
        width=args.width, height=args.height, mass=args.mass, spin=args.spin,
        frames=args.frames, script=args.script, out_dir=args.out_dir,
        term_cols=args.term_cols, quality=args.quality, device=args.device,
    )
    fps = np.asarray(stats["fps"][2:] or [0.0])
    print(json.dumps({
        "frames": stats["frames"],
        "fps_mean": round(float(fps.mean()), 2),
        "fps_p5": round(float(np.percentile(fps, 5)), 2),
        "final_scale": stats["scales"][-1] if stats["scales"] else None,
        "scale_changes": int(
            sum(1 for a, b in zip(stats["scales"], stats["scales"][1:])
                if a != b)
        ),
    }))
    return 0


def cmd_state(args) -> int:
    from blackhole_simulation_tpu_torch.app.state import encode_state

    params = _params_from_args(args)
    print(encode_state(params, full=args.full))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="blackhole_simulation_tpu_torch",
        description="Kerr black-hole renderer on PyTorch and CUDA",
    )
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where to run (default: cuda, and an error where "
                         "there is no CUDA device); cpu runs the kernels' "
                         "plain PyTorch versions")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("info", help="derived physics readout")
    _add_param_args(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("render", help="render a still to PNG")
    _add_param_args(p)
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--certified", action="store_true",
                   help="re-march the chaotic critical band at the "
                        "validation-grade reference config "
                        "(MarchConfig.refine_band; band classification "
                        "exact)")
    p.add_argument("--out", default="render.png")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("animate", help="render a cinematic sequence")
    _add_param_args(p)
    p.add_argument("--director", choices=["grand_survey", "descent"],
                   default="grand_survey")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--outdir", default="frames")
    p.set_defaults(fn=cmd_animate)

    p = sub.add_parser(
        "sweep", help="mesh-sharded batched camera sweep -> npz volume"
    )
    _add_param_args(p)
    p.add_argument("--director", choices=["grand_survey", "descent"],
                   default="grand_survey")
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--dt", type=float, default=1.0,
                   help="seconds of director time per frame")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--samples", type=int, default=1)
    p.add_argument("--devices", type=int, default=0, help="0 = all")
    p.add_argument("--out", default="sweep.npz")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="preset sweep benchmark")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--seconds", type=float, default=3.0)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("validate", help="per-feature cost measurement")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=270)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("fields", help="spacetime analytics fields -> npz")
    _add_param_args(p)
    p.add_argument("--r-min", type=float, default=1.2)
    p.add_argument("--r-max", type=float, default=20.0)
    p.add_argument("--n-r", type=int, default=64)
    p.add_argument("--n-theta", type=int, default=33)
    p.add_argument("--out", default="fields.npz")
    p.set_defaults(fn=cmd_fields)

    p = sub.add_parser("inverse", help="inverse-rendering demo")
    _add_param_args(p)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--init-spin", type=float, default=0.5)
    p.add_argument("--checkpoint-dir", default=None)
    p.set_defaults(fn=cmd_inverse)

    p = sub.add_parser(
        "live",
        help="interactive session: engine heartbeat + keyboard/scripted "
        "input -> adaptive-resolution render -> terminal display",
    )
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--mass", type=float, default=1.0)
    p.add_argument("--spin", type=float, default=0.9)
    p.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = until q)")
    p.add_argument("--script", choices=["orbit", "dive", "shake"],
                   default=None, help="canned input stream (headless)")
    p.add_argument("--out-dir", default=None, help="PNG stream directory")
    p.add_argument("--term-cols", type=int, default=120)
    p.add_argument("--quality", default="high")
    p.set_defaults(fn=cmd_live)

    p = sub.add_parser("state", help="print the shareable state string")
    _add_param_args(p)
    p.add_argument("--full", action="store_true")
    p.set_defaults(fn=cmd_state)

    return ap


def main(argv: list[str] | None = None) -> int:
    from blackhole_simulation_tpu_torch.render.pipeline import resolve_device

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)
