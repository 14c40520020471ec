"""Bit identity of the kernels that shade (the render kernel, the march and
gradient kernels' jets, the composite and its VJP) between two checkouts,
with ptxas's registers and spills of each instantiation and nvcc's seconds
for render.cu:

    python tools/shade_parity.py --parent DIR [--out FILE]

DIR is another commit's tree (``git archive <commit> | tar -x -C DIR``).
Each tree runs the same calls through its own package in a process of its
own (so each builds its kernels with its own flags and forms its own host
arguments), hashes every output (NaN as one NaN) and reports its builds;
the two reports are then compared. Exits 1 if any output differs. Needs a
CUDA card; ``--dump FILE`` runs one tree's side alone.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import dataclasses as dc
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
W, H = 1920, 1080


def digest(x) -> dict:
    """sha256 of a tensor's bytes with every NaN as one NaN."""
    import torch

    x = x.detach()
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full_like(x, math.nan), x)
    b = x.contiguous().cpu().numpy().tobytes()
    return {"sha": hashlib.sha256(b).hexdigest()[:24],
            "shape": list(x.shape), "dtype": str(x.dtype)}


def render_cases(dev) -> dict:
    """The render kernel's instantiations on the flagship cell's scene."""
    import torch
    from benchmark.director import track
    from benchmark.drivers.frames import port_scene
    from blackhole_simulation_tpu_torch.models.nrs import nrs_init
    from blackhole_simulation_tpu_torch.ops.render import render_planes_kernel
    from blackhole_simulation_tpu_torch.render.pipeline import kernel_inputs

    config = json.loads((Path("benchmark/configs/flagship_1080p.json"))
                        .read_text())
    base = port_scene(dict(config, width=W, height=H), track(64)[0], dev)
    feats = base.features
    nrs = nrs_init(0, device=dev)

    def case(feat=None, disk=None, **cfg):
        sc = dc.replace(base, march_cfg=dc.replace(base.march_cfg, **cfg))
        if feat:
            sc = dc.replace(sc, features=dc.replace(feats, **feat))
        if disk:
            sc = dc.replace(sc, disk=dc.replace(sc.disk, **disk))
        if feat and feat.get("nrs_far_field"):
            sc = dc.replace(sc, nrs_params=nrs)
        return sc

    extras = dict(feat=dict(shadow_overlay=True, nrs_far_field=True),
                  start_jitter=0.5)
    scenes = {
        "flagship": case(),
        "exact": case(approx_recip=False),
        "ab3": case(multistep=True),
        "ab3_exact": case(multistep=True, approx_recip=False),
        "jets": case(feat=dict(jets=True)),
        "jets_exact": case(feat=dict(jets=True), approx_recip=False),
        "extras": case(**extras),
        "extras_exact": case(**extras, approx_recip=False),
        "extras_ab3": case(**extras, multistep=True),
        "extras_jets": case(feat=dict(jets=True, shadow_overlay=True,
                                      nrs_far_field=True), start_jitter=0.5),
        "band": case(refine_band=0.5, refine_pole_w=0.05),
        "kmax8": case(max_crossings=8),
        "analytic": case(feat=dict(spectral_lut=False)),
        "artistic_powf": case(feat=dict(spectral_lut=False),
                              disk=dict(artistic_rgb=(1.0, 0.6, 0.3),
                                        beaming_exponent=2.7,
                                        outer_falloff=3.3)),
    }
    out = {}
    for name, sc in scenes.items():
        row, st = kernel_inputs(sc, None, dev)
        steps = torch.zeros((sc.camera.height, sc.camera.width),
                            dtype=torch.int32, device=dev)
        planes = render_planes_kernel(row, st, steps)
        out[f"render/{name}/planes"] = digest(planes)
        out[f"render/{name}/steps"] = digest(steps)
    return out


def march_cases(dev) -> dict:
    """The march kernel's and the gradient kernel's jets (and the start
    offset's hash) in float32 and float64."""
    import torch
    from blackhole_simulation_tpu_torch.ops.march_grad import (
        march_grad_kernel)
    from blackhole_simulation_tpu_torch.ops.pallas_march import march_u
    from blackhole_simulation_tpu_torch.render.camera import (
        Camera, camera_rays_u)
    from blackhole_simulation_tpu_torch.render.march import (
        MarchConfig, _march_inputs)
    from blackhole_simulation_tpu_torch.render.shading import JetParams

    out = {}
    cam = Camera.create(r=30.0, theta=0.9, fov=1.0, width=480, height=270)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        m = torch.tensor(1.0, dtype=dtype, device=dev)
        a = torch.tensor(0.9, dtype=dtype, device=dev)
        rays = camera_rays_u(cam, m, a, dtype=dtype)
        for name, cfg in (("jets", MarchConfig(max_steps=96)),
                          ("jets_offset", MarchConfig(max_steps=96,
                                                      start_jitter=0.5))):
            if dtype == torch.float64 and name == "jets_offset":
                continue
            args = _march_inputs(rays, m, a, cfg, None)
            outs = march_u(*args, cfg, JetParams())
            for i, x in enumerate(outs):
                out[f"march/{name}/{tag}/{i}"] = digest(x)
        cfg = MarchConfig(max_steps=64)
        args = _march_inputs(rays, m, a, cfg, None)
        outs = march_u(*args, cfg, JetParams())
        n, k = args[0].shape[1], cfg.max_crossings
        g = torch.Generator(device="cpu").manual_seed(2)
        f = lambda *s: (0.5 + torch.rand(*s, generator=g, dtype=dtype)).to(dev)
        ct_fin = f(8, n)
        ct_fin[4] = 0.0
        got = march_grad_kernel(*args, cfg, ct_fin, f(k, n), f(k, n),
                                f(k, n), f(n), outs[7], f(3, n), JetParams())
        for i, x in enumerate(got):
            out[f"grad/jets/{tag}/{i}"] = digest(x)
    return out


def composite_cases(dev, usage: dict) -> dict:
    """The composite forward and VJP on the inverse cell's rows after its
    first stage's 64 march steps: float32 and float64, analytic and
    Chebyshev, with and without the starfield and the glow."""
    import torch
    from blackhole_simulation_tpu_torch.configs.simulation import (
        SimulationParams, scene_from_params)
    from blackhole_simulation_tpu_torch.geometry import metrics
    from blackhole_simulation_tpu_torch.ops import build as kbuild
    from blackhole_simulation_tpu_torch.ops import composite as C
    from blackhole_simulation_tpu_torch.render.camera import camera_rays_u
    from blackhole_simulation_tpu_torch.render.march import march_rows
    from blackhole_simulation_tpu_torch.render.pipeline import (
        _mass_spin, conserved_lam)
    from blackhole_simulation_tpu_torch.render.shading import (
        spectral_kernel_tables)

    scene = scene_from_params(SimulationParams(), width=W, height=H,
                              device=dev)
    scene = dc.replace(scene, march_cfg=dc.replace(
        scene.march_cfg, use_pallas=False, max_steps=64))
    cheb_scene = dc.replace(
        scene, features=dc.replace(scene.features, spectral_lut=True),
        spectral_coeffs=spectral_kernel_tables(
            float(scene.bh.mass), float(scene.bh.spin), scene.disk))
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[1]
        m, a = _mass_spin(scene, dev, dtype)
        with torch.no_grad():
            rays = camera_rays_u(scene.camera, m, a, dtype=dtype)
            rows = march_rows(rays, m, a, scene.march_cfg)
        x = (m, a, metrics.isco_t(m, a), metrics.photon_sphere_t(m, a),
             rows.hit, rows.cross_r, rows.cross_phi, rows.cross_t,
             rows.n_crossings, rows.r_min_ph, conserved_lam(rays),
             rows.state_u, None)
        ds = torch.tensor(1.1, dtype=dtype, device=dev)
        is_ = torch.tensor(0.9, dtype=dtype, device=dev)
        n = rows.hit.shape[0]
        g = torch.Generator(device="cpu").manual_seed(5)
        g_rgb = torch.randn((3, n), generator=g, dtype=dtype).to(dev)
        for disk, sc in (("analytic", scene), ("cheb", cheb_scene)):
            c_all = C.CompositeStatic.of(sc)
            for sky, c in (("sky", c_all),
                           ("nosky", dc.replace(c_all, stars=None,
                                                glow=False))):
                key = f"composite/{tag}/{disk}/{sky}"
                out[f"{key}/forward"] = digest(
                    C.composite_kernel(c, *x, ds, is_))
                vjp = C.composite_vjp_kernel(c, *x, g_rgb, ds, is_)
                for name in sorted(vjp):
                    out[f"{key}/vjp/{name}"] = digest(vjp[name])
                usage[f"composite.cu {key.split('/', 1)[1]}"] = (
                    kbuild.parse_ptxas(kbuild.ptxas_report(
                        "composite.cu", 4, C.variant(c, dtype))))
    return out


def dump(path: Path) -> None:
    import torch
    from blackhole_simulation_tpu_torch.ops import build as kbuild

    dev = torch.device("cuda")
    report = {"device": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    kbuild.build("render.cu")
    report["render_build_s"] = time.perf_counter() - t0
    composite = [("composite.cu", 4, (f"-DBH_F64={f64}", f"-DBH_DISK={disk}",
                                      f"-DBH_STAR={sky}", f"-DBH_GLOW={sky}"))
                 for f64 in (0, 1) for disk in (1, 2) for sky in (0, 1)]
    with cf.ThreadPoolExecutor(8) as ex:   # nvcc runs in parallel
        list(ex.map(lambda a: kbuild.build(*a), [
            ("render.cu", 8), ("march.cu", 4), ("march_grad.cu", 4),
            *composite]))
    usage = {}
    got = {}
    got.update(render_cases(dev))
    got.update(march_cases(dev))
    got.update(composite_cases(dev, usage))
    torch.cuda.synchronize()
    for src, kmax in (("render.cu", 4), ("render.cu", 8), ("march.cu", 4),
                      ("march_grad.cu", 4)):
        usage[f"{src} k{kmax}"] = kbuild.parse_ptxas(
            kbuild.ptxas_report(src, kmax))
    report["outputs"] = got
    report["ptxas"] = usage
    path.write_text(json.dumps(report, indent=1))


def run_tree(root: Path, out: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    subprocess.run([sys.executable, str(HERE), "--dump", str(out)],
                   cwd=root, env=env, check=True)
    return json.loads(out.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--dump", type=Path)
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/shade_parity.json"))
    args = ap.parse_args(argv)
    if args.dump:
        sys.path.insert(0, os.getcwd())
        dump(args.dump)
        return 0
    work = Path("build/shade_parity")
    work.mkdir(parents=True, exist_ok=True)
    parent = run_tree(args.parent.resolve(), (work / "parent.json").resolve())
    this = run_tree(HERE.parents[1], (work / "this.json").resolve())
    differ = sorted(k for k in set(parent["outputs"]) | set(this["outputs"])
                    if parent["outputs"].get(k) != this["outputs"].get(k))
    ptxas = {k: {"parent": parent["ptxas"].get(k), "this": this["ptxas"][k]}
             for k in this["ptxas"]}
    result = {"device": this["device"], "outputs": len(this["outputs"]),
              "differ": differ,
              "render_build_s": {"parent": parent["render_build_s"],
                                 "this": this["render_build_s"]},
              "ptxas": ptxas,
              "ptxas_differ": sorted(k for k, v in ptxas.items()
                                     if v["parent"] != v["this"])}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps({k: result[k] for k in ("device", "outputs", "differ",
                                             "render_build_s",
                                             "ptxas_differ")}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
