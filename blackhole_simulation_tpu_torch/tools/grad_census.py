"""Census of the gradient kernel on the 1080p AD frame's rays, and its
comparison with another build of ``csrc/march_grad.cu``.

On the card, for the rays whose gradient-kernel arguments one
differentiable 1080p ``render_radiance`` records (the flagship staged
physics of ``chip_smoke.py`` phases 22-23: float64, float64 with the jets,
the float32 exact route with and without the jets, and the float32
approx_recip route of the training step on the same rays), it reports:

* each instantiation's registers and spill (ptxas) and the SASS census of
  its replay loop and its reverse loop (``tools/sass_census.py``);
* the kernel's time alone over back-to-back launches (CUDA events), its
  launch shape and, for float64, the lane efficiency of its warps;
* the lane efficiency of one thread per ray on these rays: each ray's live
  checkpoint blocks in warps of 32 consecutive rays
  (``block_lane_efficiency``).

With ``--parent DIR`` (the ``csrc/`` directory of another commit, e.g. the
parent's, unpacked by ``git archive`` into ``build/``) it also builds that
directory's ``march_grad.cu`` and, on every recorded case, launches both
kernels on the same arguments in turns (parent, this, this, parent),
requires each ray's outputs (``cty0`` (7, N), ``ctp`` (4, N)) bit-identical,
and compares the float kernels' machine code (``cuobjdump -sass``). The
parent is launched through its own C interface (``bh_march_grad_launch64``
without a ray pool, the interface before the float64 kernel took one);
``--parent-pool`` says the parent takes one too. It times the parent's
replay alone, from a copy of the parent's source cut after its replay
(phase 1), at the parent's resident warps (its shared memory per block
raised until the occupancy API gives the parent's blocks per SM) and at its
own. Copies are built under ``build/grad_census/`` from text edits of the
copy, never of the checkout's source.

``--variants`` builds copies of this checkout's ``march_grad.cu`` with
other values of the float64 kernels' constants (``VARIANTS``: the steps per
checkpoint block, the reverse kernel's resident blocks per SM, threads per
block and refill threshold) and times each on the float64 cases in turns
with the committed build, each held bit-identical to it. The lane
efficiency of the float64 reverse kernel's warps comes from a copy that
counts, per block a warp reverses, the live steps of its lanes and 32 times
the largest (``count_lanes``).

    python -m blackhole_simulation_tpu_torch.tools.grad_census
        [--parent DIR [--parent-pool]] [--variants] [--out FILE]

prints one JSON object (and writes it to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from blackhole_simulation_tpu_torch.ops import build as kbuild
from blackhole_simulation_tpu_torch.ops.march_grad import (
    CKPT,
    CKPT_F64,
    grad_kernel_shape,
    march_grad_kernel,
    march_grad_rows,
)
from blackhole_simulation_tpu_torch.ops.pallas_march import (
    c_jet_params,
    c_march_params,
    march_u,
    scalar_params,
)
from blackhole_simulation_tpu_torch.render.camera import Camera
from blackhole_simulation_tpu_torch.render.march import MarchConfig
from blackhole_simulation_tpu_torch.render.pipeline import (
    Features,
    Scene,
    render_radiance,
)
from blackhole_simulation_tpu_torch.tools import sass_census

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "blackhole_simulation_tpu_torch" / "csrc"
WORK = ROOT / "build" / "grad_census"
F64 = torch.float64
# The flagship physics on the staged route (chip_smoke.py's AD_CFG and
# F64_CFG): exact divides, one midpoint iteration, 256 steps.
AD_CFG = MarchConfig(max_steps=256, step_rate=0.2, far_step_cap_rate=0.4,
                     far_boost_radius=20.0, midpoint_iters=1,
                     shadow_precull=True)
LAUNCHES = 3
# The float64 kernels' constants that --variants sets, and the values of
# each variant: (steps per checkpoint block, the reverse kernel's resident
# blocks per SM, its threads per block, its refill threshold), the same
# for the instantiations without and with the jets.
CONSTANTS = ("CKPT_F64", ("MIN_BLOCKS_F64", "MIN_BLOCKS_F64_JETS"),
             "THREADS_F64", ("REFILL_F64", "REFILL_F64_JETS"))
VARIANTS = tuple(
    [(4, 8, 64, r) for r in (2, 4, 6, 8, 12, 16, 20, 24, 28, 32)]
    + [(4, 6, 64, r) for r in (2, 4, 6, 8, 12, 16, 20, 24, 32)]
    + [(4, 7, 64, 20), (4, 7, 64, 32), (4, 5, 64, 32), (4, 5, 96, 20),
       (4, 3, 128, 32), (8, 4, 64, 32), (2, 8, 64, 32)])


def ad_frame_args(jets: bool, dtype=F64, width=1920, height=1080):
    """The gradient kernel's arguments that one differentiable
    ``render_radiance`` of the flagship scene (with the jets' emission when
    ``jets``) in ``dtype`` records, its seven leaves 0-d tensors on the
    card, and the march kernel's outputs on the frame's march arguments."""
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    scene = Scene.create(mass=1.0, spin=0.999, camera=cam, march_cfg=AD_CFG,
                         features=Features(spectral_lut=True, jets=jets))
    t = lambda v: torch.tensor(float(v), dtype=dtype, device="cuda",
                               requires_grad=True)
    names = ("r", "theta", "phi", "fov", "roll")
    leaves = [t(scene.bh.mass), t(scene.bh.spin)] + [
        t(getattr(cam, k)) for k in names]
    sc = dataclasses.replace(
        scene, bh=dataclasses.replace(scene.bh, mass=leaves[0],
                                      spin=leaves[1]),
        camera=dataclasses.replace(cam, **dict(zip(names, leaves[2:]))))
    march_u.record, march_grad_kernel.record = [], []
    try:
        torch.autograd.grad(render_radiance(sc, dtype=dtype).mean(), leaves)
        torch.cuda.synchronize()
        m_args, g_args = march_u.record[0], march_grad_kernel.record[0]
    finally:
        march_u.record = march_grad_kernel.record = None
    with torch.no_grad():
        outs = march_u(*m_args)
    return g_args, outs


def approx_args(g_args):
    """The training step's route on the same rays: ``g_args`` with
    MarchConfig.approx_recip set and the forward's r_min from the march
    kernel on that route."""
    cfg = dataclasses.replace(g_args[6], approx_recip=True)
    with torch.no_grad():
        outs = march_u(*g_args[:6], cfg)
    return (*g_args[:6], cfg, *g_args[7:12], outs[7], *g_args[13:]), outs


def block_lane_efficiency(steps: torch.Tensor, ckpt: int = CKPT) -> float:
    """The share of one-thread-per-ray lane-blocks that hold a live block:
    each ray's checkpoint blocks (ceil(steps / ckpt), at least 1), in warps
    of 32 consecutive rays, over 32 x the warp's largest count (a warp
    walks its rays' blocks until its longest ray is done). A ray frozen by
    the sanity test has one live step more than its ``steps``; the count
    ignores it."""
    blocks = (steps.reshape(-1).long() + ckpt - 1) // ckpt
    blocks = blocks.clamp(min=1)
    pad = (-blocks.numel()) % 32
    warps = torch.cat([blocks, blocks.new_zeros(pad)]).reshape(-1, 32)
    return int(blocks.sum()) / (32 * int(warps.amax(dim=1).sum()))


def build_copy(csrc: Path, tag: str, edit=None, source: str = "march_grad.cu",
               work: Path = WORK, flags: tuple[str, ...] = ()
               ) -> tuple[Path, str]:
    """``source`` of a copy of ``csrc`` under ``work/<tag>``, its text
    first passed through ``edit`` (if any), built with ``ops/build.py``'s
    flags and ``flags``: (library, ptxas report)."""
    out = work / tag
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out / "csrc")
    src = out / "csrc" / source
    if edit is not None:
        text = src.read_text()
        new = edit(text)
        if new == text:
            raise RuntimeError(f"{tag}: the edit changed nothing")
        src.write_text(new)
    lib = out / f"lib{src.stem}.so"
    proc = subprocess.run([kbuild._nvcc(), *kbuild.NVCC_FLAGS, *flags, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {tag}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_entries(report: str) -> dict[str, list[int]]:
    """{kernel label: [registers, spill bytes]} of a ptxas -v report."""
    return {sass_census.label(e): [r, s]
            for e, r, s, _ in kbuild.parse_ptxas(report)}


REPLAY_ANCHOR = "  // ---- phase 2: reverse sweep over the live blocks ----"


def replay_only(text: str) -> str:
    """The one-kernel gradient's ``grad_body`` (the parent's, up to the
    float64 redesign) cut after its replay (phase 1): the checkpoints and
    the replay's outcome are written, nothing else."""
    return text.replace(REPLAY_ANCHOR, "  return;\n  // ---- phase 2 cut ----",
                        1)


def with_smem(text: str, f64_bytes: int) -> str:
    """The parent's double stack's shared memory per block set to
    ``f64_bytes``."""
    return re.sub(r"#define SMEM_BYTES_F64 \(.*\)",
                  f"#define SMEM_BYTES_F64 {f64_bytes}", text, count=1)


def with_constants(values) -> callable:
    """An edit of this checkout's ``march_grad.cu`` that sets CONSTANTS to
    ``values``."""
    def edit(text):
        for names, v in zip(CONSTANTS, values):
            for name in (names,) if isinstance(names, str) else names:
                text = re.sub(rf"#define {name} \d+\n",
                              f"#define {name} {v}\n", text, count=1)
        return text
    return edit


def count_lanes(text: str) -> str:
    """This checkout's float64 reverse kernel counting, per block a warp
    reverses, the sum of its live lanes' steps (pool[2..3], 64 bits) and 32
    x their largest count (pool[4..5]): their ratio over the launch is the
    lane efficiency of its warps."""
    anchor = "    // ---- backward through the tape ----\n"
    count = (
        "    {\n"
        "      const unsigned act = __activemask();\n"
        "      const int sum = __reduce_add_sync(act, n_live);\n"
        "      const int top = __reduce_max_sync(act, n_live);\n"
        "      if (lane == __ffs(act) - 1) {\n"
        "        atomicAdd(reinterpret_cast<unsigned long long*>(pool + 2),"
        " (unsigned long long)sum);\n"
        "        atomicAdd(reinterpret_cast<unsigned long long*>(pool + 4),"
        " 32ull * top);\n"
        "      }\n"
        "    }\n")
    return text.replace(anchor, count + anchor, 1)


def no_reverse(text: str) -> str:
    """This checkout's float64 launch with its reverse kernel left out: the
    replay kernel alone."""
    return text.replace("    kernel<<<grid, THREADS_F64, SMEM_BYTES_F64, ",
                        "    if (n < 0) kernel<<<grid, THREADS_F64, "
                        "SMEM_BYTES_F64, ", 1)


class GradLib:
    """A built ``march_grad.cu`` launched through ctypes: ``pool`` says
    whether its float64 launch takes a ray pool (this checkout's) or not
    (the interface before it)."""

    def __init__(self, path: Path, pool: bool):
        self.lib = lib = ctypes.CDLL(str(path))
        self.pool = pool
        for fn, real, ptrs in ((lib.bh_march_grad_launch, ctypes.c_float, 11),
                               (lib.bh_march_grad_launch64, ctypes.c_double,
                                12 if pool else 11)):
            fn.argtypes = ([ctypes.c_void_p] * ptrs
                           + [ctypes.c_int, ctypes.c_void_p, real]
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
        names = ["bh_march_grad_scratch"] + (
            ["bh_march_grad_scratch64"] if pool else [])
        for name in names:
            getattr(lib, name).argtypes = [ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
        lib.bh_march_grad_shape64.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.bh_march_grad_shape64.restype = None
        lib.bh_error_string.argtypes = [ctypes.c_int]
        lib.bh_error_string.restype = ctypes.c_char_p

    def shape64(self, jets: bool) -> dict:
        out = (ctypes.c_int * 6)()
        self.lib.bh_march_grad_shape64(ctypes.c_int(int(jets)), out)
        threads, smem, ckpt, blocks, r_threads, r_blocks = out
        shape = {"threads": threads, "smem_bytes": smem, "ckpt": ckpt,
                 "blocks_per_sm": blocks,
                 "warps_per_sm": blocks * threads // 32}
        if self.pool:
            shape["replay"] = {"threads": r_threads,
                               "blocks_per_sm": r_blocks,
                               "warps_per_sm": r_blocks * r_threads // 32}
        return shape

    def prepare(self, args):
        """The launch's tensors for ``march_grad_kernel``'s arguments."""
        (yt0, thr, m, a, r_h, r_ph, cfg, ct_fin, ct_cr, ct_cp, ct_ct,
         ct_rmin, rmin_fin, ct_jet, jets) = args
        dtype, dev, n = yt0.dtype, yt0.device, yt0.shape[1]
        f64 = dtype == F64
        flat = lambda x: x.detach().to(dtype).contiguous()
        rows7 = lambda x: flat(torch.cat([x[:4], x[5:8]]))
        scratch_fn = (self.lib.bh_march_grad_scratch64 if f64 and self.pool
                      else self.lib.bh_march_grad_scratch)
        t = dict(
            params=scalar_params(m, a, r_h, r_ph, dev, dtype),
            y=rows7(yt0), thr=flat(thr), ctf=rows7(ct_fin),
            ctc=flat(torch.cat([ct_cr, ct_cp, ct_ct])),
            ct_rmin=flat(ct_rmin), rmin=flat(rmin_fin),
            cty0=torch.empty((7, n), dtype=dtype, device=dev),
            ctp=torch.empty((4, n), dtype=dtype, device=dev),
            scratch=torch.empty(scratch_fn(cfg.max_steps) * n, dtype=dtype,
                                device=dev),
            pool=torch.zeros(8, dtype=torch.int32, device=dev),
            ctj=None if jets is None else flat(ct_jet))
        t["c_mp"] = c_march_params(cfg, dtype)
        t["c_jets"] = c_jet_params(jets, dtype)
        t["n"], t["clip"], t["jets"] = n, cfg.cotangent_clip, jets
        return t

    def launch(self, t) -> None:
        f64 = t["y"].dtype == F64
        fn = (self.lib.bh_march_grad_launch64 if f64
              else self.lib.bh_march_grad_launch)
        real = ctypes.c_double if f64 else ctypes.c_float
        p = lambda x: ctypes.c_void_p(x.data_ptr())
        pool = (p(t["pool"]),) if f64 and self.pool else ()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(p(t["params"]), p(t["y"]), p(t["thr"]), p(t["ctf"]),
                 p(t["ctc"]), p(t["ct_rmin"]), p(t["rmin"]), p(t["cty0"]),
                 p(t["ctp"]), p(t["scratch"]), ctypes.c_void_p(0), *pool,
                 ctypes.c_int(t["n"]), ctypes.byref(t["c_mp"]),
                 real(t["clip"]),
                 ctypes.c_void_p(0 if t["ctj"] is None
                                 else t["ctj"].data_ptr()),
                 None if t["jets"] is None else ctypes.byref(t["c_jets"]),
                 ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError("gradient kernel launch failed: "
                               + self.lib.bh_error_string(err).decode())


def event_ms(fn, n: int = LAUNCHES) -> float:
    """ms per call of ``fn`` over ``n`` calls back to back (CUDA events),
    after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaNs of the same payload, zeros of the same
    sign)."""
    view = torch.int64 if a.dtype == F64 else torch.int32
    return a.shape == b.shape and torch.equal(a.view(view), b.view(view))


def lane_efficiency(lib: GradLib, args) -> float:
    """The counted lane efficiency of a ``count_lanes`` build on
    ``args``."""
    t = lib.prepare(args)
    lib.launch(t)
    torch.cuda.synchronize()
    c = t["pool"].view(torch.int64).tolist()
    return c[1] / c[2] if c[2] else 1.0


def float_sass(lib: Path) -> dict[str, str]:
    """{float kernel label: its instructions (addresses and encodings
    dropped)} of a library."""
    out = {}
    for name, instrs in sass_census.parse(sass_census.sass(lib)).items():
        label = sass_census.label(name)
        if label.startswith("march_grad_kernel<"):
            out[label] = "\n".join(text for _, text in instrs)
    return out


def recorded_cases() -> dict:
    """{case: (gradient-kernel arguments, the march kernel's outputs)} of
    the 1080p AD frame."""
    cases = {}
    for name, jets, dtype in (("float64", False, F64),
                              ("float64 jets", True, F64),
                              ("float32 exact", False, torch.float32),
                              ("float32 exact jets", True, torch.float32)):
        cases[name] = ad_frame_args(jets, dtype)
    cases["float32 approx_recip"] = approx_args(cases["float32 exact"][0])
    return cases


def census(parent: Path | None, parent_pool: bool, variants: bool) -> dict:
    out = {"device": torch.cuda.get_device_name(0)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    lib_path = kbuild.build("march_grad.cu")
    text = sass_census.sass(lib_path)
    out["registers_spill"] = {sass_census.label(e): [r, s] for e, r, s
                              in kbuild.ptxas_usage("march_grad.cu")}
    out["replay_sass"] = sass_census.census(text)
    out["reverse_sass"] = sass_census.reverse_census(text)
    this = GradLib(lib_path, pool=True)
    builds = {}
    with ThreadPoolExecutor(8) as ex:
        jobs = {"count": ex.submit(build_copy, CSRC, "count", count_lanes),
                "replay": ex.submit(build_copy, CSRC, "replay", no_reverse)}
        if parent is not None:
            jobs["parent"] = ex.submit(build_copy, parent, "parent")
            if REPLAY_ANCHOR in (
                    parent / "march_grad.cu").read_text():
                jobs["parent_replay"] = ex.submit(
                    build_copy, parent, "parent_replay", replay_only)
        if variants:
            for v in VARIANTS:
                tag = "v_" + "_".join(map(str, v))
                jobs[tag] = ex.submit(build_copy, CSRC, tag,
                                      with_constants(v))
        for k, f in jobs.items():
            builds[k] = f.result()
    cases = recorded_cases()
    counter = GradLib(builds["count"][0], pool=True)
    replay = GradLib(builds["replay"][0], pool=True)
    for name, (args, outs) in cases.items():
        t = this.prepare(args)
        steps = outs[2]
        f64 = args[0].dtype == F64
        rec = {
            "rays": int(steps.numel()),
            "steps_per_ray": float(steps.double().mean()),
            "steps_sum": int(steps.long().sum()),
            "ms": event_ms(lambda: this.launch(t)),
            "shape": grad_kernel_shape(args[6].approx_recip, args[14]
                                       is not None, args[0].dtype),
            "block_lane_efficiency_one_per_thread": block_lane_efficiency(
                steps, CKPT_F64 if f64 else CKPT),
        }
        this.launch(t)
        rows, ctp = march_grad_rows(*args)
        torch.cuda.synchronize()
        rec["wrapper_bit_identical"] = (same_bits(rows, t["cty0"])
                                        and same_bits(ctp, t["ctp"]))
        if f64:
            rec["lane_efficiency"] = lane_efficiency(counter, args)
            rt = replay.prepare(args)
            rec["replay_ms"] = event_ms(lambda: replay.launch(rt))
        out[name] = rec
        print(f"{name}: {json.dumps(rec)}", flush=True)
    if parent is not None:
        out["parent"] = compare_parent(builds, parent_pool, this, cases,
                                       lib_path)
    if variants:
        out["variants"] = compare_variants(builds, this, cases, out)
    return out


def compare_parent(builds, parent_pool, this, cases, lib_path) -> dict:
    """The parent's build against this checkout's on every recorded case:
    bit-identity of the per-ray outputs, the times in turns, the parent's
    replay alone, and the float kernels' machine code."""
    res = {}
    plib_path, preport = builds["parent"]
    res["registers_spill"] = ptxas_entries(preport)
    ptext = sass_census.sass(plib_path)
    res["replay_sass"] = sass_census.census(ptext)
    res["reverse_sass"] = sass_census.reverse_census(ptext)
    mine, theirs = float_sass(lib_path), float_sass(plib_path)
    res["float_sass_identical"] = {k: mine.get(k) == v
                                   for k, v in theirs.items()}
    pk = GradLib(plib_path, pool=parent_pool)
    full = pk.shape64(False)
    res["shape64"] = full
    rk = sk = None
    if "parent_replay" in builds:
        rk = GradLib(builds["parent_replay"][0], pool=parent_pool)
        # the parent's replay alone at its resident blocks per SM: its
        # shared memory per block raised to an equal share of the SM's
        smem_same = 232448 // max(full["blocks_per_sm"], 1) - 1024
        slib, _ = build_copy(Path(builds["parent"][0]).parent / "csrc",
                             "parent_replay_same",
                             lambda t: with_smem(replay_only(t), smem_same))
        sk = GradLib(slib, pool=parent_pool)
        res["replay_shape64"] = {"own": rk.shape64(False),
                                 "at_full": sk.shape64(False)}
    for name, (args, _) in cases.items():
        pt, tt = pk.prepare(args), this.prepare(args)
        times = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            fn = ((lambda: pk.launch(pt)) if who == "parent"
                  else (lambda: this.launch(tt)))
            times[who].append(event_ms(fn))
        pk.launch(pt)
        this.launch(tt)
        torch.cuda.synchronize()
        case = {"parent_ms": times["parent"], "this_ms": times["this"],
                "cty0_bit_identical": same_bits(tt["cty0"], pt["cty0"]),
                "ctp_bit_identical": same_bits(tt["ctp"], pt["ctp"]),
                "cty0_max_abs": float((tt["cty0"] - pt["cty0"]).abs().max()),
                "ctp_max_abs": float((tt["ctp"] - pt["ctp"]).abs().max())}
        if args[0].dtype == F64 and rk is not None:
            rt, st = rk.prepare(args), sk.prepare(args)
            case["parent_replay_only_ms"] = event_ms(lambda: rk.launch(rt))
            case["parent_replay_at_its_occupancy_ms"] = event_ms(
                lambda: sk.launch(st))
        res[name] = case
        print(f"parent vs this, {name}: {json.dumps(case)}", flush=True)
    return res


def compare_variants(builds, this, cases, out) -> dict:
    """Each variant build on the float64 cases, in turns with this
    checkout's build, its outputs bit-identical to this build's."""
    res = {}
    for v in VARIANTS:
        tag = "v_" + "_".join(map(str, v))
        lib_path, report = builds[tag]
        vk = GradLib(lib_path, pool=True)
        rec = {"constants": dict(zip(
                   [c if isinstance(c, str) else "/".join(c)
                    for c in CONSTANTS], v)),
               "registers_spill": {k: r for k, r in
                                   ptxas_entries(report).items()
                                   if "f64" in k},
               "shape64": vk.shape64(False)}
        for name, (args, _) in cases.items():
            if args[0].dtype != F64:
                continue
            vt, tt = vk.prepare(args), this.prepare(args)
            ms = {"variant": [], "this": []}
            for who in ("variant", "this", "this", "variant"):
                fn = ((lambda: vk.launch(vt)) if who == "variant"
                      else (lambda: this.launch(tt)))
                ms[who].append(event_ms(fn))
            vk.launch(vt)
            this.launch(tt)
            torch.cuda.synchronize()
            rec[name] = {**ms, "bit_identical": same_bits(vt["cty0"],
                                                          tt["cty0"])
                         and same_bits(vt["ctp"], tt["ctp"])}
        res[tag] = rec
        print(f"variant {tag}: {json.dumps(rec)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory to compare with")
    ap.add_argument("--parent-pool", action="store_true",
                    help="the parent's float64 launch takes a ray pool")
    ap.add_argument("--variants", action="store_true",
                    help="time the float64 kernels' VARIANTS")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grad_census runs on a CUDA device")
    out = census(args.parent, args.parent_pool, args.variants)
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
