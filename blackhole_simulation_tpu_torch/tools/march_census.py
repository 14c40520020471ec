"""Census of the float64 AB3 march on the 1080p flagship rays, and its
comparison with another build of ``csrc/march.cu``.

On the card, for the rays of the 1080p flagship frame in float64 on the
staged route with ``MarchConfig.multistep`` (``chip_smoke.py`` phase
23 (a): 2,073,600 rays through ``march_u``, the AB3 march of
``march_kernel_f64<1>``), it reports:

* ptxas's registers, spill and stack frame of every kernel of this
  checkout's ``march.cu``, and the local-memory warnings of a copy built
  with ``-Xptxas -warn-lmem-usage``;
* the SASS census of every float64 instantiation's step loop, its
  local-memory loads and stores counted apart (``tools/sass_census.py``);
* the float64 AB3 kernel's time alone over back-to-back launches (CUDA
  events), its launch shape, the lane efficiency of its persistent warps
  (counted by a copy, ``count_lanes``) beside one thread per ray's on the
  same rays (``ops/pallas_march.py::lane_efficiency``);
* each ray's nine outputs bit-identical to ``march_u_plain``'s.

With ``--parent DIR`` (the ``csrc/`` directory of another commit, e.g. the
parent's, unpacked by ``git archive`` into ``build/``) it also builds that
directory's ``march.cu``, launches both float64 AB3 kernels on the same
rays in turns (parent, this, this, parent), requires each ray's outputs
bit-identical, and compares the machine code (``cuobjdump -sass``, each
function's instructions and encodings) of every other kernel of
``march.cu``, ``render.cu`` and ``march_grad.cu``, in the default build and
the KMAX 8 one, with the parent's.

``--variants`` builds copies of this checkout's ``march.cu`` with the
float64 kernels' registers capped (``VARIANTS``: resident blocks per SM;
the committed build takes ptxas's own choice) and, with ``--parent``,
copies of the parent's capped (``PARENT_CAPS``, its AB3 history kept in
registers), and times each in turns with this build, each held
bit-identical to it. Copies are built
under ``build/march_census/`` from text edits of the copy, never of the
checkout's source.

    python -m blackhole_simulation_tpu_torch.tools.march_census
        [--parent DIR] [--variants] [--out FILE]

prints one JSON object (and writes it to FILE).
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from blackhole_simulation_tpu_torch.ops import build as kbuild
from blackhole_simulation_tpu_torch.ops.pallas_march import (
    c_march_params,
    lane_efficiency,
    march_kernel_shape,
    march_u,
    march_u_plain,
    normalize_pt,
    scalar_params,
)
from blackhole_simulation_tpu_torch.render.camera import Camera, camera_rays_u
from blackhole_simulation_tpu_torch.render.march import _march_inputs
from blackhole_simulation_tpu_torch.tools import grad_census, sass_census
from blackhole_simulation_tpu_torch.tools.grad_census import (
    event_ms,
    same_bits,
)

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "blackhole_simulation_tpu_torch" / "csrc"
WORK = ROOT / "build" / "march_census"
F64 = torch.float64
# The flagship physics on the staged float64 route with the AB3 march
# (chip_smoke.py's F64_CFG with multistep): exact divides, 256 steps.
AB3_CFG = dataclasses.replace(grad_census.AD_CFG, multistep=True)
AB3_LABEL = "march_kernel_f64<1>"
LAUNCHES = 5
# --variants: this checkout's float64 kernels with their registers capped
# at these resident blocks per SM (ptxas's own choice is committed); with
# --parent, the parent's capped at PARENT_CAPS (its AB3 history in
# registers).
VARIANTS = (4, 5, 6, 7)
PARENT_CAPS = (4, 5)
# The sources and crossing-slot builds whose machine code --parent compares.
SASS_SOURCES = ("march.cu", "render.cu", "march_grad.cu")
SASS_KMAX = (4, 8)


def ab3_args(width: int = 1920, height: int = 1080):
    """``march_u``'s arguments for the float64 AB3 march of the flagship
    frame: phase 23 (a)'s rays."""
    cam = Camera.create(r=30.0, theta=math.pi / 2 - 0.25, fov=0.5,
                        width=width, height=height)
    m = torch.tensor(1.0, dtype=F64, device="cuda")
    a = torch.tensor(0.999, dtype=F64, device="cuda")
    rays = camera_rays_u(cam, m, a, dtype=F64)
    return _march_inputs(rays, m, a, AB3_CFG, None) + (AB3_CFG, None)


def capped(blocks: int):
    """An edit of ``march.cu`` (this checkout's or the parent's) that caps
    its float64 kernels' registers at ``blocks`` resident blocks per SM of
    128 threads (65536 / (128 x blocks))."""
    def edit(text):
        return text.replace(
            "__global__ void __launch_bounds__(THREADS)\nmarch_kernel_f64(",
            f"__global__ void __launch_bounds__(THREADS, {blocks})\n"
            "march_kernel_f64(", 1)
    return edit


def count_lanes(text: str) -> str:
    """``march.cu`` counting, over each pass of its warps' step loop, the
    steps its lanes marched (pool[2..3], 64 bits) and 32 x the most that
    one lane marched (pool[4..5]): their ratio over the launch is the lane
    efficiency of the persistent warps' step loop."""
    edits = (
        ("  int j = -1;",
         "  unsigned long long c_live = 0, c_all = 0;\n  int j = -1;"),
        ("#pragma unroll 1\n"
         "    for (int rep = 0; rep < CHECK_STEPS && live; ++rep) {\n",
         "    int n_rep = 0;\n#pragma unroll 1\n"
         "    for (int rep = 0; rep < CHECK_STEPS && live; ++rep) {\n"
         "      ++n_rep;\n"),
        ("    }\n  }\n  pool_retire(pool);",
         "    }\n"
         "    c_live += __reduce_add_sync(FULL_MASK, n_rep);\n"
         "    c_all += 32ull * __reduce_max_sync(FULL_MASK, n_rep);\n"
         "  }\n"
         "  if (lane == 0) {\n"
         "    atomicAdd(reinterpret_cast<unsigned long long*>(pool + 2), "
         "c_live);\n"
         "    atomicAdd(reinterpret_cast<unsigned long long*>(pool + 4), "
         "c_all);\n"
         "  }\n"
         "  pool_retire(pool);"),
    )
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"count_lanes: no single anchor {old!r}")
        text = text.replace(old, new)
    return text


class MarchLib:
    """A built ``march.cu`` whose float64 march is launched through
    ctypes (``bh_march_launch64``, the interface of this checkout and of
    its parent)."""

    def __init__(self, path: Path):
        self.lib = lib = ctypes.CDLL(str(path))
        lib.bh_march_launch64.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 4)
        lib.bh_march_launch64.restype = ctypes.c_int
        lib.bh_march_shape64.argtypes = [ctypes.c_void_p] * 3
        lib.bh_march_shape64.restype = ctypes.c_int
        lib.bh_error_string.argtypes = [ctypes.c_int]
        lib.bh_error_string.restype = ctypes.c_char_p

    def shape(self, cfg) -> dict:
        """The float64 launch shape (the parent's interface writes three
        words, no shared memory)."""
        out = (ctypes.c_int * 4)()
        c_mp = c_march_params(cfg, F64)
        if self.lib.bh_march_shape64(ctypes.byref(c_mp), None, out) != 0:
            raise RuntimeError("march shape query failed")
        threads, blocks, _, smem = out
        return {"threads": threads, "blocks_per_sm": blocks,
                "warps_per_sm": blocks * threads // 32, "smem_bytes": smem}

    @staticmethod
    def prepare(args) -> dict:
        """The launch's tensors for ``march_u``'s arguments (no jets)."""
        yt0, thr, m, a, r_h, r_ph, cfg, _ = args
        n, k, dev = yt0.shape[1], cfg.max_crossings, yt0.device
        fl = dict(dtype=F64, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return dict(
            params=scalar_params(m, a, r_h, r_ph, dev, F64),
            y=normalize_pt(yt0).detach().contiguous(),
            thr=thr.detach().to(F64).contiguous(),
            out=[torch.empty(sh, **dt) for sh, dt in (
                ((8, n), fl), ((n,), i32), ((n,), i32), ((k, n), fl),
                ((k, n), fl), ((k, n), fl), ((n,), i32), ((n,), fl))]
            + [torch.zeros((3, n), **fl)],
            pool=torch.zeros(8, **i32), c_mp=c_march_params(cfg, F64), n=n)

    def launch(self, t) -> None:
        p = lambda x: ctypes.c_void_p(x.data_ptr())
        yo, hit, steps, cr, cp, ct, nc, rmin, _ = t["out"]
        err = self.lib.bh_march_launch64(
            p(t["params"]), p(t["y"]), p(t["thr"]), p(yo), p(hit), p(steps),
            p(cr), p(cp), p(ct), p(nc), p(rmin), ctypes.c_void_p(0),
            ctypes.c_int(t["n"]), p(t["pool"]), ctypes.byref(t["c_mp"]), None,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err != 0:
            raise RuntimeError("march kernel launch failed: "
                               + self.lib.bh_error_string(err).decode())


def outputs_identical(a, b) -> bool:
    """Each of the nine outputs equal bit for bit."""
    return all(same_bits(x, y) for x, y in zip(a, b))


def counted_lane_efficiency(lib: MarchLib, args) -> float:
    """The lane efficiency that a ``count_lanes`` build counts on
    ``args``."""
    t = lib.prepare(args)
    lib.launch(t)
    torch.cuda.synchronize()
    c = t["pool"].view(torch.int64).tolist()
    return c[1] / c[2] if c[2] else 1.0


def functions(text: str) -> dict[str, str]:
    """{label: the function's cuobjdump text, instructions and encodings,
    runs of blanks made one} of a library's ``cuobjdump -sass``."""
    out, name, lines = {}, None, []
    for line in text.splitlines():
        if m := re.search(r"Function\s*:\s*(\S+)", line):
            if name is not None:
                out[sass_census.label(name)] = "\n".join(lines)
            name, lines = m.group(1), []
        elif name is not None and line.strip():
            # cuobjdump pads the encodings' column to the widest
            # instruction of the whole dump: compare without the padding
            lines.append(" ".join(line.split()))
    if name is not None:
        out[sass_census.label(name)] = "\n".join(lines)
    return out


def lmem_warnings(report: str) -> list[str]:
    """ptxas's local-memory lines of a ``-warn-lmem-usage`` build."""
    return [line.strip() for line in report.splitlines()
            if line.startswith("ptxas") and "ocal memory" in line]


def census(parent: Path | None, variants: bool,
           save=lambda out: None) -> dict:
    """The census (see the module docstring); ``save`` receives the
    record after each stage."""
    out = {"device": torch.cuda.get_device_name(0)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    jobs, builds, errors = {}, {}, {}
    with ThreadPoolExecutor(8) as ex:
        this_job = ex.submit(kbuild.build, "march.cu")
        jobs["count"] = ex.submit(grad_census.build_copy, CSRC, "count",
                                  count_lanes, "march.cu", WORK)
        jobs["lmem"] = ex.submit(grad_census.build_copy, CSRC, "lmem", None,
                                 "march.cu", WORK,
                                 ("-Xptxas", "-warn-lmem-usage"))
        if parent is not None:
            for src in SASS_SOURCES:
                for kmax in SASS_KMAX:
                    flags = () if kmax == 4 else (f"-DKMAX={kmax}",)
                    jobs[f"parent {src} {kmax}"] = ex.submit(
                        grad_census.build_copy, parent,
                        f"parent_{Path(src).stem}_k{kmax}", None, src, WORK,
                        flags)
                    jobs[f"this {src} {kmax}"] = ex.submit(
                        grad_census.build_copy, CSRC,
                        f"this_{Path(src).stem}_k{kmax}", None, src, WORK,
                        flags)
            jobs["parent lmem"] = ex.submit(
                grad_census.build_copy, parent, "parent_lmem", None,
                "march.cu", WORK, ("-Xptxas", "-warn-lmem-usage"))
            jobs["parent count"] = ex.submit(
                grad_census.build_copy, parent, "parent_count", count_lanes,
                "march.cu", WORK)
            if variants:
                for b in PARENT_CAPS:
                    jobs[f"parent cap {b}"] = ex.submit(
                        grad_census.build_copy, parent, f"parent_cap{b}",
                        capped(b), "march.cu", WORK)
        if variants:
            for b in VARIANTS:
                jobs[f"cap {b}"] = ex.submit(
                    grad_census.build_copy, CSRC, f"cap{b}", capped(b),
                    "march.cu", WORK)
        try:
            this_path = this_job.result()
        except RuntimeError as e:
            this_path = None
            errors["this"] = str(e)[-4000:]
        for k, f in jobs.items():
            try:
                builds[k] = f.result()
            except RuntimeError as e:
                errors[k] = str(e)[-4000:]
    out["build_errors"] = errors
    for k, (_, report) in builds.items():
        if "lmem" in k:
            out[f"{k} warnings"] = lmem_warnings(report)
    args = ab3_args()
    if this_path is not None:
        out["this"] = this_census(this_path, builds, args)
        print(f"this: {json.dumps(out['this'])}", flush=True)
        save(out)
    if parent is not None and "parent march.cu 4" in builds:
        out["parent"] = parent_census(builds, args, this_path is not None)
        print(f"parent: {json.dumps(out['parent'])}", flush=True)
        save(out)
        if this_path is not None:
            out["sass_identical"] = compare_sass(builds)
            print(f"sass: {json.dumps(out['sass_identical'])}",
                  flush=True)
            save(out)
    if variants and this_path is not None:
        out["variants"] = compare_variants(builds, this_path, args)
        save(out)
    return out


def loop_census(lib_path: Path) -> dict:
    return {k: v for k, v in sass_census.census(
        sass_census.sass(lib_path)).items() if "f64" in k}


def this_census(this_path: Path, builds, args) -> dict:
    """This checkout's build: ptxas, the float64 loops' census, the AB3
    kernel's time, shape and lane efficiency, and bit-identity to the plain
    version."""
    rec = {"ptxas": {sass_census.label(e): [r, s, f] for e, r, s, f in
                     kbuild.parse_ptxas(kbuild.ptxas_report("march.cu"))},
           "loops": loop_census(this_path)}
    lib = MarchLib(this_path)
    t = lib.prepare(args)
    rec["ms"] = event_ms(lambda: lib.launch(t), LAUNCHES)
    rec["shape"] = march_kernel_shape(AB3_CFG, None, F64)
    with torch.no_grad():
        k = march_u(*args)
        torch.cuda.synchronize()
        p = march_u_plain(*args)
    steps = k[2]
    rec.update(rays=int(steps.numel()), steps_sum=int(steps.long().sum()),
               steps_per_ray=float(steps.double().mean()),
               plain_bit_identical=outputs_identical(k, p),
               ctypes_bit_identical=outputs_identical(k, t["out"]),
               lane_efficiency_one_per_thread=lane_efficiency(steps))
    if "count" in builds:
        rec["lane_efficiency"] = counted_lane_efficiency(
            MarchLib(builds["count"][0]), args)
    return rec


def parent_census(builds, args, have_this: bool) -> dict:
    """The parent's build: ptxas, the float64 loops' census, the AB3
    kernel's time in turns with this build's, shape, lane efficiency and
    bit-identity to this build."""
    path, report = builds["parent march.cu 4"]
    rec = {"ptxas": {sass_census.label(e): [r, s, f] for e, r, s, f in
                     kbuild.parse_ptxas(report)},
           "loops": loop_census(path)}
    pk = MarchLib(path)
    rec["shape"] = pk.shape(AB3_CFG)
    pt = pk.prepare(args)
    if "parent count" in builds:
        rec["lane_efficiency"] = counted_lane_efficiency(
            MarchLib(builds["parent count"][0]), args)
    if not have_this:
        rec["ms"] = [event_ms(lambda: pk.launch(pt), LAUNCHES)]
        return rec
    this = MarchLib(kbuild.build("march.cu"))
    tt = this.prepare(args)
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        fn = ((lambda: pk.launch(pt)) if who == "parent"
              else (lambda: this.launch(tt)))
        times[who].append(event_ms(fn, LAUNCHES))
    pk.launch(pt)
    this.launch(tt)
    torch.cuda.synchronize()
    rec.update(parent_ms=times["parent"], this_ms=times["this"],
               bit_identical=outputs_identical(pt["out"], tt["out"]))
    return rec


def compare_sass(builds) -> dict:
    """{source and KMAX: {"identical": [...], "differ": [...]}} of every
    function of the parent's builds against this checkout's."""
    res = {}
    for src in SASS_SOURCES:
        for kmax in SASS_KMAX:
            key = f"parent {src} {kmax}"
            if key not in builds:
                continue
            mine_key = f"this {src} {kmax}"
            if mine_key not in builds:
                continue
            theirs = functions(sass_census.sass(builds[key][0]))
            mine = functions(sass_census.sass(builds[mine_key][0]))
            same = sorted(k for k, v in theirs.items() if mine.get(k) == v)
            differ = sorted(set(theirs) - set(same))
            res[f"{src} KMAX {kmax}"] = {
                "identical": same, "differ": differ,
                "new": sorted(set(mine) - set(theirs)),
                "first_differences": {k: first_differences(
                    theirs[k], mine.get(k, "")) for k in differ}}
    return res


def first_differences(a: str, b: str, n: int = 4) -> list:
    """The first ``n`` lines where two functions' texts part: [line, the
    parent's, this checkout's], and the two line counts."""
    la, lb = a.splitlines(), b.splitlines()
    out = [[i, x, y] for i, (x, y) in enumerate(zip(la, lb)) if x != y][:n]
    return [len(la), len(lb), out]


def compare_variants(builds, this_path: Path, args) -> dict:
    """Each variant build (and each capped parent) on the AB3 rays, in
    turns with this build, its outputs bit-identical to this build's."""
    res = {}
    this = MarchLib(this_path)
    tt = this.prepare(args)
    tags = [f"cap {b}" for b in VARIANTS] + [
        f"parent cap {b}" for b in PARENT_CAPS]
    for tag in tags:
        if tag not in builds:
            continue
        lib_path, report = builds[tag]
        vk = MarchLib(lib_path)
        vt = vk.prepare(args)
        ms = {"variant": [], "this": []}
        for who in ("variant", "this", "this", "variant"):
            fn = ((lambda: vk.launch(vt)) if who == "variant"
                  else (lambda: this.launch(tt)))
            ms[who].append(event_ms(fn, LAUNCHES))
        vk.launch(vt)
        this.launch(tt)
        torch.cuda.synchronize()
        ptxas = {sass_census.label(e): [r, s, f] for e, r, s, f in
                 kbuild.parse_ptxas(report)}
        loops = loop_census(lib_path)
        rec = {**ms, "bit_identical": outputs_identical(vt["out"],
                                                        tt["out"]),
               "ptxas": ptxas.get(AB3_LABEL),
               "shape": vk.shape(AB3_CFG),
               "loop": loops.get(AB3_LABEL)}
        res[tag] = rec
        print(f"variant {tag}: {json.dumps(rec)}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a csrc/ directory to compare with")
    ap.add_argument("--variants", action="store_true",
                    help="time the float64 AB3 march's VARIANTS")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("march_census runs on a CUDA device")
    def save(out):
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(out))

    out = census(args.parent, args.variants, save)
    save(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
