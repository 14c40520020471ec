"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xptxas -v -shared -Xcompiler -fPIC -o <lib> <source>

``--fmad=false`` stays: nvcc contracts a product and a sum into one fused
multiply-add wherever inlining lets it, so the render kernel's step, the
march kernel's and the gradient kernel's replay would contract differently
and part on chaotic rays, and the exact route would no longer round as the
plain versions do. The approx_recip route contracts explicitly instead
(``csrc/march_step.cuh::madd``), the same terms in every kernel. The
sources of ``FMAD_SOURCES`` build with nvcc's default ``--fmad=true``
instead: their own arithmetic is all explicit (``__fmul_rn`` and its kin,
never contracted), so the flag moves only the CUDA math library's
functions, which then round as PyTorch's own build of them does
(``csrc/tonemap.cu``'s ``pow`` and ``rsqrt``, the double ``sin`` and
``cos`` of ``csrc/composite.cu`` and ``csrc/birth.cu``).

The library lands in ``build/kernels/`` at the repository root, named by a
hash of the source, every header of ``csrc/`` and the flags, so an edited
source or shared header never loads a stale build. ptxas's report
(registers, spills, stack frame) is kept beside it. The first call of a
kernel's wrapper builds it; nothing is built at import time.

A march records ``MarchConfig.max_crossings`` equator crossings per ray,
any number from 1, as the JAX kernels take any. The kernels carry
``KMAX`` crossing slots per ray (``csrc/march_step.cuh``): the default
build has 4; more crossings take a build of their own with ``-DKMAX``
the next power of two from 8 up to ``KMAX_LIMIT`` (``kmax_for``), whose
library name carries it, so the default build and its instantiations are
the same whatever else is built. A source whose templates take their
arguments from the preprocessor (``csrc/composite.cu``) builds one library
for each set of ``defines`` it is asked for (``-DNAME=value`` flags, in
the library's name by a hash), at first use.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
from pathlib import Path
import subprocess

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return nvcc


KMAX_DEFAULT = 4
KMAX_LIMIT = 256


def kmax_for(max_crossings: int) -> int:
    """The crossing slots of the build that records ``max_crossings``
    crossings: 4 up to 4, else the next power of two from 8. Raises
    ValueError below 1 or above ``KMAX_LIMIT`` (each slot is 12 bytes of
    a ray's state: 256 take 3 KB per thread)."""
    if not 1 <= max_crossings <= KMAX_LIMIT:
        raise ValueError(f"max_crossings must lie in 1..{KMAX_LIMIT}, got "
                         f"{max_crossings}")
    if max_crossings <= KMAX_DEFAULT:
        return KMAX_DEFAULT
    k = 8
    while k < max_crossings:
        k *= 2
    return k


FMAD_SOURCES = ("tonemap.cu", "composite.cu", "birth.cu")


def _flags(source: str, kmax: int = KMAX_DEFAULT,
           defines: tuple[str, ...] = ()) -> tuple[str, ...]:
    """nvcc's flags for ``csrc/<source>`` with ``kmax`` crossing slots and
    the ``defines``."""
    flags = NVCC_FLAGS
    if source in FMAD_SOURCES:
        flags = tuple("--fmad=true" if f == "--fmad=false" else f
                      for f in flags)
    if kmax != KMAX_DEFAULT:
        flags = (*flags, f"-DKMAX={kmax}")
    return (*flags, *defines)


def _paths(source: str, kmax: int = KMAX_DEFAULT,
           defines: tuple[str, ...] = ()) -> tuple[Path, Path]:
    src = CSRC / source
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(_flags(source, kmax, defines)).encode())
    tag = "" if kmax == KMAX_DEFAULT else f"-k{kmax}"
    stem = f"{src.stem}{tag}-{digest.hexdigest()[:12]}"
    return BUILD_DIR / f"{stem}.so", BUILD_DIR / f"{stem}.ptxas.txt"


def build(source: str, kmax: int = KMAX_DEFAULT,
          defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<source>`` with ``kmax`` crossing slots and the
    ``defines`` unless an identical build exists; return the shared
    library's path. Raises RuntimeError with nvcc's output if the compile
    fails."""
    lib, report = _paths(source, kmax, defines)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *_flags(source, kmax, defines), "-o", str(tmp),
         str(CSRC / source)],
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    report.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def ptxas_report(source: str, kmax: int = KMAX_DEFAULT,
                 defines: tuple[str, ...] = ()) -> str:
    """ptxas's -v report of the current build of ``csrc/<source>``."""
    return _paths(source, kmax, defines)[1].read_text()


def parse_ptxas(report: str) -> list[tuple[str, int, int, int]]:
    """(kernel, registers, spill bytes stored + loaded, stack frame bytes)
    of each kernel entry in a ptxas -v report."""
    usage, entry, spill, stack = [], None, 0, 0
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            entry, spill, stack = m.group(1), 0, 0
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            stack = int(m.group(1))
            spill = int(m.group(2)) + int(m.group(3))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            usage.append((entry, int(m.group(1)), spill, stack))
            entry = None
    return usage


def ptxas_usage(source: str, kmax: int = KMAX_DEFAULT,
                defines: tuple[str, ...] = ()) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes stored + loaded) of each kernel
    entry in the current build of ``csrc/<source>``."""
    return [u[:3] for u in parse_ptxas(ptxas_report(source, kmax, defines))]


def ptxas_stack(source: str, kmax: int = KMAX_DEFAULT) -> dict[str, int]:
    """{kernel: stack frame bytes} of each kernel entry in the current
    build of ``csrc/<source>`` (local memory per thread: indexed arrays and
    spills)."""
    return {u[0]: u[3] for u in parse_ptxas(ptxas_report(source, kmax))}
