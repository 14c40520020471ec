"""SASS census of the march loop of every kernel instantiation.

Runs ``cuobjdump -sass`` on the shared libraries that ``ops/build.py``
builds from ``csrc/render.cu``, ``csrc/march.cu`` and
``csrc/march_grad.cu`` and, for each kernel (each template instantiation),
counts the instructions of its march loop by class:

* ``FFMA``, ``FMUL``, ``FADD``: the FP32 arithmetic the hand counts see;
* ``compare_select``: ``FSETP``, ``FSEL``, ``FMNMX``, ``FSET``, ``FCHK``
  (the min/max/clip, the comparisons, the divide's range check);
* ``MUFU``: the special-function unit (reciprocal, square root, exp2, ...);
* ``integer``: ``IMAD``, ``IADD3``, ``ISETP``, ``LOP3``, ``SHF``, ... (the
  step counter, the renormalization cadence, the crossing slots);
* ``double``: ``DADD``, ``DMUL``, ``DFMA``, ``DSETP``, ...;
* ``convert``: ``I2F``, ``F2I``, ``F2F`` (float <-> double among them), ...;
* ``branch``: ``BRA``, ``BSSY``, ``BSYNC``, ``RET``, ... and ``call``:
  ``CALL`` (the IEEE divide's and ``sqrtf``'s slow paths are subroutines
  placed after the kernel's body, reached by a call);
* ``move``: ``MOV``, ``IMAD.MOV``, ``HFMA2.MMA`` (a constant into a
  register), ``SEL``, ``P2R``, ``R2P``, ``PLOP3``;
* ``memory``, ``uniform`` (the uniform datapath, ``U*``), ``other``.

How the loop is found: every branch whose target lies at or before its own
address is a back-edge, and the instructions from its target to it are a
loop. Of the loops that hold no global store, no atomic and no
shared-memory access (local memory, where the crossing slots live, is
allowed) and lie in no other such loop, the march loop is the longest: in
``render.cu`` the per-pixel march (the AB3 march's main loop, its
bootstrap steps unrolled ahead of it; the start offset's and the
composite's loops are shorter). In ``march.cu``'s kernels
(``march_kernel``, ``march_kernel_f64``) it is the persistent warp's step
loop, the longest loop with no global store and no atomic (its outer loop
refills lanes and stores): shared memory is allowed there, where the
float64 AB3 march keeps its history of right-hand sides. In another
function that uses shared memory (``march_grad.cu``'s float kernels) it
is the first: the replay's march, ahead of the re-forward that writes the
stack to shared memory and the reverse that reads it; the float64 replay
is a kernel of its own (``march_replay_kernel_f64``), whose block of steps
is its march loop.
The gradient kernels' reverse loop (``reverse_loop``, ``--reverse``) is the
outermost loop that reads shared memory (the stack, or in float64 the
tape) and stores nothing: a reversed step. The count is static: every instruction of the loop counts once,
including those of a block that a branch skips on most steps (the
renormalization) and those of a nested loop (the
midpoint iteration, once). The slow-path subroutines a ``CALL`` reaches are
not in the count; each call site is.

Beside the classes, each loop's local-memory instructions are counted on
their own (``local``: ``LDL`` and ``STL``, which ``memory`` also counts):
an array indexed at run time, or a spill, lives in local memory.

    python -m blackhole_simulation_tpu_torch.tools.sass_census [--lib PATH ...]
        [--sass FILE ...] [--reverse]

prints one JSON object, {label: {"loop": [first, last address], "counts":
{class: n}, "total": n, "local": {"LDL": n, "STL": n}}}, of the march
loops (``--reverse``: of the
gradient kernels' reverse loops): by default of this checkout's three
libraries (built first if need be, which needs ``nvcc``); ``--lib`` names
other built libraries, ``--sass`` text files that ``cuobjdump -sass``
wrote.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
from pathlib import Path

SOURCES = ("render.cu", "march.cu", "march_grad.cu")
CLASSES = ("FFMA", "FMUL", "FADD", "compare_select", "MUFU", "integer",
           "double", "convert", "branch", "call", "move", "memory",
           "uniform", "other")

_FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_BRANCHES = ("BRA", "BRX", "JMP", "JMX")
_COMPARE = ("FSETP", "FSEL", "FMNMX", "FSET", "FCHK")
_INTEGER = ("IMAD", "IADD3", "IADD", "ISETP", "LOP3", "LOP", "SHF", "SHL",
            "SHR", "IABS", "IMNMX", "LEA", "IMUL", "FLO", "POPC", "BREV",
            "ISCADD", "PRMT", "IDP", "BMSK", "VIADD", "IMNMX", "VABSDIFF",
            "LEA.HI", "IDIV")
_DOUBLE = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET")
_CONVERT = ("I2F", "F2I", "F2F", "I2I", "FRND", "I2FP", "F2IP", "F2FP")
_CONTROL = ("BRA", "BRX", "JMP", "JMX", "BSSY", "BSYNC", "RET", "EXIT",
            "WARPSYNC", "BMOV", "BREAK", "YIELD", "KILL", "NANOSLEEP")
_MOVE = ("MOV", "MOV32I", "SEL", "P2R", "R2P", "PLOP3", "SHFL", "CS2R",
         "S2R", "S2UR")
_MEMORY = ("LDG", "STG", "LDS", "STS", "LDL", "STL", "LDC", "LD", "ST",
           "ATOM", "ATOMG", "ATOMS", "RED", "LDSM", "MEMBAR", "CCTL", "LDGSTS")
_STORE_OR_SHARED = ("STG", "STS", "LDS", "ST", "ATOM", "ATOMG", "ATOMS",
                    "RED", "LDSM", "LDGSTS")
_GLOBAL_STORE = ("STG", "ST", "ATOM", "ATOMG", "RED")
_LOCAL = ("LDL", "STL")
# The march kernels, whose step loop may use shared memory (march_loop).
_MARCH_KERNELS = ("march_kernel", "march_kernel_f64")


def opcode(text: str) -> str:
    """The instruction's opcode with its modifiers (``IMAD.MOV.U32``),
    without a predicate guard (``@!P0``)."""
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def classify(op: str) -> str:
    """The census class of an opcode (with its modifiers)."""
    base = op.split(".")[0]
    if base in ("FFMA", "FMUL", "FADD"):
        return base
    if base in _COMPARE:
        return "compare_select"
    if base == "MUFU":
        return "MUFU"
    if op.startswith(("IMAD.MOV", "HFMA2.MMA")) or base in _MOVE:
        return "move"
    if base in _INTEGER:
        return "integer"
    if base in _DOUBLE:
        return "double"
    if base in _CONVERT:
        return "convert"
    if base == "CALL":
        return "call"
    if base in _CONTROL:
        return "branch"
    if base in _MEMORY:
        return "memory"
    if base.startswith("U") or base in ("ULDC",):
        return "uniform"
    return "other"


def parse(text: str) -> dict[str, list[tuple[int, str]]]:
    """{function: [(address, instruction text), ...]} of cuobjdump's
    ``-sass`` output, in address order."""
    funcs: dict[str, list[tuple[int, str]]] = {}
    current = None
    for line in text.splitlines():
        if m := _FUNCTION.search(line):
            current = m.group(1)
            funcs[current] = []
        elif current is not None and (m := _INSTR.search(line)):
            funcs[current].append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(instrs: list[tuple[int, str]]) -> list[tuple[int, int]]:
    """(first, last) instruction indices of every loop: a branch whose
    target is at or before its own address, and the span back to the
    target."""
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    out = []
    for i, (addr, text) in enumerate(instrs):
        if opcode(text).split(".")[0] not in _BRANCHES:
            continue
        targets = _TARGET.findall(text)
        if not targets:
            continue
        target = int(targets[-1], 16)
        if target <= addr and target in index:
            out.append((index[target], i))
    return out


def _free_of(instrs, lo, hi, ops) -> bool:
    return not any(opcode(t).split(".")[0] in ops
                   for _, t in instrs[lo:hi + 1])


def march_loop(instrs: list[tuple[int, str]], march_kernel: bool = False
               ) -> tuple[int, int] | None:
    """The march loop: of the loops with no global store, atomic or
    shared-memory access that lie in no other such loop, the longest; in a
    function that uses shared memory (the gradient kernel), the first (its
    replay, ahead of the re-forward and the reverse that use the shared
    stack). In a march kernel (``march_kernel``: march.cu's), the longest
    of the outermost loops with no global store and no atomic, shared
    memory allowed (the float64 AB3 march's ring)."""
    banned = _GLOBAL_STORE if march_kernel else _STORE_OR_SHARED
    free = [(lo, hi) for lo, hi in loops(instrs)
            if _free_of(instrs, lo, hi, banned)]
    outer = [(lo, hi) for lo, hi in free
             if not any(a <= lo and hi <= b and (a, b) != (lo, hi)
                        for a, b in free)]
    if not outer:
        return None
    shared = any(opcode(t).split(".")[0] in ("LDS", "STS")
                 for _, t in instrs)
    if shared and not march_kernel:
        return min(outer)
    return max(outer, key=lambda span: span[1] - span[0])


def reverse_loop(instrs: list[tuple[int, str]]) -> tuple[int, int] | None:
    """The gradient kernel's reverse loop: of the loops that read shared
    memory (``LDS``, the re-forward's stack or tape) and hold no
    shared-memory store, no global store and no atomic, and that lie in no
    other such loop, the longest. None in a function without one."""
    def reads_only(lo, hi):
        ops = {opcode(t).split(".")[0] for _, t in instrs[lo:hi + 1]}
        return "LDS" in ops and not ops & {"STS", "STG", "ST", "ATOM",
                                           "ATOMG", "ATOMS", "RED"}
    spans = [(lo, hi) for lo, hi in loops(instrs) if reads_only(lo, hi)]
    outer = [(lo, hi) for lo, hi in spans
             if not any(a <= lo and hi <= b and (a, b) != (lo, hi)
                        for a, b in spans)]
    if not outer:
        return None
    return max(outer, key=lambda span: span[1] - span[0])


def local_count(instrs: list[tuple[int, str]]) -> dict[str, int]:
    """The local-memory loads and stores (``LDL``, ``STL``) among
    ``instrs``."""
    out = dict.fromkeys(_LOCAL, 0)
    for _, text in instrs:
        base = opcode(text).split(".")[0]
        if base in out:
            out[base] += 1
    return out


def count(instrs: list[tuple[int, str]]) -> dict[str, int]:
    """Instructions by class (NOPs left out)."""
    counts = dict.fromkeys(CLASSES, 0)
    for _, text in instrs:
        op = opcode(text)
        if op.split(".")[0] == "NOP":
            continue
        counts[classify(op)] += 1
    return counts


def label(mangled: str) -> str:
    """``_Z13render_kernelILi0ELb0ELb1EEv...`` -> ``render_kernel<0,0,1>``."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    start = m.end()
    name = mangled[start:start + n]
    rest = mangled[start + n:]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if not args:
        return name
    vals = re.findall(r"L[ib](\d+)E", args.group(1))
    return f"{name}<{','.join(vals)}>"


def record(instrs: list[tuple[int, str]], span: tuple[int, int]) -> dict:
    """The census record of the loop ``span`` (first and last instruction
    indices) of ``instrs``: its addresses, its counts by class, their
    total and its local-memory instructions."""
    lo, hi = span
    counts = count(instrs[lo:hi + 1])
    return {"loop": [instrs[lo][0], instrs[hi][0]], "counts": counts,
            "total": sum(counts.values()),
            "local": local_count(instrs[lo:hi + 1])}


def census(text: str) -> dict[str, dict]:
    """{label: {"loop": [first, last address], "counts", "total",
    "local"}} of the march loop of every function in ``text`` that has
    one."""
    out = {}
    for name, instrs in parse(text).items():
        lab = label(name)
        span = march_loop(instrs, lab.split("<")[0] in _MARCH_KERNELS)
        if span is not None:
            out[lab] = record(instrs, span)
    return out


def reverse_census(text: str) -> dict[str, dict]:
    """``census``'s record of the reverse loop (``reverse_loop``) of every
    function in ``text`` that has one: the gradient kernel's
    instantiations."""
    out = {}
    for name, instrs in parse(text).items():
        span = reverse_loop(instrs)
        if span is not None:
            out[label(name)] = record(instrs, span)
    return out


def _cuobjdump() -> str:
    tool = shutil.which("cuobjdump")
    if tool is None and Path("/usr/local/cuda/bin/cuobjdump").exists():
        tool = "/usr/local/cuda/bin/cuobjdump"
    if tool is None:
        raise RuntimeError("cuobjdump not found: the census runs where the "
                           "CUDA toolkit is")
    return tool


def sass(lib: Path) -> str:
    """``cuobjdump -sass`` of a built library."""
    proc = subprocess.run([_cuobjdump(), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300)
    return proc.stdout


def libraries() -> list[Path]:
    """This checkout's libraries of SOURCES, built if need be."""
    from blackhole_simulation_tpu_torch.ops import build

    return [build.build(src) for src in SOURCES]


def run(libs: list[Path] | None = None) -> dict[str, dict]:
    """The census of every instantiation in ``libs`` (default: this
    checkout's three libraries)."""
    out = {}
    for lib in libs if libs is not None else libraries():
        out.update(census(sass(Path(lib))))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lib", nargs="*", default=None,
                    help="built libraries (default: this checkout's)")
    ap.add_argument("--sass", nargs="*", default=None,
                    help="files holding cuobjdump -sass output")
    ap.add_argument("--reverse", action="store_true",
                    help="the gradient kernel's reverse loop in place of "
                         "the march loop")
    args = ap.parse_args(argv)
    of = reverse_census if args.reverse else census
    if args.sass:
        texts = [Path(f).read_text() for f in args.sass]
    else:
        texts = [sass(Path(p)) for p in args.lib] if args.lib else [
            sass(lib) for lib in libraries()]
    out = {}
    for text in texts:
        out.update(of(text))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
